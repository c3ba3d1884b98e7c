// Fused analytic-guidance Euler-Maruyama sampler (DPS / PiGDM), all f32.
//
// Replaces the Pallas TPU kernel dmip_tpu/ops/dps_kernel.py ::
// fused_guided_em_sampler (_guided_em_kernel, pallas_call at :380): every
// step of the guided reverse SDE in one launch.  Per step s = T - i/N T and
// sample row:
//   s_p = prior(x, s)          tanh MLP on [x, t]; x0 = (x + std^2 s_p) / alpha
//   f   = surr(x0)             ReLU MLP, xdim -> ydim
//   dps:  the heteroscedastic Gaussian gradient's three cotangents (v1, v2, v3
//         of losses.likelihood_score_target) folded into one,
//         v = -a^2 v1 + v2 + a^2 v3, since the target is linear in them;
//         one surrogate VJP q = J^T v and one prior VJP
//   pgdm: J by three forward tangents through the ReLU chain, the Woodbury
//         solve with the 3x3 inner matrix inverted by its adjugate (the TPU
//         kernel's expressions, term for term), q = J^T u, one prior VJP
//   both: s_lik = (q + std^2 (ds_p/dx)^T q) / alpha
//   s_lik *= min(1, clip / (|s_lik| + 1e-12));  x += delta mu + sqrt(delta) sigma xi
// with xi from an in-kernel Philox4x32-10 keyed by (seed, row, step).
//
// What bounds it on an H100: f32 arithmetic.  At the dps_prior shapes
// (4 -> 512^3 -> 3 prior, 3 -> 256^3 -> 23 surrogate) a sample-step is
// ~2.66 MFLOP in 'dps' mode (prior forward and one VJP 2.12, surrogate
// forward and one VJP 0.55) and ~3.2 MFLOP in 'pgdm' mode (the three
// Jacobian tangents): ~0.24 s and ~0.29 s per 30k x 200 launch at the
// 67 TFLOP/s non-tensor f32 peak.  No TF32 or bf16: the guidance divides by
// (a f)^2 + b^2 with b = 0.01.
//
// Design.  A block owns 64 rows for all steps, 512 threads.  Each product
// is a register-tiled SIMT GEMM in the style of the MH kernel: activations
// K-major in shared memory ([unit][row]), each thread 8 rows x (N/64)
// units, weight rows read as coalesced float4s from L2 (the ~2.6 MB of f32
// weights and their transposes do not fit in shared memory), results held
// in registers until every thread has read the layer's input and then
// written over it, so one 64 x 512 f32 buffer (128 KB) serves every layer.
// The working set does not fit beside it: the three 512-wide tanh layers
// alone are 384 KB for 64 rows.  So (a) each step runs one backward pass
// per net (the dps cotangents are folded, pgdm's tangents run one after
// another through the same buffer), (b) the ReLU masks are kept as bits in
// shared memory (8 rows per byte), and (c) the prior's tanh derivatives
// 1 - h^2 go to a per-block scratch slab in global memory, written in the
// forward pass and read back once by the VJP in the same step.  With one
// block per SM the slabs in flight are 132 x 3 x 512 x 64 x 4 B ~ 52 MB,
// a little above the 50 MB L2, so part of them goes to HBM: at most
// ~0.8 MB per block-step, ~74 GB per 30k x 200 launch, ~22 ms at 3.35 TB/s.
// Fewer rows per block would fit the working set in shared memory but
// stream every weight matrix for fewer rows; recomputing the forward in
// the backward pass would cost a third more arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define G_ROWS 64
#define G_THREADS 512
#define G_MAX_MID 4
#define G_MAX_XDIM 4
#define G_MAX_YDIM 32

struct Mlp {
  // first layer (xdim -> W), its bias, and (for the prior) the time column
  const float* w1;    // (xdim, W)
  const float* w1t;   // prior: (W,) time row; surrogate: null
  const float* b1;    // (W,)
  const float* w1T;   // (W, xdim)
  const float* w[G_MAX_MID];   // (W, W)
  const float* b[G_MAX_MID];   // (W,)
  const float* wT[G_MAX_MID];  // (W, W) transposed
  const float* wo;    // (W, out)
  const float* bo;    // (out,)
  const float* woT;   // (out, W)
  int n_mid, width, tn;  // tn = width / 64
};

struct GuidedArgs {
  const float* x0;     // (n, xdim)
  const float* y;      // (ydim,)
  Mlp prior, surr;
  const float* noise;  // (stop_step - start_step, n, xdim) or null
  float* out;          // (n, xdim)
  float* scratch;      // per block: (1 + prior.n_mid) x prior.width x 64 floats
  int n, xdim, ydim, num_steps, start_step, stop_step, pgdm, has_clip;  // runs steps [start, stop) of num_steps
  float T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale, a2, b2, clip;
  unsigned long long seed;
};

// Column j of the TN columns thread tx owns (64 threads across N = 64 TN):
// groups of 4 adjacent columns for TN >= 4, so a warp's weight reads are
// contiguous float4s.
template <int TN>
__device__ __forceinline__ int own_col(int tx, int j) {
  if (TN == 8) return (j < 4) ? tx * 4 + j : 256 + tx * 4 + (j - 4);
  return tx * TN + j;
}

template <int TN>
__device__ __forceinline__ void load_wrow(const float* __restrict__ wrow, int tx, float (&w)[TN]) {
  if constexpr (TN == 8) {
    const float4 c0 = __ldg(reinterpret_cast<const float4*>(wrow + tx * 4));
    const float4 c1 = __ldg(reinterpret_cast<const float4*>(wrow + 256 + tx * 4));
    w[0] = c0.x; w[1] = c0.y; w[2] = c0.z; w[3] = c0.w;
    w[4] = c1.x; w[5] = c1.y; w[6] = c1.z; w[7] = c1.w;
  } else if constexpr (TN == 4) {
    const float4 c0 = __ldg(reinterpret_cast<const float4*>(wrow + tx * 4));
    w[0] = c0.x; w[1] = c0.y; w[2] = c0.z; w[3] = c0.w;
  } else if constexpr (TN == 2) {
    const float2 c0 = __ldg(reinterpret_cast<const float2*>(wrow + tx * 2));
    w[0] = c0.x; w[1] = c0.y;
  } else {
    w[0] = __ldg(wrow + tx);
  }
}

// act[k][r] (k < K) -> act[n][r] (n < 64 TN) = epi(sum_k act[k][r] W[k][n]),
// in place.  epi(c, r0, v) rewrites the 8 values v of column c, rows r0..r0+7.
template <int TN, class Epi>
__device__ __forceinline__ void gemm_km(float* act, int K, const float* __restrict__ W, Epi epi) {
  constexpr int N = 64 * TN;
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const float* arow = act + ty * 8;
#pragma unroll 8  // more weight loads in flight: faster than 4 on an H100 despite the spills
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(arow + k * G_ROWS);
    const float4 a1 = *reinterpret_cast<const float4*>(arow + k * G_ROWS + 4);
    float w[TN];
    load_wrow<TN>(W + (size_t)k * N, tx, w);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], w[j], acc[i][j]);
  }
  __syncthreads();  // every thread has read the input
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = own_col<TN>(tx, j);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = acc[i][j];
    epi(c, ty * 8, v);
    *reinterpret_cast<float4*>(act + c * G_ROWS + ty * 8) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(act + c * G_ROWS + ty * 8 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
}

template <class Epi>
__device__ __forceinline__ void gemm(int tn, float* act, int K, const float* W, Epi epi) {
  switch (tn) {
    case 8: gemm_km<8>(act, K, W, epi); break;
    case 4: gemm_km<4>(act, K, W, epi); break;
    case 2: gemm_km<2>(act, K, W, epi); break;
    default: gemm_km<1>(act, K, W, epi); break;
  }
}

// out[o][r] = sum_k act[k][r] W[k][o] (+ bias[o]) for a narrow output.
__device__ __forceinline__ void reduce_small(const float* act, int K, const float* __restrict__ W,
                                             int n_out, const float* __restrict__ bias, float* out) {
  for (int i = threadIdx.x; i < n_out * G_ROWS; i += G_THREADS) {
    const int o = i / G_ROWS, r = i - o * G_ROWS;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(act[k * G_ROWS + r], __ldg(W + k * n_out + o), acc);
    out[i] = bias != nullptr ? acc + __ldg(bias + o) : acc;
  }
  __syncthreads();
}

// Epilogues.  dfac / mask are this layer's slices of the scratch slab and
// of the shared mask bytes ([unit][row / 8], bit = row % 8).
struct EpiTanh {  // prior forward: h = tanh((acc + s w1t) + b) or tanh(acc + b); keep 1 - h^2
  const float* wt; const float* b; float s; float* dfac;
  __device__ void operator()(int c, int r0, float (&v)[8]) const {
    const float bc = __ldg(b + c), tc = wt != nullptr ? s * __ldg(wt + c) : 0.f;
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float h = tanhf(wt != nullptr ? (v[i] + tc) + bc : v[i] + bc);
      v[i] = h;
      d[i] = 1.f - h * h;
    }
    *reinterpret_cast<float4*>(dfac + c * G_ROWS + r0) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(dfac + c * G_ROWS + r0 + 4) = make_float4(d[4], d[5], d[6], d[7]);
  }
};

struct EpiRelu {  // surrogate forward: g = max(acc + b, 0); keep g > 0 as bits
  const float* b; uint8_t* mask;
  __device__ void operator()(int c, int r0, float (&v)[8]) const {
    const float bc = __ldg(b + c);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = fmaxf(v[i] + bc, 0.f);
      bits |= (v[i] > 0.f ? 1u : 0u) << i;
    }
    mask[c * (G_ROWS / 8) + r0 / 8] = (uint8_t)bits;
  }
};

struct EpiMask {  // ReLU backward / tangent: acc where the unit was active, else 0
  const uint8_t* mask;
  __device__ void operator()(int c, int r0, float (&v)[8]) const {
    const uint32_t bits = mask[c * (G_ROWS / 8) + r0 / 8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ((bits >> i) & 1u) ? v[i] : 0.f;
  }
};

struct EpiDfac {  // tanh backward: acc * (1 - h^2)
  const float* dfac;
  __device__ void operator()(int c, int r0, float (&v)[8]) const {
    const float4 d0 = *reinterpret_cast<const float4*>(dfac + c * G_ROWS + r0);
    const float4 d1 = *reinterpret_cast<const float4*>(dfac + c * G_ROWS + r0 + 4);
    v[0] *= d0.x; v[1] *= d0.y; v[2] *= d0.z; v[3] *= d0.w;
    v[4] *= d1.x; v[5] *= d1.y; v[6] *= d1.z; v[7] *= d1.w;
  }
};

// u (xdim rows of act) -> out[d][r] = ((ds_p/dx)^T u)[d], the prior net's VJP.
__device__ __forceinline__ void prior_vjp(const GuidedArgs& p, float* act, const float* slab, float* out) {
  const Mlp& m = p.prior;
  const size_t layer = (size_t)m.width * G_ROWS;
  gemm(m.tn, act, p.xdim, m.woT, EpiDfac{slab + m.n_mid * layer});
  for (int l = m.n_mid - 1; l >= 0; --l) gemm(m.tn, act, m.width, m.wT[l], EpiDfac{slab + l * layer});
  reduce_small(act, m.width, m.w1T, p.xdim, nullptr, out);
}

__global__ void __launch_bounds__(G_THREADS, 1) guided_em_kernel(const GuidedArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * G_ROWS;
  const int xdim = p.xdim, ydim = p.ydim;
  const Mlp& P = p.prior;
  const Mlp& Su = p.surr;
  const int act_rows = max(max(P.width, Su.width), G_MAX_YDIM);
  float* act = reinterpret_cast<float*>(smem);   // [act_rows][64]
  float* xs = act + act_rows * G_ROWS;            // [xdim][64] the state
  float* sp = xs + G_MAX_XDIM * G_ROWS;           // [xdim][64] prior score
  float* fz = sp + G_MAX_XDIM * G_ROWS;           // [ydim][64] surrogate output
  float* jac = fz + G_MAX_YDIM * G_ROWS;          // [3][ydim][64] pgdm Jacobian
  float* vj = jac + 3 * G_MAX_YDIM * G_ROWS;      // [xdim][64] q, the surrogate VJP
  float* vh = vj + G_MAX_XDIM * G_ROWS;           // [xdim][64] the prior VJP of q
  float* ys = vh + G_MAX_XDIM * G_ROWS;           // [ydim]
  uint8_t* masks = reinterpret_cast<uint8_t*>(ys + G_MAX_YDIM);  // [1 + n_mid][width][8]
  const size_t mask_layer = (size_t)Su.width * (G_ROWS / 8);
  float* slab = p.scratch + (size_t)blockIdx.x * (1 + P.n_mid) * P.width * G_ROWS;
  const size_t slab_layer = (size_t)P.width * G_ROWS;
  const uint2 key = make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32));

  if (tid < ydim) ys[tid] = p.y[tid];
  for (int i = tid; i < xdim * G_ROWS; i += G_THREADS) {
    const int d = i / G_ROWS, r = i - d * G_ROWS, row = row0 + r;
    xs[i] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  __syncthreads();

  for (int step = p.start_step; step < p.stop_step; ++step) {
    const float tt = ((float)step / (float)p.num_steps) * p.T;
    const float s = p.T - tt;
    const float beta = p.beta_min + p.bd * s;
    const float g = sqrtf(beta);
    const float int_beta = 0.5f * p.bd * s * s + p.beta_min * s;
    const float alpha = expf(-0.5f * int_beta);
    const float sig2 = 1.f - expf(-int_beta);

    // prior forward, keeping 1 - h^2 of each hidden layer in the slab
    for (int i = tid; i < xdim * G_ROWS; i += G_THREADS) act[i] = xs[i];
    __syncthreads();
    gemm(P.tn, act, xdim, P.w1, EpiTanh{P.w1t, P.b1, s, slab});
    for (int l = 0; l < P.n_mid; ++l)
      gemm(P.tn, act, P.width, P.w[l], EpiTanh{nullptr, P.b[l], 0.f, slab + (l + 1) * slab_layer});
    reduce_small(act, P.width, P.wo, xdim, P.bo, sp);

    // Tweedie estimate, then the surrogate forward with its ReLU masks
    for (int i = tid; i < xdim * G_ROWS; i += G_THREADS) act[i] = (xs[i] + sig2 * sp[i]) / alpha;
    __syncthreads();
    gemm(Su.tn, act, xdim, Su.w1, EpiRelu{Su.b1, masks});
    for (int l = 0; l < Su.n_mid; ++l)
      gemm(Su.tn, act, Su.width, Su.w[l], EpiRelu{Su.b[l], masks + (l + 1) * mask_layer});
    reduce_small(act, Su.width, Su.wo, ydim, Su.bo, fz);

    if (!p.pgdm) {
      for (int i = tid; i < ydim * G_ROWS; i += G_THREADS) {
        const float f = fz[i], resid = ys[i / G_ROWS] - f;
        const float pinv = 1.f / ((p.a2 * f) * f + p.b2);
        act[i] = (-p.a2 * (f * pinv) + resid * pinv) + p.a2 * (((resid * resid) * f) * (pinv * pinv));
      }
      __syncthreads();
      gemm(Su.tn, act, ydim, Su.woT, EpiMask{masks + Su.n_mid * mask_layer});
      for (int l = Su.n_mid - 1; l >= 0; --l) gemm(Su.tn, act, Su.width, Su.wT[l], EpiMask{masks + l * mask_layer});
      reduce_small(act, Su.width, Su.w1T, xdim, nullptr, vj);
      for (int i = tid; i < xdim * G_ROWS; i += G_THREADS) act[i] = vj[i];
      __syncthreads();
    } else {
      // Jacobian rows k: tangent m1 * U1[k] through the ReLU chain
      for (int k = 0; k < 3; ++k) {
        for (int i = tid; i < Su.width * G_ROWS; i += G_THREADS) {
          const int c = i / G_ROWS, r = i - c * G_ROWS;
          act[i] = ((masks[c * (G_ROWS / 8) + r / 8] >> (r % 8)) & 1u) ? __ldg(Su.w1 + k * Su.width + c) : 0.f;
        }
        __syncthreads();
        for (int l = 0; l < Su.n_mid; ++l)
          gemm(Su.tn, act, Su.width, Su.w[l], EpiMask{masks + (l + 1) * mask_layer});
        reduce_small(act, Su.width, Su.wo, ydim, nullptr, jac + k * G_MAX_YDIM * G_ROWS);
      }
      if (tid < G_ROWS) {
        const int r = tid;
        const float r2 = sig2 / (alpha * alpha + sig2);
        const float* j0 = jac + r;
        const float* j1 = jac + G_MAX_YDIM * G_ROWS + r;
        const float* j2 = jac + 2 * G_MAX_YDIM * G_ROWS + r;
        float w[3] = {0.f, 0.f, 0.f};
        float sm[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        for (int o = 0; o < ydim; ++o) {
          const float f = fz[o * G_ROWS + r];
          const float dinv = 1.f / ((p.a2 * f) * f + p.b2);
          const float dr = dinv * (ys[o] - f);
          const float jk[3] = {j0[o * G_ROWS], j1[o * G_ROWS], j2[o * G_ROWS]};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            w[k] += jk[k] * dr;
#pragma unroll
            for (int l = 0; l < 3; ++l) sm[k][l] += jk[k] * dinv * jk[l];
          }
        }
        float m[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int l = 0; l < 3; ++l) m[k][l] = (k == l ? 1.f : 0.f) + r2 * sm[k][l];
        const float c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
        const float c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2];
        const float c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1];
        const float c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0];
        const float c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2];
        const float c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0];
        const float det = m[0][0] * c00 + m[0][1] * (m[1][2] * m[2][0] - m[1][0] * m[2][2]) +
                          m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
        const float dinv3 = 1.f / det;
        const float z0 = (c00 * w[0] + c01 * w[1] + c02 * w[2]) * dinv3;
        const float z1 = (c01 * w[0] + c11 * w[1] + c12 * w[2]) * dinv3;
        const float z2 = (c02 * w[0] + c12 * w[1] + c22 * w[2]) * dinv3;
        float q[3] = {0.f, 0.f, 0.f};
        for (int o = 0; o < ydim; ++o) {
          const float f = fz[o * G_ROWS + r];
          const float dinv = 1.f / ((p.a2 * f) * f + p.b2);
          const float dr = dinv * (ys[o] - f);
          const float jk[3] = {j0[o * G_ROWS], j1[o * G_ROWS], j2[o * G_ROWS]};
          const float u = dr - r2 * (dinv * (z0 * jk[0] + z1 * jk[1] + z2 * jk[2]));
#pragma unroll
          for (int k = 0; k < 3; ++k) q[k] += jk[k] * u;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          vj[k * G_ROWS + r] = q[k];
          act[k * G_ROWS + r] = q[k];
        }
      }
      __syncthreads();
    }
    prior_vjp(p, act, slab, vh);

    // guidance, its norm cap, and the Euler-Maruyama update: one thread per row
    if (tid < G_ROWS) {
      const int r = tid, row = row0 + r;
      float sl[G_MAX_XDIM];
      for (int d = 0; d < xdim; ++d) sl[d] = (vj[d * G_ROWS + r] + sig2 * vh[d * G_ROWS + r]) / alpha;
      if (p.has_clip) {
        float ss = 0.f;
        for (int d = 0; d < xdim; ++d) ss += sl[d] * sl[d];
        const float scale = fminf(1.f, p.clip / (sqrtf(ss) + 1e-12f));
        for (int d = 0; d < xdim; ++d) sl[d] = sl[d] * scale;
      }
      for (int d = 0; d < xdim; ++d) {
        const int i = d * G_ROWS + r;
        const float x = xs[i];
        const float a_tot = g * (sp[i] + sl[d]);
        const float mu = (p.c_drift * g) * a_tot + (0.5f * beta) * x;
        float xn = x + p.delta * mu;
        if (p.noise_scale != 0.f) {
          float z = 0.f;
          if (p.noise != nullptr) {
            if (row < p.n) z = p.noise[((size_t)(step - p.start_step) * p.n + row) * xdim + d];
          } else {
            const uint4 b = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, (uint32_t)(d >> 1), 0u), key);
            z = (d & 1) ? normal_from_bits(b.z, b.w) : normal_from_bits(b.x, b.y);
          }
          xn = xn + (p.sqrt_delta * (p.c_sigma * g)) * (p.noise_scale * z);
        }
        xs[i] = xn;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < xdim * G_ROWS; i += G_THREADS) {
    const int d = i / G_ROWS, r = i - d * G_ROWS, row = row0 + r;
    if (row < p.n) p.out[(size_t)row * xdim + d] = xs[i];
  }
}

// Host side: unpack the pointer list of one net (see ops/dps_kernel.py ::
// _device_nets): first layer [w1, (w1t,) b1, w1T], then (w, b, wT) per
// hidden-to-hidden layer, then [wo, bo, woT].
static bool unpack_mlp(Mlp& m, const unsigned long long* ptrs, int n_mid, int width, bool has_time) {
  if (n_mid < 0 || n_mid > G_MAX_MID || (width != 64 && width != 128 && width != 256 && width != 512))
    return false;
  int i = 0;
  auto f = [&]() { return reinterpret_cast<const float*>(ptrs[i++]); };
  m.w1 = f();
  m.w1t = has_time ? f() : nullptr;
  m.b1 = f();
  m.w1T = f();
  for (int l = 0; l < n_mid; ++l) {
    m.w[l] = f();
    m.b[l] = f();
    m.wT[l] = f();
  }
  m.wo = f();
  m.bo = f();
  m.woT = f();
  m.n_mid = n_mid;
  m.width = width;
  m.tn = width / 64;
  return true;
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream`; returns a cudaError_t.  scratch holds
// ceil(n / 64) x (1 + prior_mid) x prior_width x 64 floats.
int guided_em_launch(const float* x0, const float* y, const unsigned long long* prior_ptrs, int prior_mid,
                     int prior_width, const unsigned long long* surr_ptrs, int surr_mid, int surr_width,
                     const float* noise, float* out, float* scratch, int n, int xdim, int ydim,
                     int num_steps, int start_step, int stop_step, int pgdm, int has_clip, float T,
                     float beta_min, float bd,
                     float c_drift, float c_sigma, float delta, float sqrt_delta, float noise_scale,
                     float a2, float b2, float clip, unsigned long long seed, void* stream) {
  if (n < 1 || start_step < 0 || stop_step <= start_step || stop_step > num_steps || xdim < 1 ||
      xdim > G_MAX_XDIM || ydim < 1 || ydim > G_MAX_YDIM || (pgdm && xdim != 3))
    return (int)cudaErrorInvalidValue;
  GuidedArgs p;
  if (!unpack_mlp(p.prior, prior_ptrs, prior_mid, prior_width, true) ||
      !unpack_mlp(p.surr, surr_ptrs, surr_mid, surr_width, false))
    return (int)cudaErrorInvalidValue;
  p.x0 = x0; p.y = y; p.noise = noise; p.out = out; p.scratch = scratch;
  p.n = n; p.xdim = xdim; p.ydim = ydim;
  p.num_steps = num_steps; p.start_step = start_step; p.stop_step = stop_step;
  p.pgdm = pgdm; p.has_clip = has_clip;
  p.T = T; p.beta_min = beta_min; p.bd = bd; p.c_drift = c_drift; p.c_sigma = c_sigma;
  p.delta = delta; p.sqrt_delta = sqrt_delta; p.noise_scale = noise_scale;
  p.a2 = a2; p.b2 = b2; p.clip = clip; p.seed = seed;
  const int act_rows = (prior_width > surr_width ? prior_width : surr_width) > G_MAX_YDIM
                           ? (prior_width > surr_width ? prior_width : surr_width)
                           : G_MAX_YDIM;
  const size_t smem = sizeof(float) * ((size_t)act_rows * G_ROWS + 2 * G_MAX_XDIM * G_ROWS +
                                       4 * G_MAX_YDIM * G_ROWS + 2 * G_MAX_XDIM * G_ROWS + G_MAX_YDIM) +
                      (size_t)(1 + surr_mid) * surr_width * (G_ROWS / 8);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(guided_em_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  guided_em_kernel<<<(n + G_ROWS - 1) / G_ROWS, G_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
