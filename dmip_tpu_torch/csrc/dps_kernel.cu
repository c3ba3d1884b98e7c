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
// Design.  A block owns 64 rows for all steps, 256 threads (8 warps), one
// block per SM.  30000 rows are 469 such blocks, 3.55 waves on 132 SMs, so
// the rows left after the whole waves go to 48-row blocks when one wave of
// them holds them all (97 blocks for 30000 rows): the last wave ends sooner.
// The activations live K-major in one 64 x 512 f32 shared buffer
// ([unit][row], 128 KB) that every layer reads and then overwrites: each
// product keeps its results in registers until all threads have read the
// layer's input.  The products are register-tiled SIMT GEMMs: a thread
// holds RT = N / 32 rows x 8 columns (16 x 8 at N = 512; 3/4 of that in a
// 48-row block), a warp 4 RT rows x 64 columns, so per k a thread reads RT
// activations (each float4 shared by 8 lanes) and two float4s of the weight
// row (128 contiguous bytes a warp): 96 bytes of shared memory for 128 FMAs
// at N = 512.  (With 8 x 8 a thread and 512 threads, shared memory's 128
// bytes a clock per SM are as busy as the 128 FMA lanes; that block was
// slower.)  The weights (~2.6 MB of f32 with their transposes) do not
// fit in shared memory, so every product streams its weight rows through a
// ring of 16 KB stages in shared memory (3 stages where they fit, else 2),
// filled by 16-byte cp.async copies that all threads issue two stages ahead
// of the FMAs, one barrier a stage: each weight byte is read from L2 once
// per block and product, and no global load latency sits in the FMA loop.
//
// The working set does not fit beside the activations: a 512-wide tanh
// layer alone is 128 KB for 64 rows.  So (a) each step runs one backward
// pass per net (the dps cotangents are folded, pgdm's tangents run one after
// another through the same buffer), (b) the ReLU masks are kept as bits in
// shared memory, and (c) the prior's tanh derivatives 1 - h^2 go to a
// per-block scratch slab in global memory (132 x 3 x 512 x 64 x 4 B ~ 52 MB
// in flight), written by the forward products' epilogues and read back once
// by the VJP in the same step.  Recomputing layer 0's derivative from the
// state instead (a 2-layer slab, ~35 MB) was measured no faster.  The VJP
// applies the derivatives in elementwise passes over the buffer, not in the
// products' epilogues: with the accumulators gone a pass keeps many slab
// loads in flight, where an epilogue issued them one at a time.  The narrow
// products (an output of xdim or ydim units) stage their weights in the
// ring, split K over the warps (a thread two rows), and add the partial
// sums in slice order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define G_ROWS 64       // rows of a block
#define G_TAIL_ROWS 48  // rows of a block in the last wave
#define G_THREADS 256
#define G_WARPS (G_THREADS / 32)
#define G_MAX_MID 4
#define G_MAX_XDIM 4
#define G_MAX_YDIM 32
#define G_STAGE 4096  // floats in one ring stage (16 KB): BK = G_STAGE / N weight rows of a product
#define G_SMEM_MAX 232448
#define G_PHASES 7   // prior forward, prior output, surrogate forward, guidance, surrogate VJP, prior VJP, update

struct Mlp {
  // first layer (xdim -> W), its bias, and (for the prior) the time column
  const float* w1;    // (xdim, W)
  const float* w1t;   // prior: (W,) time row; surrogate: null
  const float* b1;    // (W,)
  const float* w1T;   // (W, 4): the transpose, rows zero-padded to 4
  const float* w[G_MAX_MID];   // (W, W)
  const float* b[G_MAX_MID];   // (W,)
  const float* wT[G_MAX_MID];  // (W, W) transposed
  const float* wo;    // (W, ldo): rows zero-padded to ldo = out rounded up to a multiple of 4
  const float* bo;    // (out,)
  const float* woT;   // (out, W)
  int n_mid, width, ldo;
};

struct GuidedArgs {
  const float* x0;     // (n, xdim)
  const float* y;      // (ydim,)
  Mlp prior, surr;
  const float* noise;  // (stop_step - start_step, n, xdim) or null
  float* out;          // (n, xdim)
  float* scratch;      // per row: (1 + prior.n_mid) x prior.width floats
  long long* stamps;   // null, or 1 + G_PHASES x (stop_step - start_step) (%globaltimer, clock64) pairs
  int n, xdim, ydim, num_steps, start_step, stop_step, pgdm, has_clip;  // runs steps [start, stop) of num_steps
  int stages;          // ring stages, 2 or 3
  int ks_x, ks_y;      // K slices of the narrow products with xdim and ydim outputs
  int full_blocks;     // blocks of 64 rows; the others have 48
  float T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale, a2, b2, clip;
  unsigned long long seed;
  const unsigned long long* seed_ptr;  // null, or the seed on the device, read in place of `seed`
};

// ---- copies and row access ------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Weight rows [k0, k1) of a row-major (K, N) matrix into one ring stage.
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ W, int N, int k0, int k1) {
  const int n4 = (k1 - k0) * N / 4;
  const float* src = W + (size_t)k0 * N;
  for (int i = threadIdx.x; i < n4; i += G_THREADS) cp_async16(stage + 4 * i, src + 4 * i);
}

// RG <= 4 consecutive floats (RG rows of one unit), aligned to 4 RG bytes.
template <int RG>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RG]) {
  if constexpr (RG == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (RG == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int RG>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[RG]) {
  if constexpr (RG == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (RG == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// ---- the products -----------------------------------------------------------


// A thread's share of a product with N output columns in a block of R
// rows: RT = R N / (8 G_THREADS) rows in Q groups of RG <= 4 consecutive
// rows, 4 RG rows apart (so the 4 row groups of a warp's lanes read 16 RG
// contiguous bytes), x 8 columns.  `ok`: the tiles cover the block (not so
// for N = 64 in a 48-row block).
template <int N, int R>
struct Tile {
  static constexpr int WC = N / 64;                      // warps across the columns
  static constexpr int RT = R * N / (8 * G_THREADS);     // rows per thread
  static constexpr int RG = RT % 4 == 0 ? 4 : RT % 2 == 0 ? 2 : 1, Q = RT / RG;
  static constexpr bool ok = RT >= 1 && (G_WARPS / WC) * 4 * RT == R;
};

// acc[i][j] += a[i] w[j] for one k: the thread's RT activations and the 8
// weights of its columns (two float4s 32 columns apart).
template <int N, int R>
__device__ __forceinline__ void fma_k(float (&acc)[Tile<N, R>::RT][8], const float* a, const float* w) {
  using T = Tile<N, R>;
  float av[T::RT];
#pragma unroll
  for (int q = 0; q < T::Q; ++q) {
    float g[T::RG];
    load_rows<T::RG>(a + q * 4 * T::RG, g);
#pragma unroll
    for (int i = 0; i < T::RG; ++i) av[q * T::RG + i] = g[i];
  }
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 32);
  const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < T::RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// act[k][r] (k < K) -> act[n][r] (n < N) = epi(sum_k act[k][r] W[k][n]), in
// place, with W (K, N) row-major in global memory streamed through the
// ring.  Each sum is one fmaf chain over k = 0, 1, ... from 0.  epi(c, r, v)
// rewrites the RG values v of column c, rows r..r+RG-1.
template <int N, int R, class Epi>
__device__ __noinline__ void gemm_km(float* act, int K, const float* __restrict__ W, float* ring, int stages, Epi epi) {
  using T = Tile<N, R>;
  static_assert(T::ok, "tiles do not cover the block's rows");
  constexpr int BK = G_STAGE / N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / T::WC) * 4 * T::RT + (lane >> 3) * T::RG;
  const int c0 = (warp % T::WC) * 64 + (lane & 7) * 4;
  float acc[T::RT][8];
#pragma unroll
  for (int i = 0; i < T::RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int tiles = (K + BK - 1) / BK;
  for (int t = 0; t < stages - 1; ++t) {
    if (t < tiles) load_stage(ring + t * G_STAGE, W, N, t * BK, min(K, (t + 1) * BK));
    cp_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    if (stages == 3) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();  // stage t has landed for every thread, and stage t - 1 is read
    const int tn = t + stages - 1;
    if (tn < tiles) load_stage(ring + (tn % stages) * G_STAGE, W, N, tn * BK, min(K, (tn + 1) * BK));
    cp_commit();
    const float* ws = ring + (t % stages) * G_STAGE + c0;
    const float* as = act + (size_t)t * BK * R + r0;
    const int kn = min(BK, K - t * BK);
    if (kn == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) fma_k<N, R>(acc, as + kk * R, ws + kk * N);
    } else {
      for (int kk = 0; kk < kn; ++kk) fma_k<N, R>(acc, as + kk * R, ws + kk * N);
    }
  }
  __syncthreads();  // every thread has read the input and the ring
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + (j < 4 ? j : 28 + j);
#pragma unroll
    for (int q = 0; q < T::Q; ++q) {
      float v[T::RG];
#pragma unroll
      for (int i = 0; i < T::RG; ++i) v[i] = acc[q * T::RG + i][j];
      const int r = r0 + q * 4 * T::RG;
      epi(c, r, v);
      store_rows<T::RG>(act + c * R + r, v);
    }
  }
  __syncthreads();
}

template <int R, class Epi>
__device__ __forceinline__ void gemm(int width, float* act, int K, const float* W, float* ring, int stages, Epi epi) {
  switch (width) {
    case 512: gemm_km<512, R>(act, K, W, ring, stages, epi); break;
    case 256: gemm_km<256, R>(act, K, W, ring, stages, epi); break;
    case 128: gemm_km<128, R>(act, K, W, ring, stages, epi); break;
    default:
      if constexpr (Tile<64, R>::ok) gemm_km<64, R>(act, K, W, ring, stages, epi);
      break;
  }
}

// out[o][r] = sum_k act[k][r] W[k][o] (+ bias[o]) for a narrow output
// (n_out <= NO), W (K, ldw) row-major with rows zero-padded to ldw, a
// multiple of 4, in a block of R rows.  K is split over ks slices, one warp
// each, a thread the rows lane and lane + 32 (if < R); once every thread
// has read act, the partial sums go to `part` (ks x n_out x R floats, over
// act and the ring) and are added in slice order.
template <int NO, int R>
__device__ __noinline__ void narrow(const float* act, int K, const float* __restrict__ W, int ldw, int n_out,
                                    const float* __restrict__ bias, float* out, float* part, int ks, float* ring,
                                    int stages) {
  const int slice = threadIdx.x >> 5, r = threadIdx.x & 31;
  const bool on = slice < ks, two = r + 32 < R;
  // W into the ring when it fits (a shared-memory broadcast in the loop), else read where it is
  const bool staged = K * ldw <= stages * G_STAGE;
  if (staged) {
    for (int i = threadIdx.x; i < K * ldw / 4; i += G_THREADS) cp_async16(ring + 4 * i, W + 4 * i);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  const float* ws = staged ? ring : W;
  float acc[2][NO];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[h][o] = 0.f;
  if (on) {
    const int kl = K / ks, k0 = slice * kl;
#pragma unroll 4
    for (int k = k0; k < k0 + kl; ++k) {
      const float a0 = act[k * R + r], a1 = act[k * R + r + 32];  // a1 is unused unless two
      const float4* wr = reinterpret_cast<const float4*>(ws + (size_t)k * ldw);
#pragma unroll
      for (int q = 0; q < NO / 4; ++q) {
        if (4 * q < n_out) {
          const float4 w = wr[q];
          const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * q + e] = fmaf(a0, wq[e], acc[0][4 * q + e]);
            acc[1][4 * q + e] = fmaf(a1, wq[e], acc[1][4 * q + e]);
          }
        }
      }
    }
  }
  __syncthreads();  // part overlaps act
  if (on) {
#pragma unroll
    for (int o = 0; o < NO; ++o)
      if (o < n_out) {
        part[(slice * n_out + o) * R + r] = acc[0][o];
        if (two) part[(slice * n_out + o) * R + r + 32] = acc[1][o];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_out * R; i += G_THREADS) {
    float s = part[i];
    for (int j = 1; j < ks; ++j) s += part[j * n_out * R + i];
    out[i] = bias != nullptr ? s + __ldg(bias + i / R) : s;
  }
  __syncthreads();
}

// K slices of a narrow product (a power of 2 dividing every width), so that
// its partial sums for 64 rows fit in `room` floats (act and the ring: the
// weights are read from the ring before the partial sums go there).
__host__ __device__ __forceinline__ int narrow_slices(int n_out, int room) {
  int ks = G_WARPS;
  while (ks > 1 && ks * n_out * G_ROWS > room) ks >>= 1;
  return ks;
}

// ---- epilogues ------------------------------------------------------------

// tanh's pre-activation and derivative, rounded step by step (no FMA
// contraction), as the plain version's separate operations are.
__device__ __forceinline__ float tanh_pre(float acc, float tc, float bc) { return __fadd_rn(__fadd_rn(acc, tc), bc); }
__device__ __forceinline__ float dtanh(float h) { return __fsub_rn(1.f, __fmul_rn(h, h)); }

struct EpiTanh {  // prior forward: h = tanh((acc + s w1t) + b) (wt null: no time column); 1 - h^2 to dfac
  const float* wt; const float* b; float s; float* dfac; int ld;  // dfac[unit][ld rows]
  template <int RG>
  __device__ void operator()(int c, int r0, float (&v)[RG]) const {
    const float bc = __ldg(b + c), tc = wt != nullptr ? __fmul_rn(s, __ldg(wt + c)) : 0.f;
    float d[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      v[i] = tanhf(tanh_pre(v[i], tc, bc));
      d[i] = dtanh(v[i]);
    }
    store_rows<RG>(dfac + c * ld + r0, d);
  }
};

struct EpiNone {  // the raw sums; an elementwise pass follows
  template <int RG>
  __device__ void operator()(int, int, float (&)[RG]) const {}
};

// ReLU masks: 64 bits a unit, two 32-bit words [unit][row / 32], zeroed
// before the surrogate forward.
struct EpiRelu {  // surrogate forward: g = max(acc + b, 0); OR the bits g > 0 into the mask
  const float* b; uint32_t* mask;
  template <int RG>
  __device__ void operator()(int c, int r0, float (&v)[RG]) const {
    const float bc = __ldg(b + c);
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      v[i] = fmaxf(v[i] + bc, 0.f);
      bits |= (v[i] > 0.f ? 1u : 0u) << i;
    }
    if (bits != 0u) atomicOr(mask + c * 2 + (r0 >> 5), bits << (r0 & 31));
  }
};

struct EpiMask {  // ReLU backward / tangent: acc where the unit was active, else 0
  const uint32_t* mask;
  template <int RG>
  __device__ void operator()(int c, int r0, float (&v)[RG]) const {
    const uint32_t bits = mask[c * 2 + (r0 >> 5)] >> (r0 & 31);
#pragma unroll
    for (int i = 0; i < RG; ++i) v[i] = ((bits >> i) & 1u) ? v[i] : 0.f;
  }
};

// ---- an elementwise pass over a prior VJP product's output ---------------
// act[c][r] (c < N), four rows a float4, consecutive threads on consecutive
// float4s: coalesced, conflict-free, and with the accumulators gone, free
// to keep several global loads in flight.

// backward through a hidden layer: acc * (1 - h^2) from the slab
template <int R>
__device__ __noinline__ void dfac_pass(float* act, int N, const float* __restrict__ dfac) {
  float4* a4 = reinterpret_cast<float4*>(act);
  const float4* d4 = reinterpret_cast<const float4*>(dfac);
#pragma unroll 8
  for (int i = threadIdx.x; i < N * (R / 4); i += G_THREADS) {
    const float4 d = __ldcg(d4 + i);
    float4 v = a4[i];
    v.x *= d.x; v.y *= d.y; v.z *= d.z; v.w *= d.w;
    a4[i] = v;
  }
  __syncthreads();
}

// With stamps, block 0 reads the card's clock (ns) and its SM's cycle
// count when a phase ends.
__device__ __forceinline__ void stamp(long long* stamps, long long i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[2 * i] = t;
    stamps[2 * i + 1] = clock64();
  }
}

// u (xdim rows of act) -> out[d][r] = ((ds_p/dx)^T u)[d], the prior net's VJP.
template <int R>
__device__ __forceinline__ void prior_vjp(const GuidedArgs& p, float* act, const float* slab, float* ring,
                                          float* out) {
  const Mlp& m = p.prior;
  const size_t layer = (size_t)m.width * R;
  gemm<R>(m.width, act, p.xdim, m.woT, ring, p.stages, EpiNone{});
  for (int l = m.n_mid - 1; l >= 0; --l) {
    dfac_pass<R>(act, m.width, slab + (l + 1) * layer);
    gemm<R>(m.width, act, m.width, m.wT[l], ring, p.stages, EpiNone{});
  }
  dfac_pass<R>(act, m.width, slab);
  narrow<G_MAX_XDIM, R>(act, m.width, m.w1T, 4, p.xdim, nullptr, out, act, p.ks_x, ring, p.stages);
}

// Every step for the R rows from row0 of one block.  The shared buffers are
// laid out for 64 rows, and used with a row stride of R.
template <int R>
__device__ __forceinline__ void run_rows(const GuidedArgs& p, unsigned char* smem, int row0) {
  const int tid = threadIdx.x;
  const int xdim = p.xdim, ydim = p.ydim;
  const Mlp& P = p.prior;
  const Mlp& Su = p.surr;
  const int act_rows = max(P.width, Su.width);
  float* act = reinterpret_cast<float*>(smem);   // [act_rows][R]
  float* ring = act + act_rows * G_ROWS;          // [stages][G_STAGE] weight stages, or narrow partial sums
  float* xs = ring + p.stages * G_STAGE;          // [xdim][64] the state
  float* sp = xs + G_MAX_XDIM * G_ROWS;           // [xdim][64] prior score
  float* vj = sp + G_MAX_XDIM * G_ROWS;           // [xdim][64] q, the surrogate VJP
  float* vh = vj + G_MAX_XDIM * G_ROWS;           // [xdim][64] the prior VJP of q
  float* fz = vh + G_MAX_XDIM * G_ROWS;           // [ydim][64] surrogate output
  float* jac = fz + G_MAX_YDIM * G_ROWS;          // [3][ydim][64] pgdm Jacobian
  float* ys = jac + 3 * G_MAX_YDIM * G_ROWS;      // [ydim]
  uint32_t* masks = reinterpret_cast<uint32_t*>(ys + G_MAX_YDIM);  // [1 + n_mid][width][2]
  const int mask_layer = Su.width * 2;
  const int mask_words = (1 + Su.n_mid) * mask_layer;
  const size_t slab_layer = (size_t)P.width * R;
  float* slab = p.scratch + (size_t)row0 * (P.n_mid + 1) * P.width;
  const unsigned long long seed = p.seed_ptr != nullptr ? __ldg(p.seed_ptr) : p.seed;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));

  if (tid < ydim) ys[tid] = p.y[tid];
  for (int i = tid; i < xdim * R; i += G_THREADS) {
    const int d = i / R, r = i - d * R, row = row0 + r;
    xs[i] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  __syncthreads();
  stamp(p.stamps, 0);

  for (int step = p.start_step; step < p.stop_step; ++step) {
    const long long st = 1 + (long long)(step - p.start_step) * G_PHASES;
    const float tt = ((float)step / (float)p.num_steps) * p.T;
    const float s = p.T - tt;
    const float beta = p.beta_min + p.bd * s;
    const float g = sqrtf(beta);
    const float int_beta = 0.5f * p.bd * s * s + p.beta_min * s;
    const float alpha = expf(-0.5f * int_beta);
    const float sig2 = 1.f - expf(-int_beta);

    // prior forward, keeping 1 - h^2 of every hidden layer in the slab
    for (int i = tid; i < xdim * R; i += G_THREADS) act[i] = xs[i];
    __syncthreads();
    gemm<R>(P.width, act, xdim, P.w1, ring, p.stages, EpiTanh{P.w1t, P.b1, s, slab, R});
    for (int l = 0; l < P.n_mid; ++l)
      gemm<R>(P.width, act, P.width, P.w[l], ring, p.stages,
              EpiTanh{nullptr, P.b[l], 0.f, slab + (l + 1) * slab_layer, R});
    stamp(p.stamps, st);
    narrow<G_MAX_XDIM, R>(act, P.width, P.wo, P.ldo, xdim, P.bo, sp, act, p.ks_x, ring, p.stages);
    stamp(p.stamps, st + 1);

    // Tweedie estimate, then the surrogate forward with its ReLU masks
    for (int i = tid; i < xdim * R; i += G_THREADS) act[i] = (xs[i] + sig2 * sp[i]) / alpha;
    for (int i = tid; i < mask_words; i += G_THREADS) masks[i] = 0u;
    __syncthreads();
    gemm<R>(Su.width, act, xdim, Su.w1, ring, p.stages, EpiRelu{Su.b1, masks});
    for (int l = 0; l < Su.n_mid; ++l)
      gemm<R>(Su.width, act, Su.width, Su.w[l], ring, p.stages, EpiRelu{Su.b[l], masks + (l + 1) * mask_layer});
    narrow<G_MAX_YDIM, R>(act, Su.width, Su.wo, Su.ldo, ydim, Su.bo, fz, act, p.ks_y, ring, p.stages);
    stamp(p.stamps, st + 2);

    if (!p.pgdm) {
      for (int i = tid; i < ydim * R; i += G_THREADS) {
        const float f = fz[i], resid = ys[i / R] - f;
        const float pinv = 1.f / ((p.a2 * f) * f + p.b2);
        act[i] = (-p.a2 * (f * pinv) + resid * pinv) + p.a2 * (((resid * resid) * f) * (pinv * pinv));
      }
      __syncthreads();
      stamp(p.stamps, st + 3);
      gemm<R>(Su.width, act, ydim, Su.woT, ring, p.stages, EpiMask{masks + Su.n_mid * mask_layer});
      for (int l = Su.n_mid - 1; l >= 0; --l)
        gemm<R>(Su.width, act, Su.width, Su.wT[l], ring, p.stages, EpiMask{masks + l * mask_layer});
      narrow<G_MAX_XDIM, R>(act, Su.width, Su.w1T, 4, xdim, nullptr, vj, act, p.ks_x, ring, p.stages);
      for (int i = tid; i < xdim * R; i += G_THREADS) act[i] = vj[i];
      __syncthreads();
      stamp(p.stamps, st + 4);
    } else {
      // Jacobian rows k: tangent m1 * U1[k] through the ReLU chain
      for (int k = 0; k < 3; ++k) {
        for (int i = tid; i < Su.width * R; i += G_THREADS) {
          const int c = i / R, r = i - c * R;
          act[i] = ((masks[c * 2 + (r >> 5)] >> (r & 31)) & 1u) ? __ldg(Su.w1 + k * Su.width + c) : 0.f;
        }
        __syncthreads();
        for (int l = 0; l < Su.n_mid; ++l)
          gemm<R>(Su.width, act, Su.width, Su.w[l], ring, p.stages, EpiMask{masks + (l + 1) * mask_layer});
        narrow<G_MAX_YDIM, R>(act, Su.width, Su.wo, Su.ldo, ydim, nullptr, jac + k * G_MAX_YDIM * R, act,
                           p.ks_y, ring, p.stages);
      }
      if (tid < R) {
        const int r = tid;
        const float r2 = sig2 / (alpha * alpha + sig2);
        const float* j0 = jac + r;
        const float* j1 = jac + G_MAX_YDIM * R + r;
        const float* j2 = jac + 2 * G_MAX_YDIM * R + r;
        float w[3] = {0.f, 0.f, 0.f};
        float sm[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        for (int o = 0; o < ydim; ++o) {
          const float f = fz[o * R + r];
          const float dinv = 1.f / ((p.a2 * f) * f + p.b2);
          const float dr = dinv * (ys[o] - f);
          const float jk[3] = {j0[o * R], j1[o * R], j2[o * R]};
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
          const float f = fz[o * R + r];
          const float dinv = 1.f / ((p.a2 * f) * f + p.b2);
          const float dr = dinv * (ys[o] - f);
          const float jk[3] = {j0[o * R], j1[o * R], j2[o * R]};
          const float u = dr - r2 * (dinv * (z0 * jk[0] + z1 * jk[1] + z2 * jk[2]));
#pragma unroll
          for (int k = 0; k < 3; ++k) q[k] += jk[k] * u;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          vj[k * R + r] = q[k];
          act[k * R + r] = q[k];
        }
      }
      __syncthreads();
      stamp(p.stamps, st + 3);  // pgdm forms q = J^T u in the solve: no surrogate VJP phase
      stamp(p.stamps, st + 4);
    }
    prior_vjp<R>(p, act, slab, ring, vh);
    stamp(p.stamps, st + 5);

    // guidance, its norm cap, and the Euler-Maruyama update: one thread per row
    if (tid < R) {
      const int r = tid, row = row0 + r;
      float sl[G_MAX_XDIM];
      for (int d = 0; d < xdim; ++d) sl[d] = (vj[d * R + r] + sig2 * vh[d * R + r]) / alpha;
      if (p.has_clip) {
        float ss = 0.f;
        for (int d = 0; d < xdim; ++d) ss += sl[d] * sl[d];
        const float scale = fminf(1.f, p.clip / (sqrtf(ss) + 1e-12f));
        for (int d = 0; d < xdim; ++d) sl[d] = sl[d] * scale;
      }
      for (int d = 0; d < xdim; ++d) {
        const int i = d * R + r;
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
    stamp(p.stamps, st + 6);
  }

  for (int i = tid; i < xdim * R; i += G_THREADS) {
    const int d = i / R, r = i - d * R, row = row0 + r;
    if (row < p.n) p.out[(size_t)row * xdim + d] = xs[i];
  }
}

// Whole waves of 64-row blocks, then (p.full_blocks onward) 48-row blocks:
// the last wave's rows spread over more SMs.
__global__ void __launch_bounds__(G_THREADS, 1) guided_em_kernel(const GuidedArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < p.full_blocks)
    run_rows<G_ROWS>(p, smem, blockIdx.x * G_ROWS);
  else
    run_rows<G_TAIL_ROWS>(p, smem, p.full_blocks * G_ROWS + (blockIdx.x - p.full_blocks) * G_TAIL_ROWS);
}

// Host side: unpack the pointer list of one net (see ops/dps_kernel.py ::
// _device_nets): first layer [w1, (w1t,) b1, w1T], then (w, b, wT) per
// hidden-to-hidden layer, then [wo, bo, woT].
static bool unpack_mlp(Mlp& m, const unsigned long long* ptrs, int n_mid, int width, int n_out, bool has_time) {
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
  m.ldo = (n_out + 3) / 4 * 4;
  return true;
}

// Dynamic shared memory with `stages` ring stages.
static size_t smem_bytes(int act_rows, int stages, int surr_mid, int surr_width) {
  return sizeof(float) * ((size_t)act_rows * G_ROWS + (size_t)stages * G_STAGE + 4 * G_MAX_XDIM * G_ROWS +
                          4 * G_MAX_YDIM * G_ROWS + G_MAX_YDIM) +
         sizeof(uint32_t) * (size_t)(1 + surr_mid) * surr_width * 2;
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }


// Launch on `stream`; returns a cudaError_t.  scratch holds
// (n + 64) x (1 + prior_mid) x prior_width floats.  seed_ptr: null, or the
// address of the seed on the device, which the kernel reads in place of
// `seed`.
int guided_em_launch(const float* x0, const float* y, const unsigned long long* prior_ptrs, int prior_mid,
                     int prior_width, const unsigned long long* surr_ptrs, int surr_mid, int surr_width,
                     const float* noise, float* out, float* scratch, long long* stamps, int n, int xdim, int ydim,
                     int num_steps, int start_step, int stop_step, int pgdm, int has_clip, float T,
                     float beta_min, float bd,
                     float c_drift, float c_sigma, float delta, float sqrt_delta, float noise_scale,
                     float a2, float b2, float clip, unsigned long long seed,
                     const unsigned long long* seed_ptr, void* stream) {
  if (n < 1 || start_step < 0 || stop_step <= start_step || stop_step > num_steps || xdim < 1 ||
      xdim > G_MAX_XDIM || ydim < 1 || ydim > G_MAX_YDIM || (pgdm && xdim != 3))
    return (int)cudaErrorInvalidValue;
  GuidedArgs p;
  if (!unpack_mlp(p.prior, prior_ptrs, prior_mid, prior_width, xdim, true) ||
      !unpack_mlp(p.surr, surr_ptrs, surr_mid, surr_width, ydim, false))
    return (int)cudaErrorInvalidValue;
  p.x0 = x0; p.y = y; p.noise = noise; p.out = out; p.scratch = scratch; p.stamps = stamps;
  p.n = n; p.xdim = xdim; p.ydim = ydim;
  p.num_steps = num_steps; p.start_step = start_step; p.stop_step = stop_step;
  p.pgdm = pgdm; p.has_clip = has_clip;
  p.T = T; p.beta_min = beta_min; p.bd = bd; p.c_drift = c_drift; p.c_sigma = c_sigma;
  p.delta = delta; p.sqrt_delta = sqrt_delta; p.noise_scale = noise_scale;
  p.a2 = a2; p.b2 = b2; p.clip = clip; p.seed = seed; p.seed_ptr = seed_ptr;
  const int act_rows = prior_width > surr_width ? prior_width : surr_width;
  p.stages = smem_bytes(act_rows, 3, surr_mid, surr_width) <= G_SMEM_MAX ? 3 : 2;
  const size_t smem = smem_bytes(act_rows, p.stages, surr_mid, surr_width);
  const int room = act_rows * G_ROWS + p.stages * G_STAGE;  // act and the ring are adjacent
  p.ks_x = narrow_slices(xdim, room);
  p.ks_y = narrow_slices(ydim, room);
  if (smem > G_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(guided_em_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // Whole waves of 64-row blocks; the rows left for the last wave go to
  // 48-row blocks when they fit one wave of them (both nets >= 128 wide).
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  const int blocks = (n + G_ROWS - 1) / G_ROWS, whole = blocks / sms * sms, rest = n - whole * G_ROWS;
  int tail = 0;
  p.full_blocks = blocks;
  if (prior_width >= 128 && surr_width >= 128 && rest > 0 && rest <= G_TAIL_ROWS * sms) {
    p.full_blocks = whole;
    tail = (rest + G_TAIL_ROWS - 1) / G_TAIL_ROWS;
  }
  guided_em_kernel<<<p.full_blocks + tail, G_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
