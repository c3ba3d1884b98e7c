// Fused Metropolis chains on the scatterometry posterior energy.
//
// Replaces the Pallas TPU kernel dmip_tpu/ops/mh_kernel.py ::
// fused_mh_scatterometry (_mh_kernel, pallas_call at :154).  N independent
// chains each take num_steps Metropolis steps in one launch:
//   x' = x + noise_std xi,  f = surrogate(x')  (3 -> 256 -> 256 -> 256 -> 23, ReLU)
//   e' = 1/2 sum log((a f)^2 + b^2) + 1/2 sum (y - f)^2 / ((a f)^2 + b^2)
//        + lambd_bd sum relu(x' - 1) + relu(-1 - x')
//   accept iff u < exp(e - e'), branchless, with the current energy carried.
// exp() overflowing to inf accepts and a NaN energy rejects, as in the TPU
// kernel.  xi and u come from an in-kernel Philox4x32-10 keyed by
// (seed, chain, step).
//
// What bounds it on an H100: the two 256x256 hidden products, 131 of the
// 137.5 kMAC of a chain-step (95%).  In f32 FMA a 300k x 1000 launch is
// 82.7 TFLOP, 1234.6 ms at the 67 TFLOP/s non-tensor f32 peak.  Plain TF32
// (10 mantissa bits) is not accurate enough: the 1/((a f)^2 + b^2) term
// with b = 0.01 amplifies product error.  Split TF32 is: each operand is
// split into hi = tf32(x) and lo = x - hi, and a_lo w_hi + a_hi w_lo +
// a_hi w_hi keeps the energies as close to float64 as f32 FMA does
// (PERF.md, the CPU study of ops/split_tf32_study.py), provided the long
// sum over K is not left to the tensor core, which truncates as it
// accumulates (a k-step's products go to a fresh tile, then one FADD).
// Three TF32 products of 82.7 TFLOP each bound the launch at ~500 ms at the
// 495 TFLOP/s dense TF32 peak; mma.sync issued from registers, with the
// splits and the FADDs beside it, takes ~7.5 cycles an mma per scheduler,
// and the hidden products hold ~80% of the step (PERF.md).
//
// Design.  A block owns 64 chains and keeps their state and activations in
// shared memory for all steps.  Activations are stored K-major
// ([unit][chain], a row of 72 floats: 64 chains and 8 of padding, so the
// mma A-fragment loads of a warp hit 32 distinct banks).  Each hidden
// product runs on the tensor cores, mma.sync m16n8k8 TF32 with f32
// accumulators: each of 8 warps owns 32 output units for all 64 chains
// (4 x 4 tiles, 64 accumulators a thread) and walks K in 8-deep steps.
// The weights do not fit in shared memory (2 x 256 KB); the wrapper lays
// them out once in B-fragment order, so a warp reads a k-step's fragments
// for two n-tiles as one coalesced 16-byte load a lane from L2, one k-step
// ahead, and splits them in registers: one f32 copy crosses L2, not a hi
// and a lo copy.  The activations are split when the A fragments load.
// Results wait in registers until every warp has read the layer's input,
// then bias and ReLU write them over it, so one activation buffer suffices
// and two blocks fit on an SM.  The first layer (K = 3), the output layer
// (23 wide), the energy and the accept step are f32 SIMT.  The output
// layer's weights live in shared memory: read through L1 they were
// evicted every step by the hidden weights streaming past, and each read
// went to L2.  Each thread forms G = 6 outputs of one chain (8 past 24; 4
// groups cover ydim), with their log and residual terms, so the energy's
// 23 logs and divisions a chain are spread over 256 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32.cuh"

#define MH_ROWS 64
#define MH_THREADS 256
#define MH_H 256
#define MH_XD 3
#define MH_XDP 4
#define MH_AS 72      // activation row stride: 64 chains + 8 floats of padding
#define MH_YD_MAX 32
#define MH_PHASES 7  // proposal, layer 0, hidden 1, hidden 2, output layer, energy, accept

struct MhArgs {
  const float* x0;        // (n, 3)
  const float* y;         // (ydim,)
  const float* w0;        // (3, 256)
  const float* b0;        // (256,)
  const float4* w1;       // (256, 256) in B-fragment order (ops/mh_kernel.py pack_tf32_b)
  const float* b1;
  const float4* w2;       // (256, 256), the same
  const float* b2;
  const float* w3;        // (256, ydim)
  const float* b3;        // (ydim,)
  const float* noise;     // (num_steps, n, 3) or null: caller-given normals
  const float* uniforms;  // (num_steps, n) or null: caller-given uniforms
  float* out;             // (n, 3)
  float* energy_out;      // (n,) or null: each chain's carried energy at the end
  long long* stamps;      // null, or 1 + MH_PHASES x num_steps (%globaltimer, clock64) pairs
  int n, ydim, num_steps;
  float noise_std, a, bb, lambd_bd;
  unsigned long long seed;
};

struct MhShared {
  float act[MH_H * MH_AS];        // [unit][chain], rows padded to MH_AS
  float2 part[4][MH_ROWS];        // the energy's partial sums (log, residual) per output group
  float x[MH_ROWS * MH_XDP];      // current states
  float xp[MH_ROWS * MH_XDP];     // proposals
  float e[MH_ROWS], ep[MH_ROWS], u[MH_ROWS];
  float4 l0[MH_H];                // layer 0 per unit: (W0[0][c], W0[1][c], W0[2][c], b0[c])
  float b1[MH_H], b2[MH_H];
  float y[MH_YD_MAX], b3[MH_YD_MAX];
};

static_assert(sizeof(MhShared) % 16 == 0, "w3s follows MhShared and is read in aligned vectors");

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

// act <- relu(act . W + b) for a 256x256 W, in place (see the note above).
// wp is W in B-fragment order: [n-tile pair][k-step][lane] float4 =
// (W[8 ks + t][16 np + g], W[8 ks + t + 4][16 np + g], the same at column
// 16 np + 8 + g), lane = 4 g + t.  Warp w owns n-tile pairs 2w and 2w + 1.
__device__ __forceinline__ void hidden_layer(float* act, const float4* __restrict__ wp, const float* bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
  const float4* wq = wp + (size_t)(2 * warp) * (32 * 32) + lane;
  float4 c0 = __ldg(wq), c1 = __ldg(wq + 32 * 32);
  const float* arow = act + t * MH_AS + g;
#pragma unroll 1
  for (int ks = 0; ks < 32; ++ks) {
    const int kn = (ks + 1) & 31;  // the next k-step (the last one reloads step 0, unused)
    const float4 n0 = __ldg(wq + kn * 32), n1 = __ldg(wq + 32 * 32 + kn * 32);
    uint32_t bh[4][2], bl[4][2];
    split_tf32(c0.x, bh[0][0], bl[0][0]);
    split_tf32(c0.y, bh[0][1], bl[0][1]);
    split_tf32(c0.z, bh[1][0], bl[1][0]);
    split_tf32(c0.w, bh[1][1], bl[1][1]);
    split_tf32(c1.x, bh[2][0], bl[2][0]);
    split_tf32(c1.y, bh[2][1], bl[2][1]);
    split_tf32(c1.z, bh[3][0], bl[3][0]);
    split_tf32(c1.w, bh[3][1], bl[3][1]);
    const float* ak = arow + ks * 8 * MH_AS;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t ah[4], al[4];
      split_tf32(ak[16 * m], ah[0], al[0]);
      split_tf32(ak[16 * m + 8], ah[1], al[1]);
      split_tf32(ak[4 * MH_AS + 16 * m], ah[2], al[2]);
      split_tf32(ak[4 * MH_AS + 16 * m + 8], ah[3], al[3]);
      // a k-step's three products into a fresh tile, the small terms
      // first, then one f32 add into the accumulators: the tensor core
      // truncates as it accumulates, so the long sum stays in FADDs (one
      // tile at a time keeps the products free of spills)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float tile[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(tile, al, bh[q]);
        mma_tf32(tile, ah, bl[q]);
        mma_tf32(tile, ah, bh[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] += tile[e];
      }
    }
    c0 = n0;
    c1 = n1;
  }
  __syncthreads();  // every warp has read the input
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = warp * 32 + q * 8 + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = 16 * m + g;
      act[col * MH_AS + row] = fmaxf(acc[m][q][0] + b0, 0.f);
      act[(col + 1) * MH_AS + row] = fmaxf(acc[m][q][1] + b1, 0.f);
      act[col * MH_AS + row + 8] = fmaxf(acc[m][q][2] + b0, 0.f);
      act[(col + 1) * MH_AS + row + 8] = fmaxf(acc[m][q][3] + b1, 0.f);
    }
  }
  __syncthreads();
}

// Energies of the 64 states xsrc ([chain][4]) into eout.  With st >= 0
// (and stamps), the ends of its five phases are stamped at st .. st + 4.
// Thread tid works on chain r = tid % 64 in the first layer and in the
// output layer, where it forms the G outputs of group og = tid / 64 from
// w3s ([og][k][G] in shared memory, read as warp-wide broadcasts) and
// their log and residual terms; a chain's 4 partial sums meet in part.
template <int G>
__device__ void energy(const MhArgs& p, MhShared& s, const float* w3s, const float* xsrc, float* eout,
                       long long st) {
  long long* stamps = st >= 0 ? p.stamps : nullptr;
  const int tid = threadIdx.x, r = tid & (MH_ROWS - 1), og = tid >> 6;
  {
    const float* xr = xsrc + r * MH_XDP;
    const float x0 = xr[0], x1 = xr[1], x2 = xr[2];
#pragma unroll 4
    for (int c = og; c < MH_H; c += MH_THREADS / MH_ROWS) {
      const float4 l = s.l0[c];
      float acc = x0 * l.x;
      acc = fmaf(x1, l.y, acc);
      acc = fmaf(x2, l.z, acc);
      s.act[c * MH_AS + r] = fmaxf(acc + l.w, 0.f);
    }
  }
  __syncthreads();
  stamp(stamps, st);
  hidden_layer(s.act, p.w1, s.b1);
  stamp(stamps, st + 1);
  hidden_layer(s.act, p.w2, s.b2);
  stamp(stamps, st + 2);
  float f[G];
#pragma unroll
  for (int j = 0; j < G; ++j) f[j] = 0.f;
  const float* wg = w3s + og * MH_H * G;
#pragma unroll 4
  for (int k = 0; k < MH_H; ++k) {
    const float a = s.act[k * MH_AS + r];
#pragma unroll
    for (int j = 0; j < G; ++j) f[j] = fmaf(a, wg[k * G + j], f[j]);
  }
  __syncthreads();
  stamp(stamps, st + 3);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int o = og * G + j;
    if (o < p.ydim) {
      const float fo = f[j] + s.b3[o];
      const float af = p.a * fo;
      const float pref = af * af + p.bb;
      const float res = s.y[o] - fo;
      s1 += logf(pref);
      s2 += res * res / pref;
    }
  }
  s.part[og][r] = make_float2(s1, s2);
  __syncthreads();
  if (tid < MH_ROWS) {
    float t1 = s.part[0][r].x, t2 = s.part[0][r].y;
#pragma unroll
    for (int q = 1; q < MH_THREADS / MH_ROWS; ++q) {
      t1 += s.part[q][r].x;
      t2 += s.part[q][r].y;
    }
    float s3 = 0.f;
#pragma unroll
    for (int d = 0; d < MH_XD; ++d) {
      const float v = xsrc[r * MH_XDP + d];
      s3 += fmaxf(v - 1.f, 0.f) + fmaxf(-1.f - v, 0.f);
    }
    eout[r] = 0.5f * t1 + 0.5f * t2 + p.lambd_bd * s3;
  }
  __syncthreads();
  stamp(stamps, st + 4);
}

// G outputs per thread in the output layer: 4 G >= ydim.
template <int G>
__global__ void __launch_bounds__(MH_THREADS, 2) mh_kernel(const MhArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MhShared& s = *reinterpret_cast<MhShared*>(smem_raw);
  float* w3s = reinterpret_cast<float*>(smem_raw + sizeof(MhShared));  // [4][256][G]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * MH_ROWS;
  const uint2 key = make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32));

  for (int i = tid; i < 4 * MH_H * G; i += MH_THREADS) {
    const int j = i % G, k = (i / G) % MH_H, o = (i / (G * MH_H)) * G + j;
    w3s[i] = o < p.ydim ? p.w3[k * p.ydim + o] : 0.f;
  }
  for (int i = tid; i < MH_H; i += MH_THREADS) {
    s.l0[i] = make_float4(p.w0[i], p.w0[MH_H + i], p.w0[2 * MH_H + i], p.b0[i]);
    s.b1[i] = p.b1[i];
    s.b2[i] = p.b2[i];
  }
  if (tid < p.ydim) {
    s.y[tid] = p.y[tid];
    s.b3[tid] = p.b3[tid];
  }
  if (tid < MH_ROWS) {
    const int row = row0 + tid;
#pragma unroll
    for (int d = 0; d < MH_XD; ++d) s.x[tid * MH_XDP + d] = row < p.n ? p.x0[(size_t)row * MH_XD + d] : 0.f;
    s.x[tid * MH_XDP + MH_XD] = 0.f;
    s.xp[tid * MH_XDP + MH_XD] = 0.f;
  }
  __syncthreads();
  energy<G>(p, s, w3s, s.x, s.e, -1);
  stamp(p.stamps, 0);

  for (int step = 0; step < p.num_steps; ++step) {
    const long long st = 1 + (long long)step * MH_PHASES;
    if (tid < MH_ROWS) {
      const int row = row0 + tid;
      float z[MH_XD], u = 1.f;
      if (p.noise != nullptr) {
#pragma unroll
        for (int d = 0; d < MH_XD; ++d) z[d] = row < p.n ? p.noise[((size_t)step * p.n + row) * MH_XD + d] : 0.f;
        if (row < p.n) u = p.uniforms[(size_t)step * p.n + row];
      } else {
        const uint4 w0 = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, 0u, 0u), key);
        const uint4 w1 = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, 1u, 0u), key);
        z[0] = normal_from_bits(w0.x, w0.y);
        z[1] = normal_from_bits(w0.z, w0.w);
        z[2] = normal_from_bits(w1.x, w1.y);
        u = uniform_from_bits(w1.z);
      }
#pragma unroll
      for (int d = 0; d < MH_XD; ++d) s.xp[tid * MH_XDP + d] = s.x[tid * MH_XDP + d] + p.noise_std * z[d];
      s.u[tid] = u;
    }
    __syncthreads();
    stamp(p.stamps, st);
    energy<G>(p, s, w3s, s.xp, s.ep, st + 1);
    if (tid < MH_ROWS) {
      const bool acc = s.u[tid] < expf(s.e[tid] - s.ep[tid]);
      if (acc) {
#pragma unroll
        for (int d = 0; d < MH_XD; ++d) s.x[tid * MH_XDP + d] = s.xp[tid * MH_XDP + d];
        s.e[tid] = s.ep[tid];
      }
    }
    __syncthreads();
    stamp(p.stamps, st + 6);
  }

  if (tid < MH_ROWS && row0 + tid < p.n) {
#pragma unroll
    for (int d = 0; d < MH_XD; ++d) p.out[(size_t)(row0 + tid) * MH_XD + d] = s.x[tid * MH_XDP + d];
    if (p.energy_out != nullptr) p.energy_out[row0 + tid] = s.e[tid];
  }
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream`; returns a cudaError_t.
int mh_chains_launch(const float* x0, const float* y, const float* w0, const float* b0,
                     const float4* w1, const float* b1, const float4* w2, const float* b2,
                     const float* w3, const float* b3, const float* noise, const float* uniforms,
                     float* out, float* energy_out, long long* stamps, int n, int ydim, int num_steps, float noise_std, float a, float bb,
                     float lambd_bd, unsigned long long seed, void* stream) {
  if (n < 1 || num_steps < 0 || ydim < 1 || ydim > MH_YD_MAX || ((noise == nullptr) != (uniforms == nullptr)))
    return (int)cudaErrorInvalidValue;
  MhArgs p;
  p.x0 = x0; p.y = y; p.w0 = w0; p.b0 = b0; p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.w3 = w3; p.b3 = b3; p.noise = noise; p.uniforms = uniforms; p.out = out;
  p.energy_out = energy_out; p.stamps = stamps;
  p.n = n; p.ydim = ydim; p.num_steps = num_steps;
  p.noise_std = noise_std; p.a = a; p.bb = bb; p.lambd_bd = lambd_bd; p.seed = seed;
  // the output layer covers 4 G >= ydim outputs
  const int G = ydim <= 24 ? 6 : 8;
  const size_t smem = sizeof(MhShared) + sizeof(float) * 4 * MH_H * G;
  void (*kernel)(const MhArgs) = G == 6 ? mh_kernel<6> : mh_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + MH_ROWS - 1) / MH_ROWS, MH_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
