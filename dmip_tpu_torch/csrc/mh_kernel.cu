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
// What bounds it on an H100: the two 256x256 products, ~275 kFLOP per
// chain-step in f32 (8.3 TFLOP per 30k x 1000 run, ~123 ms at the
// 67 TFLOP/s non-tensor f32 peak).  Everything stays f32 FMA, not TF32:
// the 1/((a f)^2 + b^2) term with b = 0.01 amplifies product error.
//
// Design.  A block owns 64 chains and keeps their state and activations in
// shared memory for all steps.  Activations are stored K-major
// ([unit][chain]), so the 8 chains of a thread's register tile are two
// broadcast float4 reads.  Each hidden product is a register-tiled SIMT
// GEMM: 256 threads, each 8 chains x 8 units, weights read as coalesced
// float4 rows through the read-only cache from L2 (the 0.55 MB surrogate
// does not fit in shared memory; it stays hot in L2).  Results wait in
// registers until every thread has read the layer's input, then overwrite
// it, so one activation buffer suffices and two blocks fit on an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define MH_ROWS 64
#define MH_THREADS 256
#define MH_H 256
#define MH_XD 3
#define MH_XDP 4
#define MH_YD_MAX 32

struct MhArgs {
  const float* x0;        // (n, 3)
  const float* y;         // (ydim,)
  const float* w0;        // (3, 256)
  const float* b0;        // (256,)
  const float* w1;        // (256, 256)
  const float* b1;
  const float* w2;        // (256, 256)
  const float* b2;
  const float* w3;        // (256, ydim)
  const float* b3;        // (ydim,)
  const float* noise;     // (num_steps, n, 3) or null: caller-given normals
  const float* uniforms;  // (num_steps, n) or null: caller-given uniforms
  float* out;             // (n, 3)
  int n, ydim, num_steps;
  float noise_std, a, bb, lambd_bd;
  unsigned long long seed;
};

struct MhShared {
  float act[MH_H * MH_ROWS];      // [unit][chain]
  float f[MH_YD_MAX * MH_ROWS];   // [output][chain]
  float x[MH_ROWS * MH_XDP];      // current states
  float xp[MH_ROWS * MH_XDP];     // proposals
  float e[MH_ROWS], ep[MH_ROWS], u[MH_ROWS];
  float w0[MH_XD * MH_H], b0[MH_H], b1[MH_H], b2[MH_H];
  float y[MH_YD_MAX], b3[MH_YD_MAX];
};

// act <- relu(act . W + b) for a 256x256 W, in place (see the note above).
__device__ __forceinline__ void hidden_layer(float* act, const float* __restrict__ w,
                                             const float* bias) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < MH_H; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(act + k * MH_ROWS + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(act + k * MH_ROWS + ty * 8 + 4);
    const float4 c0 = __ldg(reinterpret_cast<const float4*>(w + k * MH_H + tx * 4));
    const float4 c1 = __ldg(reinterpret_cast<const float4*>(w + k * MH_H + 128 + tx * 4));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
  }
  __syncthreads();  // every thread has read the input
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4) ? tx * 4 + j : 128 + tx * 4 + (j - 4);
    const float bc = bias[c];
    float4 lo, hi;
    lo.x = fmaxf(acc[0][j] + bc, 0.f); lo.y = fmaxf(acc[1][j] + bc, 0.f);
    lo.z = fmaxf(acc[2][j] + bc, 0.f); lo.w = fmaxf(acc[3][j] + bc, 0.f);
    hi.x = fmaxf(acc[4][j] + bc, 0.f); hi.y = fmaxf(acc[5][j] + bc, 0.f);
    hi.z = fmaxf(acc[6][j] + bc, 0.f); hi.w = fmaxf(acc[7][j] + bc, 0.f);
    *reinterpret_cast<float4*>(act + c * MH_ROWS + ty * 8) = lo;
    *reinterpret_cast<float4*>(act + c * MH_ROWS + ty * 8 + 4) = hi;
  }
  __syncthreads();
}

// Energies of the 64 states xsrc ([chain][4]) into eout.
__device__ void energy(const MhArgs& p, MhShared& s, const float* xsrc, float* eout) {
  const int tid = threadIdx.x;
  for (int i = tid; i < MH_H * MH_ROWS; i += MH_THREADS) {
    const int c = i / MH_ROWS, r = i - c * MH_ROWS;
    const float* xr = xsrc + r * MH_XDP;
    float acc = xr[0] * s.w0[c];
    acc = fmaf(xr[1], s.w0[MH_H + c], acc);
    acc = fmaf(xr[2], s.w0[2 * MH_H + c], acc);
    s.act[i] = fmaxf(acc + s.b0[c], 0.f);
  }
  __syncthreads();
  hidden_layer(s.act, p.w1, s.b1);
  hidden_layer(s.act, p.w2, s.b2);
  for (int i = tid; i < p.ydim * MH_ROWS; i += MH_THREADS) {
    const int o = i / MH_ROWS, r = i - o * MH_ROWS;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < MH_H; ++k) acc = fmaf(s.act[k * MH_ROWS + r], __ldg(p.w3 + k * p.ydim + o), acc);
    s.f[i] = acc + s.b3[o];
  }
  __syncthreads();
  if (tid < MH_ROWS) {
    const int r = tid;
    float s1 = 0.f, s2 = 0.f;
    for (int o = 0; o < p.ydim; ++o) {
      const float f = s.f[o * MH_ROWS + r];
      const float af = p.a * f;
      const float pref = af * af + p.bb;
      const float res = s.y[o] - f;
      s1 += logf(pref);
      s2 += res * res / pref;
    }
    float s3 = 0.f;
    for (int d = 0; d < MH_XD; ++d) {
      const float v = xsrc[r * MH_XDP + d];
      s3 += fmaxf(v - 1.f, 0.f) + fmaxf(-1.f - v, 0.f);
    }
    eout[r] = 0.5f * s1 + 0.5f * s2 + p.lambd_bd * s3;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MH_THREADS, 2) mh_kernel(const MhArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MhShared& s = *reinterpret_cast<MhShared*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * MH_ROWS;
  const uint2 key = make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32));

  for (int i = tid; i < MH_XD * MH_H; i += MH_THREADS) s.w0[i] = p.w0[i];
  for (int i = tid; i < MH_H; i += MH_THREADS) {
    s.b0[i] = p.b0[i];
    s.b1[i] = p.b1[i];
    s.b2[i] = p.b2[i];
  }
  if (tid < p.ydim) {
    s.y[tid] = p.y[tid];
    s.b3[tid] = p.b3[tid];
  }
  if (tid < MH_ROWS) {
    const int row = row0 + tid;
    for (int d = 0; d < MH_XD; ++d) s.x[tid * MH_XDP + d] = row < p.n ? p.x0[(size_t)row * MH_XD + d] : 0.f;
    s.x[tid * MH_XDP + MH_XD] = 0.f;
    s.xp[tid * MH_XDP + MH_XD] = 0.f;
  }
  __syncthreads();
  energy(p, s, s.x, s.e);

  for (int step = 0; step < p.num_steps; ++step) {
    if (tid < MH_ROWS) {
      const int row = row0 + tid;
      float z[MH_XD], u = 1.f;
      if (p.noise != nullptr) {
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
      for (int d = 0; d < MH_XD; ++d) s.xp[tid * MH_XDP + d] = s.x[tid * MH_XDP + d] + p.noise_std * z[d];
      s.u[tid] = u;
    }
    __syncthreads();
    energy(p, s, s.xp, s.ep);
    if (tid < MH_ROWS) {
      const bool acc = s.u[tid] < expf(s.e[tid] - s.ep[tid]);
      if (acc) {
        for (int d = 0; d < MH_XD; ++d) s.x[tid * MH_XDP + d] = s.xp[tid * MH_XDP + d];
        s.e[tid] = s.ep[tid];
      }
    }
    __syncthreads();
  }

  if (tid < MH_ROWS && row0 + tid < p.n) {
    for (int d = 0; d < MH_XD; ++d) p.out[(size_t)(row0 + tid) * MH_XD + d] = s.x[tid * MH_XDP + d];
  }
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream`; returns a cudaError_t.
int mh_chains_launch(const float* x0, const float* y, const float* w0, const float* b0,
                     const float* w1, const float* b1, const float* w2, const float* b2,
                     const float* w3, const float* b3, const float* noise, const float* uniforms,
                     float* out, int n, int ydim, int num_steps, float noise_std, float a, float bb,
                     float lambd_bd, unsigned long long seed, void* stream) {
  if (n < 1 || num_steps < 0 || ydim < 1 || ydim > MH_YD_MAX || ((noise == nullptr) != (uniforms == nullptr)))
    return (int)cudaErrorInvalidValue;
  MhArgs p;
  p.x0 = x0; p.y = y; p.w0 = w0; p.b0 = b0; p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.w3 = w3; p.b3 = b3; p.noise = noise; p.uniforms = uniforms; p.out = out;
  p.n = n; p.ydim = ydim; p.num_steps = num_steps;
  p.noise_std = noise_std; p.a = a; p.bb = bb; p.lambd_bd = lambd_bd; p.seed = seed;
  const size_t smem = sizeof(MhShared);
  cudaError_t err = cudaFuncSetAttribute(mh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mh_kernel<<<(n + MH_ROWS - 1) / MH_ROWS, MH_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
