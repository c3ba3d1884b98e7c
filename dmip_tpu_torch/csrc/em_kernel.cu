// Fused reverse-SDE Euler-Maruyama sampler for a CDE tanh MLP on [x, y, t].
//
// Replaces the Pallas TPU kernel dmip_tpu/ops/em_kernel.py :: fused_em_sampler
// (_em_kernel, pallas_call at :421): the whole N-step E-M loop runs in one
// launch.  Per step, for each sample row,
//   h1  = tanh(bf16(x) . W1x + s * w1t + cy),  cy = y . W1y + b1 (f32, once)
//   h   = tanh(h . W + b)  for each hidden layer, inputs bf16, sums f32
//   a   = h . Wout + bout                        (f32)
//   mu  = (1 - lmbd/2) g(s) a + beta(s)/2 x,   x += delta mu + sqrt(delta) sigma xi
// with s = T - i/N T, every tanh output rounded to bf16 before the next
// product, and xi from an in-kernel Philox4x32-10 keyed by (seed, row, step).
//
// What bounds it on an H100: the hidden 512x512 products, ~1.05 MFLOP per
// sample-step in bf16 (6.3 TFLOP per 30k x 200 posterior, ~6.4 ms at the
// 989 TFLOP/s dense bf16 peak).  Bytes are negligible: x0 in, x out, ~1 MB
// of weights.
//
// Design.  A block owns 64 rows and carries them through all steps; rows
// never leave shared memory between steps.  Activations ping-pong between
// two 64 x H bf16 buffers in shared memory (rows padded by 8 elements so
// the mma fragment loads hit 32 distinct banks).  The weights do not fit
// (the two 512x512 bf16 matrices alone are 1 MB against 227 KB), so each
// step streams them from L2, where the ~1.1 MB net stays hot; they are
// re-laid out once on the host into mma.sync fragment order, so a warp
// fetches each 32-deep K slice of its 4 n-tiles as one coalesced 16-byte
// load per lane, prefetched one slice ahead.  Products use
// mma.sync.m16n8k16 bf16 -> f32 (wgmma/TMA is later work).  The ragged
// last block is masked: its missing rows run on zeros and are not stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

#define EM_ROWS 64
#define EM_THREADS 256
#define EM_WARPS (EM_THREADS / 32)
#define EM_MAX_HIDDEN 8
#define EM_MAX_XDIM 4

struct EmArgs {
  const float* x0;     // (n, xdim)
  const float* y;      // (ydim,)
  const float* w1x;    // (xdim, h1), bf16-rounded values
  const float* w1y;    // (ydim, h1), f32
  const float* w1t;    // (h1,), f32
  const float* b1;     // (h1,)
  const uint4* wh[EM_MAX_HIDDEN];  // hidden products, packed bf16 fragments
  const float* bh[EM_MAX_HIDDEN];  // their biases
  int width[EM_MAX_HIDDEN + 1];    // width[0] = h1; width[l + 1] = out of hidden l
  int n_hidden;
  const float* wout;   // (xdim, hl): output weights transposed, bf16-rounded
  const float* bout;   // (xdim,)
  const float* noise;  // (num_steps, n, xdim) or null: caller-given normals
  float* out;          // (n, xdim)
  int n, xdim, ydim, num_steps, stride;
  float T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale;
  unsigned long long seed;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out[64, N] = bf16(tanh(in[64, K] . W + b)).  Each warp computes 64 x 32
// column chunks: 4 m-tiles x 4 n-tiles of m16n8k16.  wp is packed as
// [N/8][K/32][lane] uint4 = (k-tile 2kp: b0, b1; k-tile 2kp+1: b0, b1).
__device__ __forceinline__ void hidden_layer(const __nv_bfloat16* in, __nv_bfloat16* out,
                                             const uint4* __restrict__ wp,
                                             const float* __restrict__ bias, int K, int N,
                                             int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KP = K >> 5;
  for (int n0 = warp * 32; n0 < N; n0 += EM_WARPS * 32) {
    float acc[4][4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;

    const uint4* base = wp + (size_t)(n0 >> 3) * KP * 32 + lane;
    uint4 bcur[4], bnext[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bcur[q] = __ldg(base + (size_t)q * KP * 32);
    for (int kp = 0; kp < KP; ++kp) {
      if (kp + 1 < KP) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bnext[q] = __ldg(base + ((size_t)q * KP + kp + 1) * 32);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kp * 32 + j * 16 + 2 * t;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const __nv_bfloat16* r0 = in + (m * 16 + g) * stride + col;
          const __nv_bfloat16* r8 = r0 + 8 * stride;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(r0);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(r8);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(r0 + 8);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(r8 + 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t b0 = j ? bcur[q].z : bcur[q].x;
            const uint32_t b1 = j ? bcur[q].w : bcur[q].y;
            mma_bf16(acc[m][q], a0, a1, a2, a3, b0, b1);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) bcur[q] = bnext[q];
    }
    // epilogue: bias, tanh, round to bf16, store pairs
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + q * 8 + 2 * t;
      const float bb0 = __ldg(bias + col), bb1 = __ldg(bias + col + 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = m * 16 + g;
        *reinterpret_cast<__nv_bfloat162*>(out + row * stride + col) =
            __floats2bfloat162_rn(tanhf(acc[m][q][0] + bb0), tanhf(acc[m][q][1] + bb1));
        *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * stride + col) =
            __floats2bfloat162_rn(tanhf(acc[m][q][2] + bb0), tanhf(acc[m][q][3] + bb1));
      }
    }
  }
}

__global__ void __launch_bounds__(EM_THREADS, 1) em_kernel(const EmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h1 = p.width[0], hl = p.width[p.n_hidden], xdim = p.xdim, stride = p.stride;
  const int row0 = blockIdx.x * EM_ROWS;

  __nv_bfloat16* act[2];
  act[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  act[1] = act[0] + EM_ROWS * stride;
  float* cy = reinterpret_cast<float*>(act[1] + EM_ROWS * stride);
  float* w1t = cy + h1;
  float* w1x = w1t + h1;            // [xdim][h1]
  float* wout = w1x + xdim * h1;    // [xdim][hl]
  float* xs = wout + xdim * hl;     // [EM_ROWS][EM_MAX_XDIM]
  float* as = xs + EM_ROWS * EM_MAX_XDIM;

  // condition term, constant over rows and steps: cy = y . W1y + b1 in f32
  for (int j = tid; j < h1; j += EM_THREADS) {
    float acc = 0.f;
    for (int k = 0; k < p.ydim; ++k) acc += p.y[k] * p.w1y[k * h1 + j];
    cy[j] = acc + p.b1[j];
    w1t[j] = p.w1t[j];
    for (int d = 0; d < xdim; ++d) w1x[d * h1 + j] = p.w1x[d * h1 + j];
  }
  for (int i = tid; i < xdim * hl; i += EM_THREADS) wout[i] = p.wout[i];
  for (int i = tid; i < EM_ROWS * xdim; i += EM_THREADS) {
    const int r = i / xdim, d = i - r * xdim, row = row0 + r;
    xs[r * EM_MAX_XDIM + d] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  __syncthreads();

  for (int step = 0; step < p.num_steps; ++step) {
    const float tt = ((float)step / (float)p.num_steps) * p.T;
    const float s = p.T - tt;
    const float beta = p.beta_min + p.bd * s;
    const float gs = sqrtf(beta);

    // layer 1: K = xdim (+ the f32 time and condition terms)
    for (int r = 0; r < EM_ROWS; ++r) {
      float xb[EM_MAX_XDIM];
#pragma unroll
      for (int d = 0; d < EM_MAX_XDIM; ++d)
        xb[d] = d < xdim ? bf16_round(xs[r * EM_MAX_XDIM + d]) : 0.f;
      for (int j = tid; j < h1; j += EM_THREADS) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < EM_MAX_XDIM; ++d)
          if (d < xdim) acc += xb[d] * w1x[d * h1 + j];
        act[0][r * stride + j] = __float2bfloat16_rn(tanhf(acc + s * w1t[j] + cy[j]));
      }
    }
    __syncthreads();

    int cur = 0;
    for (int l = 0; l < p.n_hidden; ++l) {
      hidden_layer(act[cur], act[cur ^ 1], p.wh[l], p.bh[l], p.width[l], p.width[l + 1], stride);
      __syncthreads();
      cur ^= 1;
    }

    // output layer: warp w reduces rows 8w .. 8w+7 over hl
    for (int rr = 0; rr < EM_ROWS / EM_WARPS; ++rr) {
      const int r = warp * (EM_ROWS / EM_WARPS) + rr;
      float part[EM_MAX_XDIM] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lane; j < hl; j += 32) {
        const float h = __bfloat162float(act[cur][r * stride + j]);
#pragma unroll
        for (int d = 0; d < EM_MAX_XDIM; ++d)
          if (d < xdim) part[d] += h * wout[d * hl + j];
      }
#pragma unroll
      for (int d = 0; d < EM_MAX_XDIM; ++d) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part[d] += __shfl_xor_sync(0xffffffffu, part[d], o);
      }
      if (lane == 0) {
        for (int d = 0; d < xdim; ++d) as[r * EM_MAX_XDIM + d] = part[d] + p.bout[d];
      }
    }
    __syncthreads();

    // integrator update, one thread per (row, coordinate)
    if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim, row = row0 + r;
      const float x = xs[r * EM_MAX_XDIM + d];
      const float mu = (p.c_drift * gs) * as[r * EM_MAX_XDIM + d] + (0.5f * beta) * x;
      float xn = x + p.delta * mu;
      if (p.noise_scale != 0.f) {
        float z = 0.f;
        if (p.noise != nullptr) {
          if (row < p.n) z = p.noise[((size_t)step * p.n + row) * xdim + d];
        } else {
          const uint4 w = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, (uint32_t)(d >> 1), 0u),
                                        make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32)));
          z = (d & 1) ? normal_from_bits(w.z, w.w) : normal_from_bits(w.x, w.y);
        }
        xn = xn + (p.sqrt_delta * (p.c_sigma * gs)) * (p.noise_scale * z);
      }
      xs[r * EM_MAX_XDIM + d] = xn;
    }
    __syncthreads();
  }

  for (int i = tid; i < EM_ROWS * xdim; i += EM_THREADS) {
    const int r = i / xdim, d = i - r * xdim, row = row0 + r;
    if (row < p.n) p.out[(size_t)row * xdim + d] = xs[r * EM_MAX_XDIM + d];
  }
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// Shared memory the kernel needs for these widths (bytes).
static size_t em_sampler_smem_bytes(int h1, int hl, int hmax, int xdim) {
  const int stride = ((hmax + 63) / 64) * 64 + 8;
  return (size_t)2 * EM_ROWS * stride * sizeof(__nv_bfloat16) +
         sizeof(float) * ((size_t)2 * h1 + (size_t)xdim * (h1 + hl) + 2 * EM_ROWS * EM_MAX_XDIM);
}

extern "C" {

// Launch on `stream`.  wh_ptrs / bh_ptrs / widths are host arrays of
// n_hidden, n_hidden and n_hidden + 1 entries.  Returns a cudaError_t.
int em_sampler_launch(const float* x0, const float* y, const float* w1x, const float* w1y,
                      const float* w1t, const float* b1, const unsigned long long* wh_ptrs,
                      const unsigned long long* bh_ptrs, const int* widths, int n_hidden,
                      const float* wout, const float* bout, const float* noise, float* out, int n,
                      int xdim, int ydim, int num_steps, float T, float beta_min, float bd,
                      float c_drift, float c_sigma, float delta, float sqrt_delta,
                      float noise_scale, unsigned long long seed, void* stream) {
  if (n_hidden < 0 || n_hidden > EM_MAX_HIDDEN || xdim < 1 || xdim > EM_MAX_XDIM || n < 1 ||
      num_steps < 1)
    return (int)cudaErrorInvalidValue;
  EmArgs p;
  p.x0 = x0; p.y = y; p.w1x = w1x; p.w1y = w1y; p.w1t = w1t; p.b1 = b1;
  int hmax = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    if (widths[l] <= 0 || widths[l] % 32) return (int)cudaErrorInvalidValue;
    p.width[l] = widths[l];
    hmax = widths[l] > hmax ? widths[l] : hmax;
  }
  for (int l = 0; l < n_hidden; ++l) {
    p.wh[l] = reinterpret_cast<const uint4*>(wh_ptrs[l]);
    p.bh[l] = reinterpret_cast<const float*>(bh_ptrs[l]);
  }
  p.n_hidden = n_hidden;
  p.wout = wout; p.bout = bout; p.noise = noise; p.out = out;
  p.n = n; p.xdim = xdim; p.ydim = ydim; p.num_steps = num_steps;
  p.stride = ((hmax + 63) / 64) * 64 + 8;
  p.T = T; p.beta_min = beta_min; p.bd = bd; p.c_drift = c_drift; p.c_sigma = c_sigma;
  p.delta = delta; p.sqrt_delta = sqrt_delta; p.noise_scale = noise_scale; p.seed = seed;

  // wider nets than a block's 227 KB of shared memory holds are refused
  const size_t smem = em_sampler_smem_bytes(widths[0], widths[n_hidden], hmax, xdim);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(em_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + EM_ROWS - 1) / EM_ROWS;
  em_kernel<<<blocks, EM_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
