// Fused reverse-SDE Euler-Maruyama samplers for a tanh MLP: the CDE (B1)
// and the CDiffE (B4).  One kernel template serves both; they differ only
// in what feeds the first layer and in B4's per-step noise and re-diffusion
// of y.
//
// B1 replaces the Pallas TPU kernel dmip_tpu/ops/em_kernel.py ::
// fused_em_sampler (_em_kernel, pallas_call at :421): the whole N-step E-M
// loop runs in one launch.  Per step, for each sample row,
//   h1  = tanh(bf16(x) . W1x + s * w1t + cy),  cy = y . W1y + b1 (f32, once)
//   h   = tanh(h . W + b)  for each hidden layer, inputs bf16, sums f32
//   a   = h . Wout + bout                        (f32)
//   mu  = (1 - lmbd/2) g(s) a + beta(s)/2 x,   x += delta mu + sqrt(delta) sigma xi
// with s = T - i/N T, every tanh output rounded to bf16 before the next
// product, and xi from an in-kernel Philox4x32-10 keyed by (seed, row, step).
//
// B4 replaces dmip_tpu/ops/em_kernel.py :: fused_em_sampler_cdiffe
// (_em_cdiffe_kernel, pallas_call at :319).  The net is the joint one,
// [x, y, t] -> (xdim + ydim), with its output layer sliced to the x block
// on the host.  Per step s = T - i/N T, for each sample row:
//   eps = noise_scale * (D = xdim + ydim normals)   (one block per step)
//   y_t = alpha(s) y0 + std(s) eps[xdim:]            (re-diffuse the condition)
//   h1  = tanh(bf16([x, y_t]) . W1 + (s w1t + b1))
//   h   = tanh(h . W + b) per hidden layer, a = h . Wout_x + bout_x
//   x  += delta ((1 - lmbd/2) g(s) a + beta(s)/2 x) + sqrt(delta) sigma eps[:xdim]
// With noise_scale = 0 no normals are drawn: y_t = alpha(s) y0 and the
// update has no noise term, as in the TPU kernel.  The D normals of a row
// come from ceil(D/2) Philox4x32-10 draws keyed by (seed, row, step, pair).
//
// What bounds them on an H100: the hidden 512x512 products, ~1.05 (B1) and
// ~1.08 (B4) MFLOP per sample-step in bf16, ~6.4 / 6.5 ms per 30k x 200
// posterior at the 989 TFLOP/s dense bf16 peak; ~9 us a step for a block of
// 64 rows on one SM.  Device-memory bytes are negligible (x0 in, x out, ~1 MB
// of weights), but the weights do not fit in shared memory, so each block
// reads all ~1 MB of hidden weights from L2 every step.
//
// Design.  A block owns 64 rows for all steps: 2 consumer warpgroups and a
// producer warpgroup, of which one thread works.  The activations live in
// shared memory as K-major 64 x 64 bf16 slots with the 128-byte swizzle, the
// operand layout wgmma reads.  The wrapper packs every weight the steps read
// into the exact shared-memory image of its ring tiles, in the order the
// consumers take them: per step the first layer's 32 x h1 mma.sync
// fragments (a half for each warpgroup), then each hidden layer's 64-deep K
// slices of N/2 columns (K-major, swizzled).  The producer moves one tile at
// a time with one 1-D bulk copy into a ring of four 32 KB stages, completing
// on the stage's mbarrier, and so runs ahead across layers and steps while
// the consumers compute.  Warpgroup h computes columns [h N/2, (h + 1) N/2)
// of every layer:
//   layer 0    the bf16 [x] (B1) or [x, y_t] (B4) tile, 64 x 32, times its
//              half of W1 by mma.sync (K = 32), + (s w1t + cy) or (s w1t + b1);
//   hidden     wgmma m64n{N/2}k16 over the ring's slices, bf16 -> f32
//              accumulators in registers, one slice in flight behind the
//              one being issued; once both warpgroups are done reading the
//              layer's input, each writes its output over it in place;
//   output     wgmma m64n8k16 over half of K each, against the output
//              weights' x block (xdim <= 4 columns, padded to 8), resident
//              in shared memory; the two halves meet in the update.
// Every epilogue adds the bias, applies tanh.approx.f32 (one SFU op; its
// ~2^-11 relative error sits under the bf16 rounding that follows, and
// chip_smoke.py holds the samples against a float64 run of the plain
// version), rounds to bf16 and stores.  Widths are zero-padded to multiples
// of 128 by the wrapper (exact) and are at most 512.  The ragged last block
// runs its missing rows on zeros and does not store them.  PERF.md has the
// phase times.
//
// The f32-weight mode (compute_dtype=float32, as the TPU kernels take it):
// every product's inputs and every activation f32, tanh accurate (tanhf),
// the first layer x . W1x + s w1t + cy (B4: [x, y_t] . W1 + (s w1t + b1)).
// Its bound is the same products in f32, ~94.5 / 96.5 ms at the 67 TFLOP/s
// f32 peak, or ~38.4 / 39.2 ms as three TF32 products at 495 TFLOP/s.  The
// bf16 design does not carry over: 64 rows x 512 f32 activations are 128 KB,
// which with the ring passes the 227 KB a block may have; plain TF32 and
// tanh.approx.f32 keep bf16-class accuracy.  So em_sampler_f32_kernel is a
// second template, B2's split-TF32 design widened (csrc/mh_kernel.cu,
// tf32.cuh): a block of 16 warps owns 64 rows, their activations f32 and
// K-major in shared memory ([unit][row], rows of 72 floats, so a warp's
// A-fragment loads hit 32 banks; ~147 KB at 512 units, one block an SM,
// half the L2 weight traffic of two 32-row blocks).  Each hidden product
// runs on mma.sync m16n8k8 TF32: every operand split into hi + lo, a
// k-step's three products (lo hi, hi lo, hi hi) into a fresh tile, added
// into the f32 accumulators by FADD.  The warps split the columns in
// groups of 32 and, at widths under 512, the rows as well; a warp reads
// its weights, packed by the wrapper in B-fragment order, from L2 one
// k-step ahead and splits them in registers.  Results wait in registers
// until every warp has read the layer's input, then bias and tanhf write
// them over it.  Layer 0 takes the same path from its own K-major input
// ([x] or [x, y_t], zero-padded to K = 8 or 32); the output layer (xdim <=
// 4 columns) is f32 FMA.  The noise, the update and the stamps are the
// device functions both modes call, so the two draw the same normals for
// the same seed.  PERF.md has its phase times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32.cuh"

#define EM_ROWS 64
#define EM_CONSUMERS 256                 // two warpgroups
#define EM_THREADS (EM_CONSUMERS + 128)  // and the producer's warpgroup, of which one thread works
#define EM_MAX_HIDDEN 8
#define EM_MAX_XDIM 4
#define EM_MAX_WIDTH 512
#define EM_STAGES 4
#define EM_TILE_BYTES 32768              // a ring stage: up to 256 weight columns x 64 K
#define EM_SLOT_BYTES (EM_ROWS * 128)    // 64 activation rows x 64 K
#define EM_K1 32                         // the first layer's K: [x] or [x, y], zero-padded
#define EM_ZSTRIDE (EM_K1 + 8)

struct EmArgs {
  const float* x0;     // (n, xdim)
  const float* y;      // (ydim,)
  const float* c1;     // (h1,): B1 cy = y . W1y + b1, B4 b1
  const float* w1t;    // (h1,)
  const uint8_t* w1;   // first layer over [x] or [x, y]: bf16 (32, h1) as mma.sync fragments, two ring
                       // tiles; f32 (K padded to 8, h1) in B-fragment order
  const uint8_t* wh[EM_MAX_HIDDEN];  // hidden weights: bf16 as their ring tiles' images; f32 in B-fragment order
  const float* bh[EM_MAX_HIDDEN];    // their biases
  int width[EM_MAX_HIDDEN + 1];      // width[0] = h1; width[l + 1] = out of hidden l
  int n_hidden;
  const uint8_t* wout; // output weights' x block: bf16 (hl, 8) as one K-major swizzled wgmma operand; f32 (hl, 4)
  const float* bout;   // (xdim,)
  const float* noise;  // B1 (num_steps, n, xdim), B4 (num_steps, n, xdim + ydim), or null
  float* out;          // (n, xdim)
  long long* stamps;   // null, or 1 + (n_hidden + 3 (B1) or 4 (B4)) x num_steps (%globaltimer, clock64) pairs
  int n, xdim, ydim, num_steps, hmax;
  float T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale;
  unsigned long long seed;
};

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

// Step `step` of the grid: s = T - step/N T, beta(s) and g(s) = sqrt(beta).
struct EmStep {
  float s, beta, gs;
};

__device__ __forceinline__ EmStep em_step(const EmArgs& p, int step) {
  const float tt = ((float)step / (float)p.num_steps) * p.T;
  const float s = p.T - tt;
  const float beta = p.beta_min + p.bd * s;
  return {s, beta, sqrtf(beta)};
}

// B4's first-layer input at step `step` for the block's rows, over threads
// tid, tid + nthreads, ...: D = xdim + ydim normals a row (caller-given, or
// Philox keyed by (seed, row, step, pair)) times noise_scale; the x block's
// go to xi for the update, and put(r, d, v) receives [x, y_t], with y
// re-diffused to s: y_t = alpha(s) y0 + std(s) eps[xdim:] (alpha(s) y0
// with noise_scale = 0, when no normals are drawn).  Both modes call it.
template <typename Put>
__device__ __forceinline__ void cdiffe_inputs(const EmArgs& p, int step, float s, int row0, const float* xs,
                                              float* xi, const float* y0, int tid, int nthreads, Put put) {
  const uint2 key = make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32));
  const int xdim = p.xdim, D = p.xdim + p.ydim, pairs = (D + 1) >> 1;
  const float int_beta = 0.5f * p.bd * (s * s) + p.beta_min * s;
  const float alpha = expf(-0.5f * int_beta);
  const float std_s = sqrtf(1.f - expf(-int_beta));
  for (int i = tid; i < EM_ROWS * pairs; i += nthreads) {
    const int rr = i / pairs, pp = i - rr * pairs, row = row0 + rr;
    float e[2] = {0.f, 0.f};
    if (p.noise_scale != 0.f) {
      if (p.noise != nullptr) {
        for (int k = 0; k < 2; ++k) {
          const int dd = 2 * pp + k;
          if (row < p.n && dd < D) e[k] = p.noise[((size_t)step * p.n + row) * D + dd];
        }
      } else {
        const uint4 w = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, (uint32_t)pp, 0u), key);
        e[0] = normal_from_bits(w.x, w.y);
        e[1] = normal_from_bits(w.z, w.w);
      }
    }
    for (int k = 0; k < 2; ++k) {
      const int dd = 2 * pp + k;
      if (dd >= D) break;
      const float ek = p.noise_scale * e[k];
      float v;
      if (dd < xdim) {
        xi[rr * EM_MAX_XDIM + dd] = ek;
        v = xs[rr * EM_MAX_XDIM + dd];
      } else {
        v = p.noise_scale != 0.f ? alpha * y0[dd - xdim] + std_s * ek : alpha * y0[dd - xdim];
      }
      put(rr, dd, v);
    }
  }
}

// The integrator's update of coordinate d of block row r (row `row` of the
// launch) from x and the net's output a:
//   x + delta ((1 - lmbd/2) g a + beta/2 x) + sqrt(delta) sigma xi,
// xi from xi (B4), the caller's noise or Philox keyed by (seed, row, step,
// d / 2) (B1).  Both modes call it.
template <bool CD>
__device__ __forceinline__ float em_update(const EmArgs& p, int step, int r, int d, int row, float a, float x,
                                           const EmStep& st, const float* xi) {
  const float mu = (p.c_drift * st.gs) * a + (0.5f * st.beta) * x;
  float xn = x + p.delta * mu;
  if (p.noise_scale != 0.f) {
    float z;
    if (CD) {
      z = xi[r * EM_MAX_XDIM + d];
    } else if (p.noise != nullptr) {
      z = row < p.n ? p.noise_scale * p.noise[((size_t)step * p.n + row) * p.xdim + d] : 0.f;
    } else {
      const uint2 key = make_uint2((uint32_t)p.seed, (uint32_t)(p.seed >> 32));
      const uint4 w = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)step, (uint32_t)(d >> 1), 0u), key);
      z = p.noise_scale * ((d & 1) ? normal_from_bits(w.z, w.w) : normal_from_bits(w.x, w.y));
    }
    xn = xn + (p.sqrt_delta * (p.c_sigma * st.gs)) * z;
  }
  return xn;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offsets in the block's shared memory (from a 1024-byte boundary).
struct EmLayout {
  int ring, act, wout, zt, f32, bars, bytes;
};

__host__ __device__ inline EmLayout em_layout(int h1, int hl, int hmax) {
  EmLayout L;
  L.ring = 0;
  L.act = L.ring + EM_STAGES * EM_TILE_BYTES;
  L.wout = L.act + (hmax / 64) * EM_SLOT_BYTES;
  L.zt = L.wout + (hl / 64) * 1024;
  L.f32 = L.zt + EM_ROWS * EM_ZSTRIDE * 2;
  // w1t, c1, bias1 [h1]; xs, xi [EM_ROWS][EM_MAX_XDIM]; opart [2][EM_ROWS][EM_MAX_XDIM]; y0 [EM_K1]
  const int nf = 3 * h1 + 4 * EM_ROWS * EM_MAX_XDIM + EM_K1;
  L.bars = (L.f32 + 4 * nf + 7) & ~7;
  L.bytes = L.bars + 2 * EM_STAGES * 8 + 1024;  // + slack to align the base
  return L;
}

// A consumer thread's place in the accumulator layout: warpgroup h, warp w
// (within it), lane = 4 g + t: rows 16 w + g and + 8, columns h NW + 8 j +
// 2 t and + 1.
struct Lane {
  int h, r0, t;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31;
    h = threadIdx.x >> 7;
    r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    t = lane & 3;
  }
};

// act element (r, c) as a byte offset: slot c / 64, its 16-byte piece
// (c % 64) / 8 swizzled within row r.
__device__ __forceinline__ int act_off(int r, int c) {
  return (c >> 6) * EM_SLOT_BYTES + swz(r, (c & 63) >> 3, 128) + ((c & 7) << 1);
}

// A layer's epilogue over this thread's columns, column block by column
// block: pre(j, v) gives the four pre-activations of block j (the
// accumulator layout's v[0..3]); + bias, tanh, bf16, stored over the
// layer's input in act.
template <int NW, typename Pre>
__device__ __forceinline__ void epilogue(Pre pre, const float* bias, uint8_t* act) {
  const Lane ln;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = ln.h * NW + 8 * j + 2 * ln.t;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    float v[4];
    pre(j, v);
    *reinterpret_cast<__nv_bfloat162*>(act + act_off(ln.r0, c)) =
        __floats2bfloat162_rn(tanh_approx(v[0] + b.x), tanh_approx(v[1] + b.y));
    *reinterpret_cast<__nv_bfloat162*>(act + act_off(ln.r0 + 8, c)) =
        __floats2bfloat162_rn(tanh_approx(v[2] + b.x), tanh_approx(v[3] + b.y));
  }
}

// The consumers' view of the ring: warpgroup h takes ring tiles 2 j + h,
// j = 0, 1, ..., which the producer fills in that order.
struct Ring {
  uint8_t* base;
  uint64_t *full, *empty;
  uint32_t j;
  __device__ __forceinline__ uint32_t g(uint32_t jj) const { return 2 * jj + (threadIdx.x >> 7); }
  // Wait for this warpgroup's tile jj; returns its stage.
  __device__ __forceinline__ uint8_t* take(uint32_t jj) {
    const uint32_t gg = g(jj);
    mbar_wait(&full[gg % EM_STAGES], (gg / EM_STAGES) & 1);
    return base + (gg % EM_STAGES) * EM_TILE_BYTES;
  }
  // Give tile jj's stage back to the producer (one thread a warpgroup).
  __device__ __forceinline__ void give(uint32_t jj) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[g(jj) % EM_STAGES]);
  }
};

// Keeps the compiler from moving other definitions of the accumulators
// into a wgmma pipeline stage (which would serialize the products).
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Layer 0 of this warpgroup: the bf16 tile zt (64 x 32) times its ring
// tile of W1 fragments, two mma.sync k-steps per 8 columns, then the
// epilogue with bias1 = s w1t + c1.
template <int NW>
__device__ __forceinline__ void layer0(Ring& ring, const __nv_bfloat16* zt, const float* bias1, uint8_t* act) {
  const Lane ln;
  uint32_t a[2][4];
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const __nv_bfloat16* q0 = zt + ln.r0 * EM_ZSTRIDE + kt * 16 + 2 * ln.t;
    const __nv_bfloat16* q8 = q0 + 8 * EM_ZSTRIDE;
    a[kt][0] = *reinterpret_cast<const uint32_t*>(q0);
    a[kt][1] = *reinterpret_cast<const uint32_t*>(q8);
    a[kt][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
    a[kt][3] = *reinterpret_cast<const uint32_t*>(q8 + 8);
  }
  const uint4* w1 = reinterpret_cast<const uint4*>(ring.take(ring.j)) + (threadIdx.x & 31);
  epilogue<NW>(
      [&](int j, float (&v)[4]) {
        const uint4 b = w1[j * 32];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = 0.f;
        mma_bf16(v, a[0][0], a[0][1], a[0][2], a[0][3], b.x, b.y);
        mma_bf16(v, a[1][0], a[1][1], a[1][2], a[1][3], b.z, b.w);
      },
      bias1, act);
}

// One hidden layer (K = kc_n x 64 -> N = 2 NW) of this warpgroup: the
// products over the ring's tiles into registers, one slice in flight behind
// the one being issued, then, once both warpgroups are done reading act,
// the epilogue in place.
template <int NW>
__device__ __forceinline__ void hidden_layer(Ring& ring, uint8_t* act, int kc_n, const float* bias) {
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int kc = 0; kc < kc_n; ++kc) {
    const uint64_t da = wg_desc(act + kc * EM_SLOT_BYTES), db = wg_desc(ring.take(ring.j + kc));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NW>::mma(acc, da + 2 * ks, db + 2 * ks, 1);
    wgmma_commit();
    fence_acc(acc);
    if (kc > 0) {
      wgmma_wait<1>();  // the slice before this one is done: its stage goes back to the producer
      fence_acc(acc);
      ring.give(ring.j + kc - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring.give(ring.j + kc_n - 1);
  ring.j += kc_n;
  named_sync(1, EM_CONSUMERS);  // both warpgroups have read act
  epilogue<NW>(
      [&](int j, float (&v)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[4 * j + e];
      },
      bias, act);
}

// The output layer's x block, this warpgroup's half of K (kc_n slices):
// its partial sums of rows 16 w + g and + 8, columns 2 t and + 1, into
// opart[h][row][d] for d < xdim.
__device__ __forceinline__ void output_layer(const uint8_t* act, const uint8_t* wout, int kc_n, int xdim,
                                             float* opart) {
  const Lane ln;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  fence_acc(acc);
  act += ln.h * kc_n * EM_SLOT_BYTES;
  wout += ln.h * kc_n * 1024;
  wgmma_fence();
  for (int kc = 0; kc < kc_n; ++kc) {
    const uint64_t da = wg_desc(act + kc * EM_SLOT_BYTES), db = wg_desc(wout + kc * 1024);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<8>::mma(acc, da + 2 * ks, db + 2 * ks, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  float* o = opart + (ln.h * EM_ROWS + ln.r0) * EM_MAX_XDIM;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 2 * ln.t + (e & 1);
    if (d < xdim) o[(e >> 1) * 8 * EM_MAX_XDIM + d] = acc[e];
  }
}

#define EM_DISPATCH(nw, CALL)                          \
  switch (nw) {                                        \
    case 64: { constexpr int NW = 64; CALL; } break;   \
    case 128: { constexpr int NW = 128; CALL; } break; \
    case 192: { constexpr int NW = 192; CALL; } break; \
    default: { constexpr int NW = 256; CALL; } break;  \
  }

// The producer: every ring tile of every step, in the consumers' order,
// each as one bulk copy once its stage is free.
__device__ __forceinline__ void produce(const EmArgs& p, uint8_t* ring, uint64_t* full, uint64_t* empty) {
  uint32_t g = 0;
  auto put = [&](const uint8_t* src, uint32_t bytes) {
    const uint32_t st = g % EM_STAGES;
    mbar_wait(&empty[st], ((g / EM_STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], bytes);
    bulk_copy(ring + st * EM_TILE_BYTES, src, bytes, &full[st]);
    ++g;
  };
  const uint32_t w1_bytes = (uint32_t)p.width[0] * 32;  // half of (32, h1) bf16
  for (int step = 0; step < p.num_steps; ++step) {
    put(p.w1, w1_bytes);
    put(p.w1 + w1_bytes, w1_bytes);
    for (int l = 0; l < p.n_hidden; ++l) {
      const uint32_t bytes = (uint32_t)p.width[l + 1] * 64;  // N/2 columns x 128 bytes
      const int tiles = 2 * (p.width[l] >> 6);
      for (int i = 0; i < tiles; ++i) put(p.wh[l] + (size_t)i * bytes, bytes);
    }
  }
}

template <bool CD>
__global__ void __launch_bounds__(EM_THREADS, 1) em_sampler_kernel(const EmArgs p) {
  extern __shared__ uint8_t em_smem[];
  uint8_t* sm = em_smem + ((1024 - (smem_u32(em_smem) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int h1 = p.width[0], hl = p.width[p.n_hidden], xdim = p.xdim;
  const int row0 = blockIdx.x * EM_ROWS;
  const EmLayout L = em_layout(h1, hl, p.hmax);

  uint8_t* act = sm + L.act;
  uint8_t* wout = sm + L.wout;
  __nv_bfloat16* zt = reinterpret_cast<__nv_bfloat16*>(sm + L.zt);
  float* w1t = reinterpret_cast<float*>(sm + L.f32);
  float* c1 = w1t + h1;
  float* bias1 = c1 + h1;
  float* xs = bias1 + h1;                          // [EM_ROWS][EM_MAX_XDIM]
  float* xi = xs + EM_ROWS * EM_MAX_XDIM;
  float* opart = xi + EM_ROWS * EM_MAX_XDIM;       // [2][EM_ROWS][EM_MAX_XDIM]
  float* y0 = opart + 2 * EM_ROWS * EM_MAX_XDIM;   // [EM_K1]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + EM_STAGES;

  for (int j = tid; j < h1; j += EM_THREADS) {
    w1t[j] = p.w1t[j];
    c1[j] = p.c1[j];
  }
  for (int i = tid; i < hl; i += EM_THREADS)  // (hl, 8) bf16: hl 16-byte pieces
    reinterpret_cast<uint4*>(wout)[i] = reinterpret_cast<const uint4*>(p.wout)[i];
  for (int i = tid; i < EM_ROWS * EM_ZSTRIDE; i += EM_THREADS) zt[i] = __float2bfloat16_rn(0.f);
  if (CD && tid < p.ydim) y0[tid] = p.y[tid];
  for (int i = tid; i < EM_ROWS * xdim; i += EM_THREADS) {
    const int r = i / xdim, d = i - r * xdim, row = row0 + r;
    xs[r * EM_MAX_XDIM + d] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < EM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  fence_async();  // wout, written above, is read by wgmma
  __syncthreads();

  // the producer's warpgroup gives its registers to the consumers: 2 x 128
  // x 232 + 128 x 40 of the SM's 65536
  if (tid >= EM_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == EM_CONSUMERS) produce(p, sm + L.ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  Ring ring{sm + L.ring, full, empty, 0u};
  const int n_phases = p.n_hidden + (CD ? 4 : 3);
  stamp(p.stamps, 0);
  for (int step = 0; step < p.num_steps; ++step) {
    long long ph = 1 + (long long)step * n_phases;
    const EmStep st = em_step(p, step);

    // the bf16 tile the first layer takes, and its bias s w1t + c1
    if (CD) {
      // this step's normals, and [x, y_t]
      cdiffe_inputs(p, step, st.s, row0, xs, xi, y0, tid, EM_CONSUMERS,
                    [&](int rr, int dd, float v) { zt[rr * EM_ZSTRIDE + dd] = __float2bfloat16_rn(v); });
    } else if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      zt[r * EM_ZSTRIDE + d] = __float2bfloat16_rn(xs[r * EM_MAX_XDIM + d]);
    }
    for (int j = tid; j < h1; j += EM_CONSUMERS) bias1[j] = st.s * w1t[j] + c1[j];
    named_sync(1, EM_CONSUMERS);
    if (CD) stamp(p.stamps, ph++);

    EM_DISPATCH(h1 / 2, layer0<NW>(ring, zt, bias1, act));
    fence_async();
    named_sync(1, EM_CONSUMERS);  // also: both warpgroups are done with their W1 tiles
    ring.give(ring.j++);
    stamp(p.stamps, ph++);

    for (int l = 0; l < p.n_hidden; ++l) {
      EM_DISPATCH(p.width[l + 1] / 2, hidden_layer<NW>(ring, act, p.width[l] >> 6, p.bh[l]));
      fence_async();
      named_sync(1, EM_CONSUMERS);
      stamp(p.stamps, ph++);
    }

    output_layer(act, wout, hl >> 7, xdim, opart);
    named_sync(1, EM_CONSUMERS);
    stamp(p.stamps, ph++);

    // integrator update, one thread per (row, coordinate)
    if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      const float a = opart[r * EM_MAX_XDIM + d] + opart[(EM_ROWS + r) * EM_MAX_XDIM + d] + p.bout[d];
      xs[r * EM_MAX_XDIM + d] = em_update<CD>(p, step, r, d, row0 + r, a, xs[r * EM_MAX_XDIM + d], st, xi);
    }
    named_sync(1, EM_CONSUMERS);
    stamp(p.stamps, ph++);
  }

  for (int i = tid; i < EM_ROWS * xdim; i += EM_CONSUMERS) {
    const int rr = i / xdim, dd = i - rr * xdim, row = row0 + rr;
    if (row < p.n) p.out[(size_t)row * xdim + dd] = xs[rr * EM_MAX_XDIM + dd];
  }
}

// ---- The f32-weight mode: em_sampler_f32_kernel (see the note at the top) ----

#define EMF_THREADS 512                 // 16 warps, every one computing
#define EMF_AS (EM_ROWS + 8)            // activation row stride: 64 rows + 8 floats of padding
#define EMF_KQ (EMF_THREADS / EM_ROWS)  // the output layer's K parts

// Float offsets in the block's shared memory.
struct EmF32Layout {
  int act, wout, zt, bias1, opart, xs, xi, y0, floats;
};

__host__ __device__ inline EmF32Layout emf_layout(int h1, int hl, int hmax) {
  EmF32Layout L;
  L.act = 0;                                      // [hmax][EMF_AS]: [unit][row]
  L.wout = L.act + hmax * EMF_AS;                 // [hl] float4: the output layer's x block, xdim padded to 4
  L.zt = L.wout + 4 * hl;                         // [EM_K1][EMF_AS]: the first layer's input, K-major
  L.bias1 = L.zt + EM_K1 * EMF_AS;                // [h1]: s w1t + c1
  L.opart = L.bias1 + h1;                         // [EMF_KQ][EM_ROWS][EM_MAX_XDIM]
  L.xs = L.opart + EMF_KQ * EM_ROWS * EM_MAX_XDIM;  // [EM_ROWS][EM_MAX_XDIM]
  L.xi = L.xs + EM_ROWS * EM_MAX_XDIM;
  L.y0 = L.xi + EM_ROWS * EM_MAX_XDIM;            // [EM_K1]
  L.floats = L.y0 + EM_K1;
  return L;
}

// One layer in split TF32: out[:N] <- tanh(in[:K] . W + b), in and out
// K-major ([unit][row], rows of EMF_AS floats); in place when in == out
// (the hidden layers), from zt into act for layer 0 (K = 8 or 32, its
// input zero-padded).  wp is W (K x N) in B-fragment order
// (ops/mh_kernel.py pack_tf32_b):
// [n-tile pair][k-step][lane] float4 = (W[8 ks + t][16 np + g], W[8 ks + t
// + 4][16 np + g], the same at column 16 np + 8 + g), lane = 4 g + t.  The
// N / 32 column groups of two n-tile pairs go to warps w % (N / 32); the
// 4 m-tiles of rows are cut into parts of MT for the warps w / (N / 32)
// (MT = 4 at N = 512 and 384, where warps 12-15 have no part; 2 at 256; 1
// at 128).  A warp keeps MT x 4 tiles of accumulators.
template <int MT>
__device__ __forceinline__ void f32_layer(const float* in, float* out, const float4* __restrict__ wp,
                                          const float* bias, int K, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = N >> 5, cg = warp % groups, rg = warp / groups;
  const bool active = rg < 4 / MT;
  const int ksteps = K >> 3;
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
  if (active) {
    const size_t pair = (size_t)ksteps * 32;  // float4s of one n-tile pair
    const float4* wq = wp + 2 * cg * pair + lane;
    float4 c0 = __ldg(wq), c1 = __ldg(wq + pair);
    const float* arow = in + t * EMF_AS + 16 * MT * rg + g;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kn = ks + 1 < ksteps ? ks + 1 : ks;  // the next k-step (the last one reloads its own)
      const float4 n0 = __ldg(wq + kn * 32), n1 = __ldg(wq + pair + kn * 32);
      uint32_t bh[4][2], bl[4][2];
      split_tf32(c0.x, bh[0][0], bl[0][0]);
      split_tf32(c0.y, bh[0][1], bl[0][1]);
      split_tf32(c0.z, bh[1][0], bl[1][0]);
      split_tf32(c0.w, bh[1][1], bl[1][1]);
      split_tf32(c1.x, bh[2][0], bl[2][0]);
      split_tf32(c1.y, bh[2][1], bl[2][1]);
      split_tf32(c1.z, bh[3][0], bl[3][0]);
      split_tf32(c1.w, bh[3][1], bl[3][1]);
      const float* ak = arow + ks * 8 * EMF_AS;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ah[4], al[4];
        split_tf32(ak[16 * m], ah[0], al[0]);
        split_tf32(ak[16 * m + 8], ah[1], al[1]);
        split_tf32(ak[4 * EMF_AS + 16 * m], ah[2], al[2]);
        split_tf32(ak[4 * EMF_AS + 16 * m + 8], ah[3], al[3]);
        // a k-step's three products into a fresh tile, the small terms
        // first, then one f32 add into the accumulators
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
  }
  __syncthreads();  // every warp has read the input
  if (active) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 32 * cg + 8 * q + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int row = 16 * (MT * rg + m) + g;
        out[col * EMF_AS + row] = tanhf(acc[m][q][0] + b0);
        out[(col + 1) * EMF_AS + row] = tanhf(acc[m][q][1] + b1);
        out[col * EMF_AS + row + 8] = tanhf(acc[m][q][2] + b0);
        out[(col + 1) * EMF_AS + row + 8] = tanhf(acc[m][q][3] + b1);
      }
    }
  }
  __syncthreads();
}

// The output layer's x block in f32 FMA: thread (r = tid % 64, part q =
// tid / 64) sums act's units [q hl/8, (q + 1) hl/8) of row r against wout
// (a float4 a unit, read at one address across the warp) into opart[q][r].
__device__ __forceinline__ void f32_output_layer(const float* act, const float4* wout, int hl, float* opart) {
  const int r = threadIdx.x & (EM_ROWS - 1), q = threadIdx.x / EM_ROWS;
  const int kn = hl / EMF_KQ;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = q * kn; k < (q + 1) * kn; ++k) {
    const float a = act[k * EMF_AS + r];
    const float4 w = wout[k];
    acc.x = fmaf(a, w.x, acc.x);
    acc.y = fmaf(a, w.y, acc.y);
    acc.z = fmaf(a, w.z, acc.z);
    acc.w = fmaf(a, w.w, acc.w);
  }
  reinterpret_cast<float4*>(opart)[q * EM_ROWS + r] = acc;
}

#define EMF_DISPATCH(n, CALL)                           \
  switch (n) {                                          \
    case 128: { constexpr int MT = 1; CALL; } break;    \
    case 256: { constexpr int MT = 2; CALL; } break;    \
    default: { constexpr int MT = 4; CALL; } break;     \
  }

template <bool CD>
__global__ void __launch_bounds__(EMF_THREADS, 1) em_sampler_f32_kernel(const EmArgs p) {
  extern __shared__ float4 emf_smem[];
  float* sm = reinterpret_cast<float*>(emf_smem);
  const int tid = threadIdx.x;
  const int h1 = p.width[0], hl = p.width[p.n_hidden], xdim = p.xdim;
  const int k1 = ((CD ? xdim + p.ydim : xdim) + 7) & ~7;  // layer 0's K, padded to a k-step
  const int row0 = blockIdx.x * EM_ROWS;
  const EmF32Layout L = emf_layout(h1, hl, p.hmax);

  float* act = sm + L.act;
  float4* wout = reinterpret_cast<float4*>(sm + L.wout);
  float* zt = sm + L.zt;
  float* bias1 = sm + L.bias1;
  float* opart = sm + L.opart;
  float* xs = sm + L.xs;
  float* xi = sm + L.xi;
  float* y0 = sm + L.y0;

  for (int i = tid; i < hl; i += EMF_THREADS) wout[i] = reinterpret_cast<const float4*>(p.wout)[i];
  for (int i = tid; i < EM_K1 * EMF_AS; i += EMF_THREADS) zt[i] = 0.f;
  if (CD && tid < p.ydim) y0[tid] = p.y[tid];
  for (int i = tid; i < EM_ROWS * xdim; i += EMF_THREADS) {
    const int r = i / xdim, d = i - r * xdim, row = row0 + r;
    xs[r * EM_MAX_XDIM + d] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  __syncthreads();

  const int n_phases = p.n_hidden + (CD ? 4 : 3);
  stamp(p.stamps, 0);
  for (int step = 0; step < p.num_steps; ++step) {
    long long ph = 1 + (long long)step * n_phases;
    const EmStep st = em_step(p, step);

    // the first layer's input, f32 and K-major, and its bias s w1t + c1
    if (CD) {
      cdiffe_inputs(p, step, st.s, row0, xs, xi, y0, tid, EMF_THREADS,
                    [&](int rr, int dd, float v) { zt[dd * EMF_AS + rr] = v; });
    } else if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      zt[d * EMF_AS + r] = xs[r * EM_MAX_XDIM + d];
    }
    for (int j = tid; j < h1; j += EMF_THREADS) bias1[j] = st.s * __ldg(p.w1t + j) + __ldg(p.c1 + j);
    __syncthreads();
    if (CD) stamp(p.stamps, ph++);

    EMF_DISPATCH(h1, f32_layer<MT>(zt, act, reinterpret_cast<const float4*>(p.w1), bias1, k1, h1));
    stamp(p.stamps, ph++);

    for (int l = 0; l < p.n_hidden; ++l) {
      EMF_DISPATCH(p.width[l + 1], f32_layer<MT>(act, act, reinterpret_cast<const float4*>(p.wh[l]), p.bh[l],
                                                 p.width[l], p.width[l + 1]));
      stamp(p.stamps, ph++);
    }

    f32_output_layer(act, wout, hl, opart);
    __syncthreads();
    stamp(p.stamps, ph++);

    if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      float a = opart[r * EM_MAX_XDIM + d];
#pragma unroll
      for (int q = 1; q < EMF_KQ; ++q) a += opart[(q * EM_ROWS + r) * EM_MAX_XDIM + d];
      a += p.bout[d];
      xs[r * EM_MAX_XDIM + d] = em_update<CD>(p, step, r, d, row0 + r, a, xs[r * EM_MAX_XDIM + d], st, xi);
    }
    __syncthreads();
    stamp(p.stamps, ph++);
  }

  for (int i = tid; i < EM_ROWS * xdim; i += EMF_THREADS) {
    const int rr = i / xdim, dd = i - rr * xdim, row = row0 + rr;
    if (row < p.n) p.out[(size_t)row * xdim + dd] = xs[rr * EM_MAX_XDIM + dd];
  }
}

// The arguments both entry points take, checked, into p; returns a
// cudaError_t.
static int em_args(EmArgs& p, int cdiffe, const float* x0, const float* y, const float* c1, const float* w1t,
                   const void* w1, const unsigned long long* wh_ptrs, const unsigned long long* bh_ptrs,
                   const int* widths, int n_hidden, const void* wout, const float* bout, const float* noise,
                   float* out, long long* stamps, int n, int xdim, int ydim, int num_steps, float T,
                   float beta_min, float bd, float c_drift, float c_sigma, float delta, float sqrt_delta,
                   float noise_scale, unsigned long long seed) {
  if (n_hidden < 0 || n_hidden > EM_MAX_HIDDEN || xdim < 1 || xdim > EM_MAX_XDIM || n < 1 || num_steps < 1 ||
      ydim < 0 || (cdiffe && (ydim < 1 || xdim + ydim > EM_K1)))
    return (int)cudaErrorInvalidValue;
  p.x0 = x0; p.y = y; p.c1 = c1; p.w1t = w1t; p.w1 = reinterpret_cast<const uint8_t*>(w1);
  int hmax = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    if (widths[l] <= 0 || widths[l] % 128 || widths[l] > EM_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    p.width[l] = widths[l];
    hmax = widths[l] > hmax ? widths[l] : hmax;
  }
  for (int l = 0; l < n_hidden; ++l) {
    p.wh[l] = reinterpret_cast<const uint8_t*>(wh_ptrs[l]);
    p.bh[l] = reinterpret_cast<const float*>(bh_ptrs[l]);
  }
  p.n_hidden = n_hidden;
  p.wout = reinterpret_cast<const uint8_t*>(wout); p.bout = bout; p.noise = noise; p.out = out;
  p.stamps = stamps;
  p.n = n; p.xdim = xdim; p.ydim = ydim; p.num_steps = num_steps; p.hmax = hmax;
  p.T = T; p.beta_min = beta_min; p.bd = bd; p.c_drift = c_drift; p.c_sigma = c_sigma;
  p.delta = delta; p.sqrt_delta = sqrt_delta; p.noise_scale = noise_scale; p.seed = seed;
  return (int)cudaSuccess;
}

template <bool CD>
static int em_f32_start(const EmArgs& p, int blocks, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(em_sampler_f32_kernel<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  em_sampler_f32_kernel<CD><<<blocks, EMF_THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The parameters both entry points take, and their names.
#define EM_PARAMS                                                                                           \
  int cdiffe, const float *x0, const float *y, const float *c1, const float *w1t, const void *w1,                 \
      const unsigned long long *wh_ptrs, const unsigned long long *bh_ptrs, const int *widths, int n_hidden,      \
      const void *wout, const float *bout, const float *noise, float *out, long long *stamps, int n, int xdim,   \
      int ydim, int num_steps, float T, float beta_min, float bd, float c_drift, float c_sigma, float delta,      \
      float sqrt_delta, float noise_scale, unsigned long long seed
#define EM_ARGS                                                                                                  \
  cdiffe, x0, y, c1, w1t, w1, wh_ptrs, bh_ptrs, widths, n_hidden, wout, bout, noise, out, stamps, n, xdim, ydim, \
      num_steps, T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale, seed

// Launch B1 (cdiffe = 0) or B4 (cdiffe = 1) with bf16 weights on `stream`.
// wh_ptrs / bh_ptrs / widths are host arrays of n_hidden, n_hidden and
// n_hidden + 1 entries; every width a multiple of 128, at most 512; xdim +
// ydim <= 32 for B4.  w1, wh and wout as ops/em_kernel.py packs them for
// this mode.  Returns a cudaError_t.
int em_launch(EM_PARAMS, void* stream) {
  EmArgs p;
  const int bad = em_args(p, EM_ARGS);
  if (bad) return bad;
  const EmLayout L = em_layout(widths[0], widths[n_hidden], p.hmax);
  const void* fn = cdiffe ? (const void*)em_sampler_kernel<true> : (const void*)em_sampler_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + EM_ROWS - 1) / EM_ROWS;
  if (cdiffe)
    em_sampler_kernel<true><<<blocks, EM_THREADS, L.bytes, (cudaStream_t)stream>>>(p);
  else
    em_sampler_kernel<false><<<blocks, EM_THREADS, L.bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch B1 or B4 with f32 weights (em_sampler_f32_kernel): the same
// arguments as em_launch, with w1 and wh in split-TF32 B-fragment order,
// w1's K (xdim, or xdim + ydim for B4) zero-padded to a multiple of 8, and
// wout (hl, 4) f32.
int em_f32_launch(EM_PARAMS, void* stream) {
  EmArgs p;
  const int bad = em_args(p, EM_ARGS);
  if (bad) return bad;
  const size_t bytes = sizeof(float) * emf_layout(widths[0], widths[n_hidden], p.hmax).floats;
  const int blocks = (n + EM_ROWS - 1) / EM_ROWS;
  const cudaStream_t st = (cudaStream_t)stream;
  return cdiffe ? em_f32_start<true>(p, blocks, bytes, st) : em_f32_start<false>(p, blocks, bytes, st);
}

}  // extern "C"
