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
// of weights), but the weights do not fit in shared memory, so they stream
// from L2 every step, 1.08 MB a block-step at 512 wide: each weight byte
// carries only 64 MACs, written into and read from shared memory once each.
// With both warpgroups on the products at once, the products waited on the
// ring, and every epilogue (the SFU's tanh) left the tensor cores idle.
// So the two warpgroups take turns on the products, each one's epilogue
// beside the other's products, and one warpgroup alone then draws tiles at
// the tensor cores' rate, which the L2 does not deliver to every SM at once;
// so blocks also run in clusters of EM_CLUSTER = 2 on neighbouring SMs that
// share every weight tile: each block's producer fetches half of it and
// multicasts that half into both blocks' rings, halving the L2 bytes a
// block-step.
//
// Design.  A block owns 64 rows for all steps: 2 consumer warpgroups and a
// producer warpgroup, of which one thread works.  The activations live in
// shared memory as K-major 64 x 64 bf16 slots with the 128-byte swizzle, the
// operand layout wgmma reads.  The wrapper packs every weight the steps read
// into the exact shared-memory image of its ring tiles: the first layer's
// 32 x h1 mma.sync fragments (a half for each warpgroup), then each hidden
// layer's 64-deep K slices of N/2 columns (K-major, swizzled).  The
// producer takes them in the order the consumers do (Ring), moving its
// part of one tile at a time with one 1-D multicast bulk copy into a ring
// of four 32 KB stages in every block of the cluster, completing on each
// block's barrier of the warpgroup that takes the tile, and so runs ahead
// across layers and steps while the consumers compute; a stage is refilled
// once the consumers of every block of the cluster have given it back.  The
// blocks' rows and arithmetic are their own: a launch's samples do not
// depend on the cluster or on the turns.  Warpgroup h computes columns
// [h N/2, (h + 1) N/2) of every layer:
//   layer 0    the bf16 [x] (B1) or [x, y_t] (B4) tile, 64 x 32, times its
//              half of W1 by mma.sync (K = 32), + (s w1t + cy) or (s w1t + b1);
//   hidden     wgmma m64n{N/2}k16 over the ring's slices, bf16 -> f32
//              accumulators in registers, one slice in flight behind the
//              one being issued; warpgroup 1 starts once warpgroup 0's
//              products are done, and each writes its output over its half
//              of act once the other has read those slots of the input
//              (named barriers, hidden_layer);
//   output     wgmma m64n8k16 over half of K each, against the output
//              weights' x block (xdim <= 4 columns, padded to 8), resident
//              in shared memory; the two halves meet in the update.
// Every epilogue adds the bias, applies tanh.approx.f32 (one SFU op; its
// ~2^-11 relative error sits under the bf16 rounding that follows, and
// chip_smoke.py holds the samples against a float64 run of the plain
// version), rounds to bf16 and stores.  Widths are zero-padded to multiples
// of 128 by the wrapper (exact) and are at most 512.  The ragged last block,
// and the block that rounds the grid up to whole clusters, run their missing
// rows on zeros and do not store them.  PERF.md has the phase times and the
// ring's waits.
//
// The f32-weight mode (compute_dtype=float32, as the TPU kernels take it):
// every product's inputs and every activation f32, tanh accurate (tanhf),
// the first layer x . W1x + s w1t + cy (B4: [x, y_t] . W1 + (s w1t + b1)).
// Its bound is the same products in f32, ~94.5 / 96.5 ms at the 67 TFLOP/s
// f32 peak, or ~38.4 / 39.2 ms as three TF32 products at 495 TFLOP/s.
// Plain TF32 and tanh.approx.f32 keep bf16-class accuracy, so every product
// runs in split TF32: each operand split into hi = tf32(v) and lo = v - hi,
// a k-step's three products (lo hi, hi lo, hi hi) into a fresh tile, added
// into f32 accumulators by FADD (the tensor core truncates as it sums, and
// left the whole K it fails B2's float64 witness; tf32.cuh).
// em_sampler_f32_kernel: a block owns 64 rows; four warpgroups split every
// layer's columns in quarters and load their own weight tiles into a ring
// by 1-D bulk copies, so no producer warp costs registers.
//   act       64 rows x hmax f32 activations (128 KB at 512), row-major,
//             8-unit groups XOR-ed with the row; layer 0's input [x] or [x,
//             y_t], zero-padded to K = 8, 16 or 32, sits in its first
//             units and each layer writes its output over its input;
//   weights   split once by the wrapper into hi and lo and packed as the
//             ring's tiles: per k-step (8 rows of W) and column, 64 bytes,
//             hi's 8 then lo's 8, swizzled by 64 bytes (ops/em_kernel.py
//             pack_tf32_tiles); a tile is one warpgroup's quarter of two
//             k-steps (16 KB at 512 wide; layer 0 at K = 8: one k-step),
//             the ring 5 slots, each tile completing on a barrier of its
//             warpgroup's (RingF);
//   products  wgmma m64n64k8 TF32 with A from registers: per k-step each
//             thread loads its fragment from act (two float2: the wrapper
//             orders W's rows in a k-step to match) and splits it; per 64
//             columns three wgmma into a fresh tile, waited for, then added
//             into the accumulators: one warpgroup's adds and waits leave
//             the tensor cores to the other three;
//   epilogue  once every warpgroup has read act: bias, tanhf, stored over
//             it; the output layer (xdim <= 4 columns) is f32 FMA.
// The noise, the update and the stamps are the device functions both modes
// call, so the two draw the same normals for the same seed.  PERF.md has
// its phase times and the ring's waits.
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
#define EM_CLUSTER 2                     // blocks a cluster, each fetching 1/EM_CLUSTER of every ring tile
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
  long long* stamps;   // null, or 1 + (n_hidden + 3 (B1) or 4 (B4)) x num_steps (%globaltimer, clock64) pairs,
                       // then ring-wait cycle counts, 2 a phase (bf16, two blocks' records: em_launch) or 4 (f32)
  int n, xdim, ydim, num_steps, hmax;
  float T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale;
  unsigned long long seed;
  const unsigned long long* seed_ptr;  // null, or the seed on the device, read in place of `seed`
};

// The Philox key: the seed at seed_ptr when the caller gave its address
// (a seed drawn on the device, never copied to the host), else `seed`.
__device__ __forceinline__ uint2 philox_key(const EmArgs& p) {
  const unsigned long long s = p.seed_ptr != nullptr ? __ldg(p.seed_ptr) : p.seed;
  return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

// The card's clock (ns) and this SM's cycle count, as pair i of `stamps`.
__device__ __forceinline__ void stamp_pair(long long* stamps, long long i) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[2 * i] = t;
  stamps[2 * i + 1] = clock64();
}

// With stamps, block 0 reads the clocks when a phase ends.
__device__ __forceinline__ void stamp(long long* stamps, long long i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) stamp_pair(stamps, i);
}

// The bf16 template's stamps: block 0 and the launch's last block (one of
// its last wave) each fill a record, the
// pairs of `stamp` and then, per phase of each step, the cycles each
// consumer warpgroup waited for ring tiles in it.  This block's record, or
// null.
template <bool CD>
__device__ __forceinline__ long long* em_record(const EmArgs& p) {
  if (p.stamps == nullptr) return nullptr;
  if (blockIdx.x == 0) return p.stamps;
  if (blockIdx.x == gridDim.x - 1) return p.stamps + 2 + 4LL * (p.n_hidden + (CD ? 4 : 3)) * p.num_steps;
  return nullptr;
}

// Stamp i of this block's record, the end of phase i (i = 0: the start):
// thread 0 the pair, each warpgroup's first thread its waits since the
// stamp before.
template <bool CD>
__device__ __forceinline__ void stamp_em(const EmArgs& p, long long i, long long* waits) {
  long long* r = em_record<CD>(p);
  if (r == nullptr || (threadIdx.x & 127)) return;
  const int h = threadIdx.x >> 7;
  if (h == 0) stamp_pair(r, i);
  if (i > 0) r[2 + 2LL * (p.n_hidden + (CD ? 4 : 3)) * p.num_steps + 2 * (i - 1) + h] = waits[h];
  waits[h] = 0;
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
  const uint2 key = philox_key(p);
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
      const uint2 key = philox_key(p);
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
  int ring, act, wout, zt, f32, bars, waits, bytes;
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
  L.waits = L.bars + 3 * EM_STAGES * 8;  // with stamps: each consumer warpgroup's ring waits in this phase
  L.bytes = L.waits + 2 * 8 + 1024;      // + slack to align the base
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

// The consumers' view of the ring.  The producer fills the stream's tiles
// in order, tile g into stage g % EM_STAGES: per step the two W1 tiles
// (warpgroup 0's, then 1's), then per hidden layer warpgroup 0's K slices
// and then warpgroup 1's.  A stage's successive tiles may go
// to either warpgroup, so each tile completes on a barrier of the
// warpgroup that takes it, full[h][stage], whose phases are that
// warpgroup's tiles in that stage in order: `parity` holds, bit by stage,
// the parity of the warpgroup's next wait.  `g0` is the stream index of
// the current layer's first tile.  `waits` (a stamped block's, else null)
// holds the cycles each warpgroup's first thread has waited for tiles
// since the last stamp.
struct Ring {
  uint8_t* base;
  uint64_t *full, *empty;  // full [2][EM_STAGES], empty [EM_STAGES]
  long long* waits;
  uint32_t g0, parity;
  // Wait for stream tile g, this warpgroup's; returns its stage.
  __device__ __forceinline__ uint8_t* take(uint32_t g) {
    const uint32_t st = g % EM_STAGES;
    uint64_t* bar = &full[(threadIdx.x >> 7) * EM_STAGES + st];
    if (waits != nullptr) {
      const long long t0 = clock64();
      mbar_wait(bar, (parity >> st) & 1);
      if ((threadIdx.x & 127) == 0) waits[threadIdx.x >> 7] += clock64() - t0;
    } else {
      mbar_wait(bar, (parity >> st) & 1);
    }
    parity ^= 1u << st;
    return base + st * EM_TILE_BYTES;
  }
  // Give tile g's stage back to the producers of every block of the
  // cluster, which all write into it (one thread a warpgroup).
  __device__ __forceinline__ void give(uint32_t g) {
    if ((threadIdx.x & 127) == 0)
      for (uint32_t r = 0; r < EM_CLUSTER; ++r) mbar_arrive_cluster(&empty[g % EM_STAGES], r);
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
  const uint4* w1 = reinterpret_cast<const uint4*>(ring.take(ring.g0 + (threadIdx.x >> 7))) + (threadIdx.x & 31);
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

// The named barriers between the consumer warpgroups (1: all of them;
// 2 + h: warpgroup h's own) that let one warpgroup's epilogue run beside
// the other's products, in turns: warpgroup 1 starts a hidden layer's
// products once warpgroup 0's are done (P0), warpgroup 0 writes its
// epilogue over act once warpgroup 1 has read the slots it overwrites
// (R1), and warpgroup 0 reads warpgroup 1's half of a layer's output once
// it is written (W1).  Each completes once a layer: one warpgroup arrives,
// the other syncs.
#define EM_BAR_P0 4
#define EM_BAR_R1 5
#define EM_BAR_W1 6

// One hidden layer (K = kc_n x 64 -> N = 2 NW) of this warpgroup: the
// products over the ring's tiles into registers, one slice in flight behind
// the one being issued, then the epilogue in place over this warpgroup's
// half of act's N columns.  Warpgroup 0 reads warpgroup 1's half of the
// input (slots kc_n / 2 on) only once it is written, unless a full sync
// came before the layer (`synced`).
template <int NW>
__device__ __forceinline__ void hidden_layer(Ring& ring, uint8_t* act, int kc_n, const float* bias, bool synced) {
  const int h = threadIdx.x >> 7;
  const int overwritten = (NW / 64 < kc_n ? NW / 64 : kc_n) - 1;  // warpgroup 0 overwrites input slots 0..this
  const uint32_t g = ring.g0 + h * kc_n;  // the stream index of this warpgroup's first tile of the layer
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  if (h == 1) named_sync(EM_BAR_P0, EM_CONSUMERS);
  for (int kc = 0; kc < kc_n; ++kc) {
    if (h == 0 && !synced && kc == kc_n / 2) named_sync(EM_BAR_W1, EM_CONSUMERS);
    const uint64_t da = wg_desc(act + kc * EM_SLOT_BYTES);
    const uint64_t db = wg_desc(ring.take(g + kc));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NW>::mma(acc, da + 2 * ks, db + 2 * ks, 1);
    wgmma_commit();
    fence_acc(acc);
    if (kc > 0) {
      wgmma_wait<1>();  // the slice before this one is done: its stage goes back to the producer
      fence_acc(acc);
      ring.give(g + kc - 1);
      if (h == 1 && kc - 1 == overwritten) named_arrive(EM_BAR_R1, EM_CONSUMERS);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring.give(g + kc_n - 1);
  ring.g0 += 2 * kc_n;
  if (h == 1 && kc_n - 1 == overwritten) named_arrive(EM_BAR_R1, EM_CONSUMERS);
  if (h == 0) {
    named_arrive(EM_BAR_P0, EM_CONSUMERS);
    named_sync(EM_BAR_R1, EM_CONSUMERS);
  }
  epilogue<NW>(
      [&](int j, float (&v)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[4 * j + e];
      },
      bias, act);
  fence_async();
  if (h == 1) named_arrive(EM_BAR_W1, EM_CONSUMERS);
  named_sync(2 + h, 128);  // this warpgroup's half of the output is in act for its own products
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

// The producer: every ring tile of every step, in the consumers' order.
// Once a stage is free in every block of the cluster (its `empty` has the
// consumers' arrivals of all EM_CLUSTER blocks), the producer of block r
// bulk-copies part r of the tile's EM_CLUSTER parts into that stage of
// each block, completing on each block's `full`, which expects the whole
// tile: the cluster reads every tile from L2 once.
__device__ __forceinline__ void produce(const EmArgs& p, uint8_t* ring, uint64_t* full, uint64_t* empty) {
  const uint32_t rank = cluster_rank();
  uint32_t g = 0;
  // tile g for warpgroup h
  auto put = [&](const uint8_t* src, uint32_t bytes, int h) {
    const uint32_t st = g % EM_STAGES, part = bytes / EM_CLUSTER;
    uint64_t* bar = &full[h * EM_STAGES + st];
    mbar_wait(&empty[st], ((g / EM_STAGES) & 1) ^ 1);
    mbar_expect_tx(bar, bytes);
    bulk_copy_multicast(ring + st * EM_TILE_BYTES + rank * part, src + rank * part, part, bar,
                        (1u << EM_CLUSTER) - 1);
    ++g;
  };
  const uint32_t w1_bytes = (uint32_t)p.width[0] * 32;  // half of (32, h1) bf16
  for (int step = 0; step < p.num_steps; ++step) {
    put(p.w1, w1_bytes, 0);
    put(p.w1 + w1_bytes, w1_bytes, 1);
    for (int l = 0; l < p.n_hidden; ++l) {
      const uint32_t bytes = (uint32_t)p.width[l + 1] * 64;  // N/2 columns x 128 bytes
      const int kc_n = p.width[l] >> 6;  // the packed tiles are [kc][h]
      for (int h = 0; h < 2; ++h)
        for (int kc = 0; kc < kc_n; ++kc) put(p.wh[l] + (size_t)(2 * kc + h) * bytes, bytes, h);
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
  uint64_t* empty = full + 2 * EM_STAGES;
  long long* waits = em_record<CD>(p) != nullptr ? reinterpret_cast<long long*>(sm + L.waits) : nullptr;

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
      mbar_init(&full[EM_STAGES + s], 1);
      mbar_init(&empty[s], EM_CLUSTER);
    }
    mbar_init_fence();
  }
  if (waits != nullptr && tid < 2) waits[tid] = 0;
  fence_async();  // wout, written above, is read by wgmma
  cluster_sync();  // every block's barriers are set before any block's producer copies into them

  // the producer's warpgroup gives its registers to the consumers: 2 x 128
  // x 232 + 128 x 40 of the SM's 65536
  if (tid >= EM_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == EM_CONSUMERS) produce(p, sm + L.ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  Ring ring{sm + L.ring, full, empty, waits, 0u, 0u};
  const int n_phases = p.n_hidden + (CD ? 4 : 3);
  stamp_em<CD>(p, 0, waits);
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
    if (CD) stamp_em<CD>(p, ph++, waits);

    EM_DISPATCH(h1 / 2, layer0<NW>(ring, zt, bias1, act));
    fence_async();
    named_sync(1, EM_CONSUMERS);  // also: both warpgroups are done with their W1 tiles
    ring.give(ring.g0 + (tid >> 7));
    ring.g0 += 2;
    stamp_em<CD>(p, ph++, waits);

    // each hidden layer's stamp at warpgroup 0's end of it
    for (int l = 0; l < p.n_hidden; ++l) {
      EM_DISPATCH(p.width[l + 1] / 2, hidden_layer<NW>(ring, act, p.width[l] >> 6, p.bh[l], l == 0));
      stamp_em<CD>(p, ph++, waits);
    }
    // the output layer reads this warpgroup's own half of act; warpgroup 0
    // then takes the last layer's W1 all the same, so the barrier completes
    // once a layer
    output_layer(act, wout, hl >> 7, xdim, opart);
    if (p.n_hidden > 0 && tid < 128) named_sync(EM_BAR_W1, EM_CONSUMERS);
    named_sync(1, EM_CONSUMERS);
    stamp_em<CD>(p, ph++, waits);

    // integrator update, one thread per (row, coordinate)
    if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      const float a = opart[r * EM_MAX_XDIM + d] + opart[(EM_ROWS + r) * EM_MAX_XDIM + d] + p.bout[d];
      xs[r * EM_MAX_XDIM + d] = em_update<CD>(p, step, r, d, row0 + r, a, xs[r * EM_MAX_XDIM + d], st, xi);
    }
    named_sync(1, EM_CONSUMERS);
    stamp_em<CD>(p, ph++, waits);
  }

  for (int i = tid; i < EM_ROWS * xdim; i += EM_CONSUMERS) {
    const int rr = i / xdim, dd = i - rr * xdim, row = row0 + rr;
    if (row < p.n) p.out[(size_t)row * xdim + dd] = xs[rr * EM_MAX_XDIM + dd];
  }
  cluster_sync();  // the other blocks' consumers have made their last arrivals on this block's barriers
}

// ---- The f32-weight mode: em_sampler_f32_kernel (see the note at the top) ----

// Four warpgroups and no producer: sixteen warps, four on each of the SM's
// schedulers, to hide the wait of every fresh tile (two leave the tensor
// cores idle a third of the time), at 128 registers a thread.  A ninth
// warp on top of eight would cut a thread's registers to 168 (a scheduler
// holding three warps), and setmaxnreg does not raise what ptxas allocates.
#define EMF_WG 4
#define EMF_THREADS (128 * EMF_WG)
#define EMF_KPT 2                        // k-steps a ring tile (layer 0 at K = 8: one)
#define EMF_SLOT 16384                   // a ring slot: one tile, up to 128 columns x 16 K x (hi, lo) f32
#define EMF_STAGES 5                     // the slots 512-wide activations leave room for
#define EMF_KQ 8                         // the output layer's K parts, on neighbouring lanes
#define EMF_CURSOR_BYTES 48              // a warpgroup's TileCursor

// Byte offsets in the block's shared memory (from a 1024-byte boundary).
struct EmF32Layout {
  int act, bias1, oa, xs, xi, y0, bars, ring, bytes;
};

__host__ __device__ inline EmF32Layout emf_layout(int h1, int hmax) {
  EmF32Layout L;
  L.act = 0;                                      // [EM_ROWS][hmax] f32, row-major, swizzled (act_f32)
  L.bias1 = L.act + EM_ROWS * hmax * 4;           // [h1]: s w1t + c1
  L.oa = L.bias1 + h1 * 4;                        // [EM_ROWS][EM_MAX_XDIM]: the output layer's sums
  L.xs = L.oa + EM_ROWS * EM_MAX_XDIM * 4;        // [EM_ROWS][EM_MAX_XDIM]
  L.xi = L.xs + EM_ROWS * EM_MAX_XDIM * 4;
  L.y0 = L.xi + EM_ROWS * EM_MAX_XDIM * 4;        // [EM_K1]
  L.bars = L.y0 + EM_K1 * 4;                      // full [EMF_WG][EMF_STAGES], then TileCursor [EMF_WG]
  L.ring = (L.bars + EMF_WG * EMF_STAGES * 8 + EMF_WG * EMF_CURSOR_BYTES + 1023) & ~1023;
  L.bytes = L.ring + EMF_STAGES * EMF_SLOT + 1024;  // + slack to align the base
  return L;
}

// act's element (r, c): rows of hmax floats, 8-unit groups XOR-ed with r %
// 8, so a warp's A-fragment loads and epilogue stores (float2 each) hit 32
// banks per half-warp.
__device__ __forceinline__ int act_f32(int r, int c, int hmax) { return r * hmax + (c ^ ((r & 7) << 3)); }

// A position in the stream of ring tiles: per step, per layer (0: the
// first, l: hidden l - 1), per tile of the layer, one tile a warpgroup, its
// quarter of the layer's columns over two k-steps (layer 0 at K = 8: one).
// A layer's weights are packed as [tile][quarter h][k-step of the
// tile][column of the quarter][16 floats] (ops/em_kernel.py
// pack_tf32_tiles); the cursor keeps its layer's base, quarter width,
// k-steps a tile and tile count.  Each warpgroup's lies in shared memory,
// kept by its first thread.
struct TileCursor {
  const uint8_t* w;
  int step, layer, kp, nw, kpt, tiles, k0;
  long long waited;  // block 0, with stamps: cycles the warpgroup waited for tiles in this phase
  __device__ __forceinline__ void set_layer(const EmArgs& p) {
    w = layer == 0 ? p.w1 : p.wh[layer - 1];
    nw = p.width[layer] / EMF_WG;
    const int ksteps = (layer == 0 ? k0 : p.width[layer - 1]) / 8;
    kpt = ksteps < EMF_KPT ? ksteps : EMF_KPT;
    tiles = ksteps / kpt;
  }
  // At the stream's start, `n` tiles of this warpgroup's on.
  __device__ __forceinline__ void reset(const EmArgs& p, int k0_, int n) {
    step = layer = kp = 0;
    k0 = k0_;
    waited = 0;
    set_layer(p);
    for (int i = 0; i < n; ++i) advance(p);
  }
  __device__ __forceinline__ void advance(const EmArgs& p) {
    if (++kp < tiles) return;
    kp = 0;
    if (++layer > p.n_hidden) {
      layer = 0;
      ++step;
    }
    set_layer(p);
  }
  // Warpgroup h's tile here into `slot` by one bulk copy, completing on `bar`.
  __device__ __forceinline__ void load(int h, uint8_t* slot, uint64_t* bar) const {
    const uint32_t bytes = nw * 64 * kpt;
    mbar_expect_tx(bar, bytes);
    bulk_copy(slot, w + (size_t)(EMF_WG * kp + h) * bytes, bytes, bar);
  }
};

static_assert(sizeof(TileCursor) <= EMF_CURSOR_BYTES, "the layout's room for a cursor");

// The f32 ring: tile g of the stream (warpgroup g % 4's at its tile g / 4)
// sits in slot g % EMF_STAGES.  Warpgroup h takes tiles 4 j + h; once its
// four warps are done with one, its first thread loads tile g + EMF_STAGES
// (warpgroup (h + EMF_STAGES) % 4's) into that slot.  A slot's loads are
// thus in stream order, each after the one before was consumed, but its
// successive tiles go to different warpgroups, which drift apart: a barrier
// a slot, waited for by parity, would let a warpgroup that runs ahead
// match the phase before its tile's.  So tile g completes on barrier
// (g % 4, g % EMF_STAGES), whose phases are the tiles of one warpgroup in
// one slot, g, g + 20, g + 40, ...: that warpgroup waits for them in order,
// and the next cannot be loaded until it has consumed this one, so phase
// g / 20 is the barrier's current or last phase and its parity names it.
// `waits` (block 0's, each warpgroup's first thread, with stamps) counts
// the cycles the warpgroup spends waiting for tiles.
struct RingF {
  uint8_t* base;
  uint64_t* full;  // [EMF_WG][EMF_STAGES], then the warpgroups' cursors
  uint32_t taken;
  long long* waits;
  __device__ __forceinline__ uint32_t g(uint32_t jj) const { return EMF_WG * jj + (threadIdx.x >> 7); }
  __device__ __forceinline__ uint8_t* slot(uint32_t gg) const { return base + (gg % EMF_STAGES) * EMF_SLOT; }
  __device__ __forceinline__ uint64_t* bar(uint32_t gg) const {
    return full + (gg % EMF_WG) * EMF_STAGES + gg % EMF_STAGES;
  }
  __device__ __forceinline__ TileCursor& cursor() const {
    return reinterpret_cast<TileCursor*>(full + EMF_WG * EMF_STAGES)[threadIdx.x >> 7];
  }
  // The warpgroup's first thread loads its own tiles among the stream's
  // first EMF_STAGES, and places its cursor at its first refill, tile h +
  // EMF_STAGES.
  __device__ __forceinline__ void start(const EmArgs& p, int k0) {
    if (threadIdx.x & 127) return;
    const int h = threadIdx.x >> 7;
    TileCursor& c = cursor();
    c.reset(p, k0, 0);
    for (int gg = h; gg < EMF_STAGES && c.step < p.num_steps; gg += EMF_WG) {
      c.load(h, slot(gg), bar(gg));
      c.advance(p);
    }
    c.reset(p, k0, (h + EMF_STAGES) / EMF_WG);
  }
  // Wait for this warpgroup's next tile; returns its slot.
  __device__ __forceinline__ uint8_t* take() {
    const uint32_t gg = g(taken++), parity = (gg / (EMF_WG * EMF_STAGES)) & 1;
    if (waits != nullptr) {
      const long long t0 = clock64();
      mbar_wait(bar(gg), parity);
      cursor().waited += clock64() - t0;
    } else {
      mbar_wait(bar(gg), parity);
    }
    return slot(gg);
  }
  // This warp is done with the tile it took last: once the warpgroup's
  // other warps are too, its slot takes the tile EMF_STAGES on.
  __device__ __forceinline__ void give(const EmArgs& p) {
    const uint32_t gg = g(taken - 1) + EMF_STAGES;
    named_sync(2 + (threadIdx.x >> 7), 128);
    if ((threadIdx.x & 127) == 0) {
      TileCursor& c = cursor();
      if (c.step < p.num_steps) {
#ifdef EMF_SKEW_NS
        // a test build: one warpgroup at a time, turn by turn, refills late
        // while the others run ahead (tests/test_torch_cuda.py)
        if ((gg >> 5) % EMF_WG == (threadIdx.x >> 7)) __nanosleep(EMF_SKEW_NS);
#endif
        c.load((int)(gg % EMF_WG), slot(gg), bar(gg));
        c.advance(p);
      }
    }
  }
};

// One layer of a consumer warpgroup in split TF32: its NW columns [h NW,
// (h + 1) NW) of tanh(act[:, :K] . W + b) over K / 8 k-steps, written over
// act once every warpgroup has read it.  Per k-step, each thread loads its
// A fragment (rows 16 w + g and + 8, units 8 ks + 2 t and + 1) from act as
// two float2 and splits it into hi and lo; the ring's tile holds two
// k-steps' weights for the NW columns, hi and lo.  The columns go by fresh
// tiles of CW: three wgmma (lo hi, hi lo, hi hi) into a fresh tile, then,
// once it is done, its FADD into the f32 accumulators.  (Overlapping a
// tile's adds with the next tile's products makes ptxas serialize every
// wgmma; the other three warpgroups fill the tensor cores instead.)
template <int NW>
struct F32Layer {
  static constexpr int CW = NW % 64 ? 32 : 64, NC = NW / CW, R = CW / 2;
  float acc[NC][R];
  float fresh[R];
  uint32_t a[2][4];  // [hi, lo][fragment]
  const float *row0, *row1;
  int sw, t;

  __device__ __forceinline__ F32Layer(const float* act, int hmax) {
    const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    t = lane & 3;
    sw = (r0 & 7) << 3;  // rows r0 and r0 + 8 share it
    row0 = act + r0 * hmax;
    row1 = row0 + 8 * hmax;
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c][i] = 0.f;
      fresh[i] = 0.f;
    }
  }

  // K-step ks, its weights (NW columns) at w.
  __device__ __forceinline__ void kstep(int ks, const uint8_t* w) {
    const int k = ((8 * ks) ^ sw) + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(row0 + k);
    const float2 x1 = *reinterpret_cast<const float2*>(row1 + k);
    // fragment [0], [1]: units 8 ks + 2 t (the product's k = t); [2], [3]:
    // 8 ks + 2 t + 1 (k = t + 4), as the wrapper orders W's rows in a k-step
    split_tf32(x0.x, a[0][0], a[1][0]);
    split_tf32(x1.x, a[0][1], a[1][1]);
    split_tf32(x0.y, a[0][2], a[1][2]);
    split_tf32(x1.y, a[0][3], a[1][3]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db = wg_desc64(w + c * CW * 64);  // hi at +0, lo 32 bytes on (+2)
      wgmma_fence();
      WgmmaTf32<CW>::mma(fresh, a[1], db, 0);      // lo . hi
      WgmmaTf32<CW>::mma(fresh, a[0], db + 2, 1);  // hi . lo
      WgmmaTf32<CW>::mma(fresh, a[0], db, 1);      // hi . hi
      wgmma_commit();
      wgmma_wait<0>();
      // the adds end in fence_acc, so the compiler keeps them out of the
      // next tile's wgmma pipeline stage
      fence_acc(fresh);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[c][i] += fresh[i];
      fence_acc(acc[c]);
    }
  }
};

// KPT: the layer's k-steps a tile, EMF_KPT or (layer 0 at K = 8) one.
template <int NW, int KPT>
__device__ __forceinline__ void f32_layer(RingF& ring, const EmArgs& p, float* act, int hmax, int ksteps,
                                          const float* bias) {
  using Layer = F32Layer<NW>;
  Layer L(act, hmax);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ks += KPT) {
    const uint8_t* tile = ring.take();
#pragma unroll
    for (int s = 0; s < KPT; ++s) L.kstep(ks + s, tile + s * NW * 64);
    ring.give(p);
  }
  named_sync(1, EMF_THREADS);  // every warpgroup has read act
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = (threadIdx.x >> 7) * NW + 2 * (lane & 3);
#pragma unroll
  for (int cc = 0; cc < Layer::NC; ++cc) {
#pragma unroll
    for (int j = 0; j < Layer::CW / 8; ++j) {
      const int c = c0 + cc * Layer::CW + 8 * j;
      const float2 b = *reinterpret_cast<const float2*>(bias + c);
      const float v0 = L.acc[cc][4 * j], v1 = L.acc[cc][4 * j + 1], v2 = L.acc[cc][4 * j + 2],
                  v3 = L.acc[cc][4 * j + 3];
      *reinterpret_cast<float2*>(act + act_f32(r0, c, hmax)) = make_float2(tanhf(v0 + b.x), tanhf(v1 + b.y));
      *reinterpret_cast<float2*>(act + act_f32(r0 + 8, c, hmax)) = make_float2(tanhf(v2 + b.x), tanhf(v3 + b.y));
    }
  }
  named_sync(1, EMF_THREADS);  // the layer's output is in act
}

#define EMF_DISPATCH(nw, CALL)                        \
  switch (nw) {                                       \
    case 32: { constexpr int NW = 32; CALL; } break;  \
    case 64: { constexpr int NW = 64; CALL; } break;  \
    case 96: { constexpr int NW = 96; CALL; } break;  \
    default: { constexpr int NW = 128; CALL; } break; \
  }

// The output layer's x block in f32 FMA: thread (row r = tid / 8, part q =
// tid % 8) sums act's units q, q + 8, ... of row r against the output
// weights (a float4 a unit, from global memory through L1: a warp's eight
// parts read 128 consecutive bytes); the row's eight parts, on neighbouring
// lanes, meet by shuffles, and part 0 writes the row's sums to oa.
__device__ __forceinline__ void f32_output_layer(const float* act, int hmax, const float4* __restrict__ wout, int hl,
                                                 float* oa) {
  const int r = threadIdx.x >> 3, q = threadIdx.x & (EMF_KQ - 1), sw = (r & 7) << 3;
  const float* row = act + r * hmax;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = q; k < hl; k += EMF_KQ) {
    const float a = row[k ^ sw];
    const float4 w = __ldg(wout + k);
    acc.x = fmaf(a, w.x, acc.x);
    acc.y = fmaf(a, w.y, acc.y);
    acc.z = fmaf(a, w.z, acc.z);
    acc.w = fmaf(a, w.w, acc.w);
  }
#pragma unroll
  for (int m = 1; m < EMF_KQ; m <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
  }
  if (q == 0) reinterpret_cast<float4*>(oa)[r] = acc;
}

// A stamp of the f32 template: the phase's end, and the cycles each
// warpgroup of block 0 waited for ring tiles during the phase.
__device__ __forceinline__ void stamp_f32(const EmArgs& p, long long i, RingF& ring) {
  stamp(p.stamps, i);
  if (ring.waits != nullptr) {
    ring.waits[EMF_WG * (i - 1) + (threadIdx.x >> 7)] = ring.cursor().waited;
    ring.cursor().waited = 0;
  }
}

template <bool CD>
__global__ void __launch_bounds__(EMF_THREADS, 1) em_sampler_f32_kernel(const EmArgs p) {
  extern __shared__ uint8_t emf_smem[];
  uint8_t* sm = emf_smem + ((1024 - (smem_u32(emf_smem) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int h1 = p.width[0], hl = p.width[p.n_hidden], xdim = p.xdim, hmax = p.hmax;
  const int d0 = CD ? xdim + p.ydim : xdim;  // layer 0's input width,
  const int k0 = d0 <= 8 ? 8 : (d0 + 15) / 16 * 16;  // zero-padded to one k-step or to whole tiles of two
  const int row0 = blockIdx.x * EM_ROWS;
  const EmF32Layout L = emf_layout(h1, hmax);

  float* act = reinterpret_cast<float*>(sm + L.act);
  float* bias1 = reinterpret_cast<float*>(sm + L.bias1);
  float* oa = reinterpret_cast<float*>(sm + L.oa);
  float* xs = reinterpret_cast<float*>(sm + L.xs);
  float* xi = reinterpret_cast<float*>(sm + L.xi);
  float* y0 = reinterpret_cast<float*>(sm + L.y0);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);

  if (CD && tid < p.ydim) y0[tid] = p.y[tid];
  for (int i = tid; i < EM_ROWS * xdim; i += EMF_THREADS) {
    const int r = i / xdim, d = i - r * xdim, row = row0 + r;
    xs[r * EM_MAX_XDIM + d] = row < p.n ? p.x0[(size_t)row * xdim + d] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < EMF_WG * EMF_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int n_phases = p.n_hidden + (CD ? 4 : 3);
  const bool timed = p.stamps != nullptr && blockIdx.x == 0 && (tid & 127) == 0;
  RingF ring{sm + L.ring, full, 0u, timed ? p.stamps + 2 * (1 + (long long)n_phases * p.num_steps) : nullptr};
  ring.start(p, k0);
  stamp(p.stamps, 0);
  for (int step = 0; step < p.num_steps; ++step) {
    long long ph = 1 + (long long)step * n_phases;
    const EmStep st = em_step(p, step);

    // the first layer's input [x] or [x, y_t], zero-padded to k0 units, in
    // act's first units, and its bias s w1t + c1
    if (CD)
      cdiffe_inputs(p, step, st.s, row0, xs, xi, y0, tid, EMF_THREADS,
                    [&](int rr, int dd, float v) { act[act_f32(rr, dd, hmax)] = v; });
    for (int i = tid; i < EM_ROWS * k0; i += EMF_THREADS) {
      const int r = i / k0, d = i - r * k0;
      if (d >= d0)
        act[act_f32(r, d, hmax)] = 0.f;
      else if (!CD)
        act[act_f32(r, d, hmax)] = xs[r * EM_MAX_XDIM + d];
    }
    for (int j = tid; j < h1; j += EMF_THREADS) bias1[j] = st.s * __ldg(p.w1t + j) + __ldg(p.c1 + j);
    named_sync(1, EMF_THREADS);
    if (CD) stamp_f32(p, ph++, ring);

    if (k0 == 8) {
      EMF_DISPATCH(h1 / EMF_WG, (f32_layer<NW, 1>(ring, p, act, hmax, 1, bias1)));
    } else {
      EMF_DISPATCH(h1 / EMF_WG, (f32_layer<NW, EMF_KPT>(ring, p, act, hmax, k0 >> 3, bias1)));
    }
    stamp_f32(p, ph++, ring);

    for (int l = 0; l < p.n_hidden; ++l) {
      EMF_DISPATCH(p.width[l + 1] / EMF_WG,
                   (f32_layer<NW, EMF_KPT>(ring, p, act, hmax, p.width[l] >> 3, p.bh[l])));
      stamp_f32(p, ph++, ring);
    }

    f32_output_layer(act, hmax, reinterpret_cast<const float4*>(p.wout), hl, oa);
    named_sync(1, EMF_THREADS);
    stamp_f32(p, ph++, ring);

    if (tid < EM_ROWS * xdim) {
      const int r = tid / xdim, d = tid - r * xdim;
      const float a = oa[r * EM_MAX_XDIM + d] + p.bout[d];
      xs[r * EM_MAX_XDIM + d] = em_update<CD>(p, step, r, d, row0 + r, a, xs[r * EM_MAX_XDIM + d], st, xi);
    }
    named_sync(1, EMF_THREADS);
    stamp_f32(p, ph++, ring);
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
                   float noise_scale, unsigned long long seed, const unsigned long long* seed_ptr) {
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
  p.seed_ptr = seed_ptr;
  return (int)cudaSuccess;
}

// The bf16 template's launch: `blocks` rounded up to whole clusters of
// EM_CLUSTER (a block past the rows runs on zeros and stores nothing), its
// shared memory allowed.
static cudaError_t em_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster, int cdiffe, const int* widths,
                             int n_hidden, int blocks, cudaStream_t stream) {
  int hmax = 0;
  for (int l = 0; l <= n_hidden; ++l) hmax = widths[l] > hmax ? widths[l] : hmax;
  const EmLayout L = em_layout(widths[0], widths[n_hidden], hmax);
  const void* fn = cdiffe ? (const void*)em_sampler_kernel<true> : (const void*)em_sampler_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = EM_CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((blocks + EM_CLUSTER - 1) / EM_CLUSTER * EM_CLUSTER);
  cfg.blockDim = dim3(EM_THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaSuccess;
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
      float sqrt_delta, float noise_scale, unsigned long long seed, const unsigned long long *seed_ptr
#define EM_ARGS                                                                                                  \
  cdiffe, x0, y, c1, w1t, w1, wh_ptrs, bh_ptrs, widths, n_hidden, wout, bout, noise, out, stamps, n, xdim, ydim, \
      num_steps, T, beta_min, bd, c_drift, c_sigma, delta, sqrt_delta, noise_scale, seed, seed_ptr

// Launch B1 (cdiffe = 0) or B4 (cdiffe = 1) with bf16 weights on `stream`.
// wh_ptrs / bh_ptrs / widths are host arrays of n_hidden, n_hidden and
// n_hidden + 1 entries; every width a multiple of 128, at most 512; xdim +
// ydim <= 32 for B4.  w1, wh and wout as ops/em_kernel.py packs them for
// this mode.  seed_ptr: null, or the address of the seed on the device,
// which the kernel reads in place of `seed`.  stamps: null, or two records
// (block 0's, then the launch's last block's), each the pairs followed by 2
// x P x num_steps entries (P phases a step): the cycles each consumer
// warpgroup waited for ring tiles in each phase of each step,
// [step][phase][warpgroup].  Launches clusters of EM_CLUSTER blocks.
// Returns a cudaError_t.
int em_launch(EM_PARAMS, void* stream) {
  EmArgs p;
  const int bad = em_args(p, EM_ARGS);
  if (bad) return bad;
  const int blocks = (n + EM_ROWS - 1) / EM_ROWS;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  const cudaError_t err = em_config(cfg, cluster, cdiffe, widths, n_hidden, blocks, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)(cdiffe ? cudaLaunchKernelEx(&cfg, em_sampler_kernel<true>, p)
                      : cudaLaunchKernelEx(&cfg, em_sampler_kernel<false>, p));
}

// The most clusters of B1 (cdiffe = 0) or B4 (cdiffe = 1) with bf16
// weights at these widths that the card holds at once, into *clusters.
// Returns a cudaError_t.
int em_max_active_clusters(int cdiffe, const int* widths, int n_hidden, int* clusters) {
  if (n_hidden < 0 || n_hidden > EM_MAX_HIDDEN) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  const cudaError_t err = em_config(cfg, cluster, cdiffe, widths, n_hidden, EM_CLUSTER, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, cdiffe ? (const void*)em_sampler_kernel<true> : (const void*)em_sampler_kernel<false>, &cfg);
}

// Launch B1 or B4 with f32 weights (em_sampler_f32_kernel): the same
// arguments as em_launch, with w1 and wh split into TF32 hi and lo and
// packed as the ring's tiles (ops/em_kernel.py pack_tf32_tiles), w1's K
// (xdim, or xdim + ydim for B4) zero-padded to 8 or else to a multiple of
// 16, and wout (hl, 4) f32.  stamps: null, or the pairs followed by 4 x P x
// num_steps entries (P phases a step, in the stamps' order): the cycles
// each warpgroup of block 0 waited for ring tiles in each phase of each
// step, [step][phase][warpgroup].
int em_f32_launch(EM_PARAMS, void* stream) {
  EmArgs p;
  const int bad = em_args(p, EM_ARGS);
  if (bad) return bad;
  const size_t bytes = emf_layout(widths[0], p.hmax).bytes;
  const int blocks = (n + EM_ROWS - 1) / EM_ROWS;
  const cudaStream_t st = (cudaStream_t)stream;
  return cdiffe ? em_f32_start<true>(p, blocks, bytes, st) : em_f32_start<false>(p, blocks, bytes, st);
}

}  // extern "C"
