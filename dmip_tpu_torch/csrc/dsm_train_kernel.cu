// Fused DSM training epochs for a tanh MLP: forward, loss, hand-written
// backward, skip-nonfinite guard and Adam, n_epochs x n_batches steps in one
// launch.
//
// Replaces the Pallas TPU kernel dmip_tpu/ops/dsm_train_kernel.py ::
// fused_dsm_train_epochs (_dsm_train_kernel, pallas_call at :283).  Per step,
// on the step's rows h0 (B, in), eps and s1 (B, out):
//   a_k   = tanh(a_{k-1} . W_k + b_k)                  (a_0 = h0)
//   out   = a_{L-1} . W_L + b_L,  r = out s1 + eps,  loss = 1/2 sum r^2 / B_real
//   dz    = r (s1 / B_real);  per layer from the top:
//   dW_k  = a_{k-1}^T dz,  db_k = sum_rows dz,  dz <- (dz . W_k^T) (1 - a_{k-1}^2)
//   guard: skip the step if any gradient (or, under 'loss', the loss) is not
//   finite, or the epoch is >= n_active; else optax Adam with
//   bc = 1 - exp(count log b) on every tensor.
// With bf16 compute both operands of every product are rounded to bf16 and
// summed in f32; biases, db, the loss, dz's tanh factor and Adam stay f32.
//
// What bounds it on an H100.  Per step at batch 1000 on the 512x3 net the
// products are ~3.2 GFLOP (forward, dW for every layer, da below the top):
// ~3.2 us at the 989 TFLOP/s bf16 peak, and bytes are negligible.  But the
// steps form one serial chain (each step needs the previous step's weights,
// each layer the one before), and a 1000 x 512 product is only 128 64x64
// tiles, one wave of the card.  So the floor is the chain of dependent
// phases: per phase the L2 latency of a tile's first operands, its K chunks,
// the epilogue and one grid sync, ~10-17 us each on an H100 (chip_smoke.py's
// phase split), far above the operation bound.
//
// Design.  One persistent cooperative launch (all blocks co-resident, a grid
// sync between dependent phases) loops over every step.  The wrapper pads
// every hidden and output width to a multiple of 64 with zeros (exact: a
// padded unit has zero weights in and out, so its activation, its dz, its
// gradient and its Adam update are all 0); h0, eps and s1 keep their widths
// and are read with ordinary loads at the edge, and rows past the batch are
// masked.  The phases of a step, for L >= 2 and out <= 64 (`fused_out`):
//   forward k      k = 0 .. L-2: a_{k+1} = tanh(a_k W_k + b_k) tiles
//   forward L-1+da tile (mt, g) computes the output tile of rows mt (every
//                  g the same one, in the same order: g = 0 keeps its loss
//                  partial, dz and db's partials), then from dz in shared
//                  memory the da tile (mt, g) of backward layer L-1:
//                  dz_{L-2} = (dz W_{L-1}^T)(1 - a_{L-2}^2)
//   backward k     k = L-2 .. 1: dz_{k-1} tiles beside dW_k tiles (and, in
//                  the first of these phases, dW_{L-1}'s); the dz_{k-1}
//                  epilogue forms db_{k-1}'s per-tile partials and, for
//                  k = 1, dW_0's per-tile partials from h0
//   adam           sums every gradient's partials in a fixed order, checks
//                  them, and writes the candidate state (p, m, v and the
//                  operand copies) into the other half of a double buffer
// That is 2L - 1 grid syncs a step: 7 for L = 4 (with out > 64 the output
// layer's phase keeps no da tiles, and a backward phase L-1 runs: 2L; with
// L = 1 there are 2).  After the adam sync every block reads the step's
// flag (a non-finite gradient, the loss, the epoch mask) and flips to the
// candidate half only if the step is taken: the guard stays exact without a
// sync between the reduction and the update.  A weight gradient's tile
// contracts over the whole batch: cut into slices (split-K) it was slower at
// batch 1000, since a backward phase already waits for its da tiles.
//
// Operands.  Every product reads K-major copies in the compute type, written
// once where their values are made: Adam writes W_k and W_k^T, the forward
// epilogues a_k (f32 for the tanh factor, and row-major and transposed
// copies), the backward epilogues dz (row-major and transposed).  A tile
// streams 64-deep K chunks of both operands through a 5-stage ring in dynamic
// shared memory, filled by 16-byte cp.async.cg copies (L1 bypassed, so no
// block reads a stale line after a grid sync) with the 128-byte swizzle, and
// each of the block's two warpgroups multiplies them with wgmma.m64n32k16
// bf16 -> f32 (faster here than mma.sync.m16n8k16); f32 compute runs FMA
// from the same ring.  The next step's rows are prefetched into L2 during
// Adam.
//
// Code.  A step runs once through most of the kernel's code, so instruction
// fetch, not arithmetic, sets much of a phase's time: every sizeable device
// function stays out of line (one copy), loops stay rolled but for the few
// loads a thread issues together, and the arguments live in shared memory.
// Every sum whose order matters (the loss, db, dW_0's partials) runs in a
// fixed order and there are no float atomics, so a launch is
// deterministic.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

#define DT_MAX_LAYERS 10
#define DT_THREADS 256             // 8 warps: warp w computes rows 16 (w % 4) .., columns 32 (w / 4) ..
#define DT_NJ 4                    // 8-column blocks of a warp's accumulator
#define DT_T 64                    // tile rows, tile columns and K chunk depth
#define DT_RS (DT_THREADS / DT_T)  // row stride when each thread walks one column
#define DT_NE (DT_T * DT_T / DT_THREADS)  // entries of a 64x64 tile per thread
#define DT_LB 4                    // loads a thread issues together in an epilogue
#define DT_STAGES 5                // ring depth
#define DT_CP 65                   // row pitch (floats) of the f32 staging tiles

struct DsmArgs {
  // state, double-buffered: half `cur` is the state, the other the candidate
  float *p, *m, *v;        // [2][n_flat]: W_0, b_0, W_1, b_1, ... (W row-major, padded)
  void *wt, *wr;           // compute type: [2][wt_total] W_k^T, [2][wr_total] W_k (k >= 1)
  long long n_flat, wt_total, wr_total;
  long long w_off[DT_MAX_LAYERS], b_off[DT_MAX_LAYERS];
  long long wt_off[DT_MAX_LAYERS], wr_off[DT_MAX_LAYERS];
  long long pw_off[DT_MAX_LAYERS], pb_off[DT_MAX_LAYERS];
  int dims[DT_MAX_LAYERS + 1];  // dims[0] = in, dims[k + 1] = padded fan_out of layer k
  int L, in_pad, out_real, B, B_pad, n_mt, fused_out;
  long long act_stride;    // elements per layer of the activation buffers
  long long dz_stride;     // elements per slot of the dz buffers
  float* act_f;            // (L - 1) x [B_pad][D]: f32 tanh outputs
  void* act_r;             // the same in the compute type, row-major
  void* act_t;             // (L - 1) x [D][B_pad]: compute type, transposed
  void* dz_r;              // [3][B_pad][D]: slots 0 and 1 in turn, 2 for dz_{L-1} when fused_out
  void* dz_t;              // [3][D][B_pad]
  float* part_w;           // dW_k (k >= 1), or per-tile partials of dW_0
  float* part_b;           // per-tile partials of db_k
  const float* h0;         // (steps * B, in)
  const float* eps;        // (steps * B, out)
  const float* s1;         // (steps * B, out)
  float* loss_part;        // (steps, tiles_out): per-tile sums of r^2
  int* bad;                // (steps,): a non-finite gradient was seen
  const int* count0;       // Adam count on entry
  float* count_out;        // Adam count on exit
  long long* cur_out;      // the half that holds the final state
  float* losses;           // (n_epochs,): mean batch loss per epoch
  long long* stamps;       // null, or 1 + 2 x steps x syncs %globaltimer reads
  int n_epochs, n_batches, n_active, guard;  // guard: 0 off, 1 grads, 2 loss
  float inv_b, lr, b1, omb1, b2, omb2, log_b1, log_b2, adam_eps;
};

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Ty<float> {
  static __device__ __forceinline__ float from(float x) { return x; }
};

// A slot holds 64 rows x 64 K elements; row r's 16-byte piece pc sits at
// piece pc ^ (r % 8): for bf16 the 128-byte swizzle wgmma reads, and for
// f32 the rows of one read fall in distinct banks.
template <typename T> struct Slot {
  static constexpr int RB = DT_T * (int)sizeof(T);  // bytes a row
  static constexpr int PR = RB / 16;                // pieces a row
  static constexpr int BYTES = DT_T * RB;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The block's dynamic shared memory: the ring of DT_STAGES {A, B} slot
// pairs, two more slots h and x (the operands of the output phase's da
// product and of dW_0's partial), and DT_THREADS + 4 floats for reductions
// and a broadcast word.  The f32 staging tiles c and c2 ([64][DT_CP] each)
// alias the ring, which is idle whenever they are used.
extern __shared__ uint8_t dsmem[];
template <typename T> struct Smem {
  uint8_t *ring, *h, *x;
  float *red, *c, *c2;
  __device__ __forceinline__ Smem() {
    constexpr int SB = Slot<T>::BYTES;
    ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
    h = ring + DT_STAGES * 2 * SB;
    x = h + SB;
    red = reinterpret_cast<float*>(x + SB);
    c = reinterpret_cast<float*>(ring);
    c2 = c + DT_T * DT_CP;
  }
};

template <typename T>
__device__ __forceinline__ void put(uint8_t* slot, int r, int k, float x) {
  const int byte = k * (int)sizeof(T);
  *reinterpret_cast<T*>(slot + swz(r, byte >> 4, Slot<T>::RB) + (byte & 15)) = Ty<T>::from(x);
}

// K chunk k0 .. k0+63 of rows row0 .. row0+63 of a K-major operand with row
// pitch ld (every operand buffer is padded to whole tiles: no masks).
template <typename T>
__device__ __forceinline__ void load_async(uint8_t* slot, const T* g, long long ld, int row0, int k0) {
#pragma unroll
  for (int q = threadIdx.x; q < DT_T * Slot<T>::PR; q += DT_THREADS) {
    const int r = q / Slot<T>::PR, pc = q % Slot<T>::PR;
    cp_async16(smem_u32(slot + swz(r, pc, Slot<T>::RB)),
               g + (long long)(row0 + r) * ld + k0 + pc * (16 / (int)sizeof(T)));
  }
}

// Columns k0 .. k0+kw-1 (kw <= 64) of h0's rows row0 .. row0+63, zero past
// the batch and past `in`.
template <typename T>
__device__ __noinline__ void load_h0(uint8_t* slot, int in, int B, const float* h0, int row0, int k0, int kw) {
#pragma unroll 1
  for (int j0 = 0; j0 < DT_NE; j0 += DT_LB) {
    float x[DT_LB];
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int q = threadIdx.x + (j0 + j) * DT_THREADS, gr = row0 + q / kw, gk = k0 + q % kw;
      x[j] = (q < DT_T * kw && gr < B && gk < in) ? __ldg(h0 + (long long)gr * in + gk) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int q = threadIdx.x + (j0 + j) * DT_THREADS;
      if (q < DT_T * kw) put<T>(slot, q / kw, q % kw, x[j]);
    }
  }
}

// The accumulator layout of both compute types, that of wgmma m64n32 in
// each warpgroup: warp w holds rows 16 (w % 4) + g and + 8 (g = lane / 4)
// and columns 32 (w / 4) + 8 j + 2 t and + 1 (t = lane % 4) for j < 4:
// acc[j] = {(g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1)}.
typedef float Acc[DT_NJ][4];
__device__ __forceinline__ int acc_row(int e) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return 32 * (threadIdx.x >> 7) + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int j = 0; j < DT_NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += A . B^T over k < nk of two slots (A rows m, B rows n, both K-major).
template <typename T>
__device__ __forceinline__ void mma_slots(Acc& acc, const uint8_t* sa, const uint8_t* sb, int nk);

// wgmma: warpgroup g multiplies the 64 A rows into B rows 32 g .. 32 g + 31.
// Both slots are K-major with the 128-byte swizzle (8-row groups 1024 bytes
// apart), which is the slot layout (wg_desc); a 16-deep step moves 32 bytes
// along K.

template <>
__device__ __forceinline__ void mma_slots<__nv_bfloat16>(Acc& acc, const uint8_t* sa, const uint8_t* sb, int nk) {
  const uint64_t da = wg_desc(sa), db = wg_desc(sb + (threadIdx.x >> 7) * 32 * 128);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int ks = 0; ks < nk; ks += 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(acc[0][0]), "+f"(acc[0][1]), "+f"(acc[0][2]), "+f"(acc[0][3]), "+f"(acc[1][0]), "+f"(acc[1][1]),
          "+f"(acc[1][2]), "+f"(acc[1][3]), "+f"(acc[2][0]), "+f"(acc[2][1]), "+f"(acc[2][2]), "+f"(acc[2][3]),
          "+f"(acc[3][0]), "+f"(acc[3][1]), "+f"(acc[3][2]), "+f"(acc[3][3])
        : "l"(da + (ks >> 3)), "l"(db + (ks >> 3)), "r"(1));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <>
__device__ __forceinline__ void mma_slots<float>(Acc& acc, const uint8_t* sa, const uint8_t* sb, int nk) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c0 = 32 * (threadIdx.x >> 7) + 2 * (lane & 3);
  for (int k = 0; k < nk; k += 4) {
    const int pc = k >> 2;
    const float4 x0 = *reinterpret_cast<const float4*>(sa + swz(r0, pc, 256));
    const float4 x1 = *reinterpret_cast<const float4*>(sa + swz(r0 + 8, pc, 256));
#pragma unroll
    for (int j = 0; j < DT_NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 y = *reinterpret_cast<const float4*>(sb + swz(c0 + 8 * j + h, pc, 256));
        float s = acc[j][h], u = acc[j][2 + h];
        s = fmaf(x0.x, y.x, s); s = fmaf(x0.y, y.y, s); s = fmaf(x0.z, y.z, s); s = fmaf(x0.w, y.w, s);
        u = fmaf(x1.x, y.x, u); u = fmaf(x1.y, y.y, u); u = fmaf(x1.z, y.z, u); u = fmaf(x1.w, y.w, u);
        acc[j][h] = s;
        acc[j][2 + h] = u;
      }
  }
}

__device__ __forceinline__ void stage(float* c, const Acc& acc) {
#pragma unroll
  for (int j = 0; j < DT_NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[acc_row(e) * DT_CP + acc_col(j, e)] = acc[j][e];
  __syncthreads();
}

// One 64x64 tile of A . B^T over K chunks kc0 .. kc1-1: A rows a_row0.. of
// a_ptr (pitch a_ld), or of h0 when a_ptr is null; B rows b_row0.. of b_ptr.
// With `out` null the tile is staged in shared memory for its epilogue,
// else stored as it is to out (pitch out_ld) at (a_row0, b_row0).  The
// chunks are taken in turn from kc0 + rot % (kc1 - kc0) on, so that tiles
// which share an operand do not all ask for the same lines at once; chunk j
// goes to ring stage j % DT_STAGES, DT_STAGES - 1 chunks ahead of the one
// being multiplied.
template <typename T>
__device__ __noinline__ void tile(const DsmArgs& a, const T* a_ptr, long long a_ld, int a_row0, const float* h0,
                                  const T* b_ptr, long long b_ld, int b_row0, int kc0, int kc1, int rot,
                                  float* out, int out_ld) {
  constexpr int SB = Slot<T>::BYTES;
  const Smem<T> sm;
  Acc acc;
  zero_acc(acc);
  const int n = kc1 - kc0, in = a.dims[0], B = a.B;
  rot %= n;
#pragma unroll 1
  for (int i = 1 - DT_STAGES; i < n; ++i) {
    if (i >= 0) {
      cp_wait<DT_STAGES - 2>();
      fence_async();
      __syncthreads();
    }
    const int j = i + DT_STAGES - 1;
    if (j < n) {
      uint8_t* st = sm.ring + (j % DT_STAGES) * 2 * SB;
      const int k0 = (kc0 + (j + rot < n ? j + rot : j + rot - n)) * DT_T;
      if (a_ptr != nullptr) load_async<T>(st, a_ptr, a_ld, a_row0, k0);
      else load_h0<T>(st, in, B, h0, a_row0, k0, DT_T);
      load_async<T>(st + SB, b_ptr, b_ld, b_row0, k0);
    }
    cp_commit();
    if (i >= 0) {
      const uint8_t* st = sm.ring + (i % DT_STAGES) * 2 * SB;
      mma_slots<T>(acc, st, st + SB, DT_T);
    }
  }
  cp_wait<0>();
  __syncthreads();
  if (out == nullptr) {
    stage(sm.c, acc);
    return;
  }
#pragma unroll
  for (int j = 0; j < DT_NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(out + (long long)(a_row0 + acc_row(e)) * out_ld + b_row0 + acc_col(j, e)) =
          make_float2(acc[j][e], acc[j][e + 1]);
}

// Sum of one float per thread over the block, in a fixed order.
template <typename T>
__device__ float block_sum(float x) {
  const Smem<T> sm;
  const int tid = threadIdx.x;
  sm.red[tid] = x;
  __syncthreads();
  for (int s = DT_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) sm.red[tid] += sm.red[tid + s];
    __syncthreads();
  }
  const float out = sm.red[0];
  __syncthreads();
  return out;
}

// Column sums of the staged tile, in a fixed order, to out[0..64): DT_RS
// threads a column, each over a run of rows, then the runs in order.
template <typename T>
__device__ void column_sums(float* out) {
  constexpr int RUN = DT_T / DT_RS;
  const Smem<T> sm;
  const int tid = threadIdx.x, c = tid & 63, q = tid >> 6;
  float s = 0.f;
#pragma unroll
  for (int r = RUN * q; r < RUN * q + RUN; ++r) s += sm.c[r * DT_CP + c];
  sm.red[tid] = s;
  __syncthreads();
  if (tid < 64) {
    float t = sm.red[tid];
#pragma unroll
    for (int j = 1; j < DT_RS; ++j) t += sm.red[tid + 64 * j];
    out[tid] = t;
  }
  __syncthreads();
}

// dW_0's partial for M-tile mt and columns n0..: (h0 rows m0..)^T . dz_0
// (the staged f32 tile), as one product of two slots: h0^T (in rows, the
// batch rows along K) and dz_0^T (64 rows, the batch rows along K), both
// rounded to the compute type where they are put.
template <typename T>
__device__ __noinline__ void dw0_partial(const DsmArgs& a, const float* h0, int mt, int n0) {
  const Smem<T> sm;
  const int in = a.dims[0], D1 = a.dims[1], B = a.B, m0 = mt * DT_T;
  float* out = a.part_w + a.pw_off[0] + (long long)mt * in * D1;
  for (int q = threadIdx.x; q < DT_T * DT_T; q += DT_THREADS) {
    const int c = q >> 6, r = q & 63;
    put<T>(sm.x, c, r, sm.c[r * DT_CP + c]);
  }
  for (int i0 = 0; i0 < in; i0 += DT_T) {
    const int iw = in - i0 < DT_T ? in - i0 : DT_T;
#pragma unroll 1
    for (int j0 = 0; j0 < DT_NE; j0 += DT_LB) {
      float x[DT_LB];
#pragma unroll
      for (int j = 0; j < DT_LB; ++j) {
        const int q = threadIdx.x + (j0 + j) * DT_THREADS, gr = m0 + q / iw;
        x[j] = (q < DT_T * iw && gr < B) ? __ldg(h0 + (long long)gr * in + i0 + q % iw) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < DT_LB; ++j) {
        const int q = threadIdx.x + (j0 + j) * DT_THREADS;
        if (q < DT_T * iw) put<T>(sm.h, q % iw, q / iw, x[j]);
      }
    }
    fence_async();
    __syncthreads();
    Acc acc;
    zero_acc(acc);
    mma_slots<T>(acc, sm.h, sm.x, DT_T);
    // rows of sm.h past iw hold stale values; their rows of the product are not stored
#pragma unroll
    for (int jj = 0; jj < DT_NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (acc_row(e) < iw) out[(long long)(i0 + acc_row(e)) * D1 + n0 + acc_col(jj, e)] = acc[jj][e];
    __syncthreads();
  }
}

// Epilogue of a hidden forward tile of layer k: a_{k+1} = tanh(acc + b).
template <typename T>
__device__ __noinline__ void epilogue_hidden(const DsmArgs& a, int k, const float* bias, int m0, int n0) {
  const Smem<T> sm;
  const int N = a.dims[k + 1], B = a.B, B_pad = a.B_pad;
  float* af = a.act_f + k * a.act_stride;
  T* ar = reinterpret_cast<T*>(a.act_r) + k * a.act_stride;
  T* at = reinterpret_cast<T*>(a.act_t) + k * a.act_stride;
  // thread tid holds column tid % 64 of rows tid / 64 + DT_RS j
  const int c = threadIdx.x & 63, gc = n0 + c;
  const float bv = __ldcg(bias + gc);
#pragma unroll 2
  for (int j = 0; j < DT_NE; ++j) {
    const int r = (threadIdx.x >> 6) + DT_RS * j, gr = m0 + r;
    const float x = gr < B ? tanhf(sm.c[r * DT_CP + c] + bv) : 0.f;
    const long long idx = (long long)gr * N + gc;
    af[idx] = x;
    ar[idx] = Ty<T>::from(x);
    sm.c[r * DT_CP + c] = x;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < DT_T * DT_T; q += DT_THREADS) {
    const int cc = q >> 6, r = q & 63;
    at[(long long)(n0 + cc) * B_pad + m0 + r] = Ty<T>::from(sm.c[r * DT_CP + cc]);
  }
  __syncthreads();
}

// With `copies`, stores the staged dz tile in the compute type, row-major
// into dz_r and transposed into dz_t (half `half`); then db's partial.
template <typename T>
__device__ void store_dz(const DsmArgs& a, int half, int N, bool copies, float* db, int m0, int n0) {
  const Smem<T> sm;
  if (copies) {
    T* dr = reinterpret_cast<T*>(a.dz_r) + half * a.dz_stride;
    T* dt = reinterpret_cast<T*>(a.dz_t) + half * a.dz_stride;
    const int B_pad = a.B_pad;
    for (int q = threadIdx.x; q < DT_T * DT_T; q += DT_THREADS) {
      const int r = q >> 6, c = q & 63;
      dr[(long long)(m0 + r) * N + n0 + c] = Ty<T>::from(sm.c[r * DT_CP + c]);
    }
    for (int q = threadIdx.x; q < DT_T * DT_T; q += DT_THREADS) {
      const int c = q >> 6, r = q & 63;
      dt[(long long)(n0 + c) * B_pad + m0 + r] = Ty<T>::from(sm.c[r * DT_CP + c]);
    }
  }
  column_sums<T>(db + n0);
}

// Epilogue of an output tile: dz, staged in f32; with `first`, also the
// loss partial, dz's copies into slot `slot`, db's partial and, for L = 1,
// dW_0's.
template <typename T>
__device__ __noinline__ void epilogue_out(const DsmArgs& a, int s, int t, const float* bias, const float* h0,
                                          const float* eps, const float* s1, int mt, int n0, bool first,
                                          int slot) {
  const Smem<T> sm;
  const int L = a.L, N = a.dims[L], out = a.out_real, B = a.B, m0 = mt * DT_T;
  const float inv_b = a.inv_b;
  // thread tid holds column tid % 64 of rows tid / 64 + DT_RS j
  const int c = threadIdx.x & 63, gc = n0 + c;
  const float bv = __ldcg(bias + gc);
  float part = 0.f;
#pragma unroll 1
  for (int j0 = 0; j0 < DT_NE; j0 += DT_LB) {
    float sv[DT_LB], ev[DT_LB];
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int gr = m0 + (threadIdx.x >> 6) + DT_RS * (j0 + j);
      const bool in = gr < B && gc < out;
      sv[j] = in ? __ldg(s1 + (long long)gr * out + gc) : 0.f;
      ev[j] = in ? __ldg(eps + (long long)gr * out + gc) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int r = (threadIdx.x >> 6) + DT_RS * (j0 + j), gr = m0 + r;
      float dz = 0.f;
      if (gr < B && gc < out) {
        const float res = (sm.c[r * DT_CP + c] + bv) * sv[j] + ev[j];
        dz = res * (sv[j] * inv_b);
        part += res * res;
      }
      sm.c[r * DT_CP + c] = dz;
    }
  }
  __syncthreads();
  if (!first) return;
  part = block_sum<T>(part);
  if (threadIdx.x == 0) a.loss_part[(long long)s * a.n_mt * (N / DT_T) + t] = part;
  store_dz<T>(a, slot, N, L > 1, a.part_b + a.pb_off[L - 1] + (long long)mt * N, m0, n0);
  if (L == 1) dw0_partial<T>(a, h0, mt, n0);
}

// Epilogue of a da tile of backward layer k: dz_{k-1} = acc (1 - a_{k-1}^2)
// into half `half`, db_{k-1}'s partial, and for k = 1 dW_0's.
template <typename T>
__device__ __noinline__ void epilogue_da(const DsmArgs& a, int k, int half, const float* h0, int mt, int n0) {
  const Smem<T> sm;
  const int N = a.dims[k], B = a.B, m0 = mt * DT_T;
  const float* af = a.act_f + (k - 1) * a.act_stride;
  // thread tid holds column tid % 64 of rows tid / 64 + DT_RS j
  const int c = threadIdx.x & 63;
#pragma unroll 1
  for (int j0 = 0; j0 < DT_NE; j0 += DT_LB) {
    float ap[DT_LB];
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int gr = m0 + (threadIdx.x >> 6) + DT_RS * (j0 + j);
      ap[j] = gr < B ? __ldcg(af + (long long)gr * N + n0 + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DT_LB; ++j) {
      const int r = (threadIdx.x >> 6) + DT_RS * (j0 + j);
      sm.c[r * DT_CP + c] = m0 + r < B ? sm.c[r * DT_CP + c] * (1.f - ap[j] * ap[j]) : 0.f;
    }
  }
  __syncthreads();
  store_dz<T>(a, half, N, k > 1, a.part_b + a.pb_off[k - 1] + (long long)mt * N, m0, n0);
  if (k == 1) dw0_partial<T>(a, h0, mt, n0);
}

// With out_pad = 64 (fused_out), tile (mt, g) of the output layer's phase:
// the output tile of rows mt (every g computes the same one, in the same
// order; g = 0 stores its loss partial, dz and db's partial), then the da
// tile of backward layer L-1 for those rows and columns g: dz_{L-2} =
// (dz W_{L-1}^T)(1 - a_{L-2}^2) into slot 1, with dz rounded to the compute
// type from shared memory.
template <typename T>
__device__ __noinline__ void tile_out_da(const DsmArgs& a, int s, const T* wt, const T* wr, const float* bias,
                                         const float* h0, const float* eps, const float* s1, int mt, int g) {
  const Smem<T> sm;
  const int L = a.L, D = a.dims[L - 1], N = a.dims[L], m0 = mt * DT_T;
  load_async<T>(sm.x, wr + a.wr_off[L - 1], N, g * DT_T, 0);  // W_{L-1} rows g.., K = N; waited for below
  cp_commit();
  tile<T>(a, reinterpret_cast<const T*>(a.act_r) + (L - 2) * a.act_stride, D, m0, h0, wt + a.wt_off[L - 1], D, 0, 0,
          D / DT_T, mt, nullptr, 0);
  epilogue_out<T>(a, s, mt, bias, h0, eps, s1, mt, 0, g == 0, 2);
  for (int q = threadIdx.x; q < DT_T * DT_T; q += DT_THREADS) put<T>(sm.h, q >> 6, q & 63, sm.c[(q >> 6) * DT_CP + (q & 63)]);
  fence_async();
  __syncthreads();
  Acc acc;
  zero_acc(acc);
  mma_slots<T>(acc, sm.h, sm.x, DT_T);
  stage(sm.c, acc);
  epilogue_da<T>(a, L - 1, 1, h0, mt, g * DT_T);
}

// Adam's units of work, for layer k (K x N padded): tiles of DT_UR rows x 64
// columns of W_k, then runs of DT_UB entries of b_k; a thread takes DT_UE
// entries of a unit.  The gradients of W_0 and of every b_k come in n_mt
// per-tile partials (one per 64 rows of the batch), those of W_k (k >= 1)
// whole.
#define DT_UE 4
#define DT_UR (DT_UE * DT_THREADS / DT_T)
#define DT_UB (DT_UE * DT_THREADS)
__device__ __forceinline__ int w_units(int K, int N) { return cdiv(K, DT_UR) * (N / DT_T); }
__device__ __forceinline__ int b_units(int N) { return cdiv(N, DT_UB); }

// Adam over unit u of the state (the units of every W first, then those of
// every b).  Reads half `src`; with `update` writes the candidate into the
// other half, else only the operand copies of half `src`.  Each thread
// loads all of its entries' inputs before it stores anything.  Returns
// whether a gradient was not finite.
template <typename T>
__device__ __noinline__ bool adam_unit(const DsmArgs& a, int u, int src, bool update, float bc1, float bc2) {
  const Smem<T> sm;
  const int L = a.L;
  int k = -1, i0 = 0, n0 = 0;
  for (int kk = 0; kk < L && k < 0; ++kk) {
    const int tn = a.dims[kk + 1] / DT_T, nw = w_units(a.dims[kk], a.dims[kk + 1]);
    if (u < nw) {
      k = kk;
      i0 = (u / tn) * DT_UR;
      n0 = (u % tn) * DT_T;
    } else {
      u -= nw;
    }
  }
  const bool w = k >= 0;
  for (int kk = 0; kk < L && k < 0; ++kk) {
    const int nb = b_units(a.dims[kk + 1]);
    if (u < nb) {
      k = kk;
      n0 = u * DT_UB;
    } else {
      u -= nb;
    }
  }
  const int K = a.dims[k], N = a.dims[k + 1];
  const int dst = update ? src ^ 1 : src;
  const int cnt = (!w || k == 0) ? a.n_mt : 1;
  const long long stride = w ? (long long)K * N : N;
  const float* part = w ? a.part_w + a.pw_off[k] : a.part_b + a.pb_off[k];
  const long long base = (w ? a.w_off[k] : a.b_off[k]) + (long long)src * a.n_flat;
  const long long moved = (long long)(dst - src) * a.n_flat;
  float* const p = a.p;
  float* const m = a.m;
  float* const v = a.v;
  const float b1 = a.b1, omb1 = a.omb1, b2 = a.b2, omb2 = a.omb2, adam_eps = a.adam_eps, lr = a.lr;
  // entry q: W row i0 + q / 64, column n0 + q % 64; b entry n0 + q
  long long loc[DT_UE];
  bool ok[DT_UE];
  float g[DT_UE], pv[DT_UE], mv[DT_UE], vv[DT_UE];
#pragma unroll
  for (int e = 0; e < DT_UE; ++e) {
    const int q = threadIdx.x + e * DT_THREADS;
    ok[e] = w ? i0 + (q >> 6) < K : n0 + q < N;
    loc[e] = w ? (long long)(i0 + (q >> 6)) * N + n0 + (q & 63) : n0 + q;
    pv[e] = ok[e] ? __ldcg(p + base + loc[e]) : 0.f;
    mv[e] = update && ok[e] ? __ldcg(m + base + loc[e]) : 0.f;
    vv[e] = update && ok[e] ? __ldcg(v + base + loc[e]) : 0.f;
    g[e] = 0.f;
  }
  bool bad = false;
  if (update) {
#pragma unroll 4
    for (int j = 0; j < cnt; ++j)
#pragma unroll
      for (int e = 0; e < DT_UE; ++e)
        if (ok[e]) g[e] += __ldcg(part + j * stride + loc[e]);
#pragma unroll
    for (int e = 0; e < DT_UE; ++e) {
      if (!ok[e]) continue;
      bad |= !isfinite(g[e]);
      const float m_new = b1 * mv[e] + omb1 * g[e];
      const float v_new = b2 * vv[e] + omb2 * (g[e] * g[e]);
      const float upd = (m_new / bc1) / (sqrtf(v_new / bc2) + adam_eps);
      pv[e] = pv[e] - lr * upd;
      p[base + moved + loc[e]] = pv[e];
      m[base + moved + loc[e]] = m_new;
      v[base + moved + loc[e]] = v_new;
    }
  }
  if (!w) return bad;
  T* wr = reinterpret_cast<T*>(a.wr) + dst * a.wr_total + a.wr_off[k];
  T* wt = reinterpret_cast<T*>(a.wt) + dst * a.wt_total + a.wt_off[k];
  const int ldk = k == 0 ? a.in_pad : K;
#pragma unroll
  for (int e = 0; e < DT_UE; ++e) {
    const int q = threadIdx.x + e * DT_THREADS;
    if (k > 0 && ok[e]) wr[loc[e]] = Ty<T>::from(pv[e]);
    sm.c[(q & 63) * DT_CP + (q >> 6)] = pv[e];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < DT_UR * DT_T; q += DT_THREADS) {
    const int c = q / DT_UR, r = q % DT_UR;
    if (i0 + r < K) wt[(long long)(n0 + c) * ldk + i0 + r] = Ty<T>::from(sm.c[c * DT_CP + r]);
  }
  __syncthreads();
  return bad;
}

// Asks L2 for step s's rows of h0, eps and s1, spread over the grid, so that
// the step does not wait on device memory for them.
__device__ void prefetch_rows(const DsmArgs& a, int s) {
  const float* src[3] = {a.h0 + (size_t)s * a.B * a.dims[0], a.eps + (size_t)s * a.B * a.out_real,
                         a.s1 + (size_t)s * a.B * a.out_real};
  const long long bytes[3] = {4ll * a.B * a.dims[0], 4ll * a.B * a.out_real, 4ll * a.B * a.out_real};
  for (int j = 0; j < 3; ++j)
    for (long long o = 128ll * (blockIdx.x * DT_THREADS + threadIdx.x); o < bytes[j];
         o += 128ll * gridDim.x * DT_THREADS)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const char*>(src[j]) + o));
}

__device__ __forceinline__ void stamp(long long* stamps, long long i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// A grid sync that ends a phase; with stamps, block 0 reads the clock when
// its own work is done and again when the sync returns.
__device__ __forceinline__ void end_phase(cg::grid_group& grid, long long* stamps, long long& n) {
  stamp(stamps, n++);
  grid.sync();
  stamp(stamps, n++);
}

// The step's rows of h0, eps and s1.
struct Rows {
  const float *h0, *eps, *s1;
  __device__ __forceinline__ Rows(const DsmArgs& a, int s)
      : h0(a.h0 + (size_t)s * a.B * a.dims[0]),
        eps(a.eps + (size_t)s * a.B * a.out_real),
        s1(a.s1 + (size_t)s * a.B * a.out_real) {}
};

// Forward layer k of step s on state half `cur`; with fused_out the output
// layer's phase also runs backward layer L-1's da tiles.
template <typename T>
__device__ __noinline__ void forward_phase(const DsmArgs& a, int s, int cur, int k) {
  const int L = a.L;
  const Rows rows(a, s);
  const float* p = a.p + cur * a.n_flat;
  const T* wt = reinterpret_cast<const T*>(a.wt) + cur * a.wt_total;
  const bool out_da = k == L - 1 && a.fused_out;
  const int tn = out_da ? a.dims[L - 1] / DT_T : a.dims[k + 1] / DT_T, tiles = a.n_mt * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / tn, m0 = mt * DT_T, n0 = (t % tn) * DT_T;
    if (out_da) {
      tile_out_da<T>(a, s, wt, reinterpret_cast<const T*>(a.wr) + cur * a.wr_total, p + a.b_off[k], rows.h0,
                     rows.eps, rows.s1, mt, t % tn);
      continue;
    }
    if (k == 0)
      tile<T>(a, nullptr, 0, m0, rows.h0, wt + a.wt_off[0], a.in_pad, n0, 0, a.in_pad / DT_T, 0, nullptr, 0);
    else
      tile<T>(a, reinterpret_cast<const T*>(a.act_r) + (k - 1) * a.act_stride, a.dims[k], m0, rows.h0,
              wt + a.wt_off[k], a.dims[k], n0, 0, a.dims[k] / DT_T, mt + t % tn, nullptr, 0);
    if (k < L - 1) epilogue_hidden<T>(a, k, p + a.b_off[k], m0, n0);
    else epilogue_out<T>(a, s, t, p + a.b_off[k], rows.h0, rows.eps, rows.s1, mt, n0, true, 0);
  }
}

// Backward layer k of step s on state half `cur`, dz_k in slot `half`:
// dz_{k-1} tiles (k >= 1), then dW_k tiles (k >= 1), then with fused_out in
// the first backward phase the tiles of dW_{L-1} (dz_{L-1} in slot 2).
template <typename T>
__device__ __noinline__ void backward_phase(const DsmArgs& a, int s, int cur, int k, int half) {
  const int L = a.L, K = a.dims[k], N = a.dims[k + 1];
  const float* h0 = Rows(a, s).h0;
  const T* wr = reinterpret_cast<const T*>(a.wr) + cur * a.wr_total;
  const T* dzr = reinterpret_cast<const T*>(a.dz_r) + half * a.dz_stride;
  const int tk = K / DT_T, tn = N / DT_T;
  const int tiles_da = k >= 1 ? a.n_mt * tk : 0, tiles_dw = k >= 1 ? tk * tn : 0;
  const int tiles_top = a.fused_out && k == L - 2 ? a.dims[L - 1] / DT_T * (a.dims[L] / DT_T) : 0;
  for (int t = blockIdx.x; t < tiles_da + tiles_dw + tiles_top; t += gridDim.x) {
    if (t < tiles_da) {
      // da (B, K) = dz (B x N) . W_k^T
      const int mt = t / tk, n0 = (t % tk) * DT_T;
      tile<T>(a, dzr, N, mt * DT_T, h0, wr + a.wr_off[k], N, n0, 0, N / DT_T, mt + t % tk, nullptr, 0);
      epilogue_da<T>(a, k, half ^ 1, h0, mt, n0);
    } else {
      // dW_l (K_l, N_l) = a_{l-1}^T . dz_l over the batch, l = k or L-1
      const bool top = t >= tiles_da + tiles_dw;
      const int l = top ? L - 1 : k, w = top ? t - tiles_da - tiles_dw : t - tiles_da;
      const int Nl = a.dims[l + 1], tnl = Nl / DT_T;
      tile<T>(a, reinterpret_cast<const T*>(a.act_t) + (l - 1) * a.act_stride, a.B_pad, (w / tnl) * DT_T, nullptr,
              reinterpret_cast<const T*>(a.dz_t) + (top ? 2 : half) * a.dz_stride, a.B_pad, (w % tnl) * DT_T, 0,
              a.B_pad / DT_T, w / tnl + w % tnl, a.part_w + a.pw_off[l], Nl);
    }
  }
}

// Adam of step s from half `cur` (count cnt) into the other half, and the
// next step's rows into L2; raises the step's flag on a non-finite gradient.
template <typename T>
__device__ __noinline__ void adam_phase(const DsmArgs& a, int s, int cur, float cnt, int n_units) {
  const float cnt_new = cnt + 1.f;
  const float bc1 = 1.f - expf(cnt_new * a.log_b1);
  const float bc2 = 1.f - expf(cnt_new * a.log_b2);
  if (s + 1 < a.n_epochs * a.n_batches) prefetch_rows(a, s + 1);
  bool bad = false;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) bad |= adam_unit<T>(a, u, cur, true, bc1, bc2);
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(a.bad + s, 1);
}

// Whether step s is taken (the same answer in every block), and block 0's
// bookkeeping of the epoch's mean loss.
template <typename T>
__device__ __noinline__ bool step_taken(const DsmArgs& a, int s, float& epoch_acc) {
  const Smem<T> sm;
  if (threadIdx.x == 0) {
    const int e = s / a.n_batches, tiles_out = a.n_mt * (a.dims[a.L] / DT_T);
    // unrolled so that the loads go out together; the sum keeps its order
    float part_sum = 0.f;
#pragma unroll 16
    for (int t = 0; t < tiles_out; ++t) part_sum += __ldcg(a.loss_part + (size_t)s * tiles_out + t);
    const float batch_loss = 0.5f * part_sum * a.inv_b;
    bool ok = e < a.n_active;
    if (a.guard == 2) ok = ok && isfinite(batch_loss);
    if (a.guard == 1) ok = ok && __ldcg(a.bad + s) == 0;
    sm.red[DT_THREADS] = ok ? 1.f : 0.f;
    if (blockIdx.x == 0) {
      epoch_acc += batch_loss;
      if (s % a.n_batches == a.n_batches - 1) {
        a.losses[e] = epoch_acc / (float)a.n_batches;
        epoch_acc = 0.f;
      }
    }
  }
  __syncthreads();
  const bool ok = sm.red[DT_THREADS] != 0.f;
  __syncthreads();
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(DT_THREADS, 2) dsm_train_kernel(const __grid_constant__ DsmArgs args) {
  // the arguments go to shared memory once: the device functions read them
  // there through a reference, which is cheap to repeat
  __shared__ DsmArgs a_sh;
  static_assert(sizeof(DsmArgs) % 8 == 0 && sizeof(DsmArgs) / 8 <= DT_THREADS, "DsmArgs copy");
  if (threadIdx.x < sizeof(DsmArgs) / 8)
    reinterpret_cast<long long*>(&a_sh)[threadIdx.x] = reinterpret_cast<const long long*>(&args)[threadIdx.x];
  __syncthreads();
  const DsmArgs& a = a_sh;
  cg::grid_group grid = cg::this_grid();
  const int L = a.L, n_steps = a.n_epochs * a.n_batches;
  int n_units = 0;
  for (int k = 0; k < L; ++k) n_units += w_units(a.dims[k], a.dims[k + 1]) + b_units(a.dims[k + 1]);
  float cnt = (float)a.count0[0];
  float epoch_acc = 0.f;  // block 0, thread 0: running sum of the epoch's batch losses
  int cur = 0;
  long long n_stamp = 0;

  // the operand copies of the state on entry, and the first step's rows into L2
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) adam_unit<T>(a, u, 0, false, 1.f, 1.f);
  prefetch_rows(a, 0);
  grid.sync();
  stamp(a.stamps, n_stamp++);

  for (int s = 0; s < n_steps; ++s) {
    for (int k = 0; k < L; ++k) {
      forward_phase<T>(a, s, cur, k);
      end_phase(grid, a.stamps, n_stamp);
    }
    int half = a.fused_out ? 1 : 0;  // the dz slot of the first backward phase
    const int k_top = a.fused_out ? L - 2 : L - 1, k_end = (a.fused_out && L == 2) ? 0 : 1;
    for (int k = k_top; k >= k_end; --k, half ^= 1) {
      backward_phase<T>(a, s, cur, k, half);
      end_phase(grid, a.stamps, n_stamp);
    }
    adam_phase<T>(a, s, cur, cnt, n_units);
    end_phase(grid, a.stamps, n_stamp);
    if (step_taken<T>(a, s, epoch_acc)) {
      cur ^= 1;
      cnt += 1.f;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.count_out[0] = cnt;
    a.cur_out[0] = cur;
  }
}

template <typename T>
static size_t smem_bytes() {
  return 2048 + (DT_STAGES * 2 + 2) * Slot<T>::BYTES + (DT_THREADS + 4) * sizeof(float);
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream`.  ptrs, offs, dims, iargs and fargs are host arrays in
// the order ops/dsm_train_kernel.py writes them.  Returns a cudaError_t.
int dsm_train_launch(void* const* ptrs, const long long* offs, const int* dims, const int* iargs,
                     const float* fargs, void* stream) {
  DsmArgs a;
  const int L = iargs[0];
  if (L < 1 || L > DT_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  a.L = L;
  a.B = iargs[1]; a.B_pad = iargs[2]; a.n_mt = a.B_pad / DT_T;
  a.n_epochs = iargs[3]; a.n_batches = iargs[4]; a.n_active = iargs[5]; a.guard = iargs[6];
  const int bf16 = iargs[7];
  a.out_real = iargs[8]; a.in_pad = iargs[9]; a.fused_out = iargs[10];
  if (a.B < 1 || a.B > a.B_pad || a.B_pad % DT_T || a.n_epochs < 1 || a.n_batches < 1 || a.guard < 0 ||
      a.guard > 2 || a.in_pad % DT_T || (a.fused_out && (L < 2 || dims[L] != DT_T)))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k <= L; ++k) {
    if (dims[k] < 1 || (k > 0 && dims[k] % DT_T)) return (int)cudaErrorInvalidValue;
    a.dims[k] = dims[k];
  }
  a.p = (float*)ptrs[0]; a.m = (float*)ptrs[1]; a.v = (float*)ptrs[2];
  a.wt = ptrs[3]; a.wr = ptrs[4];
  a.act_f = (float*)ptrs[5]; a.act_r = ptrs[6]; a.act_t = ptrs[7];
  a.dz_r = ptrs[8]; a.dz_t = ptrs[9];
  a.part_w = (float*)ptrs[10]; a.part_b = (float*)ptrs[11];
  a.h0 = (const float*)ptrs[12]; a.eps = (const float*)ptrs[13]; a.s1 = (const float*)ptrs[14];
  a.loss_part = (float*)ptrs[15]; a.bad = (int*)ptrs[16]; a.count0 = (const int*)ptrs[17];
  a.count_out = (float*)ptrs[18]; a.cur_out = (long long*)ptrs[19]; a.losses = (float*)ptrs[20];
  a.stamps = (long long*)ptrs[21];
  const long long* o = offs;
  a.n_flat = *o++; a.wt_total = *o++; a.wr_total = *o++; a.act_stride = *o++; a.dz_stride = *o++;
  for (int k = 0; k < L; ++k) {
    a.w_off[k] = *o++; a.b_off[k] = *o++; a.wt_off[k] = *o++;
    a.wr_off[k] = *o++; a.pw_off[k] = *o++; a.pb_off[k] = *o++;
  }
  a.inv_b = fargs[0]; a.lr = fargs[1]; a.b1 = fargs[2]; a.omb1 = fargs[3]; a.b2 = fargs[4];
  a.omb2 = fargs[5]; a.log_b1 = fargs[6]; a.log_b2 = fargs[7]; a.adam_eps = fargs[8];

  const void* fn = bf16 ? (const void*)dsm_train_kernel<__nv_bfloat16> : (const void*)dsm_train_kernel<float>;
  const size_t smem = bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, DT_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block must be resident for the grid syncs: at most what fits
  const int blocks = n_sm * (per_sm < 2 ? per_sm : 2);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(DT_THREADS), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
