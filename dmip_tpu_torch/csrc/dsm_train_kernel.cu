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
// What bounds it on an H100.  Per step at batch 1000 on the 512x3 net, the
// products are ~3.2 GFLOP (forward, dW for every layer, da below the top),
// ~3.2 us at the 989 TFLOP/s bf16 peak; bytes are negligible (state in and
// out once, the batches once).  But the steps form one serial chain: each
// step needs the previous step's weights, and inside a step every layer
// needs the one before.  A 1000x512 product is only ~128 64x64 tiles, about
// one wave of the card's 132 SMs, so the floor in practice is the chain of
// dependent phases, not the tensor-core rate.
//
// Design.  One persistent cooperative launch (a grid of co-resident blocks,
// cooperative_groups grid sync between dependent phases), looping over all
// steps inside the kernel.  Parameters, Adam moments and gradients live in
// flat f32 buffers in device memory (~8.5 MB, resident in the 50 MB L2);
// activations and dz are f32 buffers (B x 512 each).  Each phase is a list
// of 64x64 output tiles spread over all blocks: forward layer k; then per
// layer from the top, dW_k (with db_k summed in f32 from the same dz loads)
// beside da_{k-1} -> dz_{k-1}, which read only the old W_k; then Adam over
// the flat buffers.  That is 2L + 1 grid syncs per step.  A tile streams K in
// chunks of 32 through shared memory, the next chunk's loads issued from
// registers while the current one is multiplied: mma.sync.m16n8k16 bf16 ->
// f32 for bf16 compute, f32 FMA for f32 compute (wgmma/TMA is later work).
// Buffers that change during the launch are read with ld.global.cg, so no
// SM reads a stale L1 line after a grid sync.  The ragged last tile of the
// batch (1000 is not a multiple of 64) is masked, not padded.  Every sum
// whose order matters (loss, db) runs in a fixed order, so a launch is
// deterministic.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DT_MAX_LAYERS 10
#define DT_THREADS 256
#define DT_TM 64
#define DT_TN 64
#define DT_TK 32
#define DT_PAD 8

struct DsmArgs {
  float* p;  // flat params, updated in place: W_0, b_0, W_1, b_1, ... (W row-major)
  float* m;  // Adam first moments, same layout
  float* v;  // Adam second moments
  float* g;  // gradients of the current step
  long long w_off[DT_MAX_LAYERS], b_off[DT_MAX_LAYERS];
  int dims[DT_MAX_LAYERS + 1];  // dims[0] = in, dims[k + 1] = fan_out of layer k
  int n_layers;
  long long n_flat;
  const float* h0;   // (steps * B, in)
  const float* eps;  // (steps * B, out)
  const float* s1;   // (steps * B, out)
  float* acts;       // (L - 1) x B x hmax: tanh outputs of the current step
  float* dz0;        // B x dmax, ping
  float* dz1;        // B x dmax, pong
  float* loss_part;  // (steps, tiles_out): per-tile sums of r^2
  int* bad;          // (steps,): a non-finite gradient was seen
  const int* count0; // Adam count on entry
  float* count_out;  // Adam count on exit
  float* losses;     // (n_epochs,): mean batch loss per epoch
  int B, n_epochs, n_batches, n_active, guard;  // guard: 0 off, 1 grads, 2 loss
  int hmax;
  float inv_b, lr, b1, omb1, b2, omb2, log_b1, log_b2, adam_eps;
};

struct SmemBf16 {
  __nv_bfloat16 a[DT_TM][DT_TK + DT_PAD];  // A chunk, row-major
  __nv_bfloat16 b[DT_TN][DT_TK + DT_PAD];  // B chunk, n-major (k contiguous)
};
struct __align__(16) SmemF32 {
  float a[DT_TK][DT_TM + 4];  // A chunk, k-major
  float b[DT_TK][DT_TN + 4];  // B chunk, k-major
};
struct __align__(16) Smem {
  union {
    SmemBf16 h;
    SmemF32 f;
  } u;
  float c[DT_TM][DT_TN + 1];  // the tile's sums, for the epilogue
  float red[DT_THREADS];      // block reductions
  float bcast[2];
};

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One operand of a product: element (i, k) at ptr[i * si + k * sk], for
// i < ni and k < nk; zero outside.  `k_fast` says which index neighbouring
// threads walk (the one with stride 1), so the loads are coalesced.
struct Operand {
  const float* ptr;
  long long si, sk;
  int ni, nk;
  bool k_fast;
};

// Loads of one TK-deep chunk of a 64-wide operand tile: 8 elements a thread.
// Element q of thread tid is (i, k) with, for k-fast operands,
// e = tid + 256 q, i = e / TK, k = e % TK; for i-fast ones i = e % 64,
// k = e / 64.
__device__ __forceinline__ void load_chunk(const Operand& op, int i0, int k0, float* r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = tid + DT_THREADS * q;
    const int i = op.k_fast ? e / DT_TK : e % 64;
    const int k = op.k_fast ? e % DT_TK : e / 64;
    const int gi = i0 + i, gk = k0 + k;
    r[q] = (gi < op.ni && gk < op.nk) ? ldcg(op.ptr + gi * op.si + gk * op.sk) : 0.f;
  }
}

__device__ __forceinline__ void chunk_coords(const Operand& op, int q, int* i, int* k) {
  const int e = threadIdx.x + DT_THREADS * q;
  *i = op.k_fast ? e / DT_TK : e % 64;
  *k = op.k_fast ? e % DT_TK : e / 64;
}

// C tile (m0.., n0..) = A . B over all K, into sm.c.  A is (M, K) as
// Operand{i = m}, B is (N, K) as Operand{i = n}.  When `colsum` is set, B must
// be n-fast (k_fast false), and the f32 sum over k of each of the tile's B
// columns is written to colsum[0..64) in a fixed order.
template <bool BF16>
__device__ void tile_product(Smem& sm, const Operand& A, const Operand& Bop, int m0, int n0, int K,
                             float* colsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float col_acc = 0.f;
  float ra[8], rb[8];
  const int nk = (K + DT_TK - 1) / DT_TK;
  load_chunk(A, m0, 0, ra);
  load_chunk(Bop, n0, 0, rb);
  for (int kc = 0; kc < nk; ++kc) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      int i, k;
      chunk_coords(A, q, &i, &k);
      if (BF16) sm.u.h.a[i][k] = __float2bfloat16_rn(ra[q]);
      else sm.u.f.a[k][i] = ra[q];
      chunk_coords(Bop, q, &i, &k);
      if (BF16) sm.u.h.b[i][k] = __float2bfloat16_rn(rb[q]);
      else sm.u.f.b[k][i] = rb[q];
      if (colsum != nullptr) col_acc += rb[q];
    }
    __syncthreads();
    if (kc + 1 < nk) {
      load_chunk(A, m0, (kc + 1) * DT_TK, ra);
      load_chunk(Bop, n0, (kc + 1) * DT_TK, rb);
    }
    if (BF16) {
      // warp w: rows 16 (w % 4) .. +16, columns 32 (w / 4) .. +32
      const int g = lane >> 2, t = lane & 3;
      const int r0 = (warp & 3) * 16 + g, c0 = (warp >> 2) * 32 + g;
#pragma unroll
      for (int ks = 0; ks < DT_TK; ks += 16) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&sm.u.h.a[r0][ks + 2 * t]);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(&sm.u.h.a[r0 + 8][ks + 2 * t]);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(&sm.u.h.a[r0][ks + 2 * t + 8]);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(&sm.u.h.a[r0 + 8][ks + 2 * t + 8]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.u.h.b[c0 + 8 * q][ks + 2 * t]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sm.u.h.b[c0 + 8 * q][ks + 2 * t + 8]);
          mma_bf16(acc[q], a0, a1, a2, a3, b0, b1);
        }
      }
    } else {
      // thread (ty, tx) = (tid / 16, tid % 16): rows 4 ty .. +4, columns 4 tx .. +4
      const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 8
      for (int k = 0; k < DT_TK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.u.f.a[k][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&sm.u.f.b[k][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  if (BF16) {
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp & 3) * 16 + g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = (warp >> 2) * 32 + 8 * q + 2 * t;
      sm.c[r0][c] = acc[q][0];
      sm.c[r0][c + 1] = acc[q][1];
      sm.c[r0 + 8][c] = acc[q][2];
      sm.c[r0 + 8][c + 1] = acc[q][3];
    }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.c[4 * ty + i][4 * tx + j] = acc[i][j];
  }
  if (colsum != nullptr) {
    // thread tid held column tid % 64 over k = tid / 64 + 4 q: 4 partials a column
    sm.red[tid] = col_acc;
  }
  __syncthreads();
  if (colsum != nullptr && tid < 64)
    colsum[tid] = ((sm.red[tid] + sm.red[tid + 64]) + sm.red[tid + 128]) + sm.red[tid + 192];
}

// Sum of one float per thread over the block, in a fixed order.
__device__ float block_sum(Smem& sm, float x) {
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

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <bool BF16>
__global__ void __launch_bounds__(DT_THREADS, 2) dsm_train_kernel(const DsmArgs a) {
  __shared__ Smem sm;
  __shared__ float colsum[DT_TN];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int L = a.n_layers, B = a.B;
  const int in_dim = a.dims[0], out_dim = a.dims[L];
  const int n_steps = a.n_epochs * a.n_batches;
  const int tiles_out = cdiv(B, DT_TM) * cdiv(out_dim, DT_TN);
  float cnt = (float)a.count0[0];
  float epoch_acc = 0.f;  // block 0, thread 0: running sum of the epoch's batch losses

  for (int s = 0; s < n_steps; ++s) {
    const int e = s / a.n_batches, i_batch = s % a.n_batches;
    const float* h0 = a.h0 + (size_t)s * B * in_dim;
    const float* eps = a.eps + (size_t)s * B * out_dim;
    const float* s1 = a.s1 + (size_t)s * B * out_dim;

    // ---- forward, one phase per layer ----
    for (int k = 0; k < L; ++k) {
      const int K = a.dims[k], N = a.dims[k + 1];
      const float* ain = k == 0 ? h0 : a.acts + (size_t)(k - 1) * B * a.hmax;
      const Operand A{ain, K, 1, B, K, true};
      const Operand W{a.p + a.w_off[k], 1, N, N, K, false};  // (n, k) -> W[k][n]
      const float* bias = a.p + a.b_off[k];
      const int tn = cdiv(N, DT_TN), tiles = cdiv(B, DT_TM) * tn;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tn) * DT_TM, n0 = (t % tn) * DT_TN;
        tile_product<BF16>(sm, A, W, m0, n0, K, nullptr);
        if (k < L - 1) {
          float* out = a.acts + (size_t)k * B * a.hmax;
          for (int q = tid; q < DT_TM * DT_TN; q += DT_THREADS) {
            const int r = m0 + q / DT_TN, c = n0 + q % DT_TN;
            if (r < B && c < N) out[(size_t)r * N + c] = tanhf(sm.c[q / DT_TN][q % DT_TN] + ldcg(bias + c));
          }
        } else {
          float part = 0.f;
          for (int q = tid; q < DT_TM * DT_TN; q += DT_THREADS) {
            const int r = m0 + q / DT_TN, c = n0 + q % DT_TN;
            if (r < B && c < N) {
              const size_t idx = (size_t)r * N + c;
              const float sc = __ldg(s1 + idx);
              const float res = (sm.c[q / DT_TN][q % DT_TN] + ldcg(bias + c)) * sc + __ldg(eps + idx);
              a.dz0[idx] = res * (sc * a.inv_b);
              part += res * res;
            }
          }
          part = block_sum(sm, part);
          if (tid == 0) a.loss_part[(size_t)s * tiles_out + t] = part;
        }
        __syncthreads();
      }
      grid.sync();
    }

    // ---- backward, one phase per layer: dW_k and db_k beside da_{k-1} ----
    float* dzc = a.dz0;
    float* dzn = a.dz1;
    for (int k = L - 1; k >= 0; --k) {
      const int K = a.dims[k], N = a.dims[k + 1];
      const float* aprev = k == 0 ? h0 : a.acts + (size_t)(k - 1) * B * a.hmax;
      const int tn_dw = cdiv(N, DT_TN), tiles_dw = cdiv(K, DT_TM) * tn_dw;
      const int tn_da = cdiv(K, DT_TN), tiles_da = k > 0 ? cdiv(B, DT_TM) * tn_da : 0;
      for (int t = blockIdx.x; t < tiles_dw + tiles_da; t += gridDim.x) {
        if (t < tiles_dw) {
          // dW_k (K, N) = aprev^T (K x B) . dz (B x N): contraction over the batch
          const int m0 = (t / tn_dw) * DT_TM, n0 = (t % tn_dw) * DT_TN;
          const Operand At{aprev, 1, K, K, B, false};  // (i, b) -> aprev[b][i]
          const Operand Dz{dzc, 1, N, N, B, false};    // (n, b) -> dz[b][n]
          const bool with_db = m0 == 0;
          tile_product<BF16>(sm, At, Dz, m0, n0, B, with_db ? colsum : nullptr);
          bool bad = false;
          float* gw = a.g + a.w_off[k];
          for (int q = tid; q < DT_TM * DT_TN; q += DT_THREADS) {
            const int r = m0 + q / DT_TN, c = n0 + q % DT_TN;
            if (r < K && c < N) {
              const float val = sm.c[q / DT_TN][q % DT_TN];
              gw[(size_t)r * N + c] = val;
              bad |= !isfinite(val);
            }
          }
          if (with_db && tid < DT_TN && n0 + tid < N) {
            a.g[a.b_off[k] + n0 + tid] = colsum[tid];
            bad |= !isfinite(colsum[tid]);
          }
          if (__syncthreads_or(bad) && tid == 0) atomicOr(a.bad + s, 1);
        } else {
          // da (B, K) = dz (B x N) . W_k^T (N x K); dz_{k-1} = da (1 - aprev^2)
          const int tt = t - tiles_dw;
          const int m0 = (tt / tn_da) * DT_TM, n0 = (tt % tn_da) * DT_TN;
          const Operand Dz{dzc, N, 1, B, N, true};               // (b, n) -> dz[b][n]
          const Operand Wt{a.p + a.w_off[k], N, 1, K, N, true};  // (i, n) -> W[i][n]
          tile_product<BF16>(sm, Dz, Wt, m0, n0, N, nullptr);
          for (int q = tid; q < DT_TM * DT_TN; q += DT_THREADS) {
            const int r = m0 + q / DT_TN, c = n0 + q % DT_TN;
            if (r < B && c < K) {
              const size_t idx = (size_t)r * K + c;
              const float ap = ldcg(aprev + idx);
              dzn[idx] = sm.c[q / DT_TN][q % DT_TN] * (1.f - ap * ap);
            }
          }
        }
        __syncthreads();
      }
      grid.sync();
      float* tmp = dzc;
      dzc = dzn;
      dzn = tmp;
    }

    // ---- guard and Adam ----
    if (tid == 0) {
      float part_sum = 0.f;
      for (int t = 0; t < tiles_out; ++t) part_sum += ldcg(a.loss_part + (size_t)s * tiles_out + t);
      const float batch_loss = 0.5f * part_sum * a.inv_b;
      bool ok = e < a.n_active;
      if (a.guard == 2) ok = ok && isfinite(batch_loss);
      if (a.guard == 1) ok = ok && __ldcg(a.bad + s) == 0;
      sm.bcast[0] = batch_loss;
      sm.bcast[1] = ok ? 1.f : 0.f;
      if (blockIdx.x == 0) {
        epoch_acc += batch_loss;
        if (i_batch == a.n_batches - 1) {
          a.losses[e] = epoch_acc / (float)a.n_batches;
          epoch_acc = 0.f;
        }
      }
    }
    __syncthreads();
    const bool do_update = sm.bcast[1] != 0.f;
    __syncthreads();
    if (do_update) {
      const float cnt_new = cnt + 1.f;
      const float bc1 = 1.f - expf(cnt_new * a.log_b1);
      const float bc2 = 1.f - expf(cnt_new * a.log_b2);
      for (long long i = (long long)blockIdx.x * DT_THREADS + tid; i < a.n_flat;
           i += (long long)gridDim.x * DT_THREADS) {
        const float gi = ldcg(a.g + i);
        const float m_new = a.b1 * ldcg(a.m + i) + a.omb1 * gi;
        const float v_new = a.b2 * ldcg(a.v + i) + a.omb2 * (gi * gi);
        const float upd = (m_new / bc1) / (sqrtf(v_new / bc2) + a.adam_eps);
        a.p[i] = ldcg(a.p + i) - a.lr * upd;
        a.m[i] = m_new;
        a.v[i] = v_new;
      }
      cnt = cnt_new;
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && tid == 0) a.count_out[0] = cnt;
}

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch on `stream`.  w_off / b_off (n_layers) and dims (n_layers + 1) are
// host arrays.  Returns a cudaError_t.
int dsm_train_launch(float* p, float* m, float* v, float* g, const long long* w_off,
                     const long long* b_off, const int* dims, int n_layers, long long n_flat,
                     const float* h0, const float* eps, const float* s1, float* acts, float* dz0,
                     float* dz1, float* loss_part, int* bad, const int* count0, float* count_out,
                     float* losses, int B, int n_epochs, int n_batches, int n_active, int guard,
                     int bf16, float inv_b, float lr, float b1, float omb1, float b2, float omb2,
                     float log_b1, float log_b2, float adam_eps, void* stream) {
  if (n_layers < 1 || n_layers > DT_MAX_LAYERS || B < 1 || n_epochs < 1 || n_batches < 1 ||
      guard < 0 || guard > 2)
    return (int)cudaErrorInvalidValue;
  DsmArgs a;
  a.p = p; a.m = m; a.v = v; a.g = g;
  int hmax = 1;
  for (int k = 0; k < n_layers; ++k) {
    a.w_off[k] = w_off[k];
    a.b_off[k] = b_off[k];
  }
  for (int k = 0; k <= n_layers; ++k) {
    if (dims[k] < 1) return (int)cudaErrorInvalidValue;
    a.dims[k] = dims[k];
    if (k > 0 && k < n_layers && dims[k] > hmax) hmax = dims[k];
  }
  a.n_layers = n_layers; a.n_flat = n_flat;
  a.h0 = h0; a.eps = eps; a.s1 = s1; a.acts = acts; a.dz0 = dz0; a.dz1 = dz1;
  a.loss_part = loss_part; a.bad = bad; a.count0 = count0; a.count_out = count_out;
  a.losses = losses;
  a.B = B; a.n_epochs = n_epochs; a.n_batches = n_batches; a.n_active = n_active;
  a.guard = guard; a.hmax = hmax;
  a.inv_b = inv_b; a.lr = lr; a.b1 = b1; a.omb1 = omb1; a.b2 = b2; a.omb2 = omb2;
  a.log_b1 = log_b1; a.log_b2 = log_b2; a.adam_eps = adam_eps;

  const void* fn = bf16 ? (const void*)dsm_train_kernel<true> : (const void*)dsm_train_kernel<false>;
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, DT_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block must be resident for the grid syncs: at most what fits
  const int blocks = n_sm * (per_sm < 2 ? per_sm : 2);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(DT_THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
