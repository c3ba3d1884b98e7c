// Split-TF32 building blocks shared by the kernels whose f32 products run
// on the tensor cores (B2's hidden layers, the f32 mode of B1 and B4): the
// TF32 rounding, the hi / lo split, the mma.sync m16n8k8 TF32 product (B2)
// and the wgmma m64nNk8 TF32 product with A in registers (B1 / B4).
//
// A product a w in split TF32 is a_lo w_hi + a_hi w_lo + a_hi w_hi, each
// operand split into hi = tf32(x) and lo = x - hi; it keeps a result as
// close to float64 as f32 FMA does (PERF.md, ops/split_tf32_study.py),
// provided the long sum over K is not left to the tensor core, which
// truncates as it accumulates: a kernel issues a k-step's three products
// into a fresh tile and adds the tile into its f32 accumulators by FADD.
#pragma once
#include <stdint.h>

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, on the bits: the same rule as cvt.rna.tf32.f32 and as the plain
// model ops/mh_kernel.py tf32_rna (which also passes inf and NaN through;
// here a NaN may come out as inf, and a NaN follows it in the lo part).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32_rna(x) and lo = x - hi, exact in f32; the tensor core reads
// lo's top 19 bits (ops/mh_kernel.py split_tf32, tf32_trunc), which keeps
// as much as rounding lo would (PERF.md) in 3 operations, not 5.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (+)= A . B over one 8-deep step on a warpgroup: A (64 x 8) from
// registers, B (N x 8, K-major) in shared memory (descriptor db); scale_d =
// 0 overwrites d.  Thread lane of warp w (within the warpgroup) holds a[0]
// = A(16 w + lane / 4, lane % 4), a[1] the same 8 rows down, a[2] and a[3]
// those two 4 columns right, and d[4 j + e] = (row 16 w + lane / 4 + 8 (e /
// 2), column 8 j + 2 (lane % 4) + e % 2).  TF32 reads the top 19 bits of
// each 32-bit operand; it has no transposed form, so B is K-major.
template <int N> struct WgmmaTf32;

template <> struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
        "}, {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
