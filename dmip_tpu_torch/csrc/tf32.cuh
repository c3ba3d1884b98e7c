// Split-TF32 building blocks shared by the kernels whose f32 products run
// on the tensor cores (B2's hidden layers, the f32 mode of B1 and B4): the
// TF32 rounding, the hi / lo split and the mma.sync m16n8k8 TF32 product.
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
