// Counter-based Philox4x32-10 and the uniform / Box-Muller maps the JAX
// kernels use (dmip_tpu/ops/em_kernel.py:41-68).  Keyed by a 64-bit seed
// and a 4-word counter, so a stream depends on (seed, row, step, word) and
// not on how rows are tiled over blocks.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = c.x * 0xD2511F53u, hi0 = __umulhi(c.x, 0xD2511F53u);
    const uint32_t lo1 = c.z * 0xCD9E8D57u, hi1 = __umulhi(c.z, 0xCD9E8D57u);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// uint32 bits -> uniform in (0, 1]: top 24 bits, plus one ulp so log() is finite.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f) + (1.0f / 16777216.0f);
}

// Box-Muller, cosine branch only, as the JAX kernels draw one normal per pair.
__device__ __forceinline__ float normal_from_bits(uint32_t b1, uint32_t b2) {
  const float u1 = uniform_from_bits(b1), u2 = uniform_from_bits(b2);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}
