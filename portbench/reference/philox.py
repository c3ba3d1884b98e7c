"""Philox4x32-10 and the normals the fused E-M sampler draws from it.

The sampler kernel documents its noise: normal d of row r at step i comes
from Philox4x32-10 keyed by the 64-bit seed (low word, high word) with the
counter (r, i, d // 2, 0); words 0 and 1 of the output give even d, words
2 and 3 odd d, each pair through uniform = (bits >> 8) 2^-24 + 2^-24 and
Box-Muller's cosine branch.  This computes the same numbers with int64
tensor arithmetic, every product split in 16-bit halves so nothing
overflows.
"""

from __future__ import annotations

import math

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mul_hi_lo(a: torch.Tensor, m: int):
    """(high word, low word) of the 64-bit product of uint32 a and m."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    return a_hi * m_hi + (mid >> 16) + (low >> 32), low & MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words for counters (c0, c1, c2, c3) (int64 tensors
    holding uint32 values) and key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(c0, M0)
        hi1, lo1 = _mul_hi_lo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) + (1.0 / 16777216.0)


def _normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    u1, u2 = _uniform(b1), _uniform(b2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(torch.tensor(2.0 * math.pi, dtype=torch.float32) * u2)


def sampler_normals(seed: int, n_rows: int, dim: int, step0: int, step1: int, device) -> torch.Tensor:
    """The sampler's normals for steps step0 .. step1 - 1: (steps, n_rows, dim) float32."""
    seed &= 2**64 - 1
    k0, k1 = seed & MASK, seed >> 32
    steps = torch.arange(step0, step1, dtype=torch.int64, device=device).view(-1, 1, 1)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device).view(1, -1, 1)
    pairs = torch.arange((dim + 1) // 2, dtype=torch.int64, device=device).view(1, 1, -1)
    shape = (step1 - step0, n_rows, (dim + 1) // 2)
    w = philox4x32_10(rows.expand(shape), steps.expand(shape), pairs.expand(shape),
                      torch.zeros(shape, dtype=torch.int64, device=device), k0, k1)
    out = torch.stack([_normal(w[0], w[1]), _normal(w[2], w[3])], dim=-1)  # (steps, rows, pairs, 2)
    return out.reshape(step1 - step0, n_rows, -1)[..., :dim].contiguous()
