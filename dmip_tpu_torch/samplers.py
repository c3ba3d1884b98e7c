"""Reverse-SDE Euler-Maruyama posterior sampler.

Port of ``dmip_tpu/samplers.py:26-69``.  Time grid t_i = i/N * T for
i = 0..N-1, step delta = T/N, update
x <- x + delta mu(t_i, x, y) + sqrt(delta) sigma(t_i) xi.

This is also the plain version of the fused E-M kernel
(:mod:`dmip_tpu_torch.ops.em_kernel`), which calls it with a drift that
mirrors the kernel's bf16 casts.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .sde import ReverseSDE

Tensor = torch.Tensor


def euler_maruyama(
    sde: ReverseSDE,
    drift_a: Callable[[Tensor, Optional[Tensor], Tensor], Tensor],
    y: Optional[Tensor],
    num_samples: int,
    xdim: int,
    num_steps: int = 200,
    mean: float = 0.0,
    std: float = 1.0,
    lmbd: float = 0.0,
    noise_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
    x0: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Integrate the plug-in reverse SDE from x0 ~ N(mean, std^2).

    ``x0`` (num_samples, xdim) replaces the initial draw and ``noise``
    (num_steps, num_samples, xdim) the per-step normal draws, so two
    implementations can be fed the same random numbers.  ``noise_scale=0``
    makes the integrator deterministic.  ``y`` (ydim,) is tiled over the
    batch, or None for an unconditional net.
    """
    gen_dev = generator.device if generator is not None else "cpu"
    if x0 is None:
        x0 = torch.randn(num_samples, xdim, generator=generator, device=gen_dev)
        x0 = (x0 * std + mean).to(device)
    x = x0.to(torch.float32)
    dev = x.device
    cond = None
    if y is not None:
        cond = y.to(device=dev, dtype=x.dtype).expand(num_samples, y.shape[-1])
    delta = sde.T / num_steps
    ts = (torch.arange(num_steps, dtype=x.dtype, device=dev) / num_steps) * sde.T
    for i in range(num_steps):
        t_col = ts[i].expand(num_samples, 1)
        mu = sde.mu(drift_a, t_col, x, cond, lmbd)
        sigma = sde.sigma(t_col, lmbd)
        if noise is not None:
            xi = noise[i].to(dev)
        else:
            xi = torch.randn(x.shape, generator=generator, device=gen_dev).to(dev)
        x = x + delta * mu + math.sqrt(delta) * sigma * (noise_scale * xi)
    return x
