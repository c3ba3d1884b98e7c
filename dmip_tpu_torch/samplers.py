"""Reverse-SDE Euler-Maruyama posterior samplers: CDE and CDiffE.

Port of ``dmip_tpu/samplers.py:26-141``.  Time grid t_i = i/N * T for
i = 0..N-1, step delta = T/N, update
x <- x + delta mu(t_i, x, y) + sqrt(delta) sigma(t_i) xi.

These are also the plain versions of the fused E-M kernels
(:mod:`dmip_tpu_torch.ops.em_kernel`), which call them with a drift that
mirrors the kernels' bf16 casts.
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


def euler_maruyama_cdiffe(
    sde: ReverseSDE,
    drift_a: Callable[[Tensor, Optional[Tensor], Tensor], Tensor],
    y: Tensor,
    num_samples: int,
    xdim: int,
    num_steps: int = 200,
    mean: float = 0.0,
    std: float = 1.0,
    lmbd: float = 0.0,
    noise_scale: float = 1.0,
    y_noise: str = "fresh",
    generator: Optional[torch.Generator] = None,
    device=None,
    x0: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
    y_eps: Optional[Tensor] = None,
) -> Tensor:
    """CDiffE sampler: each step re-diffuses the observed y (ydim,) to
    s = T - t_i, y_t = alpha(s) y + std(s) eps_y, takes the unconditional
    joint drift a([x, y_t], None, s) and advances only the x block.

    ``y_noise``: 'fresh' (new eps_y every step), 'shared' (one eps_y for
    the whole trajectory) or 'mean' (y_t = alpha(s) y).  ``noise_scale=0``
    zeroes both the y noise and the integrator noise.

    Draws are over the joint width D = xdim + ydim, as in the JAX sampler:
    per step eps_y (fresh), then the integrator normals, each (num_samples,
    D); the x block moves with columns [:xdim] of the integrator draw and
    y_t with columns [xdim:] of eps_y.  ``x0`` replaces the initial draw,
    ``noise`` (num_steps, num_samples, D) the integrator draws and ``y_eps``
    the y draws: (num_steps, num_samples, D) for 'fresh', (num_samples, D)
    for 'shared'.  Passing the same tensor as ``noise`` and ``y_eps`` gives
    the fused CDiffE kernel's layout, one D-wide block per step.
    """
    if y_noise not in ("fresh", "shared", "mean"):
        raise ValueError(f"y_noise must be fresh|shared|mean, got {y_noise!r}")
    gen_dev = generator.device if generator is not None else "cpu"
    draw = lambda *shape: torch.randn(shape, generator=generator, device=gen_dev)
    if x0 is None:
        x0 = (draw(num_samples, xdim) * std + mean).to(device)
    x = x0.to(torch.float32)
    dev = x.device
    ydim = y.shape[-1]
    width = xdim + ydim
    y0 = y.to(device=dev, dtype=x.dtype).reshape(1, ydim)
    if y_noise == "shared" and y_eps is None:
        y_eps = draw(num_samples, width)
    delta = sde.T / num_steps
    ts = (torch.arange(num_steps, dtype=x.dtype, device=dev) / num_steps) * sde.T
    for i in range(num_steps):
        t_col = ts[i].expand(num_samples, 1)
        s = sde.T - t_col
        if y_noise == "mean":
            eps_y = torch.zeros(num_samples, ydim, device=dev)
        elif y_noise == "shared":
            eps_y = noise_scale * y_eps.to(dev)[:, xdim:]
        else:
            e = y_eps[i] if y_eps is not None else draw(num_samples, width)
            eps_y = noise_scale * e.to(dev)[:, xdim:]
        y_t = sde.base.mean_weight(s) * y0 + sde.base.std(s) * eps_y
        a = drift_a(torch.cat([x, y_t], dim=1), None, s)[:, :xdim]
        mu = (1.0 - 0.5 * lmbd) * sde.base.g(s) * a - sde.base.f(s, x)
        xi = noise[i] if noise is not None else draw(num_samples, width)
        x = x + delta * mu + math.sqrt(delta) * sde.sigma(t_col, lmbd) * (noise_scale * xi.to(dev)[:, :xdim])
    return x
