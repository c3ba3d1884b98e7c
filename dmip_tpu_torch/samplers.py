"""Reverse-SDE posterior samplers: Euler-Maruyama (CDE and CDiffE), Heun
and the exponential integrators.

Port of ``dmip_tpu/samplers.py``.  Euler-Maruyama (:26-141): time grid
t_i = i/N * T for i = 0..N-1, step delta = T/N, update
x <- x + delta mu(t_i, x, y) + sqrt(delta) sigma(t_i) xi.  These are also
the plain versions of the fused E-M kernels
(:mod:`dmip_tpu_torch.ops.em_kernel`), which call them with a drift that
mirrors the kernels' bf16 casts.

``heun_ode`` (:145), ``_exp_nodes`` (:209) and ``exponential_integrator``
(:242) are plain PyTorch in f32 on the caller's device: the probability-flow
ODE by Heun's method, and the DPM-Solver family, which integrates the linear
part of the VP reverse process in closed form.  ``batched_sampler`` (:376)
runs a single-condition sampler over a batch of conditions.
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
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Integrate the plug-in reverse SDE from x0 ~ N(mean, std^2).

    ``x0`` (num_samples, xdim) replaces the initial draw and ``noise``
    (num_steps, num_samples, xdim) the per-step normal draws, so two
    implementations can be fed the same random numbers.  ``noise_scale=0``
    makes the integrator deterministic.  ``y`` (ydim,) is tiled over the
    batch, or None for an unconditional net.  The state is kept in
    ``dtype`` (float32; float64 for a reference of the f32 versions).
    """
    gen_dev = generator.device if generator is not None else "cpu"
    if x0 is None:
        x0 = torch.randn(num_samples, xdim, generator=generator, device=gen_dev)
        x0 = (x0 * std + mean).to(device)
    x = x0.to(dtype)
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
    dtype: torch.dtype = torch.float32,
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
    the fused CDiffE kernel's layout, one D-wide block per step.  The
    state is kept in ``dtype``, as in :func:`euler_maruyama`.
    """
    if y_noise not in ("fresh", "shared", "mean"):
        raise ValueError(f"y_noise must be fresh|shared|mean, got {y_noise!r}")
    gen_dev = generator.device if generator is not None else "cpu"
    draw = lambda *shape: torch.randn(shape, generator=generator, device=gen_dev)
    if x0 is None:
        x0 = (draw(num_samples, xdim) * std + mean).to(device)
    x = x0.to(dtype)
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
            eps_y = torch.zeros(num_samples, ydim, device=dev, dtype=dtype)
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


def _initial_state(num_samples, xdim, mean, std, generator, device, x0):
    """x0 ~ N(mean, std^2) from ``generator`` on its device (else on
    ``device``), moved to ``device``; or the given ``x0``."""
    if x0 is None:
        gen_dev = generator.device if generator is not None else (device or "cpu")
        x0 = torch.randn(num_samples, xdim, generator=generator, device=gen_dev) * std + mean
    return x0.to(device=device, dtype=torch.float32)


def heun_ode(
    sde: ReverseSDE,
    drift_a: Callable[[Tensor, Optional[Tensor], Tensor], Tensor],
    y: Optional[Tensor],
    num_samples: int,
    xdim: int,
    num_steps: int = 50,
    mean: float = 0.0,
    std: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
    x0: Optional[Tensor] = None,
) -> Tensor:
    """Second-order (Heun) probability-flow ODE sampler: the drift is
    ``mu`` at lmbd = 1 (sigma = 0), Euler predictor and trapezoidal
    corrector, two drift evaluations a step.  The corrector's time on the
    last step is clamped to T - t_epsilon, inside the net's training range.
    Only x0 is random (``x0`` replaces its draw)."""
    x = _initial_state(num_samples, xdim, mean, std, generator, device, x0)
    dev = x.device
    cond = None if y is None else y.to(device=dev, dtype=x.dtype).expand(num_samples, y.shape[-1])
    delta = sde.T / num_steps
    # the step and corrector times in f32, as the JAX sampler forms them
    ts = (torch.arange(num_steps, dtype=torch.float32) / num_steps) * sde.T
    t_corr = torch.clamp(ts + delta, max=sde.T - sde.base.t_epsilon)

    def mu(t: float, z: Tensor) -> Tensor:
        t_col = torch.full((num_samples, 1), t, dtype=x.dtype, device=dev)
        return sde.mu(drift_a, t_col, z, cond, lmbd=1.0)

    for t_i, t_c in zip(ts.tolist(), t_corr.tolist()):
        d1 = mu(t_i, x)
        x_euler = x + delta * d1
        d2 = mu(t_c, x_euler)
        x = x + 0.5 * delta * (d1 + d2)
    return x


def _exp_nodes(base, num_steps: int):
    """Time nodes s_0 = T > s_1 > ... > s_num_steps = t_epsilon (the net's
    training floor) of the exponential integrators and their (alpha,
    sigma), float32 CPU tensors: uniform in the half-log-SNR lambda(s) =
    log(alpha / sigma) (the DPM-Solver schedule; ``dmip_tpu``'s
    grid='lambda'), inverted in closed form: B(s) = softplus(-2 lambda),
    then the quadratic of :meth:`VPSDE.sample_debiasing_t`.
    """
    s_min = base.t_epsilon

    def lam(s_):
        a = base.mean_weight(torch.tensor(s_, dtype=torch.float32))
        return torch.log(a) - torch.log(torch.sqrt(1.0 - a**2))

    lams = _linspace(lam(base.T), lam(s_min), num_steps + 1)
    # jax.nn.softplus: max(v, 0) + log1p(exp(-|v|)) (torch's switches to v above 20)
    v = -2.0 * lams
    b = torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))
    bd = base.beta_max - base.beta_min
    s = (-base.beta_min + torch.sqrt(base.beta_min**2 + 2.0 * bd * b)) / bd
    s[0], s[-1] = base.T, s_min
    return s, base.mean_weight(s), base.std(s)


def _linspace(start, stop, num: int) -> Tensor:
    """jnp.linspace's float32 arithmetic: start (1 - i/d) + stop i/d, then
    stop itself."""
    start, stop = (torch.as_tensor(v, dtype=torch.float32) for v in (start, stop))
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def exponential_integrator(
    sde: ReverseSDE,
    drift_a: Callable[[Tensor, Optional[Tensor], Tensor], Tensor],
    y: Optional[Tensor],
    num_samples: int,
    xdim: int,
    num_steps: int = 40,
    mean: float = 0.0,
    std: float = 1.0,
    ode: bool = False,
    order: int = 1,
    generator: Optional[torch.Generator] = None,
    device=None,
    x0: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Exponential integrators of the plug-in reverse process (DDIM /
    DPM-Solver): with eps_hat = -sigma a / g, each step s_i -> s_{i+1}
    (Phi = alpha_{i+1} / alpha_i) is

      ode=True:  x <- Phi x + (sigma_{i+1} - Phi sigma_i) eps_hat
      ode=False: x <- Phi x + 2 (sigma_{i+1} - Phi sigma_i) eps_hat + sqrt(Phi^2 - 1) z

    ``order=2`` extrapolates eps_hat to the step's midpoint in lambda from
    the previous step's (DPM-Solver++(2M)); the first step and the final
    denoise stay first order.  The nodes are uniform in lambda down to the
    net's training floor t_epsilon, where a final denoise x <- (x - sigma
    eps_hat) / alpha follows (``dmip_tpu``'s grid='lambda',
    final_denoise=True): num_steps + 1 net evaluations.  ``x0`` replaces
    the initial draw and ``noise`` (num_steps + 1, num_samples, xdim) the
    per-step normals (the ODE form and the denoise draw none).
    """
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order!r}")
    base = sde.base
    x = _initial_state(num_samples, xdim, mean, std, generator, device, x0)
    dev = x.device
    gen_dev = generator.device if generator is not None else dev
    cond = None if y is None else y.to(device=dev, dtype=x.dtype).expand(num_samples, y.shape[-1])

    s_nodes, alphas, sigmas = _exp_nodes(base, num_steps)
    lam = torch.log(alphas) - torch.log(sigmas)
    h = lam[1:] - lam[:-1]
    phi = alphas[1:] / alphas[:-1]
    c_ode = sigmas[1:] - phi * sigmas[:-1]
    c_eps = c_ode if ode else 2.0 * c_ode
    c_n = torch.zeros_like(phi) if ode else torch.sqrt(torch.clamp(phi**2 - 1.0, min=0.0))
    # the last node's net evaluation is the final denoise
    phi_f = 1.0 / alphas[-1]
    s_eval, sig_eval, g_eval = s_nodes, sigmas, base.g(s_nodes)
    phi = torch.cat([phi, phi_f[None]])
    c_eps = torch.cat([c_eps, (-phi_f * sigmas[-1])[None]])
    c_n = torch.cat([c_n, torch.zeros(1)])
    h = torch.cat([h, h[-1:]])
    h_prev = torch.cat([torch.ones(1), h[:-1]])
    c2 = h / (2.0 * h_prev)
    c2[0] = 0.0
    c2[num_steps:] = 0.0
    if order == 1:
        c2.zero_()
    steps = zip(*(v.tolist() for v in (s_eval, sig_eval, g_eval, phi, c_eps, c_n, c2)))

    eps_prev = torch.zeros_like(x)
    for i, (s_i, sig_i, g_i, phi_i, ce_i, cn_i, c2_i) in enumerate(steps):
        s_col = torch.full((num_samples, 1), s_i, dtype=x.dtype, device=dev)
        eps_hat = -sig_i * drift_a(x, cond, s_col) / g_i
        eps_use = eps_hat + c2_i * (eps_hat - eps_prev)
        x = phi_i * x + ce_i * eps_use
        if cn_i != 0.0:
            z = noise[i].to(dev) if noise is not None else torch.randn(x.shape, generator=generator,
                                                                        device=gen_dev).to(dev)
            x = x + cn_i * z
        eps_prev = eps_hat
    return x


def batched_sampler(sampler_fn: Callable[..., Tensor]) -> Callable[..., Tensor]:
    """A single-condition sampler over a batch of conditions.

    ``sampler_fn(draws, y) -> (num_samples, xdim)`` takes one condition's
    source of randomness (a ``torch.Generator``, or the ``x0`` / ``noise``
    it is given) and y (ydim,); the result ``run(draws, ys)`` takes one
    such source per condition and ys (n_y, ydim) and returns (n_y,
    num_samples, xdim).  The JAX package vmaps ``sampler_fn(key, y)`` over
    keys and ys; here the conditions run one after another, each from its
    own source, so a condition's samples do not depend on the others.
    """

    def run(draws, ys: Tensor) -> Tensor:
        if len(draws) != ys.shape[0]:
            raise ValueError(f"{len(draws)} sources of randomness for {ys.shape[0]} conditions")
        return torch.stack([sampler_fn(d, y) for d, y in zip(draws, ys)])

    return run
