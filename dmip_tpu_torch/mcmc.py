"""MCMC kernels: Metropolis-Hastings, MALA and unadjusted Langevin.

Port of ``dmip_tpu/mcmc.py``: ``energy_grad`` (:26), ``langevin_step``
(:45), ``anneal_to_energy`` (:84) with random-walk or Langevin (MALA)
proposals, ``annealed_mh`` (:133) and ``interpolated_energy`` (:228).  An
energy maps (n, d) -> (n,) and returns the NEGATIVE log density.  All
chains advance together; nothing leaves the device of ``x`` (the draws are
made on the generator's device, else on x's).

Every function takes its draws from the caller when given (``noise``,
``uniforms``, ``eta``), so two implementations can be fed the same random
numbers.  Accept iff u < exp(log ratio), by ``torch.where``: an overflow to
inf accepts and a NaN energy rejects.  (The JAX chains blend
``(1 - acc) e + acc e'``, which agrees for finite energies.)

``anneal_to_energy`` with random-walk proposals is also the plain version of
the fused MH kernel (:mod:`dmip_tpu_torch.ops.mh_kernel`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
EnergyFn = Callable[[Tensor], Tensor]


def _draw(sample, shape, generator, like: Tensor, given: Optional[Tensor]) -> Tensor:
    """``given`` on x's device, else a draw of ``sample`` (torch.randn or
    torch.rand) from ``generator`` on its device, or on x's without one."""
    if given is not None:
        return given.to(like.device)
    dev = generator.device if generator is not None else like.device
    return sample(shape, generator=generator, device=dev, dtype=like.dtype).to(like.device)


def energy_grad(x: Tensor, energy: EnergyFn) -> Tuple[Tensor, Tensor]:
    """(grad of energy, per-sample energy) at x, by one forward and one
    backward pass.

    With grad enabled and an x that requires it (an SNF layer inside a
    loss), both stay in the graph (``create_graph``), so a loss
    differentiates through the gradient as ``jax.grad`` does through
    ``dmip_tpu.mcmc.energy_grad``.  Otherwise (also under
    ``torch.no_grad``, as the refinement chains run) both come back
    detached."""
    if torch.is_grad_enabled() and x.requires_grad:
        e = energy(x)
        (grad,) = torch.autograd.grad(e.sum(), x, create_graph=True)
        return grad, e
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        e = energy(z)
        (grad,) = torch.autograd.grad(e.sum(), z)
    return grad, e.detach()


def langevin_step(
    x: Tensor,
    stepsize: float,
    energy: EnergyFn,
    lang_steps: int,
    beta: float = 1.0,
    generator: Optional[torch.Generator] = None,
    eta: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Unadjusted Langevin trajectory of ``lang_steps`` sub-steps
    y = x - stepsize grad E(x) + sqrt(2 stepsize / beta) eta.

    Returns (x_final, log_det, energy at the initial point, energy at the
    final point); log_det accumulates 0.5 (|eta|^2 - |eta_back|^2), the
    forward/backward noise correction of the MALA acceptance ratio.  ``eta``
    (lang_steps, n, d) replaces the normal draws.  The gradient at a
    sub-step's end point is the next sub-step's start gradient.  Inside a
    loss (grad enabled, x requiring it) every term stays differentiable
    (:func:`energy_grad`).
    """
    scale = math.sqrt(2.0 * stepsize / beta)
    grad_x, e_x = energy_grad(x, energy)
    e_first = e_x
    log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(lang_steps):
        z = _draw(torch.randn, x.shape, generator, x, None if eta is None else eta[i])
        y = x - stepsize * grad_x + scale * z
        grad_y, e_y = energy_grad(y, energy)
        eta_back = (x - y + stepsize * grad_y) / scale
        log_det = log_det + 0.5 * torch.sum(z**2 - eta_back**2, dim=1)
        x, grad_x, e_x = y, grad_y, e_y
    return x, log_det, e_first, e_x


def anneal_to_energy(
    x_curr: Tensor,
    energy: EnergyFn,
    metr_steps_per_block: int,
    noise_std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    langevin_prop: bool = False,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
    lang_steps: Optional[int] = None,
    stepsize: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Run ``metr_steps_per_block`` Metropolis steps on every chain:
    Gaussian random-walk proposals of std ``noise_std``, or with
    ``langevin_prop`` Langevin (MALA) proposals of ``lang_steps`` sub-steps
    of ``stepsize``.

    Returns (x_final, e_final - e_initial).  The random walk carries the
    accepted energy from step to step; a Langevin proposal recomputes it
    with its gradient.  ``noise`` replaces the normal draws: (steps, n, d)
    for the random walk, (steps, lang_steps, n, d) for Langevin proposals;
    ``uniforms`` (steps, n) the accept draws.  Per step the proposal's
    draws come first, then the uniforms.
    """
    x = x_curr
    e0 = energy(x)
    e = e0
    for i in range(metr_steps_per_block):
        if langevin_prop:
            x_prop, log_det, e_curr, e_prop = langevin_step(
                x, stepsize, energy, lang_steps, generator=generator,
                eta=None if noise is None else noise[i])
            log_ratio = e_curr - e_prop + log_det
        else:
            xi = _draw(torch.randn, x.shape, generator, x, None if noise is None else noise[i])
            x_prop = x + noise_std * xi
            e_prop = energy(x_prop)
            e_curr = e
            log_ratio = e_curr - e_prop
        u = _draw(torch.rand, e_prop.shape, generator, x, None if uniforms is None else uniforms[i])
        acc = u < torch.exp(log_ratio)
        x = torch.where(acc[:, None], x_prop, x)
        e = torch.where(acc, e_prop, e_curr)
    return x, e - e0


def annealed_mh(
    x_curr: Tensor,
    energy: EnergyFn,
    steps: int,
    noise_std: float = 0.1,
    lambda0: float = 1.0,
    lambda1: float = 1.0,
    target_acc: Optional[float] = None,
    adapt_rate: float = 1.0,
    anneal_frac: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, dict]:
    """Random-walk MH chain whose target anneals through the interpolated
    energies lam E(x) + (1 - lam) |x|^2 / 2, lam running linearly from
    ``lambda0`` to ``lambda1`` over the first round(anneal_frac * steps)
    steps and holding ``lambda1`` after them (anneal-then-polish).

    ``target_acc`` adapts the shared log proposal std after every step by
    adapt_rate / (t + 1) (acc_rate - target_acc), on the device: no value
    is read back to the host inside the loop.  Both energies are carried,
    so each step evaluates E once.  ``noise`` (steps, n, d) and
    ``uniforms`` (steps, n) replace the draws.

    Returns (x_final, info): ``info['acc_rate']`` the per-step mean
    acceptance (steps,), ``info['noise_std']`` the final proposal std.
    """
    n_ramp = max(2, round(anneal_frac * steps)) if steps > 1 else steps
    lambdas = [lambda1] * steps
    if steps > 1:
        # jnp.linspace's f32 arithmetic, on the host: start (1 - s) + stop s
        s = torch.arange(n_ramp - 1, dtype=torch.float32) / (n_ramp - 1)
        lambdas[:n_ramp - 1] = (lambda0 * (1 - s) + lambda1 * s).tolist()
    x = x_curr
    e_post = energy(x)
    e_prior = 0.5 * torch.sum(x**2, dim=1)
    log_std = torch.log(torch.full((), noise_std, dtype=x.dtype, device=x.device))  # a fill, not a copy
    acc_rates = []
    for t, lam in enumerate(lambdas):
        xi = _draw(torch.randn, x.shape, generator, x, None if noise is None else noise[t])
        x_prop = x + torch.exp(log_std) * xi
        ep_prop = energy(x_prop)
        epr_prop = 0.5 * torch.sum(x_prop**2, dim=1)
        log_ratio = (lam * e_post + (1.0 - lam) * e_prior) - (lam * ep_prop + (1.0 - lam) * epr_prop)
        u = _draw(torch.rand, ep_prop.shape, generator, x, None if uniforms is None else uniforms[t])
        acc = u < torch.exp(log_ratio)
        x = torch.where(acc[:, None], x_prop, x)
        e_post = torch.where(acc, ep_prop, e_post)
        e_prior = torch.where(acc, epr_prop, e_prior)
        acc_rate = acc.to(x.dtype).mean()
        acc_rates.append(acc_rate)
        if target_acc is not None:
            log_std = log_std + adapt_rate / (t + 1.0) * (acc_rate - target_acc)
    acc_rate = torch.stack(acc_rates) if acc_rates else x.new_zeros(0)
    return x, {"acc_rate": acc_rate, "noise_std": torch.exp(log_std)}


def interpolated_energy(
    ys: Tensor, lambd: float, neg_log_posterior: Callable[[Tensor, Tensor], Tensor]
) -> EnergyFn:
    """lambd * (-log p(x|y)) + (1 - lambd) * |x|^2 / 2."""
    if lambd == 0.0:
        return lambda x: 0.5 * torch.sum(x**2, dim=1)
    if lambd == 1.0:
        return lambda x: neg_log_posterior(x, ys)
    return lambda x: lambd * neg_log_posterior(x, ys) + (1.0 - lambd) * 0.5 * torch.sum(x**2, dim=1)
