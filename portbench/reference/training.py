"""A CDE's training epoch with the thesis's PINN loss and optax's Adam.

Each epoch draws from its own generator, seeded by (seed, epoch): on a
CUDA device seed' x 2^32 + epoch, on the CPU (seed' x 0x9E3779B1 + epoch)
mod 2^32, with seed' = seed mod 2^31.  It draws its batches first (the
linear problem: a permutation of the training set, then the observation
noise; scatterometry: 8 x batch fresh prior samples through the surrogate
and its noise), then for each batch in turn its times t (one uniform
column through the debiased sampler, shifted by 1e-4) and its noise eps.

The loss of a batch is mean(DSM + IC + PDE):
  DSM = |s(z_t, y, t) std(t) + eps|^2 / 2 with z_t = alpha(t) x + std(t) eps;
  IC  = lam2 mean_d (s(x, y, 0) - score_post(x, y))_d^2;
  PDE = lam mean_d |ds/dt - beta(t) / 2 grad_z h(z_t)|_d, ds/dt the total
        derivative along z_t(t), h(z) = div s + |s|^2 + z . s at fixed t,
        its gradient a constant for the parameters' gradient.
Here ds/dt is taken by reverse mode, one output at a time, and the
divergence the same way, where the program uses forward mode.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from . import mlp

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
T_EPS, SHIFT = 1e-3, 1e-4


def epoch_seed(seed: int, epoch: int, device) -> int:
    seed = int(seed) % 2**31
    if torch.device(device).type == "cpu":
        return (seed * 0x9E3779B1 + int(epoch)) % 2**32
    return seed * 2**32 + int(epoch)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    return gen.manual_seed(epoch_seed(seed, epoch, gen.device))


def _q(t: float, device) -> torch.Tensor:
    """log(e^B(t) - 1) in float32, as the sampler's bounds are computed."""
    b = mlp.int_beta(torch.tensor(t, dtype=torch.float32, device=device))
    return b + torch.log1p(-torch.exp(-b))


def debiased_t(u: torch.Tensor) -> torch.Tensor:
    """t with density proportional to g^2 / var on [T_EPS, 1], by the inverse
    CDF, shifted by SHIFT and shifted back above 1."""
    u0, u1 = _q(T_EPS, u.device), _q(mlp.T_END, u.device)
    b = torch.nn.functional.softplus(u0 + (u1 - u0) * u)
    bd = mlp.BETA_MAX - mlp.BETA_MIN
    t = torch.clamp((-mlp.BETA_MIN + torch.sqrt(mlp.BETA_MIN**2 + 2.0 * bd * b)) / bd, T_EPS, mlp.T_END) + SHIFT
    return torch.where(t > mlp.T_END, t - SHIFT, t)


def batch_draws(gen: torch.Generator, batch: int, xdim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.rand((batch, 1), generator=gen, device=gen.device)
    eps = torch.randn((batch, xdim), generator=gen, device=gen.device)
    return debiased_t(u), eps


def pinn_loss(params, x, y, t, eps, ic_fn: Callable, lam: float, lam2: float, pde_metric: str = "L1",
              ic_metric: str = "L2") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The batch's loss and its terms' means, differentiable in ``params``."""
    xdim = x.shape[1]
    t0 = torch.zeros_like(t)
    ic = mlp.score(params, x, y, t0)[:, :xdim] - ic_fn(x, y)
    ic = lam2 * (torch.mean(ic**2, dim=1) if ic_metric == "L2" else torch.mean(torch.abs(ic), dim=1))
    z_t = mlp.alpha(t) * x + mlp.std(t) * eps
    s = mlp.score(params, z_t, y, t)
    dsm = 0.5 * torch.sum((s * mlp.std(t) + eps) ** 2, dim=1)

    tt = t.detach().requires_grad_(True)
    s_t = mlp.score(params, mlp.alpha(tt) * x + mlp.std(tt) * eps, y, tt)
    ds_dt = torch.cat([torch.autograd.grad(s_t[:, d].sum(), tt, create_graph=True)[0] for d in range(xdim)], dim=1)

    fixed = [(w.detach(), b.detach()) for w, b in params]
    with torch.enable_grad():
        z = z_t.detach().requires_grad_(True)
        s_z = mlp.score(fixed, z, y, t)
        div = sum(torch.autograd.grad(s_z[:, d].sum(), z, create_graph=True)[0][:, d] for d in range(xdim))
        h = torch.sum(div + torch.sum(s_z**2, dim=1) + torch.sum(z * s_z, dim=1))
        (grad_z,) = torch.autograd.grad(h, z)
    res = ds_dt - 0.5 * mlp.beta(t) * grad_z.detach()
    pde = lam * (torch.mean(torch.abs(res), dim=1) if pde_metric == "L1" else torch.mean(res**2, dim=1))
    info = {"PDE-Loss": pde.mean(), "Initial Condition": ic.mean(), "DSM-Loss": dsm.mean()}
    return torch.mean(dsm + ic + pde), info


def adam_init(params) -> Dict[str, object]:
    leaves = [t for wb in params for t in wb]
    return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves], "nu": [torch.zeros_like(t) for t in leaves]}


def adam_step(params, state, grads: List[torch.Tensor], lr: float):
    """optax.adam: m, v, count + 1, bias corrections, lr m^ / (sqrt(v^) + eps)."""
    leaves = [t for wb in params for t in wb]
    count = state["count"] + 1
    mu = [(1 - ADAM_B1) * g_ + ADAM_B1 * m for g_, m in zip(grads, state["mu"])]
    nu = [(1 - ADAM_B2) * g_ * g_ + ADAM_B2 * v for g_, v in zip(grads, state["nu"])]
    bc1 = 1 - ADAM_B1**count
    bc2 = 1 - ADAM_B2**count
    new = [p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)) for p, m, v in zip(leaves, mu, nu)]
    return tuple(zip(new[0::2], new[1::2])), {"count": count, "mu": mu, "nu": nu}


def run_epoch(params, state, batches, draws_fn, loss_kw: dict, lr: float, batch_keep=None):
    """One epoch over ``batches`` ((nb, B, xdim), (nb, B, ydim)); batch i's
    draws from ``draws_fn(i)``, made just before its step.  ``batch_keep``
    (rows kept of each batch) plants the half-batch fault.  Returns (params,
    state, mean loss, mean info)."""
    xb, yb = batches
    losses, infos = [], []
    for i in range(xb.shape[0]):
        t, eps = draws_fn(i)
        x, y = xb[i], yb[i]
        if batch_keep is not None:
            x, y, t, eps = x[:batch_keep], y[:batch_keep], t[:batch_keep], eps[:batch_keep]
        leaves = [p.detach().requires_grad_(True) for wb in params for p in wb]
        tree = tuple(zip(leaves[0::2], leaves[1::2]))
        loss, info = pinn_loss(tree, x, y, t, eps, **loss_kw)
        grads = torch.autograd.grad(loss, leaves)
        params, state = adam_step(params, state, [g_.detach() for g_ in grads], lr)
        params = tuple((w.detach(), b.detach()) for w, b in params)
        losses.append(float(loss.detach()))
        infos.append({k: float(v.detach()) for k, v in info.items()})
    mean = {k: sum(d[k] for d in infos) / len(infos) for k in infos[0]}
    return params, state, sum(losses) / len(losses), mean
