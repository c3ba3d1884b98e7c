"""Score-matching and Score-Fokker-Planck (PINN) losses.

Port of ``dmip_tpu/losses.py:53-548``.  The derivatives in t and x are
``torch.func`` transforms over the batch, as the JAX package's
``impl='batched'`` path composes them:

  * exact divergence:      one forward-mode JVP per state dimension
  * Hutchinson divergence: v . (J^T v) by one VJP, with the probe v given
  * total ds/dt:           one JVP through t -> s(z_t(t), cond, t) / g(t)
  * grad_x:                reverse mode over the summed per-sample scalar
                           div(s) + |s|^2 + x . s

The parameter gradients are ordinary autograd through all of it: the
parameters are leaves that require grad, captured by the closures.

Semantics, as in the JAX package:
  * ds/dt is the TOTAL derivative: z_t = alpha(t) z0 + sigma(t) eps moves
    with t, and so does g(t).
  * grad_x is the partial derivative at fixed t and, with
    ``detach_grad_x=True`` (the default), a constant for the parameter
    gradient.
  * ``pinn2_loss`` takes ``ic_metric`` explicitly, default 'L1'.

Every random number (t, eps, the probe v) is an argument; the model's
``make_loss_fn`` draws them.

The DPS guidance terms (``dmip_tpu/losses.py:556-678``) are here too:
``likelihood_score_target`` (the Tweedie point-estimate likelihood
gradient) and ``pgdm_likelihood_score`` (its variance-corrected form).
They are the plain drift of ``AnalyticGuidanceDPS``.  ``posterior_loss``,
which trains a likelihood net on the first, is not ported yet (ROADMAP.md
§A item 11).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad, jvp, vjp

from .sde import VPSDE

Tensor = torch.Tensor

# A batched drift net: apply_a(params, z, cond_or_None, t) -> (batch, out_dim).
ApplyFn = Callable[..., Tensor]


def rademacher_like(shape, generator: Optional[torch.Generator] = None, device=None,
                    dtype=torch.float32) -> Tensor:
    """+/-1 probes, drawn on the generator's device and moved to ``device``."""
    gen_dev = generator.device if generator is not None else "cpu"
    bits = torch.randint(0, 2, shape, generator=generator, device=gen_dev)
    return (2 * bits - 1).to(dtype=dtype, device=device)


def divergence_exact(s_fn: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """Exact divergence of a per-sample field s: R^d -> R^d at x (d,)."""
    return torch.trace(torch.func.jacfwd(s_fn)(x))


def divergence_hutchinson(s_fn: Callable[[Tensor], Tensor], x: Tensor, v: Tensor) -> Tensor:
    """Hutchinson estimate v . (J_s(x)^T v) with a fixed probe v."""
    _, pullback = vjp(s_fn, x)
    return torch.dot(pullback(v)[0], v)


def dsm_loss(score: Tensor, std: Tensor, target: Tensor) -> Tensor:
    """Per-sample denoising score matching: |s std + eps|^2 / 2."""
    return 0.5 * torch.sum((score * std + target) ** 2, dim=tuple(range(1, score.ndim)))


def _check_metric(metric: str) -> None:
    if metric not in ("L1", "L2"):
        raise ValueError(f"metric must be 'L1' or 'L2', got {metric!r}")


def _fpe_probe(divergence_method: str, v: Optional[Tensor]) -> Optional[Tensor]:
    if divergence_method == "exact":
        return None
    if divergence_method in ("hutchinson", "approx", "approximate"):
        if v is None:
            raise ValueError("hutchinson divergence requires the probe v")
        return v
    raise ValueError(
        "divergence_method must be one of 'exact', 'hutchinson', 'approx', "
        f"'approximate'; got {divergence_method!r}"
    )


def _ds_dt(apply_a: ApplyFn, params, base_sde: VPSDE, z0: Tensor, eps: Tensor, cond, t_col: Tensor) -> Tensor:
    """Total ds/dt along the diffusion path, one JVP for the batch."""

    def s_of_t(tc):
        return apply_a(params, base_sde.diffuse(tc, z0, eps), cond, tc) / base_sde.g(tc)

    return jvp(s_of_t, (t_col,), (torch.ones_like(t_col),))[1]


def score_fpe_loss(
    apply_a: ApplyFn,
    params,
    base_sde: VPSDE,
    z0: Tensor,
    eps: Tensor,
    cond: Optional[Tensor],
    t: Tensor,
    *,
    metric: str = "L1",
    divergence_method: str = "exact",
    v: Optional[Tensor] = None,
    detach_grad_x: bool = True,
) -> Tensor:
    """ScoreFPE residual ds/dt - beta/2 grad_x(div s + |s|^2 + x . s),
    reduced per sample by the MEAN over dimensions of |.| (L1) or (.)^2
    (L2); shape (batch,).  ``v`` is the Hutchinson probe (batch, d)."""
    _check_metric(metric)
    batch, d = z0.shape
    t_col = t.reshape(batch, 1)
    beta = base_sde.beta(t_col)
    z_t = base_sde.diffuse(t_col, z0, eps)
    probe = _fpe_probe(divergence_method, v)

    def s_of_x(z):
        return apply_a(params, z, cond, t_col) / base_sde.g(t_col)

    ds_dt = _ds_dt(apply_a, params, base_sde, z0, eps, cond, t_col)

    if probe is None:
        def div_fn(z):
            out = torch.zeros(batch, dtype=z.dtype, device=z.device)
            for i in range(d):
                e_i = torch.zeros_like(z)
                e_i[:, i] = 1.0
                out = out + jvp(s_of_x, (z,), (e_i,))[1][:, i]
            return out
    else:
        def div_fn(z):
            _, pullback = vjp(s_of_x, z)
            return torch.sum(pullback(probe)[0] * probe, dim=1)

    def h_sum(z):
        s = s_of_x(z)
        return torch.sum(div_fn(z) + torch.sum(s**2, dim=1) + torch.sum(z * s, dim=1))

    if detach_grad_x:
        # a constant for the parameter gradient: build no outer graph for it
        with torch.no_grad():
            grad_x = grad(h_sum)(z_t)
    else:
        grad_x = grad(h_sum)(z_t)
    res = ds_dt - 0.5 * beta * grad_x
    if metric == "L1":
        return torch.mean(torch.abs(res), dim=1)
    return torch.mean(res**2, dim=1)


def cscore_fpe_loss(
    apply_a: ApplyFn,
    params,
    base_sde: VPSDE,
    z0: Tensor,
    eps: Tensor,
    cond: Optional[Tensor],
    t: Tensor,
    *,
    metric: str = "L2",
) -> Tensor:
    """cScoreFPE: per-sample SUM over dims of |std^3 ds/dt - eps beta alpha^2 / 2|^p."""
    _check_metric(metric)
    t_col = t.reshape(z0.shape[0], 1)
    ds_dt = _ds_dt(apply_a, params, base_sde, z0, eps, cond, t_col)
    alpha = base_sde.mean_weight(t_col)
    u = 0.5 * eps * base_sde.beta(t_col) * alpha**2
    res = base_sde.std(t_col) ** 3 * ds_dt - u
    if metric == "L2":
        return torch.sum(res**2, dim=1)
    return torch.sum(torch.abs(res), dim=1)


def _cond_for(z0: Tensor, x: Tensor, y: Tensor) -> Optional[Tensor]:
    return y if z0.shape[-1] == x.shape[-1] else None


def _batched_score(apply_a, params, base_sde, z_t, cond, t):
    return apply_a(params, z_t, cond, t) / base_sde.g(t)


def _pde_term(pde_loss, pde_metric, divergence_method, apply_a, params, base_sde, z0, eps, cond, t, v):
    if pde_loss == "cScoreFPE":
        return cscore_fpe_loss(apply_a, params, base_sde, z0, eps, cond, t, metric=pde_metric)
    return score_fpe_loss(
        apply_a, params, base_sde, z0, eps, cond, t,
        metric=pde_metric, divergence_method=divergence_method, v=v,
    )


def dsm_pde_loss(
    apply_a: ApplyFn,
    params,
    base_sde: VPSDE,
    x: Tensor,
    y: Tensor,
    z0: Tensor,
    eps: Tensor,
    t: Tensor,
    *,
    lam: float = 1.0,
    pde_loss: str = "FPE",
    pde_metric: str = "L1",
    divergence_method: str = "exact",
    v: Optional[Tensor] = None,
):
    """mean(DSM + lam PDE); returns (loss, info)."""
    cond = _cond_for(z0, x, y)
    z_t = base_sde.diffuse(t, z0, eps)
    score = _batched_score(apply_a, params, base_sde, z_t, cond, t)
    dsm = dsm_loss(score, base_sde.std(t), eps)
    pde = lam * _pde_term(pde_loss, pde_metric, divergence_method, apply_a, params, base_sde, z0, eps, cond, t, v)
    return torch.mean(dsm + pde), {"PDE-Loss": torch.mean(pde), "DSM-Loss": torch.mean(dsm)}


def _ic_term(apply_a, params, base_sde, x, y, initial_condition, ic_metric, lam2, xdim):
    """lam2 |s_0[:, :xdim] - score_post(x, y)|, per sample; s_0 = a(x, y, 0)/g(0)."""
    t0 = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
    s0 = apply_a(params, x, y, t0) / base_sde.g(t0)
    ic = s0[:, :xdim] - initial_condition(x, y)
    if ic_metric == "L2":
        return lam2 * torch.mean(ic**2, dim=1)
    if ic_metric == "L1":
        return lam2 * torch.mean(torch.abs(ic), dim=1)
    raise ValueError(f"ic_metric must be 'L1' or 'L2', got {ic_metric!r}")


def pinn_loss(
    apply_a: ApplyFn,
    params,
    base_sde: VPSDE,
    x: Tensor,
    y: Tensor,
    z0: Tensor,
    eps: Tensor,
    t: Tensor,
    *,
    initial_condition: Callable[[Tensor, Tensor], Tensor],
    lam: float = 1.0,
    lam2: float = 1.0,
    pde_loss: str = "FPE",
    ic_metric: str = "L1",
    pde_metric: str = "L1",
    divergence_method: str = "exact",
    v: Optional[Tensor] = None,
):
    """PINN objective mean(DSM + lam2 IC + lam PDE); returns (loss, info)."""
    cond = _cond_for(z0, x, y)
    z_t = base_sde.diffuse(t, z0, eps)
    ic = _ic_term(apply_a, params, base_sde, x, y, initial_condition, ic_metric, lam2, x.shape[-1])
    score = _batched_score(apply_a, params, base_sde, z_t, cond, t)
    dsm = dsm_loss(score, base_sde.std(t), eps)
    pde = lam * _pde_term(pde_loss, pde_metric, divergence_method, apply_a, params, base_sde, z0, eps, cond, t, v)
    info = {"PDE-Loss": torch.mean(pde), "Initial Condition": torch.mean(ic), "DSM-Loss": torch.mean(dsm)}
    return torch.mean(dsm + ic + pde), info


def pinn2_loss(
    apply_a: ApplyFn,
    params,
    base_sde: VPSDE,
    x: Tensor,
    y: Tensor,
    z0: Tensor,
    eps: Tensor,
    t: Tensor,
    *,
    initial_condition: Callable[[Tensor, Tensor], Tensor],
    lam: float = 1.0,
    lam2: float = 1.0,
    pde_loss: str = "FPE",
    ic_metric: str = "L1",
    pde_metric: str = "L1",
    divergence_method: str = "exact",
    v: Optional[Tensor] = None,
):
    """PINN without the DSM data term, mean(IC + lam PDE); DSM is only
    logged (``DSM_eval``).  Returns (loss, info)."""
    cond = _cond_for(z0, x, y)
    z_t = base_sde.diffuse(t, z0, eps)
    ic = _ic_term(apply_a, params, base_sde, x, y, initial_condition, ic_metric, lam2, x.shape[-1])
    pde = lam * _pde_term(pde_loss, pde_metric, divergence_method, apply_a, params, base_sde, z0, eps, cond, t, v)
    with torch.no_grad():
        dsm_eval = dsm_loss(_batched_score(apply_a, params, base_sde, z_t, cond, t), base_sde.std(t), eps)
    info = {"PDE-Loss": torch.mean(pde), "Initial Condition": torch.mean(ic), "DSM_eval": torch.mean(dsm_eval)}
    return torch.mean(ic + pde), info


def likelihood_score_target(
    prior_apply: Callable[..., Tensor],
    prior_params,
    base_sde: VPSDE,
    forward_fn: Callable[[Tensor], Tensor],
    x_t: Tensor,
    y: Tensor,
    t: Tensor,
    *,
    a: float,
    b: float,
    s_prior: Optional[Tensor] = None,
) -> Tensor:
    """alpha * grad_{x_t} log p(y | x_hat_0(x_t)), the DPS likelihood score.

    Tweedie estimate x_hat_0 = (x_t + std^2 s_prior) / alpha, then the exact
    gradient of log N(y; f(x_0), (a f)^2 + b^2) through the surrogate (three
    VJPs, with the corrected v3 = (y - f)^2 f / prefactor^2) and through
    x_hat_0 (three VJPs of the prior net at x_t).  ``prior_apply(params, x,
    t)`` and ``forward_fn`` act on batches whose rows are independent, so one
    batched VJP per cotangent gives every row's VJP.  x_t (batch, xdim), y
    (batch, ydim), t (batch, 1).
    """
    t = t.reshape(x_t.shape[0], 1)
    std = base_sde.std(t)
    alpha = base_sde.mean_weight(t)
    if s_prior is None:
        s_prior = prior_apply(prior_params, x_t, t)
    x_0 = (x_t + std**2 * s_prior) / alpha
    f_x, vjp_f = vjp(forward_fn, x_0)
    prefactor = (a * f_x) ** 2 + b**2
    v1 = f_x / prefactor
    v2 = (y - f_x) / prefactor
    v3 = (y - f_x) ** 2 * f_x / prefactor**2
    vjp1, vjp2, vjp3 = (vjp_f(v)[0] for v in (v1, v2, v3))
    _, vjp_s = vjp(lambda xt: prior_apply(prior_params, xt, t), x_t)
    vhp1, vhp2, vhp3 = (vjp_s(v)[0] for v in (vjp1, vjp2, vjp3))
    sig2 = std**2
    return -(a**2) * (sig2 * vhp1 + vjp1) + sig2 * vhp2 + vjp2 + a**2 * (sig2 * vhp3 + vjp3)


def pgdm_likelihood_score(
    prior_apply: Callable[..., Tensor],
    prior_params,
    base_sde: VPSDE,
    forward_fn: Callable[[Tensor], Tensor],
    x_t: Tensor,
    y: Tensor,
    t: Tensor,
    *,
    a: float,
    b: float,
) -> Tensor:
    """Variance-corrected DPS guidance grad_{x_t} log p(y | x_t) (PiGDM).

    p(y | x_t) ~= N(f(x_hat_0), D + r^2 J J^T), D = (a f)^2 + b^2 diagonal,
    J = df/dx_0 at x_hat_0, r^2 = std^2 / (alpha^2 + std^2); the covariance
    is held constant in x_t and solved by Woodbury with the xdim x xdim
    inner matrix M = I + r^2 J^T D^-1 J.  Per sample, as the JAX function:
    ``vmap`` of ``grad`` of -1/2 r^T C^-1 r with ``jacfwd`` for J.
    """
    batch = x_t.shape[0]
    t = t.reshape(batch, 1)
    std = base_sde.std(t).reshape(batch)
    alpha = base_sde.mean_weight(t).reshape(batch)
    r2 = std**2 / (alpha**2 + std**2)

    def per_sample(xt_i, y_i, t_i, sig_i, al_i, r2_i):
        def x0_of(xt):
            s = prior_apply(prior_params, xt[None], t_i.reshape(1, 1))[0]
            return (xt + sig_i**2 * s) / al_i

        x0 = x0_of(xt_i)
        f0 = forward_fn(x0)
        jac = torch.func.jacfwd(forward_fn)(x0)  # (ydim, xdim)
        dinv = 1.0 / ((a * f0) ** 2 + b**2)
        dinv_j = dinv[:, None] * jac
        m = torch.eye(jac.shape[1], dtype=jac.dtype, device=jac.device) + r2_i * (jac.T @ dinv_j)

        def cov_solve(v):
            return dinv * v - r2_i * (dinv_j @ torch.linalg.solve(m, dinv_j.T @ v))

        def ell(xt):
            resid = y_i - forward_fn(x0_of(xt))
            return -0.5 * torch.dot(resid, cov_solve(resid))

        return grad(ell)(xt_i)

    return torch.func.vmap(per_sample)(x_t, y, t.reshape(batch), std, alpha, r2)
