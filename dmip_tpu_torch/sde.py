"""Variance-preserving SDE: closed forms, marginals and the t samplers.

Port of ``dmip_tpu/sde.py``: ``VPSDE`` (:30-127) with ``marginal_sample``,
``diffuse`` and the debiased t sampler, ``ReverseSDE`` (:131-165) and
``sample_t`` (:254-270), and the ELBO tools ``log_normal``, ``sample_v``,
``reverse_sde_dsm`` and ``elbo_random_t_slice`` (:167-251).  Every draw
takes an explicit ``torch.Generator`` and happens on the generator's device;
the t samplers also take the uniforms ``u`` themselves, and the ELBO tools
their t and noise, so two implementations can be fed the same numbers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from . import device_constant

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """beta(t) = beta_min + (beta_max - beta_min) t; f = -beta/2 x; g = sqrt(beta)."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    T: float = 1.0
    t_epsilon: float = 0.001

    def beta(self, t: Tensor) -> Tensor:
        return self.beta_min + (self.beta_max - self.beta_min) * t

    def int_beta(self, t: Tensor) -> Tensor:
        """B(t) = 1/2 (beta_max - beta_min) t^2 + beta_min t."""
        return 0.5 * (self.beta_max - self.beta_min) * t**2 + self.beta_min * t

    def mean_weight(self, t: Tensor) -> Tensor:
        return torch.exp(-0.5 * self.int_beta(t))

    def var(self, t: Tensor) -> Tensor:
        return 1.0 - torch.exp(-self.int_beta(t))

    def std(self, t: Tensor) -> Tensor:
        return torch.sqrt(self.var(t))

    def f(self, t: Tensor, y: Tensor) -> Tensor:
        return -0.5 * self.beta(t) * y

    def g(self, t: Tensor) -> Tensor:
        return torch.sqrt(self.beta(t))

    def marginal_sample(self, t: Tensor, y0: Tensor, generator: Optional[torch.Generator] = None):
        """(y_t, epsilon, std, g) with y_t = mean_weight(t) y0 + std(t) epsilon."""
        gen_dev = generator.device if generator is not None else y0.device
        epsilon = torch.randn(y0.shape, generator=generator, device=gen_dev, dtype=y0.dtype).to(y0.device)
        std = self.std(t)
        return epsilon * std + self.mean_weight(t) * y0, epsilon, std, self.g(t) * torch.ones_like(y0)

    def diffuse(self, t: Tensor, y0: Tensor, epsilon: Tensor) -> Tensor:
        """y_t as a differentiable function of t, given the noise."""
        return self.mean_weight(t) * y0 + self.std(t) * epsilon

    def sample_debiasing_t(
        self, shape, generator: Optional[torch.Generator] = None, u: Optional[Tensor] = None
    ) -> Tensor:
        """t with density proportional to g(t)^2 / var(t) on [t_epsilon, T],
        by the closed-form inverse CDF: u ~ U(Q(t_eps), Q(T)) with
        Q(t) = log(e^B(t) - 1), then B(t) = softplus(u) solved for t.
        ``u`` in [0, 1) replaces the uniform draw."""
        if u is None:
            gen_dev = generator.device if generator is not None else "cpu"
            u = torch.rand(shape, generator=generator, device=gen_dev)
        u0, u1 = _debias_bounds(self, u.dtype, u.device)
        b = torch.nn.functional.softplus(u0 + (u1 - u0) * u)
        bd = self.beta_max - self.beta_min
        t = (-self.beta_min + torch.sqrt(self.beta_min**2 + 2.0 * bd * b)) / bd
        return torch.clamp(t, self.t_epsilon, self.T)

    def _Q(self, t: Tensor) -> Tensor:
        b = self.int_beta(t)
        return b + torch.log1p(-torch.exp(-b))


@functools.lru_cache(maxsize=None)
def _debias_bounds(sde: VPSDE, dtype: torch.dtype, device: torch.device) -> Tuple[Tensor, Tensor]:
    """(Q(t_epsilon), Q(T)) of :meth:`VPSDE.sample_debiasing_t` on
    ``device``, computed once: the sampler runs in every train step."""
    with torch.inference_mode(False), torch.no_grad():
        return sde._Q(device_constant(sde.t_epsilon, dtype, device)), sde._Q(device_constant(sde.T, dtype, device))


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Plug-in reverse SDE run forward in t in [0, T]:

    mu(t, x, c) = (1 - lmbd/2) g(T-t) a(x, c, T-t) - f(T-t, x)
    sigma(t)    = sqrt(1 - lmbd) g(T-t)
    """

    base: VPSDE = dataclasses.field(default_factory=VPSDE)
    T: float = 1.0
    debias: bool = True

    def mu(
        self,
        drift_a: Callable[[Tensor, Optional[Tensor], Tensor], Tensor],
        t: Tensor,
        x: Tensor,
        cond: Optional[Tensor],
        lmbd: float = 0.0,
    ) -> Tensor:
        s = self.T - t
        return (1.0 - 0.5 * lmbd) * self.base.g(s) * drift_a(x, cond, s) - self.base.f(s, x)

    def sigma(self, t: Tensor, lmbd: float = 0.0) -> Tensor:
        return math.sqrt(1.0 - lmbd) * self.base.g(self.T - t)


def _draw(sample, shape, generator: Optional[torch.Generator], like: Tensor) -> Tensor:
    """A draw of ``sample`` (torch.randn or torch.rand) from ``generator``
    on its device, or on like's without one, moved to like's device."""
    dev = generator.device if generator is not None else like.device
    return sample(shape, generator=generator, device=dev, dtype=like.dtype).to(like.device)


def log_normal(x: Tensor, mean: Tensor, log_var: Tensor) -> Tensor:
    """Elementwise Gaussian log density."""
    return -0.5 * (math.log(2.0 * math.pi) + log_var + (x - mean) ** 2 / torch.exp(log_var))


def sample_v(shape, vtype: str = "rademacher", generator: Optional[torch.Generator] = None, device=None) -> Tensor:
    """Hutchinson probe vectors: Rademacher (+-1) or standard normal, drawn
    on the generator's device, else on ``device``, and moved to ``device``."""
    dev = generator.device if generator is not None else device
    if vtype == "rademacher":
        return (2.0 * torch.randint(0, 2, shape, generator=generator, device=dev) - 1.0).to(device)
    if vtype in ("normal", "gaussian"):
        return torch.randn(shape, generator=generator, device=dev).to(device)
    raise ValueError(f"unknown vtype {vtype!r}")


def reverse_sde_dsm(
    sde: ReverseSDE,
    apply_a: Callable[..., Tensor],
    params,
    x: Tensor,
    cond: Optional[Tensor],
    generator: Optional[torch.Generator] = None,
    t: Optional[Tensor] = None,
    eps: Optional[Tensor] = None,
) -> Tensor:
    """Per-sample DSM loss of the plug-in reverse SDE,
    1/2 |a(y_t, cond, t) std / g + eps|^2, with t from the debiased sampler
    (or uniform on [0, T]) and y_t diffused from x.  ``t`` (batch, 1) and
    ``eps`` replace the draws (t first, then eps)."""
    batch = x.shape[0]
    if t is None:
        u = _draw(torch.rand, (batch, 1), generator, x)
        t = sde.base.sample_debiasing_t(u.shape, u=u) if sde.debias else u * sde.T
    t = t.to(x.device)
    eps = _draw(torch.randn, x.shape, generator, x) if eps is None else eps.to(x.device)
    y_t = sde.base.diffuse(t, x, eps)
    a = apply_a(params, y_t, cond, t)
    return 0.5 * torch.sum((a * sde.base.std(t) / sde.base.g(t) + eps) ** 2, dim=1)


def elbo_random_t_slice(
    sde: ReverseSDE,
    apply_a: Callable[..., Tensor],
    params,
    x: Tensor,
    cond: Optional[Tensor] = None,
    vtype: str = "rademacher",
    generator: Optional[torch.Generator] = None,
    t: Optional[Tensor] = None,
    eps: Optional[Tensor] = None,
    v: Optional[Tensor] = None,
    eps_T: Optional[Tensor] = None,
) -> Tensor:
    """Single-t-slice ELBO estimate of the plug-in reverse SDE: t ~ U(0, T),
    y_t from the marginal, div(mu) by one Hutchinson vector-Jacobian probe
    (``torch.func.vjp``, so also under ``torch.no_grad``), and the prior
    term log N(y_T; 0, I).  ``t`` (batch, 1), ``eps``, ``v`` and ``eps_T``
    replace the draws, made in that order."""
    batch = x.shape[0]
    if t is None:
        t = _draw(torch.rand, (batch, 1), generator, x) * sde.T
    t = t.to(x.device)
    qt = 1.0 / sde.T
    eps = _draw(torch.randn, x.shape, generator, x) if eps is None else eps.to(x.device)
    y = sde.base.diffuse(t, x, eps)
    v = sample_v(x.shape, vtype, generator, device=x.device) if v is None else v.to(x.device)

    def mu_fn(y_in):
        return sde.base.g(t) * apply_a(params, y_in, cond, t) - sde.base.f(t, y_in)

    a_val = apply_a(params, y, cond, t)
    _, vjp = torch.func.vjp(mu_fn, y)
    mu_div_probe = torch.sum(vjp(v)[0] * v, dim=1)
    Mu = -mu_div_probe / qt
    Nu = -0.5 * torch.sum(a_val**2, dim=1) / qt
    eps_T = _draw(torch.randn, x.shape, generator, x) if eps_T is None else eps_T.to(x.device)
    y_T = sde.base.diffuse(torch.full((batch, 1), sde.base.T, dtype=x.dtype, device=x.device), x, eps_T)
    lp = torch.sum(log_normal(y_T, torch.zeros_like(y_T), torch.zeros_like(y_T)), dim=1)
    return lp + Mu + Nu


def sample_t(
    sde: ReverseSDE,
    batch: int,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-4,
    u: Optional[Tensor] = None,
) -> Tensor:
    """Per-example diffusion times (batch, 1): the debiased sampler shifted
    by ``eps`` with values above T shifted back, or uniform on [eps, T] with
    values above T mapped to T - eps.  The uniforms are one
    ``torch.rand((batch, 1))`` draw from ``generator`` on its device, or
    ``u`` of any shape when given."""
    if u is None:
        gen_dev = generator.device if generator is not None else "cpu"
        u = torch.rand((batch, 1), generator=generator, device=gen_dev)
    if sde.debias:
        t = sde.base.sample_debiasing_t(u.shape, u=u) + eps
        return torch.where(t > sde.T, t - eps, t)
    t = eps + u * sde.T
    return torch.where(t > sde.T, torch.full_like(t, sde.T - eps), t)
