"""Energy-refined diffusion sampling: a learned conditional score proposes,
an exact-energy MCMC chain refines.

Port of ``dmip_tpu/models/refined.py``: :class:`EnergyRefinedModel` (:42)
and :func:`from_config` (:215), and :func:`from_spec`, which also takes the
scatterometry driver's dict form of a ``refine:`` key
(``mains/main_diffusion_scatterometry.py:131-141``).  :func:`for_problem`
is the drivers' one way to refine on a problem's energy.  The base model's
sampler proposes (on a CUDA device its fused kernel, B1 for the CDE, B4 for
the CDiffE); then ``refine_steps`` Metropolis-Hastings steps (random walk,
annealed, MALA) or unadjusted Langevin steps on the problem's exact
negative log posterior move the population, on the proposal's device, with
the chains of :mod:`dmip_tpu_torch.mcmc`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import mcmc
from ..problems import LinearForwardProblem
from ..problems.scatterometry import get_log_posterior

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class EnergyRefinedModel:
    """A diffusion model whose samples are refined by exact-energy MCMC.

    ``energy_fn(x, ys_tiled)`` -> (n,) is the NEGATIVE log posterior.
    ``kernel``: 'mh' (random walk of std ``noise_std``), 'mala' (Langevin
    proposals of ``lang_steps`` sub-steps of ``stepsize``) or 'ula'
    (``refine_steps`` unadjusted Langevin steps).  ``refine_frac`` < 1 keeps
    the raw proposal for the other chains (the mixture); ``anneal_from``,
    ``anneal_to``, ``anneal_frac`` and ``target_acc`` select
    :func:`mcmc.annealed_mh` (MH only); ``smooth_tau`` > 0 appends one ULA
    step of that size.  ``refine_steps=0`` (and no smoothing) is the base
    model.  ``sde``, ``xdim``, ``ydim`` and ``apply_a`` delegate to the base
    model, so score-MSE measures the learned score.
    """

    base_model: Any
    energy_fn: Callable[[Tensor, Tensor], Tensor]
    refine_steps: int = 10
    kernel: str = "mh"
    noise_std: float = 0.4
    stepsize: float = 5e-3
    lang_steps: int = 1
    refine_frac: float = 1.0
    anneal_from: float = 1.0
    anneal_frac: float = 1.0
    anneal_to: float = 1.0
    target_acc: float = 0.0
    smooth_tau: float = 0.0

    def __post_init__(self):
        if self.kernel not in ("mh", "mala", "ula"):
            raise ValueError(f"kernel must be 'mh', 'mala' or 'ula', got {self.kernel!r}")
        if self.kernel != "mh" and (
            self.anneal_from < 1.0 or self.anneal_to != 1.0 or self.target_acc > 0.0 or self.anneal_frac < 1.0
        ):
            raise ValueError(
                "anneal_from/anneal_to/anneal_frac/target_acc are implemented for the random-walk MH "
                f"kernel only (mcmc.annealed_mh); got kernel={self.kernel!r}"
            )
        if not 0.0 < self.anneal_frac <= 1.0:
            raise ValueError(f"anneal_frac must be in (0, 1], got {self.anneal_frac}")

    @property
    def sde(self):
        return self.base_model.sde

    @property
    def xdim(self) -> int:
        return self.base_model.xdim

    @property
    def ydim(self) -> int:
        return self.base_model.ydim

    def apply_a(self, params, z: Tensor, cond: Optional[Tensor], t) -> Tensor:
        return self.base_model.apply_a(params, z, cond, t)

    def refine(
        self,
        x: Tensor,
        y: Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        uniforms: Optional[Tensor] = None,
        keep_u: Optional[Tensor] = None,
        smooth_eta: Optional[Tensor] = None,
    ) -> Tensor:
        """Run the refinement chain on a population x (n, xdim) for y (ydim,).

        Draws, in this order, from ``generator`` unless given: the chain's
        (``noise`` and ``uniforms`` in the layout of the chain function the
        kernel selects; for 'ula' ``noise`` is the Langevin eta), the
        mixture's uniforms ``keep_u`` (n, 1), the smoothing step's eta
        ``smooth_eta`` (1, n, xdim).
        """
        if self.refine_steps <= 0 and self.smooth_tau <= 0.0:
            return x
        ys = y.to(device=x.device, dtype=x.dtype).expand(x.shape[0], y.shape[-1])
        energy = lambda z: self.energy_fn(z, ys)
        x_out = x
        if self.refine_steps > 0:
            draws = dict(generator=generator, noise=noise, uniforms=uniforms)
            if self.kernel == "mala":
                x_out, _ = mcmc.anneal_to_energy(x, energy, self.refine_steps, langevin_prop=True,
                                                 lang_steps=self.lang_steps, stepsize=self.stepsize, **draws)
            elif self.kernel == "ula":
                x_out, _, _, _ = mcmc.langevin_step(x, self.stepsize, energy, self.refine_steps,
                                                    generator=generator, eta=noise)
            elif self.anneal_from < 1.0 or self.anneal_to != 1.0 or self.target_acc > 0.0:
                x_out, _ = mcmc.annealed_mh(
                    x, energy, self.refine_steps, noise_std=self.noise_std, lambda0=self.anneal_from,
                    lambda1=self.anneal_to, target_acc=self.target_acc if self.target_acc > 0 else None,
                    anneal_frac=self.anneal_frac, **draws)
            else:
                x_out, _ = mcmc.anneal_to_energy(x, energy, self.refine_steps, noise_std=self.noise_std, **draws)
            if self.refine_frac < 1.0:
                if keep_u is None:
                    gen_dev = generator.device if generator is not None else x.device
                    keep_u = torch.rand((x.shape[0], 1), generator=generator, device=gen_dev)
                x_out = torch.where(keep_u.to(x.device) < self.refine_frac, x_out, x)
        if self.smooth_tau > 0.0:
            x_out, _, _, _ = mcmc.langevin_step(x_out, self.smooth_tau, energy, 1, generator=generator,
                                                eta=smooth_eta)
        return x_out

    def sample(
        self,
        params,
        y: Tensor,
        num_samples: int = 2000,
        num_steps: int = 200,
        mean: float = 0.0,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
        method: str = "auto",
    ) -> Tensor:
        """The base model's posterior samples (its fused kernel on a CUDA
        device, any of its sampler ``method``s), then the refinement chain
        on their device."""
        x = self.base_model.sample(params, y, num_samples, num_steps, mean=mean, std=std,
                                   generator=generator, device=device, method=method)
        return self.refine(x, y, generator=generator)


def from_config(model, energy, cfg_str: str):
    """Refinement grammar -> (model, tag), as ``dmip_tpu.models.refined``.

    ``'kernel,steps,param[,frac[,tau]][,key=value...]'``: kernel
    mh/mala/ula/none, param = noise_std (mh) or stepsize (mala/ula);
    positional frac < 1 = partial-refinement mixture, tau > 0 = one final
    ULA smoothing step.  Named options: ``anneal=L`` (start lambda),
    ``lend=L`` (final lambda), ``afrac=F`` (ramp over the first F of the
    steps), ``acc=A`` (adapt the proposal std toward acceptance A).
    """
    parts = cfg_str.split(",")
    named = {}
    positional = []
    for p in parts[3:]:
        if "=" in p:
            k, v = p.split("=", 1)
            named[k] = float(v)
        else:
            positional.append(p)
    kernel, steps, param = parts[0], int(parts[1]), parts[2]
    frac = float(positional[0]) if len(positional) > 0 else 1.0
    tau = float(positional[1]) if len(positional) > 1 else 0.0
    anneal = named.pop("anneal", 1.0)
    lend = named.pop("lend", 1.0)
    afrac = named.pop("afrac", 1.0)
    acc = named.pop("acc", 0.0)
    if named:
        raise ValueError(f"unknown refinement options: {sorted(named)}")
    if (kernel == "none" or steps == 0) and tau == 0.0:
        return model, "cde"
    if kernel == "none" or steps == 0:
        return EnergyRefinedModel(model, energy, refine_steps=0, smooth_tau=tau), f"cde_tau{tau}"
    kw = {"noise_std": float(param)} if kernel == "mh" else {"stepsize": float(param)}
    refined = EnergyRefinedModel(model, energy, refine_steps=steps, kernel=kernel, refine_frac=frac,
                                 smooth_tau=tau, anneal_from=anneal, anneal_to=lend, anneal_frac=afrac,
                                 target_acc=acc, **kw)
    tag = (f"{kernel}{steps}_{param}"
           + (f"_f{frac}" if frac < 1.0 else "")
           + (f"_tau{tau}" if tau > 0.0 else "")
           + (f"_a{anneal}" if anneal < 1.0 else "")
           + (f"_e{lend}" if lend != 1.0 else "")
           + (f"_af{afrac}" if afrac < 1.0 else "")
           + (f"_acc{acc}" if acc > 0.0 else ""))
    return refined, tag


def from_spec(model, energy, spec):
    """A config's ``refine:`` value -> (model, tag): the grammar string of
    :func:`from_config`, or the dict form ``{kernel, steps, noise_std,
    stepsize, lang_steps, anneal_from, anneal_to}`` with the JAX
    scatterometry driver's defaults (tag kernel + steps, e.g. 'mh20')."""
    if isinstance(spec, str):
        return from_config(model, energy, spec)
    refined = EnergyRefinedModel(
        model, energy,
        refine_steps=int(spec.get("steps", 5)),
        kernel=str(spec.get("kernel", "mh")),
        noise_std=float(spec.get("noise_std", 0.4)),
        stepsize=float(spec.get("stepsize", 5e-3)),
        lang_steps=int(spec.get("lang_steps", 1)),
        anneal_from=float(spec.get("anneal_from", 1.0)),
        anneal_to=float(spec.get("anneal_to", 1.0)),
    )
    return refined, f"{refined.kernel}{refined.refine_steps}"


def for_problem(problem: str, model, spec, forward_model=None, fparams=None):
    """A config's ``refine:`` value on a problem's exact energy -> (model,
    tag, out-dir suffix), as the JAX drivers build it: 'linear' refines on
    :meth:`LinearForwardProblem.log_posterior` into ``_refined_<tag>``;
    'scatterometry' on the surrogate posterior's energy
    (``forward_model``, ``fparams``' a, b and lambd_bd) into ``_refined``."""
    if problem == "linear":
        prob = LinearForwardProblem()
        refined, tag = from_spec(model, lambda x, ys: prob.log_posterior(x, ys)[:, 0], spec)
        return refined, tag, f"_refined_{tag}"
    if problem == "scatterometry":
        a, b, lambd_bd = fparams["a"], fparams["b"], fparams["lambd_bd"]
        refined, tag = from_spec(
            model, lambda x, ys: get_log_posterior(x, forward_model, a, b, ys, lambd_bd), spec)
        return refined, tag, "_refined"
    raise ValueError(f"unknown problem {problem!r}")
