"""Score-based diffusion models for inverse problems: the CDE.

Port of ``dmip_tpu/models/diffusion.py:36-237``: ``LossConfig``,
``DiffusionModel`` and ``CDE`` with ``init``, ``apply_a``,
``diffusion_state``, ``make_loss_fn`` (DSM, DSM_PDE, PINNLoss, PINNLoss2)
and ``sample``.  Parameters live outside the model, as a tuple of (W, b)
tensors.

``sample(method="auto")`` launches the fused E-M kernel for a CUDA device
and runs the plain Euler-Maruyama scan for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .. import losses as L
from .. import nets, samplers
from ..sde import ReverseSDE, sample_t

Tensor = torch.Tensor

_LATER = "is not ported yet; see ROADMAP.md §A"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training objective selection (mirrors dmip_tpu's LossConfig)."""

    name: str = "DSM"
    lam: float = 1.0
    lam2: float = 1.0
    pde_loss: str = "FPE"
    pde_metric: str = "L1"
    ic_metric: str = "L1"
    divergence_method: str = "exact"


@dataclasses.dataclass(frozen=True)
class DiffusionModel:
    xdim: int
    ydim: int
    hidden_layers: Tuple[int, ...] = (512, 512, 512)
    sde: ReverseSDE = dataclasses.field(default_factory=ReverseSDE)

    @property
    def net_in(self) -> int:
        return self.xdim + self.ydim + 1

    @property
    def net_out(self) -> int:
        return self.xdim

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        return nets.mlp_init(
            self.net_in, self.net_out, self.hidden_layers, generator=generator, device=device
        )

    def apply_a(self, params, z: Tensor, cond: Optional[Tensor], t) -> Tensor:
        """Learned drift a(z, cond, t); the net predicts g * score."""
        return nets.score_mlp_apply(params, z, cond, t)

    def diffusion_state(self, x: Tensor, y: Tensor):
        """(z0, cond): what is diffused and what conditions the net.  The
        CDE diffuses x conditioned on y."""
        return x, y

    def make_loss_fn(
        self,
        cfg: LossConfig,
        initial_condition: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    ):
        """loss(params, generator, x, y, *, t=None, eps=None, v=None) ->
        (scalar, info dict).

        Draws from ``generator``, in this order, whatever is not given: t
        (one ``torch.rand((batch, 1))`` through ``sample_t``), eps (normal,
        the shape of z0), and for a Hutchinson divergence the Rademacher
        probe v.  DSM draws no probe.  Passing t, eps and v (generator None)
        is the injection form the tests feed with another package's draws.
        """
        if cfg.name not in ("DSM", "DSM_PDE", "PINNLoss", "PINNLoss2"):
            raise ValueError(f"unsupported loss {cfg.name!r} for {type(self).__name__}")
        base = self.sde.base
        hutchinson = cfg.divergence_method != "exact" and cfg.pde_loss != "cScoreFPE"
        pde_kw = dict(pde_loss=cfg.pde_loss, pde_metric=cfg.pde_metric,
                      divergence_method=cfg.divergence_method)
        pinn_kw = dict(initial_condition=initial_condition, lam=cfg.lam, lam2=cfg.lam2,
                       ic_metric=cfg.ic_metric, **pde_kw)

        def loss_fn(params, generator: Optional[torch.Generator], x: Tensor, y: Tensor, *,
                    t: Optional[Tensor] = None, eps: Optional[Tensor] = None, v: Optional[Tensor] = None):
            z0, cond_y = self.diffusion_state(x, y)
            gen_dev = generator.device if generator is not None else "cpu"
            if t is None:
                t = sample_t(self.sde, z0.shape[0], generator).to(z0.device)
            if eps is None:
                eps = torch.randn(z0.shape, generator=generator, device=gen_dev, dtype=z0.dtype).to(z0.device)
            if cfg.name == "DSM":
                z_t = base.diffuse(t, z0, eps)
                cond = cond_y if z0.shape[-1] == x.shape[-1] else None
                score = self.apply_a(params, z_t, cond, t) / base.g(t)
                return torch.mean(L.dsm_loss(score, base.std(t), eps)), {}
            if v is None and hutchinson:
                v = L.rademacher_like(z0.shape, generator, device=z0.device, dtype=z0.dtype)
            if cfg.name == "DSM_PDE":
                return L.dsm_pde_loss(self.apply_a, params, base, x, y, z0, eps, t, lam=cfg.lam, v=v, **pde_kw)
            fn = L.pinn_loss if cfg.name == "PINNLoss" else L.pinn2_loss
            return fn(self.apply_a, params, base, x, y, z0, eps, t, v=v, **pinn_kw)

        return loss_fn

    def sample(
        self,
        params,
        y: Optional[Tensor],
        num_samples: int = 2000,
        num_steps: int = 200,
        mean: float = 0.0,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
        method: str = "auto",
        compute_dtype="auto",
    ) -> Tensor:
        """Posterior samples (num_samples, xdim) for the condition y (ydim,).

        method: 'auto' (the fused E-M kernel on a CUDA device, the plain
        Euler-Maruyama scan on the CPU), 'kernel' or 'plain'.  The device
        is ``device``, else y's.  compute_dtype ('auto' = bf16) is the
        kernel's weight/activation dtype; its sums and state stay f32.  The
        plain scan computes in f32.
        """
        if method == "heun" or method.startswith("expint"):
            raise NotImplementedError(f"sampler {method!r} {_LATER}")
        dev = torch.device(device) if device is not None else (
            y.device if y is not None else params[0][0].device)
        if method == "auto":
            method = "kernel" if dev.type == "cuda" else "plain"
        if method not in ("kernel", "plain"):
            raise ValueError(f"unknown sampler method {method!r}")
        if method == "plain":
            return samplers.euler_maruyama(
                self.sde, lambda z, c, s: self.apply_a(params, z, c, s), y,
                num_samples, self.xdim, num_steps, mean=mean, std=std,
                generator=generator, device=dev,
            )
        from ..ops.em_kernel import fused_em_sampler

        gen_dev = generator.device if generator is not None else "cpu"
        x0 = torch.randn(num_samples, self.xdim, generator=generator, device=gen_dev)
        x0 = (x0 * std + mean).to(dev)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev))
        base = self.sde.base
        return fused_em_sampler(
            params, x0, y, num_steps, T=self.sde.T, beta_min=base.beta_min,
            beta_max=base.beta_max, seed=seed,
            compute_dtype=torch.bfloat16 if compute_dtype == "auto" else compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class CDE(DiffusionModel):
    """Conditional Denoising Estimator: score net on [x, y, t] -> xdim."""
