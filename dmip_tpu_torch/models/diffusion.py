"""Score-based diffusion models for inverse problems: the CDE, for sampling.

Port of ``dmip_tpu/models/diffusion.py:36-237``: ``LossConfig`` (config
only; the losses come with the training slice), ``DiffusionModel`` and
``CDE`` with ``init``, ``apply_a`` and ``sample``.  Parameters live outside
the model, as a tuple of (W, b) tensors.

``sample(method="auto")`` launches the fused E-M kernel for a CUDA device
and runs the plain Euler-Maruyama scan for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import nets, samplers
from ..sde import ReverseSDE

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
