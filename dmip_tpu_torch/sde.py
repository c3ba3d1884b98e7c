"""Variance-preserving SDE, sampling-time closed forms.

Port of ``dmip_tpu/sde.py`` (``VPSDE`` :30-127, ``ReverseSDE`` :131-165):
the parts the posterior sampler needs.  The training-time samplers
(``sample_debiasing_t``, ``sample_t``, the ELBO/DSM helpers) come with the
training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

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
