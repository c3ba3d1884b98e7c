"""Linear-Gaussian toy inverse problem with an analytic posterior.

Port of ``dmip_tpu/problems/linear.py:29-176`` (forward model, posterior
moments, sampling, log density, the quadratic energy and the score).  f(x) = A x + b with
A = [[1, .5], [0, 1]], b = (0.3, 0.5), noise covariance Sigma = 0.3 I and a
standard-normal prior.  The constants of the forward model, the score and
the posterior moments are built once per device and dtype (the caller's
tensors'), so a call only queues work on the device and never copies from
the host or waits for it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LinearForwardProblem:
    xdim: int = 2
    ydim: int = 2
    scale: float = 0.3
    epsilon: float = 1e-6

    # -- constants, on the device/dtype of a reference tensor ---------------
    def A(self, like: Tensor) -> Tensor:
        return torch.tensor([[1.0, 0.5], [0.0, 1.0]], dtype=like.dtype, device=like.device)

    def b(self, like: Tensor) -> Tensor:
        return torch.tensor([0.3, 0.5], dtype=like.dtype, device=like.device)

    def Sigma(self, like: Tensor) -> Tensor:
        return self.scale * torch.eye(self.ydim, dtype=like.dtype, device=like.device)

    def Sigma_inv(self, like: Tensor) -> Tensor:
        return (1.0 / self.scale) * torch.eye(self.ydim, dtype=like.dtype, device=like.device)

    @property
    def noise_std(self) -> float:
        """Observation noise std consistent with Sigma (sqrt(scale)); see the
        JAX docstring for the reference's std/covariance mix-up."""
        return math.sqrt(self.scale)

    def Sigma_y_inv(self, like: Tensor) -> Tensor:
        A = self.A(like)
        eye = torch.eye(self.ydim, dtype=like.dtype, device=like.device)
        # inv_ex: no check of the result's info, so no wait for the device
        return torch.linalg.inv_ex(self.Sigma(like) + A @ A.T + self.epsilon * eye)[0]

    # -- forward model -------------------------------------------------------
    def __call__(self, x: Tensor) -> Tensor:
        return self.forward(x)

    def forward(self, x: Tensor) -> Tensor:
        c = _constants(self, x.device, x.dtype)
        return x @ c.A.T + c.b

    # -- analytic posterior --------------------------------------------------
    def posterior_moments(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        """N(mean, cov) of x | y (prior mean 0, prior covariance I)."""
        c = _constants(self, y.device, y.dtype)
        return c.AtSy @ (y - c.b), c.cov

    def sample_posterior(
        self, y: Tensor, n: int, generator: Optional[torch.Generator] = None
    ) -> Tensor:
        c = _constants(self, y.device, y.dtype)
        mean = c.AtSy @ (y - c.b)
        gen_dev = generator.device if generator is not None else y.device
        z = torch.randn(n, self.xdim, generator=generator, device=gen_dev, dtype=y.dtype)
        return mean + z.to(y.device) @ c.cov_tril.T

    def posterior_log_prob(self, x: Tensor, y: Tensor) -> Tensor:
        c = _constants(self, y.device, y.dtype)
        mvn = torch.distributions.MultivariateNormal(c.AtSy @ (y - c.b), scale_tril=c.cov_tril, validate_args=False)
        return mvn.log_prob(x)

    def log_posterior(self, xs: Tensor, ys: Tensor, epsilon: float = 1e-6) -> Tensor:
        """Unnormalized NEGATIVE log posterior 1/2 (x - m)^T C^-1 (x - m),
        shape (batch, 1), with m = A^T Sigma_y^-1 (y - b) and C = I - A^T
        Sigma_y^-1 A (the analytic posterior's moments), C regularised by
        ``epsilon`` I.  The energy of the refinement chains: its constants
        are built once per device, so a call in a chain's step only queues
        work on the device and never waits for it."""
        SyA, b, cov_inv = _energy_constants(self, epsilon, xs.device, xs.dtype)
        x_res = xs - (ys - b) @ SyA
        return 0.5 * torch.einsum("bi,ij,bj->b", x_res, cov_inv, x_res)[:, None]

    def score_posterior(self, x: Tensor, y: Tensor) -> Tensor:
        """grad_x log p(x|y) = -x + A^T Sigma^-1 (y - A x - b)."""
        c = _constants(self, x.device, x.dtype)
        y_res = y - (x @ c.A.T + c.b)
        return -x + (y_res @ c.Sigma_inv.T) @ c.A


class _Constants(NamedTuple):
    A: Tensor
    b: Tensor
    Sigma_inv: Tensor
    AtSy: Tensor       # A^T Sigma_y^-1
    SyA: Tensor        # Sigma_y^-1 A
    cov: Tensor        # I - A^T Sigma_y^-1 A, the posterior covariance
    cov_tril: Tensor   # its Cholesky factor


@functools.lru_cache(maxsize=None)
def _constants(prob: LinearForwardProblem, device, dtype) -> _Constants:
    """The forward model's, the score's and the posterior moments'
    constants on ``device``, computed as the per-call forms computed them."""
    with torch.inference_mode(False), torch.no_grad():
        like = torch.empty(0, dtype=dtype, device=device)
        A, Sy = prob.A(like), prob.Sigma_y_inv(like)
        cov = torch.eye(prob.xdim, dtype=dtype, device=device) - A.T @ Sy @ A
        return _Constants(A, prob.b(like), prob.Sigma_inv(like), A.T @ Sy, Sy @ A, cov, torch.linalg.cholesky(cov))


@functools.lru_cache(maxsize=None)
def _energy_constants(prob: LinearForwardProblem, epsilon: float, device, dtype) -> Tuple[Tensor, Tensor, Tensor]:
    """(Sigma_y^-1 A, b, (I - A^T Sigma_y^-1 A + epsilon I)^-1) of
    :meth:`LinearForwardProblem.log_posterior`, on ``device``."""
    c = _constants(prob, device, dtype)
    with torch.inference_mode(False), torch.no_grad():
        eye = torch.eye(prob.xdim, dtype=dtype, device=device)
        return c.SyA, c.b, torch.linalg.inv_ex(c.cov + epsilon * eye)[0]
