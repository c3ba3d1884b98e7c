"""Diffusion posterior sampling with the exact likelihood (Chung et al. 2022,
arXiv:2209.14687), in plain PyTorch.

The prior net is a tanh MLP on [x, s] that returns the prior's score
s_p(x, s) (not g times it).  Each reverse step, on the grid s = T - i T / N,
i = 0 .. N - 1, as ``mlp.sample``'s:

* Tweedie's estimate x_hat0 = (x + std(s)^2 s_p) / alpha(s);
* s_lik = grad_x log N(y; f(x_hat0), diag((a f)^2 + b^2)), the Gaussian's
  log-determinant included, by ``torch.autograd.grad`` through the
  surrogate f (``scatterometry.forward``) and through Tweedie, the prior
  net included: nothing of the gradient is written out by hand;
* the cap s_lik min(1, clip / (|s_lik| + 1e-12)), a sample at a time;
* x += delta (g^2 (s_p + s_lik) + beta / 2 x) + sqrt(delta) g z.

z is the fused kernel's Philox stream for the request's seed
(``philox.sampler_normals``) on a card, or ``noise_fn``'s normals (the
generator's, ``mlp.sampler_draws``) on the CPU.  Rows and steps run in
blocks so that a 30k-sample posterior fits.

Precision: the configuration states f32 products, so of a ``Precision``
only ``tf32`` counts here (float32 matmuls in TF32 or not, the backward
passes' too); ``sampler_dtype``, the bf16 samplers' rounding, is not used.
The reference runs in float32 with TF32 off, the control in TF32.  No
departure from the published algorithm but the cap, which the served
configuration adds (``guidance_clip``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import mlp, philox, scatterometry
from .precision import Precision

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def log_likelihood(surrogate: Params, x0: torch.Tensor, y: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """log N(y; f(x0), diag((a f)^2 + b^2)) of each row, up to the constant."""
    f = scatterometry.forward(surrogate, x0)
    var = (a * f) ** 2 + b**2
    return -0.5 * torch.sum(torch.log(var), dim=1) - 0.5 * torch.sum((y - f) ** 2 / var, dim=1)


def guided_scores(prior: Params, surrogate: Params, x: torch.Tensor, y: torch.Tensor, s: torch.Tensor,
                  a: float, b: float, clip: Optional[float]):
    """(s_p, capped s_lik) at the rows x and time s (a 0-d tensor)."""
    alpha, var = mlp.alpha(s), mlp.std(s) ** 2
    with torch.enable_grad():
        xt = x.detach().requires_grad_(True)
        s_p = mlp.forward(prior, torch.cat([xt, s.expand(x.shape[0], 1)], dim=1))
        x_hat0 = (xt + var * s_p) / alpha
        (s_lik,) = torch.autograd.grad(log_likelihood(surrogate, x_hat0, y, a, b).sum(), xt)
    if clip is not None:
        norm = torch.sqrt(torch.sum(s_lik * s_lik, dim=1, keepdim=True))
        s_lik = s_lik * torch.clamp(clip / (norm + 1e-12), max=1.0)
    return s_p.detach(), s_lik


def sample(prior: Params, surrogate: Params, x0: torch.Tensor, y: torch.Tensor, num_steps: int, seed: int,
           precision: Precision, noise_fn=None, *, a: float, b: float, clip: Optional[float] = 100.0,
           block: int = 25, rows: int = 32768) -> torch.Tensor:
    """Posterior samples for the observation y (ydim,) from x0 (N, xdim);
    the noise of steps [i0, i1) from ``noise_fn(i0, i1)`` (steps, N, xdim),
    by default the kernel's Philox stream for ``seed``.  Steps run ``block``
    at a time, and each step ``rows`` rows at a time."""
    n, xdim = x0.shape
    if noise_fn is None:
        noise_fn = lambda i0, i1: philox.sampler_normals(seed, n, xdim, i0, i1, x0.device)
    yv = y.reshape(1, -1).to(torch.float32)
    delta = mlp.T_END / num_steps
    x = x0.to(torch.float32).clone()
    with precision.matmuls():
        for i0 in range(0, num_steps, block):
            z = noise_fn(i0, min(i0 + block, num_steps))
            for k in range(z.shape[0]):
                i = i0 + k
                s = torch.tensor(mlp.T_END - (i / num_steps) * mlp.T_END, dtype=torch.float32, device=x.device)
                gs, bs = mlp.g(s), mlp.beta(s)
                parts = []
                for r0 in range(0, n, rows):
                    xr = x[r0:r0 + rows]
                    s_p, s_lik = guided_scores(prior, surrogate, xr, yv, s, a, b, clip)
                    parts.append(xr + delta * (gs * gs * (s_p + s_lik) + 0.5 * bs * xr)
                                 + math.sqrt(delta) * gs * z[k, r0:r0 + rows])
                x = torch.cat(parts) if len(parts) > 1 else parts[0]
    return x
