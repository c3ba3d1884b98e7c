"""The scatterometry problem of the thesis: its frozen surrogate forward
model, read from the committed ``.npz`` (a 3 -> 256 -> 256 -> 256 -> 23
ReLU MLP), the heteroscedastic noise y = f(x) + b xi1 + a f(x) xi2 with
a = 0.2, b = 0.01, and the boundary prior of strength 1000 (uniform on
[-1, 1]^3 with exponential tails), sampled by its inverse CDF.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

A, B, LAMBD_BD = 0.2, 0.01, 1000.0
XDIM, YDIM = 3, 23
SURROGATE = os.path.join("dmip_tpu", "problems", "data", "scatterometry_surrogate.npz")


@functools.lru_cache(maxsize=None)
def surrogate(root: str, device):
    """The surrogate's (W, b) pairs, float32 on ``device``."""
    with np.load(os.path.join(root, SURROGATE)) as f:
        n = len([k for k in f.files if k.startswith("w")])
        return tuple((torch.as_tensor(np.array(f[f"w{i}"]), dtype=torch.float32, device=device),
                      torch.as_tensor(np.array(f[f"b{i}"]), dtype=torch.float32, device=device)) for i in range(n))


def forward(weights, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in weights[:-1]:
        h = torch.relu(h @ w + b)
    w, b = weights[-1]
    return h @ w + b


def inverse_cdf_prior(u: torch.Tensor) -> torch.Tensor:
    lam = LAMBD_BD
    v = u * (2.0 * lam + 2.0) / lam
    left = torch.log(torch.clamp(v * lam, min=1e-38)) - 1.0
    middle = v - 1.0 / lam - 1.0
    right = -torch.log(torch.clamp(((2.0 + 2.0 / lam) - v) * lam, min=1e-38)) + 1.0
    out = torch.where(v < 1.0 / lam, left, middle)
    return torch.where(v >= 2.0 + 1.0 / lam, right, out)


def sample_prior(n: int, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, XDIM, generator=generator, device=generator.device)
    return inverse_cdf_prior(1e-7 + u * (1.0 - 2e-7))


def noisy_forward(weights, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    y = forward(weights, x)
    xi1 = torch.randn(y.shape, generator=generator, device=generator.device)
    xi2 = torch.randn(y.shape, generator=generator, device=generator.device)
    return y + B * xi1 + A * y * xi2


def energy(weights, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The negative log posterior of x given y, per row."""
    f = forward(weights, x)
    var = (A * f) ** 2 + B**2
    bound = LAMBD_BD * torch.sum(torch.relu(x - 1.0) + torch.relu(-1.0 - x), dim=1)
    return 0.5 * torch.sum(torch.log(var), dim=1) + 0.5 * torch.sum((y - f) ** 2 / var, dim=1) + bound


def score_true(weights, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-grad_x of the energy."""
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(energy(weights, z, y).sum(), z)
    return -grad
