"""Scatterometry inverse problem: the frozen neural surrogate forward model.

Port of ``dmip_tpu/problems/scatterometry.py:41-158``: a 3 -> 256 -> 256 ->
256 -> 23 ReLU MLP forward operator, heteroscedastic noise
y = f(x) + b xi1 + a f(x) xi2 (a = 0.2, b = 0.01), the negative log
posterior energy with the boundary prior of strength lambd_bd = 1000, and
the prior's inverse-CDF sampler.

The weights are read from the committed ``.npz`` by its path in the
repository; nothing is imported from the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "..", "..", "dmip_tpu", "problems", "data", "scatterometry_surrogate.npz",
)

DEFAULT_PARAMS: Dict[str, float] = {
    "a": 0.2,
    "b": 0.01,
    "lambd_bd": 1000.0,
    "xdim": 3,
    "ydim": 23,
}


def load_surrogate_weights(
    weights_path: str = DEFAULT_WEIGHTS, device=None, dtype=torch.float32
) -> Tuple[Tuple[Tensor, Tensor], ...]:
    """The surrogate's (W, b) pairs, W of shape (fan_in, fan_out)."""
    with np.load(weights_path) as data:
        n_layers = len([k for k in data.files if k.startswith("w")])
        return tuple(
            (
                torch.as_tensor(np.array(data[f"w{i}"], order="C"), dtype=dtype, device=device),
                torch.as_tensor(np.array(data[f"b{i}"], order="C"), dtype=dtype, device=device),
            )
            for i in range(n_layers)
        )


def surrogate_apply(weights, x: Tensor) -> Tensor:
    h = x
    for w, b in weights[:-1]:
        h = torch.relu(h @ w + b)
    w, b = weights[-1]
    return h @ w + b


def load_forward_model(
    weights_path: str = DEFAULT_WEIGHTS, device=None, dtype=torch.float32
) -> Tuple[Callable[[Tensor], Tensor], Dict[str, float]]:
    """(apply_fn, params): apply_fn maps (..., 3) -> (..., 23).  The loaded
    weights ride along as ``apply_fn.weights`` for the fused MH kernel."""
    weights = load_surrogate_weights(weights_path, device, dtype)

    def apply_fn(x: Tensor) -> Tensor:
        return surrogate_apply(weights, x)

    apply_fn.weights = weights
    return apply_fn, dict(DEFAULT_PARAMS)


def get_log_posterior(
    samples: Tensor,
    forward_model: Callable[[Tensor], Tensor],
    a: float,
    b: float,
    ys: Tensor,
    lambd_bd: float,
) -> Tensor:
    """NEGATIVE log posterior energy:
    0.5 sum log((a f)^2 + b^2) + 0.5 sum (y - f)^2 / ((a f)^2 + b^2)
    + lambd_bd * sum relu(x - 1) + relu(-1 - x)."""
    f = forward_model(samples)
    prefactor = (a * f) ** 2 + b**2
    p = 0.5 * torch.sum(torch.log(prefactor), dim=-1)
    p2 = 0.5 * torch.sum((ys - f) ** 2 / prefactor, dim=-1)
    p3 = lambd_bd * torch.sum(
        torch.relu(samples - 1.0) + torch.relu(-1.0 - samples), dim=-1
    )
    return p + p2 + p3


def inverse_cdf_prior(u: Tensor, lambd_bd: float) -> Tensor:
    """Inverse CDF of the smoothed-uniform (boundary-loss) prior: u in
    (0, 1) -> x, uniform on [-1, 1] with exp(-lambd_bd |x|)-like tails."""
    v = u * (2.0 * lambd_bd + 2.0) / lambd_bd
    left = torch.log(torch.clamp(v * lambd_bd, min=1e-38)) - 1.0
    middle = v - 1.0 / lambd_bd - 1.0
    right = -torch.log(torch.clamp(((2.0 + 2.0 / lambd_bd) - v) * lambd_bd, min=1e-38)) + 1.0
    out = torch.where(v < 1.0 / lambd_bd, left, middle)
    return torch.where(v >= 2.0 + 1.0 / lambd_bd, right, out)


def sample_prior(
    n: int, lambd_bd: float, xdim: int = 3, generator: Optional[torch.Generator] = None, device=None
) -> Tensor:
    """n prior samples by the inverse CDF.  u is kept in [1e-7, 1 - 1e-7]:
    a uniform of exactly 0 would map to x ~ -88 and give an inf loss."""
    gen_dev = generator.device if generator is not None else "cpu"
    u = torch.rand(n, xdim, generator=generator, device=gen_dev)
    u = 1e-7 + u * (1.0 - 2e-7)
    return inverse_cdf_prior(u, lambd_bd).to(device)


def noisy_forward(
    forward_model: Callable[[Tensor], Tensor],
    x: Tensor,
    a: float,
    b: float,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """y = f(x) + b xi1 + a f(x) xi2, the noise drawn on the generator's
    device and moved to x's."""
    y = forward_model(x)
    gen_dev = generator.device if generator is not None else y.device
    xi1 = torch.randn(y.shape, generator=generator, device=gen_dev, dtype=y.dtype)
    xi2 = torch.randn(y.shape, generator=generator, device=gen_dev, dtype=y.dtype)
    return y + b * xi1.to(y.device) + a * y * xi2.to(y.device)


def score_posterior(
    forward_model: Callable[[Tensor], Tensor],
    a: float,
    b: float,
    lambd_bd: float,
) -> Callable[[Tensor, Tensor], Tensor]:
    """-grad_x of the energy, by one reverse-mode pass."""

    def score(x: Tensor, ys: Tensor) -> Tensor:
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            e = torch.sum(get_log_posterior(z, forward_model, a, b, ys, lambd_bd))
            (grad,) = torch.autograd.grad(e, z)
        return -grad

    return score
