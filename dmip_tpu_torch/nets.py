"""Score networks as plain functions on (W, b) tensor pairs.

Port of ``dmip_tpu/nets.py:41-116``.  Parameters are a tuple of (W, b) pairs
with W of shape (fan_in, fan_out), the JAX ``x @ W`` layout, so weights
carry over from the JAX checkpoints unchanged and the tests compare like
with like.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor
MLPParams = Tuple[Tuple[Tensor, Tensor], ...]


def mlp_init(
    input_dim: int,
    output_dim: int,
    hidden_layers: Sequence[int] = (512, 512, 512),
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=torch.float32,
) -> MLPParams:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    for both W and b.  Draws on the generator's device, then moves."""
    gen_dev = generator.device if generator is not None else "cpu"
    dims = [input_dim, *hidden_layers, output_dim]
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.rand(fan_in, fan_out, generator=generator, device=gen_dev, dtype=dtype)
        b = torch.rand(fan_out, generator=generator, device=gen_dev, dtype=dtype)
        params.append(((2 * w - 1) * bound, (2 * b - 1) * bound))
    return tuple((w.to(device), b.to(device)) for w, b in params)


def mlp_apply(params: MLPParams, h: Tensor, activation=torch.tanh) -> Tensor:
    """Forward pass on a pre-concatenated input (batch, features)."""
    for w, b in params[:-1]:
        h = activation(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def _as_t_column(t, batch: int, like: Tensor) -> Tensor:
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    if t.ndim == 0:
        return t.expand(batch, 1)
    return t.reshape(batch, 1)


def score_mlp_apply(
    params: MLPParams, x: Tensor, y: Optional[Tensor], t, activation=torch.tanh
) -> Tensor:
    """Conditional score net a(x, y, t) on the concatenation [x, y, t].

    ``y=None`` (or an empty tensor) means the net has no condition block.
    """
    parts = [x]
    if y is not None and y.numel() > 0:
        parts.append(y)
    parts.append(_as_t_column(t, x.shape[0], x))
    return mlp_apply(params, torch.cat(parts, dim=-1), activation)


def prior_mlp_apply(params: MLPParams, x: Tensor, t, activation=torch.tanh) -> Tensor:
    """Unconditional score net a(x, t) on the concatenation [x, t]."""
    return mlp_apply(params, torch.cat([x, _as_t_column(t, x.shape[0], x)], dim=-1), activation)


def posterior_score_apply(
    prior_params: MLPParams, likelihood_params: MLPParams, g_fn, x: Tensor, y: Tensor, t
) -> Tensor:
    """g(t) * (prior(x, t) + likelihood(x, y, t)); ``g_fn`` is the forward
    SDE's diffusion coefficient."""
    s = prior_mlp_apply(prior_params, x, t) + score_mlp_apply(likelihood_params, x, y, t)
    return g_fn(_as_t_column(t, x.shape[0], x)) * s
