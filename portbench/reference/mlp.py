"""The score net and the reverse-SDE sampler, in plain PyTorch.

The net is a tanh MLP on the concatenation [x, y, t] with weights W of
shape (fan_in, fan_out).  The VP SDE has beta(s) = beta_min + (beta_max -
beta_min) s; the net predicts a = g(s) x score.  The sampler is
Euler-Maruyama on the plug-in reverse SDE from x0 over s = T - i T / N,
i = 0 .. N - 1: x += delta (g(s) a + beta(s) / 2 x) + sqrt(delta) g(s) z.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import philox
from .precision import Precision

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]

BETA_MIN, BETA_MAX, T_END = 0.1, 20.0, 1.0


def beta(s):
    return BETA_MIN + (BETA_MAX - BETA_MIN) * s


def int_beta(s):
    return 0.5 * (BETA_MAX - BETA_MIN) * s**2 + BETA_MIN * s


def alpha(s):
    return torch.exp(-0.5 * int_beta(s))


def std(s):
    return torch.sqrt(1.0 - torch.exp(-int_beta(s)))


def g(s):
    return torch.sqrt(beta(s))


def forward(params: Params, h: torch.Tensor) -> torch.Tensor:
    """The MLP on its input rows, tanh between layers."""
    for w, b in params[:-1]:
        h = torch.tanh(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def score(params: Params, x: torch.Tensor, y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a(x, y, s) / g(s), the net's score; s a column of the rows' times."""
    return forward(params, torch.cat([x, y.expand(x.shape[0], -1), s], dim=1)) / g(s)


def sampler_draws(gen: torch.Generator, n: int, xdim: int):
    """(x0, seed, noise_fn): what the program's sampler draws from the
    request's generator, in its order.  On a card (the fused kernel): x0,
    then a seed for the kernel's Philox stream.  On the CPU (the plain
    Euler-Maruyama scan): x0, then each step's normals from the same
    generator, drawn when the sampler reaches them."""
    x0 = torch.randn(n, xdim, generator=gen, device=gen.device)
    if gen.device.type == "cuda":
        return x0, int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device)), None
    noise = lambda i0, i1: torch.stack([torch.randn((n, xdim), generator=gen) for _ in range(i1 - i0)])
    return x0, 0, noise


def sample(params: Params, x0: torch.Tensor, y: torch.Tensor, num_steps: int, seed: int, precision: Precision,
           noise_fn=None, block: int = 25) -> torch.Tensor:
    """Posterior samples for condition y from x0 (N, xdim), the noise of step
    i from ``noise_fn(step0, step1)`` (steps, N, xdim), by default the
    kernel's Philox stream for ``seed``.  Every product's inputs are rounded
    by ``precision``; sums, tanh and the state stay float32."""
    n, xdim = x0.shape
    if noise_fn is None:
        noise_fn = lambda i0, i1: philox.sampler_normals(seed, n, xdim, i0, i1, x0.device)
    rnd = precision.round
    w1, b1 = params[0]
    # the condition's part of the first layer is the same at every step and row
    cy = (y.reshape(1, -1) @ w1[xdim:-1] + b1) if w1.shape[0] > xdim + 1 else b1.reshape(1, -1)
    w1x, w1t = rnd(w1[:xdim]), w1[-1]
    hidden = [(rnd(w), b) for w, b in params[1:-1]]
    w_out, b_out = rnd(params[-1][0]), params[-1][1]
    delta = T_END / num_steps
    x = x0.to(torch.float32).clone()
    with precision.matmuls():
        for i0 in range(0, num_steps, block):
            z = noise_fn(i0, min(i0 + block, num_steps))
            for k in range(z.shape[0]):
                i = i0 + k
                s = torch.tensor(T_END - (i / num_steps) * T_END, dtype=torch.float32, device=x.device)
                h = torch.tanh(rnd(x) @ w1x + (s * w1t + cy))
                for w, b in hidden:
                    h = torch.tanh(rnd(h) @ w + b)
                a = rnd(h) @ w_out + b_out
                gs = torch.sqrt(beta(s))
                x = x + delta * (gs * a + 0.5 * beta(s) * x) + math.sqrt(delta) * gs * z[k]
    return x
