"""The linear-Gaussian problem of the thesis and its evaluation protocol.

f(x) = A x + b with A = [[1, .5], [0, 1]], b = (.3, .5), observation noise
covariance 0.3 I and a standard-normal prior, so the posterior of x given y
is N(A^T S (y - b), I - A^T S A) with S = (0.3 I + A A^T + 1e-6 I)^-1.
A condition's evaluation: for each repeat, posterior samples from the
model and from the analytic posterior, 75 x 75 histograms on [-3.5, 3.5]^2
(a point on the upper edge in the last bin, points outside dropped), the
NLL of both sample sets under the posterior, the score-MSE of the net at
t = 0 on the analytic samples and the sliced W2 over 128 random
directions; then the forward and reverse KL of the summed histograms (each
normalised, + 1e-10, renormalised) and the repeats' mean of the rest.
"""

from __future__ import annotations

import functools
import math

import torch

from . import mlp
from .precision import Precision

A = ((1.0, 0.5), (0.0, 1.0))
B = (0.3, 0.5)
SCALE = 0.3
NOISE_STD = math.sqrt(SCALE)
STATS = ("kl", "kl_reverse", "nll_true", "nll_model", "mse_score", "w2")


@functools.lru_cache(maxsize=None)
def constants(device):
    """(A, b, posterior mean map A^T S, covariance, its Cholesky factor, its
    inverse, log det), float32 on ``device``, computed in float64."""
    a = torch.tensor(A, dtype=torch.float64)
    b = torch.tensor(B, dtype=torch.float64)
    s = torch.linalg.inv(SCALE * torch.eye(2, dtype=torch.float64) + a @ a.T + 1e-6 * torch.eye(2, dtype=torch.float64))
    cov = torch.eye(2, dtype=torch.float64) - a.T @ s @ a
    out = (a, b, a.T @ s, cov, torch.linalg.cholesky(cov), torch.linalg.inv(cov))
    f32 = tuple(t.to(device=device, dtype=torch.float32) for t in out)
    return (*f32, float(torch.logdet(cov)))


def forward(x: torch.Tensor) -> torch.Tensor:
    a, b, *_ = constants(x.device)
    return x @ a.T + b


def posterior_mean(y: torch.Tensor) -> torch.Tensor:
    _, b, ats, *_ = constants(y.device)
    return (y - b) @ ats.T


def log_prob(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    *_, cov_inv, logdet = constants(x.device)
    r = x - posterior_mean(y)
    return -0.5 * (torch.sum((r @ cov_inv) * r, dim=1) + logdet + 2 * math.log(2 * math.pi))


def score_true(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """grad_x log p(x | y) = -x + A^T (y - A x - b) / 0.3, the prior's and
    the likelihood's."""
    a, b, *_ = constants(x.device)
    return -x + ((y - forward(x)) / SCALE) @ a


def histogram(x: torch.Tensor, nbins: int, lo: float, hi: float) -> torch.Tensor:
    width = (hi - lo) / nbins
    idx = torch.clamp(torch.floor((x - lo) / width).to(torch.int64), 0, nbins - 1)
    inside = torch.all((x >= lo) & (x <= hi), dim=1)
    flat = idx[:, 0] * nbins + idx[:, 1]
    return torch.bincount(flat[inside], minlength=nbins * nbins)


def kl_pair(h_true: torch.Tensor, h_model: torch.Tensor, eps: float = 1e-10):
    p = h_true.to(torch.float64)
    q = h_model.to(torch.float64)
    p = p / max(float(p.sum()), 1.0) + eps
    q = q / max(float(q.sum()), 1.0) + eps
    p, q = p / p.sum(), q / q.sum()
    return float(torch.sum(p * (torch.log(p) - torch.log(q)))), float(torch.sum(q * (torch.log(q) - torch.log(p))))


def sliced_w2(x: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor) -> float:
    d = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    px = torch.sort(x @ d.T, dim=0).values
    pz = torch.sort(z @ d.T, dim=0).values
    return float(torch.sqrt(torch.mean((px - pz) ** 2)))


def score_stats(params, y: torch.Tensor, x_true: torch.Tensor, precision: Precision):
    """A repeat's statistics that read no model sample: (nll_true, mse_score)."""
    with precision.matmuls():
        t0 = torch.zeros(x_true.shape[0], 1, device=x_true.device)
        mse = float(torch.mean(torch.sum((mlp.score(params, x_true, y, t0) - score_true(x_true, y)) ** 2, dim=1)))
    return -float(torch.mean(log_prob(x_true, y))), mse


def repeat_stats(params, y: torch.Tensor, x_model: torch.Tensor, x_true: torch.Tensor, dirs: torch.Tensor,
                 nbins: int, box, precision: Precision):
    """One repeat's histograms and its (nll_true, nll_model, mse_score, w2)."""
    nll_true, mse = score_stats(params, y, x_true, precision)
    with precision.matmuls():
        row = (nll_true, -float(torch.mean(log_prob(x_model, y))), mse, sliced_w2(x_model, x_true, dirs))
    return histogram(x_true, nbins, *box), histogram(x_model, nbins, *box), row


def condition_stats(hists_true, hists_model, rows):
    """The condition's six statistics from its repeats' histograms and rows."""
    kl, kl_rev = kl_pair(sum(hists_true), sum(hists_model))
    means = [sum(r[k] for r in rows) / len(rows) for k in range(4)]
    return dict(zip(STATS, (kl, kl_rev, *means)))
