"""Dataset generation, per-epoch training batches and the ground-truth
loaders.

Port of ``dmip_tpu/data.py``: the linear dataset and its split, the linear
epoch batches (a fresh permutation and fresh observation noise every epoch),
the scatterometry condition generator and epoch batches (a fresh prior
sample through the surrogate every epoch), and the ``<gt_dir>/<i>/<j>.npy``
ground-truth layout.  Random draws happen on the caller's generator's device
and are then moved to ``device``, so a seeded CPU generator gives the same
data on any device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .problems import scatterometry as scat

Tensor = torch.Tensor


def _gen_device(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else "cpu"


def generate_dataset_linear(
    xdim: int,
    f: Callable[[Tensor], Tensor],
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """x ~ N(0, I), y = f(x) (noise-free; training adds noise per epoch)."""
    x = torch.randn(n_samples, xdim, generator=generator, device=_gen_device(generator))
    x = x.to(device)
    return x, f(x)


def train_test_split(
    x: Tensor, y: Tensor, train_size: float, generator: Optional[torch.Generator] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    n = x.shape[0]
    n_train = int(n * train_size)
    perm = torch.randperm(n, generator=generator, device=_gen_device(generator)).to(x.device)
    x, y = x[perm], y[perm]
    return x[:n_train], x[n_train:], y[:n_train], y[n_train:]


def linear_epoch_batches(
    generator: Optional[torch.Generator],
    x_train: Tensor,
    y_train: Tensor,
    sigma: float,
    batch_size: int,
) -> Tuple[Tensor, Tensor]:
    """One epoch's (xb, yb), each (n_batches, batch_size, dim): a fresh
    permutation, then fresh observation noise of std ``sigma`` on y; the
    trailing partial batch is dropped."""
    gen_dev = _gen_device(generator)
    n = x_train.shape[0]
    n_batches = n // batch_size
    perm = torch.randperm(n, generator=generator, device=gen_dev).to(x_train.device)
    noise = torch.randn(y_train.shape, generator=generator, device=gen_dev, dtype=y_train.dtype)
    x = x_train[perm]
    y = y_train[perm] + sigma * noise.to(y_train.device)
    keep = n_batches * batch_size
    return x[:keep].reshape(n_batches, batch_size, -1), y[:keep].reshape(n_batches, batch_size, -1)


def generate_dataset_scatterometry(
    forward_model: Callable[[Tensor], Tensor],
    a: float,
    b: float,
    size: int = 100,
    xdim: int = 3,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """x ~ U(-1, 1)^3, y through the heteroscedastic noise model."""
    x = torch.rand(size, xdim, generator=generator, device=_gen_device(generator))
    x = (x * 2.0 - 1.0).to(device)
    return x, scat.noisy_forward(forward_model, x, a, b, generator)


def get_gt_samples_scatterometry(src_dir: str, y_idx: int, repeat: int) -> np.ndarray:
    """One (condition, repeat) ground-truth array from gt_dir/<y_idx>/<repeat>.npy."""
    with open(os.path.join(src_dir, str(y_idx), f"{repeat}.npy"), "rb") as f:
        return np.load(f)


def gt_loader(src_dir: str):
    """``(i, j) -> numpy GT array`` bound to one GT directory."""
    return lambda i, j: get_gt_samples_scatterometry(src_dir, i, j)


def cached_gt_loader(src_dir: str, device=None):
    """``gt_loader`` that keeps each (i, j) array on ``device`` after its
    first load, for callers that score many nets against the same GT."""
    cache = {}

    def load(i, j):
        if (i, j) not in cache:
            cache[(i, j)] = torch.as_tensor(
                get_gt_samples_scatterometry(src_dir, i, j), dtype=torch.float32, device=device
            )
        return cache[(i, j)]

    return load


# Optimizer steps per scatterometry epoch: 8 x batch_size fresh samples every
# epoch.  Schedules that count optimizer steps (cosine decay_steps) scale
# n_epochs by this.
SCATTEROMETRY_BATCHES_PER_EPOCH = 8


def scatterometry_epoch_batches(
    generator: Optional[torch.Generator],
    forward_model: Callable[[Tensor], Tensor],
    a: float,
    b: float,
    lambd_bd: float,
    batch_size: int,
    n_batches: int = SCATTEROMETRY_BATCHES_PER_EPOCH,
) -> Tuple[Tensor, Tensor]:
    """One epoch's fresh simulation: prior samples, the surrogate, noise;
    (xb, yb) of shape (n_batches, batch_size, dim) on the generator's
    device, where the surrogate's weights must lie."""
    x = scat.sample_prior(n_batches * batch_size, lambd_bd, generator=generator, device=_gen_device(generator))
    y = scat.noisy_forward(forward_model, x, a, b, generator)
    return x.reshape(n_batches, batch_size, -1), y.reshape(n_batches, batch_size, -1)
