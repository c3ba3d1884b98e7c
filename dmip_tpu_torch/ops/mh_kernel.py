"""Fused Metropolis chains on the scatterometry posterior: CUDA kernel and
plain version.

Port of ``dmip_tpu/ops/mh_kernel.py :: fused_mh_scatterometry``.  The
kernel (``csrc/mh_kernel.cu``) runs every step of every chain in one
launch; :func:`mh_chains_reference` is its plain PyTorch version,
:func:`dmip_tpu_torch.mcmc.anneal_to_energy` on
:func:`dmip_tpu_torch.problems.scatterometry.get_log_posterior`.

:func:`fused_mh_scatterometry` takes the plain version only for CPU
tensors; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..mcmc import anneal_to_energy
from ..problems.scatterometry import get_log_posterior, surrogate_apply
from . import build

Tensor = torch.Tensor

HIDDEN = 256
XDIM = 3
MAX_YDIM = 32


def mh_chains_reference(
    weights: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    num_steps: int,
    noise_std: float = 0.5,
    a: float = 0.2,
    b: float = 0.01,
    lambd_bd: float = 1000.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """Plain version: Metropolis annealing to the surrogate posterior energy."""
    ys = y.reshape(1, -1).to(x0)

    def energy(x):
        return get_log_posterior(x, lambda z: surrogate_apply(weights, z), a, b, ys, lambd_bd)

    x, _ = anneal_to_energy(
        x0, energy, num_steps, noise_std=noise_std, generator=generator,
        noise=noise, uniforms=uniforms,
    )
    return x


_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [
    ctypes.c_uint64, ctypes.c_void_p]


def _check_tensor(t: Tensor, name: str, shape, dev) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def _launch(weights, x0, y, num_steps, noise_std, a, b, lambd_bd, seed, noise, uniforms):
    dev = x0.device
    n = x0.shape[0]
    _check_tensor(x0, "x0", (n, XDIM), dev)
    if len(weights) != 4:
        raise ValueError(f"the kernel takes the 4-layer surrogate, got {len(weights)} layers")
    ydim = weights[-1][0].shape[1]
    if not 1 <= ydim <= MAX_YDIM:
        raise ValueError(f"the kernel takes 1..{MAX_YDIM} outputs, got {ydim}")
    dims = [(XDIM, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, ydim)]
    flat = []
    for i, ((w, bias), shape) in enumerate(zip(weights, dims)):
        _check_tensor(w, f"W{i}", shape, dev)
        _check_tensor(bias, f"b{i}", shape[1:], dev)
        flat += [w, bias]
    y = y.reshape(-1)
    _check_tensor(y, "y", (ydim,), dev)
    if (noise is None) != (uniforms is None):
        raise ValueError("give both noise and uniforms, or neither")
    if noise is not None:
        _check_tensor(noise, "noise", (num_steps, n, XDIM), dev)
        _check_tensor(uniforms, "uniforms", (num_steps, n), dev)
    out = torch.empty_like(x0)
    lib = build.load("mh_kernel")
    fn = lib.mh_chains_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(
        x0.data_ptr(), y.data_ptr(), *[t.data_ptr() for t in flat], ptr(noise), ptr(uniforms),
        out.data_ptr(), n, ydim, num_steps, noise_std, a, b * b, lambd_bd,
        seed & (2**64 - 1), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "mh_chains_launch")
    fused_mh_scatterometry.launches += 1
    return out


def fused_mh_scatterometry(
    weights: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    num_steps: int,
    noise_std: float = 0.5,
    a: float = 0.2,
    b: float = 0.01,
    lambd_bd: float = 1000.0,
    seed: int = 0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """Metropolis annealing of the chains x0 (N, 3) to the scatterometry
    posterior of the observation y (23,).  Returns (N, 3) float32.

    On a CUDA tensor this launches the kernel, with Philox randomness keyed
    by ``seed``, or ``noise`` (num_steps, N, 3) and ``uniforms``
    (num_steps, N) when given.  On a CPU tensor it runs
    :func:`mh_chains_reference` with a generator seeded by ``seed``.
    """
    if x0.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed) if noise is None else None
        return mh_chains_reference(
            weights, x0, y, num_steps, noise_std, a, b, lambd_bd, gen, noise, uniforms)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    return _launch(weights, x0, y, num_steps, noise_std, a, b, lambd_bd, seed, noise, uniforms)


fused_mh_scatterometry.launches = 0
