"""Fused Metropolis chains on the scatterometry posterior: CUDA kernel and
plain version.

Port of ``dmip_tpu/ops/mh_kernel.py :: fused_mh_scatterometry``.  The
kernel (``csrc/mh_kernel.cu``) runs every step of every chain in one
launch; :func:`mh_chains_reference` is its plain PyTorch version,
:func:`dmip_tpu_torch.mcmc.anneal_to_energy` on
:func:`dmip_tpu_torch.problems.scatterometry.get_log_posterior`.

:func:`split_tf32_matmul` is the plain model of the kernel's hidden-layer
product: each f32 operand split into a TF32 part and its remainder, three
(or four) TF32 products summed in f32.  :func:`mh_chains_reference` runs
it with ``terms=`` for the tests, the numerics study
(:mod:`dmip_tpu_torch.ops.split_tf32_study`) and ``chip_smoke.py``; the
main path never does.

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
# a step's phases, in the order the kernel's clock stamps end them
PHASES = ("proposal", "layer0", "hidden1", "hidden2", "output", "energy", "accept")


def tf32_rna(x: Tensor) -> Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does: integer operations on the bits,
    so subnormals round like normals and a carry moves into the exponent.
    inf and NaN pass through unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000   # -0x2000 == 0xFFFFE000
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, rounded).view(torch.float32)


def tf32_trunc(x: Tensor) -> Tensor:
    """The TF32 value a tensor core reads from a float32 register: the low
    13 mantissa bits dropped (rounding toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo): hi = tf32_rna(x) and lo = x - hi, exact in float32.  A
    tensor core reads lo through :func:`tf32_trunc`, so hi + that keeps
    about 21 of float32's 24 significand bits."""
    hi = tf32_rna(x)
    return hi, x - hi


def split_tf32_matmul(a: Tensor, w: Tensor, terms: int = 3) -> Tensor:
    """a @ w (float32) from TF32 parts, summed in float32 as the kernel's
    tensor-core products are: a_lo w_hi + a_hi w_lo + a_hi w_hi, and with
    ``terms=4`` a_lo w_lo first.  Each lo part enters as the tensor core
    reads it (:func:`tf32_trunc`).  Each product of two TF32 values is
    exact in float32; what is lost is the split's remainder and f32
    summation."""
    if terms not in (3, 4):
        raise ValueError(f"terms must be 3 or 4, got {terms}")
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    a_lo, w_lo = tf32_trunc(a_lo), tf32_trunc(w_lo)
    out = a_lo @ w_hi + a_hi @ w_lo
    if terms == 4:
        out = a_lo @ w_lo + out
    return out + a_hi @ w_hi


def surrogate_split_apply(weights: Sequence[Tuple[Tensor, Tensor]], x: Tensor, terms: int) -> Tensor:
    """The surrogate with the two 256 x 256 hidden products in split TF32
    (:func:`split_tf32_matmul`) and the rest in float32, as the kernel
    computes it."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = weights
    h = torch.relu(x @ w0 + b0)
    h = torch.relu(split_tf32_matmul(h, w1, terms) + b1)
    h = torch.relu(split_tf32_matmul(h, w2, terms) + b2)
    return h @ w3 + b3


def mh_energy(weights, y: Tensor, a: float, b: float, lambd_bd: float, terms: Optional[int] = None):
    """The chains' energy x (n, 3) -> (n,) in the dtype of x: the surrogate
    posterior energy, with split-TF32 hidden products when ``terms`` is
    3 or 4."""
    ys = y.reshape(1, -1)
    if terms is None:
        fwd = lambda z: surrogate_apply(weights, z)
    else:
        fwd = lambda z: surrogate_split_apply(weights, z, terms)
    return lambda x: get_log_posterior(x, fwd, a, b, ys.to(x), lambd_bd)


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
    dtype: torch.dtype = torch.float32,
    terms: Optional[int] = None,
) -> Tensor:
    """Plain version: Metropolis annealing to the surrogate posterior energy.

    ``dtype`` float64 runs the chains and the net in double precision (a
    witness for the f32 versions; the result is returned in float32).
    ``terms`` 3 or 4 computes the two hidden products as the kernel does,
    with :func:`split_tf32_matmul`, in float32."""
    if terms is not None and dtype != torch.float32:
        raise ValueError("the split-TF32 model runs in float32")
    weights = [(w.to(dtype), bb.to(dtype)) for w, bb in weights]
    energy = mh_energy(weights, y, a, b, lambd_bd, terms)
    if dtype != torch.float32:
        x0 = x0.to(dtype)
        noise = None if noise is None else noise.to(dtype)
        uniforms = None if uniforms is None else uniforms.to(dtype)
    x, _ = anneal_to_energy(
        x0, energy, num_steps, noise_std=noise_std, generator=generator,
        noise=noise, uniforms=uniforms,
    )
    return x.float()


def pack_tf32_b(w: Tensor) -> Tensor:
    """(K, N) weight -> float32 in mma.sync m16n8k8 TF32 B-fragment order,
    as the split-TF32 products read it: B2's (256, 256) hidden layers
    (``csrc/mh_kernel.cu``).

    Output shape (N/16, K/8, 32, 2, 2): n-tile pair, 8-deep k-step, lane,
    n-tile within the pair, fragment register.  Element [np, ks, lane, nh,
    kh] is W[8 ks + 4 kh + lane % 4, 16 np + 8 nh + lane // 4], so a lane
    reads both n-tiles' fragments for one k-step as one 16-byte load.  K
    must be a multiple of 8 and N of 128, each at most 512.
    """
    K, N = w.shape
    if K % 8 or N % 128 or not (0 < K <= 512 and 0 < N <= 512):
        raise ValueError(f"pack_tf32_b takes K a multiple of 8 and N of 128, each up to 512, got {tuple(w.shape)}")
    # W[k, n] with k = 8 ks + 4 kh + t and n = 16 np + 8 nh + g, lane = 4 g + t
    wr = w.reshape(K // 8, 2, 4, N // 16, 2, 8)   # ks, kh, t, np, nh, g
    return wr.permute(3, 0, 5, 2, 4, 1).reshape(N // 16, K // 8, 32, 2, 2).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [
    ctypes.c_uint64, ctypes.c_void_p]


def _check_tensor(t: Tensor, name: str, shape, dev) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def _launch(weights, x0, y, num_steps, noise_std, a, b, lambd_bd, seed, noise, uniforms, energy_out, stamps):
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
        flat += [pack_tf32_b(w) if i in (1, 2) else w, bias]
    y = y.reshape(-1)
    _check_tensor(y, "y", (ydim,), dev)
    if (noise is None) != (uniforms is None):
        raise ValueError("give both noise and uniforms, or neither")
    if noise is not None:
        _check_tensor(noise, "noise", (num_steps, n, XDIM), dev)
        _check_tensor(uniforms, "uniforms", (num_steps, n), dev)
    if energy_out is not None:
        _check_tensor(energy_out, "energy_out", (n,), dev)
    if stamps is not None:
        need = 2 * (1 + len(PHASES) * num_steps)
        if stamps.dtype != torch.int64 or stamps.device != dev or stamps.numel() < need:
            raise ValueError(f"stamps must be an int64 tensor of >= {need} entries on {dev}")
    out = torch.empty_like(x0)
    lib = build.load("mh_kernel")
    fn = lib.mh_chains_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    # the launcher sets attributes and launches on the current device
    with torch.cuda.device(dev):
        err = fn(
            x0.data_ptr(), y.data_ptr(), *[t.data_ptr() for t in flat], ptr(noise), ptr(uniforms),
            out.data_ptr(), ptr(energy_out), ptr(stamps), n, ydim, num_steps, noise_std, a, b * b, lambd_bd,
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
    energy_out: Optional[Tensor] = None,
    stamps: Optional[Tensor] = None,
) -> Tensor:
    """Metropolis annealing of the chains x0 (N, 3) to the scatterometry
    posterior of the observation y (23,).  Returns (N, 3) float32.

    On a CUDA tensor this launches the kernel, with Philox randomness keyed
    by ``seed``, or ``noise`` (num_steps, N, 3) and ``uniforms``
    (num_steps, N) when given.  On a CPU tensor it runs
    :func:`mh_chains_reference` with a generator seeded by ``seed``.

    Two diagnostics, taken only by the kernel; the states do not change:
    ``energy_out``, a float32 (N,) tensor, receives each chain's carried
    energy at the end; ``stamps``, an int64 tensor of >= 2 x (1 + 7 x
    num_steps) entries, receives block 0's clock (ns) and its SM's cycle
    count, a pair, once before the first step and then at the end of each
    of a step's :data:`PHASES`.
    """
    if x0.device.type == "cpu":
        if energy_out is not None or stamps is not None:
            raise ValueError("energy_out and stamps are taken only by the CUDA kernel")
        gen = torch.Generator().manual_seed(seed) if noise is None else None
        return mh_chains_reference(
            weights, x0, y, num_steps, noise_std, a, b, lambd_bd, gen, noise, uniforms)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    return _launch(weights, x0, y, num_steps, noise_std, a, b, lambd_bd, seed, noise, uniforms, energy_out,
                   stamps)


fused_mh_scatterometry.launches = 0
