"""Fused reverse-SDE Euler-Maruyama samplers: CUDA kernels and plain versions.

Port of ``dmip_tpu/ops/em_kernel.py``:

  * :func:`fused_em_sampler` (B1, ``fused_em_sampler``): all steps of the
    CDE sampler in one launch; plain version :func:`em_sampler_reference`,
    the same arithmetic through :func:`dmip_tpu_torch.samplers.euler_maruyama`
    with explicit bf16 rounding where the kernel rounds.
  * :func:`fused_em_sampler_cdiffe` (B4, ``fused_em_sampler_cdiffe``): the
    CDiffE sampler, re-diffusing y every step; plain version
    :func:`em_cdiffe_reference` through
    :func:`dmip_tpu_torch.samplers.euler_maruyama_cdiffe`.

Both kernels live in ``csrc/em_kernel.cu``.  A wrapper takes the plain
version only for CPU tensors; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..samplers import euler_maruyama, euler_maruyama_cdiffe
from ..sde import ReverseSDE, VPSDE
from . import build

Tensor = torch.Tensor

MAX_HIDDEN = 8
MAX_XDIM = 4
CDIFFE_MAX_WIDTH = 32  # xdim + ydim: B4's first layer is one 32-deep mma slice


def _ceil32(v: int) -> int:
    return -(-v // 32) * 32


def _pad2(w: Tensor, rows: int, cols: int) -> Tensor:
    out = w.new_zeros(rows, cols)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _pad1(b: Tensor, n: int) -> Tensor:
    out = b.new_zeros(n)
    out[: b.shape[0]] = b
    return out


def _bf16_values(w: Tensor) -> Tensor:
    return w.to(torch.bfloat16).to(torch.float32)


def pack_mma_b(w: Tensor) -> Tensor:
    """(K, N) weight -> bf16 in mma.sync m16n8k16 B-fragment order.

    Output shape (N/8, K/32, 32, 2, 2, 2): n-tile, 32-deep k slice, lane,
    k-tile within the slice, fragment register, element.  Element
    [nt, kp, lane, j, r, e] is W[(2 kp + j) 16 + 2 (lane % 4) + 8 r + e,
    8 nt + lane // 4], so each lane reads its fragments for two k-tiles as
    one 16-byte load.  K must be a multiple of 32 and N of 8.
    """
    K, N = w.shape
    if K % 32 or N % 8:
        raise ValueError(f"pack_mma_b needs K % 32 == 0 and N % 8 == 0, got {tuple(w.shape)}")
    dev = w.device
    ar = lambda n, *shape: torch.arange(n, device=dev).view(*shape)
    kp = ar(K // 32, 1, -1, 1, 1, 1, 1)
    nt = ar(N // 8, -1, 1, 1, 1, 1, 1)
    lane = ar(32, 1, 1, 32, 1, 1, 1)
    j = ar(2, 1, 1, 1, 2, 1, 1)
    r = ar(2, 1, 1, 1, 1, 2, 1)
    e = ar(2, 1, 1, 1, 1, 1, 2)
    k_idx = (2 * kp + j) * 16 + (lane % 4) * 2 + r * 8 + e
    n_idx = nt * 8 + lane // 4
    return w.to(torch.bfloat16)[k_idx, n_idx].contiguous()


def _split_first_layer(params, xdim: int):
    w1, b1 = params[0]
    ydim = w1.shape[0] - xdim - 1
    if ydim < 0:
        raise ValueError(f"first layer takes {w1.shape[0]} inputs, fewer than xdim + 1")
    return w1[:xdim], w1[xdim : xdim + ydim], w1[xdim + ydim], b1, ydim


def _check_y(y: Optional[Tensor], ydim: int) -> None:
    if ydim > 0 and y is None:
        raise ValueError("net is conditional but y is None")
    if ydim > 0 and y.numel() != ydim:
        raise ValueError(f"y has {y.numel()} entries, the net's condition block {ydim}")


def _rounder(compute_dtype):
    if compute_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(compute_dtype).to(torch.float32)


def em_sampler_reference(
    params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Optional[Tensor],
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Plain PyTorch version of the kernel: E-M through the first layer split
    as x . W1x + s w1t + cy, inputs of every product rounded to
    ``compute_dtype``, f32 sums, f32 state.  Noise is ``noise`` when given,
    else drawn from ``generator``."""
    xdim = x0.shape[-1]
    w1x, w1y, w1t, b1, ydim = _split_first_layer(params, xdim)
    _check_y(y, ydim)
    rnd = _rounder(compute_dtype)
    cy = b1 if ydim == 0 else y.reshape(1, ydim).to(torch.float32) @ w1y + b1
    w1x_c = rnd(w1x)
    hidden = [(rnd(w), b) for w, b in params[1:-1]]
    w_out, b_out = rnd(params[-1][0]), params[-1][1]

    def drift(x, _cond, s):
        h = rnd(torch.tanh(rnd(x) @ w1x_c + s * w1t + cy))
        for w, b in hidden:
            h = rnd(torch.tanh(h @ w + b))
        return h @ w_out + b_out

    sde = ReverseSDE(base=VPSDE(beta_min=beta_min, beta_max=beta_max, T=T), T=T)
    return euler_maruyama(
        sde, drift, None, x0.shape[0], xdim, num_steps, lmbd=lmbd,
        noise_scale=noise_scale, generator=generator, x0=x0, noise=noise,
    )


def _device_net(params, xdim: int):
    """Kernel layout of the net: padded to multiples of 32, hidden weights
    packed for mma.sync, output weights transposed; bf16-rounded where the
    kernel computes in bf16, f32 for W1y, w1t and the biases."""
    w1x, w1y, w1t, b1, ydim = _split_first_layer(params, xdim)
    h1 = _ceil32(w1x.shape[1])
    f32 = lambda t: t.to(torch.float32)
    net = {
        "w1x": _bf16_values(_pad2(f32(w1x), xdim, h1)),
        "w1y": _pad2(f32(w1y), max(ydim, 1), h1),
        "w1t": _pad1(f32(w1t), h1),
        "b1": _pad1(f32(b1), h1),
        "ydim": ydim,
    }
    return _add_hidden_and_out(net, params, h1, xdim)


def _add_hidden_and_out(net: dict, params, h1: int, xdim: int) -> dict:
    """The layout B1 and B4 share after the first layer: hidden weights
    padded to multiples of 32 and packed for mma.sync, f32 biases, and the
    output layer's first xdim columns bf16-rounded and transposed."""
    f32 = lambda t: t.to(torch.float32)
    net.update(wh=[], bh=[], widths=[h1])
    for w, b in params[1:-1]:
        k, n = _ceil32(w.shape[0]), _ceil32(w.shape[1])
        net["wh"].append(pack_mma_b(_pad2(f32(w), k, n)))
        net["bh"].append(_pad1(f32(b), n))
        net["widths"].append(n)
    w_out, b_out = params[-1]
    net["wout"] = _bf16_values(_pad2(f32(w_out[:, :xdim]), net["widths"][-1], xdim)).t().contiguous()
    net["bout"] = f32(b_out[:xdim]).contiguous()
    return net


def _check_launch(params, x0: Tensor, noise: Optional[Tensor], num_steps: int, noise_width: int) -> None:
    """What both sampler kernels require of their inputs."""
    n, xdim = x0.shape
    dev = x0.device
    if not 1 <= xdim <= MAX_XDIM:
        raise ValueError(f"the kernel takes 1..{MAX_XDIM} state dims, got {xdim}")
    if len(params) < 2 or len(params) - 2 > MAX_HIDDEN:
        raise ValueError(f"the kernel takes 2..{MAX_HIDDEN + 2} layers, got {len(params)}")
    for w, b in params:
        if w.device != dev or b.device != dev:
            raise ValueError("params must lie on the device of x0")
    if x0.dtype != torch.float32 or not x0.is_contiguous():
        raise ValueError("x0 must be a contiguous float32 tensor")
    if noise is not None:
        if noise.shape != (num_steps, n, noise_width) or noise.dtype != torch.float32:
            raise ValueError(f"noise must be float32 of shape {(num_steps, n, noise_width)}")
        if noise.device != dev or not noise.is_contiguous():
            raise ValueError("noise must be contiguous on the device of x0")


def _hidden_args(net: dict):
    """The hidden layers' pointer and width arrays for the C entry points."""
    n_hidden = len(net["wh"])
    wh = (ctypes.c_uint64 * max(n_hidden, 1))(*[t.data_ptr() for t in net["wh"]])
    bh = (ctypes.c_uint64 * max(n_hidden, 1))(*[t.data_ptr() for t in net["bh"]])
    widths = (ctypes.c_int * (n_hidden + 1))(*net["widths"])
    return wh, bh, widths, n_hidden


_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4
    + [ctypes.c_float] * 8
    + [ctypes.c_uint64, ctypes.c_void_p]
)


def _launch(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed):
    n, xdim = x0.shape
    dev = x0.device
    _check_launch(params, x0, noise, num_steps, xdim)
    net = _device_net(params, xdim)
    _check_y(y, net["ydim"])
    y_dev = (torch.zeros(1, device=dev) if net["ydim"] == 0
             else y.to(device=dev, dtype=torch.float32).reshape(-1).contiguous())
    out = torch.empty_like(x0)
    wh, bh, widths, n_hidden = _hidden_args(net)
    delta = T / num_steps
    lib = build.load("em_kernel")
    fn = lib.em_sampler_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(
        x0.data_ptr(), y_dev.data_ptr(), net["w1x"].data_ptr(), net["w1y"].data_ptr(),
        net["w1t"].data_ptr(), net["b1"].data_ptr(), wh, bh, widths, n_hidden,
        net["wout"].data_ptr(), net["bout"].data_ptr(),
        None if noise is None else noise.data_ptr(), out.data_ptr(),
        n, xdim, net["ydim"], num_steps,
        T, beta_min, beta_max - beta_min, 1.0 - 0.5 * lmbd, (1.0 - lmbd) ** 0.5,
        delta, delta**0.5, noise_scale, seed & (2**64 - 1),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "em_sampler_launch")
    fused_em_sampler.launches += 1
    return out


def fused_em_sampler(
    params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Optional[Tensor],
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    seed: int = 0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Run the fused E-M sampler from x0 (N, xdim) for the single condition
    y (ydim,) or None.  Returns (N, xdim) float32.

    On a CUDA tensor this launches the kernel (bf16 weights only), with
    Philox noise keyed by ``seed``, or ``noise`` (num_steps, N, xdim) when
    given.  On a CPU tensor it runs :func:`em_sampler_reference`, drawing
    noise from a generator seeded with ``seed``.
    """
    if x0.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed) if noise is None else None
        return em_sampler_reference(
            params, x0, y, num_steps, T, beta_min, beta_max, lmbd,
            compute_dtype, noise_scale, noise, gen,
        )
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA E-M kernel computes with bf16 weights; other compute "
            "dtypes are queued in ROADMAP.md"
        )
    return _launch(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed)


fused_em_sampler.launches = 0


def em_cdiffe_reference(
    params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Plain PyTorch version of B4: the CDiffE sampler on the joint net
    (layer 0 takes [x, y, t]), the output sliced to the x block, inputs of
    every product rounded to ``compute_dtype`` ([x, y_t] included), f32
    sums, f32 state, the first layer's bias taken as s w1t + b1.  ``noise``
    (num_steps, N, xdim + ydim) is the kernel's one block per step: columns
    [:xdim] for the integrator, [xdim:] for y; else drawn from
    ``generator``, y's draw first in each step."""
    xdim = x0.shape[-1]
    w1, b1 = params[0]
    width = w1.shape[0] - 1
    _check_y(y, width - xdim)
    rnd = _rounder(compute_dtype)
    w1z, w1t = rnd(w1[:width]), w1[width]
    hidden = [(rnd(w), b) for w, b in params[1:-1]]
    w_out, b_out = rnd(params[-1][0][:, :xdim]), params[-1][1][:xdim]

    def drift(z, _cond, s):
        h = rnd(torch.tanh(rnd(z) @ w1z + (s * w1t + b1)))
        for w, b in hidden:
            h = rnd(torch.tanh(h @ w + b))
        return h @ w_out + b_out

    sde = ReverseSDE(base=VPSDE(beta_min=beta_min, beta_max=beta_max, T=T), T=T)
    return euler_maruyama_cdiffe(
        sde, drift, y.reshape(-1), x0.shape[0], xdim, num_steps, lmbd=lmbd,
        noise_scale=noise_scale, generator=generator, x0=x0, noise=noise, y_eps=noise,
    )


_CDIFFE_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4
    + [ctypes.c_float] * 8
    + [ctypes.c_uint64, ctypes.c_void_p]
)


def _cdiffe_device_net(params, xdim: int):
    """B4's layout of the joint net: the first layer's [x, y] rows padded
    to 32 x h1 and packed for mma.sync, hidden layers as B1, the output
    layer's x block transposed; bf16 where the kernel computes in bf16."""
    w1, b1 = params[0]
    width = w1.shape[0] - 1
    f32 = lambda t: t.to(torch.float32)
    h1 = _ceil32(w1.shape[1])
    net = {
        "w1": pack_mma_b(_pad2(f32(w1[:width]), CDIFFE_MAX_WIDTH, h1)),
        "w1t": _pad1(f32(w1[width]), h1),
        "b1": _pad1(f32(b1), h1),
    }
    return _add_hidden_and_out(net, params, h1, xdim)


def _launch_cdiffe(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed):
    n, xdim = x0.shape
    dev = x0.device
    width = params[0][0].shape[0] - 1
    ydim = width - xdim
    if ydim < 1 or width > CDIFFE_MAX_WIDTH:
        raise ValueError(f"the kernel takes 1 <= ydim and xdim + ydim <= {CDIFFE_MAX_WIDTH}, got {xdim} + {ydim}")
    if params[-1][0].shape[1] != width:
        raise ValueError(f"a CDiffE net ends in xdim + ydim = {width} outputs, not {params[-1][0].shape[1]}")
    _check_launch(params, x0, noise, num_steps, width)
    _check_y(y, ydim)
    net = _cdiffe_device_net(params, xdim)
    y_dev = y.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    out = torch.empty_like(x0)
    wh, bh, widths, n_hidden = _hidden_args(net)
    delta = T / num_steps
    lib = build.load("em_kernel")
    fn = lib.em_cdiffe_launch
    fn.argtypes = _CDIFFE_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(
        x0.data_ptr(), y_dev.data_ptr(), net["w1"].data_ptr(), net["w1t"].data_ptr(), net["b1"].data_ptr(),
        wh, bh, widths, n_hidden, net["wout"].data_ptr(), net["bout"].data_ptr(),
        None if noise is None else noise.data_ptr(), out.data_ptr(),
        n, xdim, ydim, num_steps,
        T, beta_min, beta_max - beta_min, 1.0 - 0.5 * lmbd, (1.0 - lmbd) ** 0.5,
        delta, delta**0.5, noise_scale, seed & (2**64 - 1),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "em_cdiffe_launch")
    fused_em_sampler_cdiffe.launches += 1
    return out


def fused_em_sampler_cdiffe(
    params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    seed: int = 0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Run the CDiffE sampler from x0 (N, xdim) for the observed y (ydim,)
    on the joint net ([x, y, t] -> xdim + ydim).  Returns (N, xdim) float32.

    On a CUDA tensor this launches B4 (bf16 weights only), with Philox
    noise keyed by ``seed``, or ``noise`` (num_steps, N, xdim + ydim) when
    given.  On a CPU tensor it runs :func:`em_cdiffe_reference`, drawing
    noise from a generator seeded with ``seed``.
    """
    if x0.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed) if noise is None else None
        return em_cdiffe_reference(
            params, x0, y, num_steps, T, beta_min, beta_max, lmbd,
            compute_dtype, noise_scale, noise, gen,
        )
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA CDiffE kernel computes with bf16 weights; other compute "
            "dtypes are queued in ROADMAP.md"
        )
    return _launch_cdiffe(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed)


fused_em_sampler_cdiffe.launches = 0
