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

Both kernels live in ``csrc/em_kernel.cu``, in two modes, the
``compute_dtype`` of the JAX kernels.  With bf16 weights (the default) one
template serves both, taking every weight as the image of its tiles in
shared memory (:func:`pack_mma_b` for the first layer,
:func:`pack_wgmma_tiles` for the rest).  With f32 weights a second template
runs the first and the hidden layers' products in split TF32 on wgmma,
every weight split once by the wrapper into a TF32 hi and a lo part and
packed as the image of its ring tiles (:func:`pack_tf32_tiles`), the
output layer in f32.  The bf16 template runs as clusters of
:data:`CLUSTER` blocks that share every weight tile
(:func:`launch_blocks`, :func:`ring_bytes_per_block_step`).  A wrapper
takes the plain version only for CPU tensors; for a CUDA tensor it launches
the kernel or raises.  Each counts its launches (``launches``) and, apart,
each mode's (``launches_by_dtype``) and each cluster size's
(``launches_by_cluster``).  B1 packs a net's layers once per params and
reuses them while the params are unchanged (:class:`NetCache`), counting
``packs`` and ``pack_hits``.
"""

from __future__ import annotations

import collections
import ctypes
import weakref
from typing import Optional, Sequence, Tuple, Union

import torch

from ..samplers import euler_maruyama, euler_maruyama_cdiffe
from ..sde import ReverseSDE, VPSDE
from ..utils import profiling
from . import build
from .mh_kernel import tf32_rna

Tensor = torch.Tensor

MAX_HIDDEN = 8
MAX_XDIM = 4
MAX_WIDTH = 512  # every width, after padding to a multiple of 128
K1 = 32  # the first layer's [x] (B1) or [x, y] (B4) rows, zero-padded: one 32-deep mma.sync slice
ROWS = 64  # sample rows a block
CLUSTER = 2  # blocks a cluster of the bf16 template (csrc/em_kernel.cu EM_CLUSTER); the f32 one runs alone
# the kernels' two modes, as ``compute_dtype``: bf16 or f32 weights and activations
COMPUTE_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def phase_names(n_hidden: int, cdiffe: bool = False) -> Tuple[str, ...]:
    """The phases of one step of B1 (or B4, with ``cdiffe``) on a net with
    ``n_hidden`` hidden products, in the order the stamps end them."""
    names = ("layer0", *[f"hidden{i + 1}" for i in range(n_hidden)], "output", "update")
    return ("noise", *names) if cdiffe else names


# the phases of the served nets, which have two hidden products
PHASES = phase_names(2)
CDIFFE_PHASES = phase_names(2, cdiffe=True)


def _ceil128(v: int) -> int:
    return -(-v // 128) * 128


def _pad2(w: Tensor, rows: int, cols: int) -> Tensor:
    out = w.new_zeros(rows, cols)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _pad1(b: Tensor, n: int) -> Tensor:
    out = b.new_zeros(n)
    out[: b.shape[0]] = b
    return out


def check_compute_dtype(compute_dtype) -> None:
    """Raise unless ``compute_dtype`` is one of the kernels' two modes."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"the E-M kernels compute in torch.bfloat16 or torch.float32, got {compute_dtype}")


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


def pack_wgmma_tiles(w: Tensor, parts: int = 2) -> Tensor:
    """(K, N) weight -> bf16 images of the kernels' wgmma B operands, in the
    order the products take them.

    Output shape (K/64, parts, N/parts, 64): 64-deep k slice, column part,
    column within the part, k within the slice.  Each [kc, h] is one tile
    as it lies in shared memory: N/parts rows of 128 bytes (column n's 64 k
    values, K-major), whose 16-byte pieces are swizzled, piece q of row r at
    q ^ (r % 8).  So element [kc, h, r, 8 q + e] is
    W[64 kc + 8 (q ^ (r % 8)) + e, h N/parts + r].  K must be a multiple of
    64 and N of 8 parts.  The hidden layers are cut in two parts, one per
    warpgroup; the output layer is one part of 8 columns.
    """
    K, N = w.shape
    if K % 64 or N % (8 * parts):
        raise ValueError(f"pack_wgmma_tiles needs K % 64 == 0 and N % {8 * parts} == 0, got {tuple(w.shape)}")
    cols = N // parts
    t = w.to(torch.bfloat16).reshape(K // 64, 8, 8, parts, cols)   # kc, piece, e, h, r
    t = t.permute(0, 3, 4, 1, 2)                                    # kc, h, r, piece, e
    r = torch.arange(cols, device=w.device).view(cols, 1)
    q = torch.arange(8, device=w.device).view(1, 8)
    src = (q ^ (r % 8)).view(1, 1, cols, 8, 1).expand(K // 64, parts, cols, 8, 8)
    return torch.gather(t, 3, src).reshape(K // 64, parts, cols, 64).contiguous()


def pack_tf32_tiles(w: Tensor) -> Tensor:
    """(K, N) f32 weight -> the f32 kernel's ring tiles: every entry split
    into hi = :func:`tf32_rna` (w) and lo = w - hi (exact), both f32, in the
    order the products take them.

    A tile holds S = 2 8-deep k-steps, or S = 1 when K = 8 (the first
    layer of a net whose input is at most 8 wide).  Output shape (K/(8 S),
    4, S, N/4, 16): tile, column quarter (one per warpgroup), k-step of the
    tile, column within the quarter, and 64 bytes for that column: four
    16-byte pieces, hi's then lo's, each plane's 8 rows of the k-step in
    the order (0, 2, 4, 6 | 1, 3, 5, 7), the pieces swizzled by 64 bytes,
    logical piece p of column n at p ^ ((n // 2) % 4).  So element [kp, h,
    s, n, 4 q + e] is plane(p // 2)[8 (S kp + s) + 2 e + p % 2, h N/4 + n]
    with p = q ^ ((n // 2) % 4), plane 0 hi and 1 lo.  K must be 8 or a
    multiple of 16 and N a multiple of 128.  Each [kp, h] is one ring tile.
    """
    K, N = w.shape
    if (K != 8 and K % 16) or N % 128 or w.dtype != torch.float32:
        raise ValueError(f"pack_tf32_tiles takes f32 with K == 8 or K % 16 == 0 and N % 128 == 0, got {w.dtype} "
                         f"{tuple(w.shape)}")
    hi = tf32_rna(w)
    S, cols = min(2, K // 8), N // 4
    t = torch.stack([hi, w - hi]).reshape(2, K // (8 * S), S, 4, 2, 4, cols)  # plane, kp, s, e, p % 2, h, n
    t = t.permute(1, 5, 2, 6, 0, 4, 3).reshape(K // (8 * S), 4, S, cols, 4, 4)  # kp, h, s, n, p, e
    n = torch.arange(cols, device=w.device).view(cols, 1)
    q = torch.arange(4, device=w.device).view(1, 4)
    src = (q ^ ((n // 2) % 4)).view(1, 1, 1, cols, 4, 1).expand(K // (8 * S), 4, S, cols, 4, 4)
    return torch.gather(t, 4, src).reshape(K // (8 * S), 4, S, cols, 16).contiguous()


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


def _rounder(compute_dtype, dtype=torch.float32):
    """Round to ``compute_dtype``, then compute in ``dtype``."""
    if compute_dtype == dtype:
        return lambda t: t.to(dtype)
    return lambda t: t.to(compute_dtype).to(dtype)


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
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Plain PyTorch version of the kernel: E-M through the first layer split
    as x . W1x + s w1t + cy, inputs of every product rounded to
    ``compute_dtype``, sums and state in ``dtype``.  Noise is ``noise`` when
    given, else drawn from ``generator``.  ``dtype=torch.float64`` with
    ``compute_dtype=torch.float64`` runs the sampler unrounded in float64,
    the witness both f32 versions are held against."""
    xdim = x0.shape[-1]
    params = [(w.to(dtype), b.to(dtype)) for w, b in params]
    w1x, w1y, w1t, b1, ydim = _split_first_layer(params, xdim)
    _check_y(y, ydim)
    rnd = _rounder(compute_dtype, dtype)
    cy = b1 if ydim == 0 else y.reshape(1, ydim).to(dtype) @ w1y + b1
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
        noise_scale=noise_scale, generator=generator, x0=x0, noise=noise, dtype=dtype,
    )


def _first_layer(w: Tensor, h1: int, f32_mode: bool) -> Tensor:
    """The first layer's weight over [x] (B1) or [x, y] (B4), (k, h1
    unpadded) f32, in a mode's layout: bf16 with its rows padded to 32,
    packed for mma.sync; or f32 with its rows padded to one k-step, 8, or
    past 8 to a multiple of 16 (tiles of two k-steps), split and packed as
    ring tiles (:func:`pack_tf32_tiles`)."""
    if f32_mode:
        return pack_tf32_tiles(_pad2(w, 8 if w.shape[0] <= 8 else -(-w.shape[0] // 16) * 16, h1))
    return pack_mma_b(_pad2(w, K1, h1))


def _c1(params, xdim: int, y: Optional[Tensor]) -> Tensor:
    """The condition folded into B1's first layer: c1 = cy = y . W1y + b1
    (f32, as the plain version computes it), zero-padded to the first
    layer's padded width."""
    _, w1y, _, b1, ydim = _split_first_layer(params, xdim)
    _check_y(y, ydim)
    f32 = lambda t: t.to(torch.float32)
    cy = f32(b1) if ydim == 0 else y.reshape(1, ydim).to(device=b1.device, dtype=torch.float32) @ f32(w1y) + f32(b1)
    return _pad1(cy.reshape(-1), _ceil128(params[0][0].shape[1]))


def _packed_net(params, xdim: int, f32_mode: bool = False) -> dict:
    """What of B1's layout does not depend on the condition: widths
    zero-padded to multiples of 128 (exact: a padded unit has zero weights
    in and out), W1x in the mode's first-layer layout
    (:func:`_first_layer`), the padded t row, the layers after as
    :func:`_add_hidden_and_out`."""
    w1x, _, w1t, _, ydim = _split_first_layer(params, xdim)
    f32 = lambda t: t.to(torch.float32)
    h1 = _ceil128(w1x.shape[1])
    net = {"w1": _first_layer(f32(w1x), h1, f32_mode), "w1t": _pad1(f32(w1t), h1), "ydim": ydim}
    return _add_hidden_and_out(net, params, h1, xdim, f32_mode)


def _device_net(params, xdim: int, y: Optional[Tensor], f32_mode: bool = False):
    """B1's layout of the net for the condition y, packed anew:
    :func:`_packed_net` and c1 (:func:`_c1`)."""
    c1 = _c1(params, xdim, y)
    return {**_packed_net(params, xdim, f32_mode), "c1": c1}


PACKED_NETS_KEPT = 4


class NetCache:
    """B1's packed layouts (:func:`_packed_net`) of the nets it was handed
    last, at most ``size``, the least recently used dropped first.

    An entry holds for one mode, ``xdim``, device and (on a card) stream,
    and for the params' leaves as they were: each tensor itself (held by a
    weak reference, compared by identity), its ``_version``, shape, dtype
    and data_ptr.  Every in-place write through PyTorch bumps ``_version``
    (an optimizer step, a ``copy_`` or ``add_`` under ``no_grad``), and a new
    tree of equal values holds other tensors, so either misses; nothing is
    read from the card.  An entry one of whose leaves has died is dropped
    at the next lookup.  A write PyTorch does not see (through ``.data``,
    or a raw pointer into a leaf) is not seen here either: hand B1 a new
    tree after one.  Inference tensors track no version and are packed at
    every call.  A hit on another stream than the pack's would let the
    caching allocator reuse an evicted entry's memory on the pack's stream
    while the other stream's launch still reads it, so a stream keys its
    own entry."""

    def __init__(self, size: int = PACKED_NETS_KEPT):
        self.size = size
        self._entries = collections.OrderedDict()  # key -> (weak references to the leaves, packed net)

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, params, xdim: int, f32_mode: bool = False) -> Tuple[dict, bool]:
        """(the packed net of ``params``, whether it was kept from an
        earlier call)."""
        leaves = [t for pair in params for t in pair]
        if any(t.is_inference() for t in leaves):
            return _packed_net(params, xdim, f32_mode), False
        dev = leaves[0].device
        stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        # an id() names one live tensor: dropping the entries of dead leaves first makes it an identity
        for k in [k for k, (refs, _) in self._entries.items() if any(r() is None for r in refs)]:
            del self._entries[k]
        key = (f32_mode, xdim, dev, stream,
               tuple((id(t), t._version, tuple(t.shape), t.dtype, t.data_ptr()) for t in leaves))
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key][1], True
        with torch.no_grad():  # a packed tensor holding a leaf's autograd graph would keep the leaf alive
            net = _packed_net(params, xdim, f32_mode)
        self._entries[key] = ([weakref.ref(t) for t in leaves], net)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return net, False


_B1_NETS = NetCache()


def _b1_net(params, xdim: int, y: Optional[Tensor], f32_mode: bool = False) -> dict:
    """B1's layout of the net for y: the packed layers kept in
    ``_B1_NETS`` for these params, or packed now (counted in
    ``fused_em_sampler.pack_hits`` and ``.packs``), and c1 computed anew.
    Equal, tensor for tensor, to :func:`_device_net`."""
    c1 = _c1(params, xdim, y)
    net, hit = _B1_NETS.get(params, xdim, f32_mode)
    fused_em_sampler.pack_hits += hit
    fused_em_sampler.packs += not hit
    return {**net, "c1": c1}


def _add_hidden_and_out(net: dict, params, h1: int, xdim: int, f32_mode: bool = False) -> dict:
    """The layout B1 and B4 share after the first layer: hidden weights
    padded to multiples of 128, f32 biases, and the output layer's first
    xdim columns.  bf16: the hidden weights packed as ring tiles, the
    output columns padded to 8 and packed as one wgmma operand.  f32: the
    hidden weights split into TF32 hi and lo and packed as ring tiles
    (:func:`pack_tf32_tiles`), the output columns padded to 4, (hl, 4)."""
    f32 = lambda t: t.to(torch.float32)
    pack = pack_tf32_tiles if f32_mode else pack_wgmma_tiles
    net.update(wh=[], bh=[], widths=[h1])
    for w, b in params[1:-1]:
        k, n = _ceil128(w.shape[0]), _ceil128(w.shape[1])
        net["wh"].append(pack(_pad2(f32(w), k, n)))
        net["bh"].append(_pad1(f32(b), n))
        net["widths"].append(n)
    w_out, b_out = params[-1]
    if f32_mode:
        net["wout"] = _pad2(f32(w_out[:, :xdim]), net["widths"][-1], 4)
    else:
        net["wout"] = pack_wgmma_tiles(_pad2(f32(w_out[:, :xdim]), net["widths"][-1], 8), parts=1)
    net["bout"] = f32(b_out[:xdim]).clone(memory_format=torch.contiguous_format)  # no view of a caller's leaf
    net["hidden_args"] = _hidden_args(net)
    return net


def _check_launch(params, x0: Tensor, noise: Optional[Tensor], num_steps: int, noise_width: int) -> None:
    """What both sampler kernels require of their inputs."""
    n, xdim = x0.shape
    dev = x0.device
    if not 1 <= xdim <= MAX_XDIM:
        raise ValueError(f"the kernel takes 1..{MAX_XDIM} state dims, got {xdim}")
    if len(params) < 2 or len(params) - 2 > MAX_HIDDEN:
        raise ValueError(f"the kernel takes 2..{MAX_HIDDEN + 2} layers, got {len(params)}")
    widths = [w.shape[1] for w, _ in params[:-1]]
    if max(_ceil128(v) for v in widths) > MAX_WIDTH:
        raise ValueError(f"the kernel takes widths up to {MAX_WIDTH}, got {widths}")
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
    [ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_float] * 8
    + [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
)


def _em_launch(net: dict, cdiffe: bool, f32_mode: bool, x0, y_dev, noise, stamps, ydim, num_steps, T, beta_min, beta_max,
               lmbd, noise_scale, seed) -> Tensor:
    """Launch B1 or B4, in the f32 or the bf16 mode, on the device net
    ``net`` laid out for that mode (B4 with its observation ``y_dev``);
    returns the samples."""
    n, xdim = x0.shape
    dev = x0.device
    out = torch.empty_like(x0)
    wh, bh, widths, n_hidden = net["hidden_args"]
    delta = T / num_steps
    ptr = lambda t: None if t is None else t.data_ptr()
    seed_value, seed_ptr = build.seed_args(seed, dev)
    lib = build.load("em_kernel")
    fn = lib.em_f32_launch if f32_mode else lib.em_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # the launcher sets attributes and launches on the current device
    with torch.cuda.device(dev):
        err = fn(
            int(cdiffe), x0.data_ptr(), ptr(y_dev), net["c1"].data_ptr(), net["w1t"].data_ptr(),
            net["w1"].data_ptr(), wh, bh, widths, n_hidden,
            net["wout"].data_ptr(), net["bout"].data_ptr(), ptr(noise), out.data_ptr(), ptr(stamps),
            n, xdim, ydim, num_steps,
            T, beta_min, beta_max - beta_min, 1.0 - 0.5 * lmbd, (1.0 - lmbd) ** 0.5,
            delta, delta**0.5, noise_scale, seed_value, seed_ptr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, err, "em_f32_launch" if f32_mode else "em_launch")
    return out


def cluster_size(compute_dtype) -> int:
    """The blocks a cluster of the mode's template."""
    return CLUSTER if compute_dtype == torch.bfloat16 else 1


def launch_blocks(n: int, compute_dtype=torch.bfloat16) -> int:
    """The blocks a launch on ``n`` rows runs: one per ``ROWS`` rows,
    rounded up to whole clusters (a block past the rows runs on zeros and
    stores nothing)."""
    c = cluster_size(compute_dtype)
    return -(-n // (ROWS * c)) * c


def ring_bytes_per_block_step(widths: Sequence[int], cluster: int = CLUSTER) -> int:
    """The weight bytes one block of the bf16 template reads from L2 a step:
    its share of every ring tile its cluster of ``cluster`` blocks fetches
    once, the first layer's (K1, h1) and each hidden layer's (K, N) bf16,
    ``widths`` the hidden layers' (padded to multiples of 128).  The output
    layer's weights stay in shared memory."""
    w = [_ceil128(v) for v in widths]
    return 2 * (K1 * w[0] + sum(a * b for a, b in zip(w[:-1], w[1:]))) // cluster


_max_clusters = {}


def max_active_clusters(widths: Sequence[int], cdiffe: bool = False) -> int:
    """The most clusters of B1 (or B4, with ``cdiffe``) in bf16 at these
    hidden widths that the current card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per shape and card."""
    padded = tuple(_ceil128(v) for v in widths)
    key = (padded, bool(cdiffe), torch.cuda.current_device())
    if key not in _max_clusters:
        lib = build.load("em_kernel")
        lib.em_max_active_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int)]
        lib.em_max_active_clusters.restype = ctypes.c_int
        out = ctypes.c_int(0)
        err = lib.em_max_active_clusters(int(cdiffe), (ctypes.c_int * len(padded))(*padded), len(padded) - 1,
                                         ctypes.byref(out))
        build.check(lib, err, "em_max_active_clusters")
        _max_clusters[key] = out.value
    return _max_clusters[key]


def stamp_entries(n_phases: int, num_steps: int, compute_dtype=torch.bfloat16) -> int:
    """The int64 entries a ``stamps`` tensor needs: a (clock, cycles) pair
    before the first step and at the end of each of the ``n_phases`` phases
    of each step, then the ring's waits, one count for each consumer
    warpgroup in each phase of each step (four with f32 weights; two with
    bf16, whose two records, block 0's and the launch's last block's, each
    hold pairs and waits)."""
    pairs = 2 * (1 + n_phases * num_steps)
    if compute_dtype == torch.float32:
        return pairs + 4 * n_phases * num_steps
    return 2 * (pairs + 2 * n_phases * num_steps)


def _check_stamps(stamps: Optional[Tensor], n_phases: int, num_steps: int, dev, compute_dtype) -> None:
    need = stamp_entries(n_phases, num_steps, compute_dtype)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev or stamps.numel() < need
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 tensor of >= {need} entries on {dev}")


def _count(fn, compute_dtype) -> None:
    fn.launches += 1
    fn.launches_by_dtype[COMPUTE_DTYPES[compute_dtype]] += 1
    fn.launches_by_cluster[cluster_size(compute_dtype)] += 1


def _launch(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed, stamps, compute_dtype):
    n, xdim = x0.shape
    dev = x0.device
    f32_mode = compute_dtype == torch.float32
    _check_launch(params, x0, noise, num_steps, xdim)
    _check_stamps(stamps, len(phase_names(len(params) - 2)), num_steps, dev, compute_dtype)
    with profiling.span("b1.pack"):
        net = _b1_net(params, xdim, y, f32_mode)
    with profiling.span("b1.launch"):
        out = _em_launch(net, False, f32_mode, x0, None, noise, stamps, net["ydim"], num_steps, T, beta_min,
                         beta_max, lmbd, noise_scale, seed)
    _count(fused_em_sampler, compute_dtype)
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
    seed: Union[int, Tensor] = 0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    stamps: Optional[Tensor] = None,
) -> Tensor:
    """Run the fused E-M sampler from x0 (N, xdim) for the single condition
    y (ydim,) or None.  Returns (N, xdim) float32.

    ``compute_dtype`` is torch.bfloat16 (bf16 weights and activations, f32
    sums and state) or torch.float32 (every product's inputs f32, the
    JAX kernel's way to reproduce the f32 sampler); another raises.  On a
    CUDA tensor this launches that mode's kernel, with Philox noise keyed
    by ``seed`` (the same normals in both modes), or ``noise`` (num_steps,
    N, xdim) when given.  On a CPU tensor it runs
    :func:`em_sampler_reference`, drawing noise from a generator seeded
    with ``seed``.  ``seed`` is an int, or a one-element int64 tensor on
    x0's device, which the kernel reads there (``build.seed_args``): a seed
    drawn on the card needs no copy to the host, and gives the samples of
    its value as an int.

    ``stamps``, taken only by the kernel, is a contiguous int64 tensor of
    >= ``stamp_entries(P, num_steps, compute_dtype)`` entries, P =
    len(phase_names(n_hidden)): it receives block 0's clock (ns) and its
    SM's cycle count, a pair, once before the first step and then at the
    end of each phase of each step; these 2 (1 + P x num_steps) entries are
    followed by P x num_steps x W more, [step][phase][warpgroup]: the
    cycles each of block 0's W consumer warpgroups (4 with f32 weights, 2
    with bf16) waited for weight tiles in that phase.  With bf16 weights a
    second record of the same form follows, from the launch's last block
    (one of its last wave); the two warpgroups there take turns on each
    hidden layer's products, and a phase's pair is read when warpgroup 0
    ends it.  The samples do not change.
    """
    check_compute_dtype(compute_dtype)
    if x0.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stamps are taken only by the CUDA kernel")
        gen = torch.Generator().manual_seed(int(seed)) if noise is None else None
        return em_sampler_reference(
            params, x0, y, num_steps, T, beta_min, beta_max, lmbd,
            compute_dtype, noise_scale, noise, gen,
        )
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    return _launch(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed, stamps,
                   compute_dtype)


fused_em_sampler.launches = 0
fused_em_sampler.launches_by_dtype = dict.fromkeys(COMPUTE_DTYPES.values(), 0)
fused_em_sampler.launches_by_cluster = {1: 0, CLUSTER: 0}
fused_em_sampler.packs = 0  # launches that packed the net's layers
fused_em_sampler.pack_hits = 0  # launches that found them packed (NetCache)


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
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Plain PyTorch version of B4: the CDiffE sampler on the joint net
    (layer 0 takes [x, y, t]), the output sliced to the x block, inputs of
    every product rounded to ``compute_dtype`` ([x, y_t] included), sums
    and state in ``dtype``, the first layer's bias taken as s w1t + b1.
    ``noise`` (num_steps, N, xdim + ydim) is the kernel's one block per
    step: columns [:xdim] for the integrator, [xdim:] for y; else drawn from
    ``generator``, y's draw first in each step.  ``dtype`` and the float64
    witness as :func:`em_sampler_reference`."""
    xdim = x0.shape[-1]
    params = [(w.to(dtype), b.to(dtype)) for w, b in params]
    w1, b1 = params[0]
    width = w1.shape[0] - 1
    _check_y(y, width - xdim)
    rnd = _rounder(compute_dtype, dtype)
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
        noise_scale=noise_scale, generator=generator, x0=x0, noise=noise, y_eps=noise, dtype=dtype,
    )


def _cdiffe_device_net(params, xdim: int, f32_mode: bool = False):
    """B4's layout of the joint net: the first layer's [x, y] rows in the
    mode's first-layer layout (:func:`_first_layer`), hidden and output
    layers as B1's."""
    w1, b1 = params[0]
    width = w1.shape[0] - 1
    f32 = lambda t: t.to(torch.float32)
    h1 = _ceil128(w1.shape[1])
    net = {
        "w1": _first_layer(f32(w1[:width]), h1, f32_mode),
        "w1t": _pad1(f32(w1[width]), h1),
        "c1": _pad1(f32(b1), h1),
    }
    return _add_hidden_and_out(net, params, h1, xdim, f32_mode)


def _launch_cdiffe(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed, stamps,
                   compute_dtype):
    n, xdim = x0.shape
    dev = x0.device
    width = params[0][0].shape[0] - 1
    ydim = width - xdim
    if ydim < 1 or width > K1:
        raise ValueError(f"the kernel takes 1 <= ydim and xdim + ydim <= {K1}, got {xdim} + {ydim}")
    if params[-1][0].shape[1] != width:
        raise ValueError(f"a CDiffE net ends in xdim + ydim = {width} outputs, not {params[-1][0].shape[1]}")
    _check_launch(params, x0, noise, num_steps, width)
    _check_stamps(stamps, len(phase_names(len(params) - 2, cdiffe=True)), num_steps, dev, compute_dtype)
    _check_y(y, ydim)
    f32_mode = compute_dtype == torch.float32
    net = _cdiffe_device_net(params, xdim, f32_mode)
    y_dev = y.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    out = _em_launch(net, True, f32_mode, x0, y_dev, noise, stamps, ydim, num_steps, T, beta_min, beta_max, lmbd,
                     noise_scale, seed)
    _count(fused_em_sampler_cdiffe, compute_dtype)
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
    seed: Union[int, Tensor] = 0,
    compute_dtype=torch.bfloat16,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    stamps: Optional[Tensor] = None,
) -> Tensor:
    """Run the CDiffE sampler from x0 (N, xdim) for the observed y (ydim,)
    on the joint net ([x, y, t] -> xdim + ydim).  Returns (N, xdim) float32.

    ``compute_dtype`` as :func:`fused_em_sampler`.  On a CUDA tensor this
    launches that mode's B4, with Philox noise keyed by ``seed``, or
    ``noise`` (num_steps, N, xdim + ydim) when given.  On a CPU tensor it
    runs :func:`em_cdiffe_reference`, drawing noise from a generator seeded
    with ``seed``.  ``seed`` and ``stamps`` as :func:`fused_em_sampler`, over
    ``phase_names(n_hidden, cdiffe=True)``.
    """
    check_compute_dtype(compute_dtype)
    if x0.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stamps are taken only by the CUDA kernel")
        gen = torch.Generator().manual_seed(int(seed)) if noise is None else None
        return em_cdiffe_reference(
            params, x0, y, num_steps, T, beta_min, beta_max, lmbd,
            compute_dtype, noise_scale, noise, gen,
        )
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    return _launch_cdiffe(params, x0, y, num_steps, T, beta_min, beta_max, lmbd, noise_scale, noise, seed, stamps,
                          compute_dtype)


fused_em_sampler_cdiffe.launches = 0
fused_em_sampler_cdiffe.launches_by_dtype = dict.fromkeys(COMPUTE_DTYPES.values(), 0)
fused_em_sampler_cdiffe.launches_by_cluster = {1: 0, CLUSTER: 0}
