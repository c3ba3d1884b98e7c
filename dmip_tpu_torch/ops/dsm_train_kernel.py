"""Fused DSM training epochs: CUDA kernel and plain version.

Port of ``dmip_tpu/ops/dsm_train_kernel.py :: fused_dsm_train_epochs``.  The
kernel (``csrc/dsm_train_kernel.cu``) runs ``n_epochs x n_batches`` optimizer
steps of a tanh MLP in one launch; each step is the forward pass, the DSM
loss 1/2 sum (out s1 + eps)^2 / batch_real, the hand-written backward, the
skip-nonfinite guard and optax's Adam with bias correction.  Epochs at index
>= ``n_active`` compute but do not update.  Parameters never leave the card
between steps; no autograd is involved, since the kernel applies the update
itself and returns the new state.

:func:`dsm_train_epochs_reference` is the plain version: the same arithmetic
step by step in torch, rounding every product's operands to
``compute_dtype`` where the kernel does.  :func:`fused_dsm_train_epochs`
takes it only for CPU tensors; for a CUDA tensor it launches the kernel or
raises.  :func:`make_fused_dsm_epoch_fn` is the drop-in epoch engine behind
``train_backend: fused_pallas``.

The wrapper hands the kernel its state zero-padded to whole 64-wide tiles
(:func:`padded_widths`, :func:`pad_tree`) and cuts the result back
(:func:`unpad_tree`).  This is exact: a padded unit has zero weights in and
out, so its activation, gradient and Adam update are all 0, and a padded
output column has s1 = eps = 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence, Tuple

import torch

from . import build

Tensor = torch.Tensor
Pairs = Sequence[Tuple[Tensor, Tensor]]

MAX_LAYERS = 10
TILE = 64
GUARDS = {False: 0, True: 1, "loss": 2}
# side streams a preparation on a card spreads its epochs over: an epoch's
# tensor calls are small, so a stream alone leaves the card idle between them
PREP_STREAMS = 8


def _check_args(params, mu, nu, h0, eps, s1, n_epochs, n_batches, batch_real, compute_dtype, skip_nonfinite):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if skip_nonfinite not in GUARDS:
        raise ValueError(f"skip_nonfinite must be True, 'loss' or False, got {skip_nonfinite!r}")
    if not (len(params) == len(mu) == len(nu)) or len(params) < 1:
        raise ValueError("params, mu and nu must hold the same number of (W, b) pairs")
    rows = h0.shape[0]
    if n_epochs < 1 or n_batches < 1 or rows % (n_epochs * n_batches):
        raise ValueError(f"{rows} rows do not split into {n_epochs} x {n_batches} batches")
    bp = rows // (n_epochs * n_batches)
    if not 1 <= batch_real <= bp:
        raise ValueError(f"batch_real {batch_real} outside 1..{bp}")
    out_dim = params[-1][0].shape[1]
    if h0.shape[1] != params[0][0].shape[0]:
        raise ValueError(f"h0 has {h0.shape[1]} features, the net takes {params[0][0].shape[0]}")
    if eps.shape != (rows, out_dim) or s1.shape != (rows, out_dim):
        raise ValueError(f"eps and s1 must have shape {(rows, out_dim)}")
    return bp


def dsm_train_epochs_reference(
    params: Pairs,
    mu: Pairs,
    nu: Pairs,
    count,
    h0: Tensor,
    eps: Tensor,
    s1: Tensor,
    n_epochs: int,
    n_batches: int,
    batch_real: int,
    lr: float,
    n_active: int,
    b1: float = 0.9,
    b2: float = 0.999,
    adam_eps: float = 1e-8,
    compute_dtype=torch.bfloat16,
    skip_nonfinite=True,
):
    """Plain PyTorch version of the kernel, step by step.

    params/mu/nu: tuples of (W, b) (Adam's first and second moments for
    mu/nu).  h0 (E nb B, in) net inputs [z_t, y, t]; eps and s1 (E nb B,
    out) the DSM target and std/g (rows with s1 = 0 are padding).  count:
    Adam's step count on entry.  Returns (params, mu, nu, count as a 0-d
    int32 tensor, per-epoch mean losses (n_epochs,)).
    """
    _check_args(params, mu, nu, h0, eps, s1, n_epochs, n_batches, batch_real, compute_dtype, skip_nonfinite)
    L = len(params)
    bp = h0.shape[0] // (n_epochs * n_batches)
    dev = h0.device
    inv_b = 1.0 / batch_real
    f32 = torch.float32
    rnd = (lambda t: t) if compute_dtype == f32 else (lambda t: t.to(compute_dtype).to(f32))
    state = [[t.to(f32) for pair in tree for t in pair] for tree in (params, mu, nu)]
    p, m, v = state
    cnt = torch.as_tensor(count, device=dev).to(f32).reshape(())
    log_b1, log_b2 = math.log(b1), math.log(b2)
    losses = []
    for e in range(n_epochs):
        acc = torch.zeros((), dtype=f32, device=dev)
        for i in range(n_batches):
            rows = slice((e * n_batches + i) * bp, (e * n_batches + i + 1) * bp)
            hb, eb, sb = h0[rows].to(f32), eps[rows].to(f32), s1[rows].to(f32)
            acts, h = [], hb
            for k in range(L - 1):
                h = torch.tanh(rnd(h) @ rnd(p[2 * k]) + p[2 * k + 1])
                acts.append(h)
            out = rnd(h) @ rnd(p[2 * L - 2]) + p[2 * L - 1]
            r = out * sb + eb
            batch_loss = 0.5 * torch.sum(r * r) * inv_b
            acc = acc + batch_loss
            dz = r * (sb * inv_b)
            grads = [None] * (2 * L)
            for k in range(L - 1, -1, -1):
                a_prev = acts[k - 1] if k > 0 else hb
                grads[2 * k] = rnd(a_prev).T @ rnd(dz)
                grads[2 * k + 1] = torch.sum(dz, dim=0)
                if k > 0:
                    dz = (rnd(dz) @ rnd(p[2 * k]).T) * (1.0 - a_prev * a_prev)
            do = torch.tensor(e < n_active, device=dev)
            if skip_nonfinite == "loss":
                do = do & torch.isfinite(batch_loss)
            elif skip_nonfinite:
                for g in grads:
                    do = do & torch.isfinite(g).all()
            cnt_new = cnt + 1.0
            bc1 = 1.0 - torch.exp(cnt_new * log_b1)
            bc2 = 1.0 - torch.exp(cnt_new * log_b2)
            for j, g in enumerate(grads):
                m_new = b1 * m[j] + (1.0 - b1) * g
                v_new = b2 * v[j] + (1.0 - b2) * (g * g)
                upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + adam_eps)
                p[j] = torch.where(do, p[j] - lr * upd, p[j])
                m[j] = torch.where(do, m_new, m[j])
                v[j] = torch.where(do, v_new, v[j])
            cnt = torch.where(do, cnt_new, cnt)
        losses.append(acc / n_batches)
    pairs = lambda flat: tuple((flat[2 * k], flat[2 * k + 1]) for k in range(L))
    return pairs(p), pairs(m), pairs(v), cnt.to(torch.int32), torch.stack(losses)


_ARGTYPES = [ctypes.c_void_p] * 6  # ptrs, offs, dims, iargs, fargs (host arrays), stream


def _flat(tree: Pairs) -> Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for pair in tree for t in pair]).contiguous()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_widths(dims: Sequence[int]):
    """The kernel's widths: the input as it is, every fan-out rounded up to
    a multiple of TILE."""
    return [dims[0]] + [_cdiv(d, TILE) * TILE for d in dims[1:]]


def pad_tree(tree: Pairs, widths: Sequence[int]):
    """(W, b) pairs zero-padded to ``widths`` (fan-in of layer k is
    widths[k], fan-out widths[k + 1])."""
    pad = torch.nn.functional.pad
    return tuple((pad(w, (0, widths[k + 1] - w.shape[1], 0, widths[k] - w.shape[0])),
                  pad(b, (0, widths[k + 1] - b.shape[0]))) for k, (w, b) in enumerate(tree))


def unpad_tree(tree: Pairs, dims: Sequence[int]):
    """The inverse of :func:`pad_tree` for the real widths ``dims``."""
    return tuple((w[:dims[k], :dims[k + 1]].contiguous(), b[:dims[k + 1]].contiguous())
                 for k, (w, b) in enumerate(tree))


def _fuses_output(n_layers: int, out_dim: int) -> bool:
    """Whether the output layer's phase also runs backward layer L-1's da
    tiles: with two layers or more and an output of at most TILE features."""
    return n_layers >= 2 and out_dim <= TILE


def phase_names(n_layers: int, out_dim: int):
    """Names of the kernel's phases that end in a grid sync, in the order
    of one step."""
    L, fused = n_layers, _fuses_output(n_layers, out_dim)
    names = [f"forward_{k}" for k in range(L - 1)] + [f"forward_{L - 1}" + ("+da" if fused else "")]
    top, end = (L - 2, 0 if L == 2 else 1) if fused else (L - 1, 1)
    for k in range(top, end - 1, -1):
        names.append(f"backward_{k}" + (f"+dw_{L - 1}" if fused and k == L - 2 else "") + ("+dw_0" if k == 1 else ""))
    return names + ["adam"]


def _launch(params, mu, nu, count, h0, eps, s1, n_epochs, n_batches, batch_real, lr, n_active,
            b1, b2, adam_eps, compute_dtype, skip_nonfinite, stamps=None):
    dev = h0.device
    L = len(params)
    if L > MAX_LAYERS:
        raise ValueError(f"the kernel takes up to {MAX_LAYERS} layers, got {L}")
    bp = h0.shape[0] // (n_epochs * n_batches)
    dims = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
    for k, (w, b) in enumerate(params):
        if tuple(w.shape) != (dims[k], dims[k + 1]) or tuple(b.shape) != (dims[k + 1],):
            raise ValueError(f"layer {k}: W {tuple(w.shape)} and b {tuple(b.shape)} do not chain")
        for tree, name in ((mu, "mu"), (nu, "nu")):
            if tree[k][0].shape != w.shape or tree[k][1].shape != b.shape:
                raise ValueError(f"{name} layer {k} does not match params")
    for t in (*[t for tree in (params, mu, nu) for pair in tree for t in pair], h0, eps, s1):
        if t.device != dev:
            raise ValueError("params, moments and batches must lie on one device")
    for t, name in ((h0, "h0"), (eps, "eps"), (s1, "s1")):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    ct = compute_dtype
    wd = padded_widths(dims)
    in_pad = _cdiv(dims[0], TILE) * TILE
    b_pad = _cdiv(bp, TILE) * TILE
    n_mt = b_pad // TILE
    n_steps = n_epochs * n_batches
    # the flat padded state and the offsets of its tensors, operand copies and gradient partials
    offs, o, wt, wr, pw, pb = [], 0, 0, 0, 0, 0
    for k in range(L):
        offs.append((o, o + wd[k] * wd[k + 1], wt, wr, pw, pb))
        o += (wd[k] + 1) * wd[k + 1]
        wt += wd[k + 1] * (in_pad if k == 0 else wd[k])
        wr += 0 if k == 0 else wd[k] * wd[k + 1]
        pw += (n_mt if k == 0 else 1) * wd[k] * wd[k + 1]
        pb += n_mt * wd[k + 1]
    hmax, dmax = max(wd[1:-1], default=0), max(wd[1:])
    state = [torch.empty(2, o, device=dev) for _ in range(3)]
    for half, tree in zip(state, (params, mu, nu)):
        half[0] = _flat(pad_tree(tree, wd))
    count0 = torch.as_tensor(count, device=dev).to(torch.int32).reshape(1).contiguous()
    # in the order dsm_train_launch reads ptrs (csrc/dsm_train_kernel.cu)
    bufs = [
        *state,
        torch.zeros(2, wt, dtype=ct, device=dev),             # W^T copies (W_0^T's pad columns stay 0)
        torch.empty(2, max(wr, 1), dtype=ct, device=dev),     # W copies, k >= 1
        torch.empty(max((L - 1) * b_pad * hmax, 1), device=dev),
        torch.empty(max((L - 1) * b_pad * hmax, 1), dtype=ct, device=dev),
        torch.empty(max((L - 1) * b_pad * hmax, 1), dtype=ct, device=dev),
        torch.empty(3 * b_pad * dmax, dtype=ct, device=dev),
        torch.empty(3 * b_pad * dmax, dtype=ct, device=dev),
        torch.empty(pw, device=dev),
        torch.empty(pb, device=dev),
        h0, eps, s1,
        torch.empty(n_steps * n_mt * (wd[-1] // TILE), device=dev),
        torch.zeros(n_steps, dtype=torch.int32, device=dev),
        count0,
        torch.empty(1, device=dev),
        torch.empty(1, dtype=torch.int64, device=dev),
        torch.empty(n_epochs, device=dev),
    ]
    count_out, cur, losses = bufs[-3:]
    ptrs = (ctypes.c_void_p * 22)(*[t.data_ptr() for t in bufs], None if stamps is None else stamps.data_ptr())
    flat_offs = [o, wt, wr, b_pad * hmax, b_pad * dmax] + [x for row in offs for x in row]
    iargs = [L, bp, b_pad, n_epochs, n_batches, int(n_active), GUARDS[skip_nonfinite], int(ct == torch.bfloat16),
             dims[-1], in_pad, int(_fuses_output(L, dims[-1]))]
    fargs = [1.0 / batch_real, lr, b1, 1.0 - b1, b2, 1.0 - b2, math.log(b1), math.log(b2), adam_eps]
    lib = build.load("dsm_train_kernel")
    fn = lib.dsm_train_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # the launcher reads the current device, sets attributes and launches on it
    with torch.cuda.device(dev):
        err = fn(ptrs, (ctypes.c_int64 * len(flat_offs))(*flat_offs), (ctypes.c_int * (L + 1))(*wd),
                 (ctypes.c_int * len(iargs))(*iargs), (ctypes.c_float * len(fargs))(*fargs),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "dsm_train_launch")
    fused_dsm_train_epochs.launches += 1

    def unflat(half):
        flat = half.index_select(0, cur)[0]
        tree = tuple((flat[a:b].view(wd[k], wd[k + 1]), flat[b:b + wd[k + 1]])
                     for k, (a, b, *_) in enumerate(offs))
        return unpad_tree(tree, dims)

    return (*(unflat(h) for h in state), count_out.to(torch.int32).reshape(()), losses)


def fused_dsm_train_epochs(
    params: Pairs,
    mu: Pairs,
    nu: Pairs,
    count,
    h0: Tensor,
    eps: Tensor,
    s1: Tensor,
    n_epochs: int,
    n_batches: int,
    batch_real: int,
    lr: float,
    n_active: int,
    b1: float = 0.9,
    b2: float = 0.999,
    adam_eps: float = 1e-8,
    compute_dtype=torch.bfloat16,
    skip_nonfinite=True,
    stamps: Tensor | None = None,
):
    """Run n_epochs x n_batches fused DSM optimizer steps; same arguments
    and results as :func:`dsm_train_epochs_reference`.

    stamps: None, or an int64 CUDA tensor of 1 + 2 x n_epochs x n_batches
    x len(phase_names(L, out)) entries, into which block 0 of the kernel
    writes the card's nanosecond clock when the steps start, and for every
    phase when its own work is done and when the phase's grid sync returns.

    skip_nonfinite: True (a step with any non-finite gradient is skipped),
    'loss' (a step with a non-finite batch loss is skipped) or False.  On a
    CUDA tensor this is one launch of the kernel; on a CPU tensor it runs
    the plain version.
    """
    _check_args(params, mu, nu, h0, eps, s1, n_epochs, n_batches, batch_real, compute_dtype, skip_nonfinite)
    args = (params, mu, nu, count, h0, eps, s1, n_epochs, n_batches, batch_real, lr, n_active,
            b1, b2, adam_eps, compute_dtype, skip_nonfinite)
    if h0.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stamps are taken only by the CUDA kernel")
        return dsm_train_epochs_reference(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    if stamps is not None:
        need = 1 + 2 * n_epochs * n_batches * len(phase_names(len(params), eps.shape[1]))
        if stamps.dtype != torch.int64 or stamps.device != h0.device or stamps.numel() < need:
            raise ValueError(f"stamps must be an int64 tensor of >= {need} entries on {h0.device}")
    return _launch(*args, stamps=stamps)


fused_dsm_train_epochs.launches = 0


def spread_over_streams(fn, gens, streams: dict):
    """[fn(gen) for gen in gens]; on a card epoch j runs on side stream j
    mod PREP_STREAMS (``streams`` caches them by device), each stream
    starting after the current stream's work so far, and the current
    stream waits for all of them.  The results are read on the current
    stream only after that wait, and a side stream's next use waits for
    the current stream again, so no block the allocator hands back is
    reused too early."""
    dev = gens[0].device
    if dev.type != "cuda":
        return [fn(gen) for gen in gens]
    side = streams.setdefault(dev, [torch.cuda.Stream(dev) for _ in range(PREP_STREAMS)])
    main = torch.cuda.current_stream(dev)
    for s in side:
        s.wait_stream(main)
    out = []
    for j, gen in enumerate(gens):
        with torch.cuda.stream(side[j % len(side)]):
            out.append(fn(gen))
    for s in side:
        main.wait_stream(s)
    return out


def make_fused_dsm_epoch_fn(
    model,
    lr: float,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int = 1,
    compute_dtype=torch.bfloat16,
    skip_nonfinite=True,
    capture: bool = True,
):
    """Drop-in fused replacement for ``train.make_epoch_fn`` (DSM + Adam at
    a constant lr).

    Returns epochs(params, opt_state, seed, epoch0, n_active) with the
    signature and results of the autograd engine.  Each epoch's generator,
    its batches and their t and eps are drawn exactly as the autograd
    engine draws them for the DSM loss (``batch_fn``, then
    ``model.epoch_draws``: same generator, same calls, same order), so both
    engines consume the same batches and noise.  ``opt_state`` must be a
    plain Adam state (no schedule).  For epochs >= n_active the kernel
    computes but freezes every step, so the losses it reports there are not
    the autograd engine's (which skips such epochs); params, optimizer state
    and losses[:n_active] agree.

    The kernel's inputs are prepared as the JAX engine's vmapped
    ``prep_epoch`` prepares them: each epoch makes a fixed number of tensor
    calls whatever its number of batches (``batch_fn`` and the two draws of
    ``epoch_draws``), and the diffusion, the net inputs and std / g are
    computed once a call on the stacked epochs (E, nb, B, .).  On a CUDA
    device the epochs run on PREP_STREAMS side streams
    (:func:`spread_over_streams`), and with ``capture`` (the default) the
    whole preparation is one replay of a CUDA graph (``train.SeededGraph``,
    captured at the first call; the epochs' generators re-seeded before
    each replay), where JAX compiles it; ``capture=False`` runs it eagerly
    there too (to compare).  ``batch_fn`` must give the same shapes at
    every call.
    ``epochs.prepare(seed, epoch0, device)`` -> (h0, eps, s1) of shape (E,
    nb, B, .) is that preparation alone; a replay's are overwritten by the
    next call.  Nothing in it or in the launch waits for the card.
    """
    from ..train import AdamState, SeededGraph, epoch_generator, epoch_seed

    base = model.sde.base
    streams: dict = {}

    def draw_epoch(gen):
        xb, yb = batch_fn(gen)
        return (xb, yb, *model.epoch_draws(gen, xb, yb))

    def prepare_from(gens):
        drawn = spread_over_streams(draw_epoch, gens, streams)
        xb, yb, t, ep = (torch.stack(a) for a in zip(*drawn))  # (E, nb, B, .)
        z0, cond = model.diffusion_state(xb, yb)
        z_t = base.diffuse(t, z0, ep)
        h0 = torch.cat([z_t, cond, t] if model.conditions_on_y else [z_t, t], dim=-1)
        s1 = (base.std(t) / base.g(t)).expand(ep.shape).contiguous()
        return h0, ep, s1

    graph = SeededGraph(prepare_from)

    def prepare(seed: int, epoch0: int, device):
        dev = torch.device(device)
        if capture and dev.type == "cuda":
            return graph([epoch_seed(seed, epoch0 + j, dev) for j in range(epochs_per_call)], dev)
        return prepare_from([epoch_generator(seed, epoch0 + j, dev) for j in range(epochs_per_call)])

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, n_active: int = epochs_per_call):
        if opt_state.schedule_count is not None:
            raise ValueError("the fused engine takes a constant-lr Adam state")
        h0, ep, s1 = prepare(seed, epoch0, params[0][0].device)
        flat = lambda a: a.view(-1, a.shape[-1])
        new_params, mu, nu, count, losses = fused_dsm_train_epochs(
            params, opt_state.mu, opt_state.nu, opt_state.count, flat(h0), flat(ep), flat(s1),
            n_epochs=epochs_per_call, n_batches=h0.shape[1], batch_real=h0.shape[2], lr=lr, n_active=n_active,
            compute_dtype=compute_dtype, skip_nonfinite=skip_nonfinite,
        )
        return new_params, AdamState(count, mu, nu), losses, {}

    epochs.prepare = prepare
    epochs.graph = graph
    return epochs
