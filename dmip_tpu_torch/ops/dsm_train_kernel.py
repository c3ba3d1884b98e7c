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


_ARGTYPES = (
    [ctypes.c_void_p] * 4                       # p, m, v, g (flat, updated in place)
    + [ctypes.POINTER(ctypes.c_int64)] * 2      # w_off, b_off
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]  # dims, n_layers
    + [ctypes.c_int64]                          # n_flat
    + [ctypes.c_void_p] * 3                     # h0, eps, s1
    + [ctypes.c_void_p] * 3                     # acts, dz0, dz1
    + [ctypes.c_void_p] * 2                     # loss_part, bad
    + [ctypes.c_void_p] * 3                     # count0, count_out, losses
    + [ctypes.c_int] * 6                        # B, n_epochs, n_batches, n_active, guard, bf16
    + [ctypes.c_float] * 9                      # inv_b, lr, b1, 1-b1, b2, 1-b2, log b1, log b2, eps
    + [ctypes.c_void_p]                         # stream
)


def _flat(tree: Pairs) -> Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for pair in tree for t in pair]).contiguous()


def _launch(params, mu, nu, count, h0, eps, s1, n_epochs, n_batches, batch_real, lr, n_active,
            b1, b2, adam_eps, compute_dtype, skip_nonfinite):
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
    count0 = torch.as_tensor(count, device=dev).to(torch.int32).reshape(1).contiguous()
    p, m, v = _flat(params), _flat(mu), _flat(nu)
    g = torch.empty_like(p)
    offs, o = [], 0
    for w, b in params:
        offs.append((o, o + w.numel()))
        o += w.numel() + b.numel()
    n_steps = n_epochs * n_batches
    hmax = max(dims[1:-1], default=1)
    acts = torch.empty((L - 1) * bp * hmax + 1, device=dev)
    dz0 = torch.empty(bp * max(dims[1:]), device=dev)
    dz1 = torch.empty_like(dz0)
    tiles_out = -(-bp // TILE) * -(-dims[-1] // TILE)
    loss_part = torch.empty(n_steps * tiles_out, device=dev)
    bad = torch.zeros(n_steps, dtype=torch.int32, device=dev)
    count_out = torch.empty(1, device=dev)
    losses = torch.empty(n_epochs, device=dev)
    w_off = (ctypes.c_int64 * L)(*[a for a, _ in offs])
    b_off = (ctypes.c_int64 * L)(*[b for _, b in offs])
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    lib = build.load("dsm_train_kernel")
    fn = lib.dsm_train_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), w_off, b_off, c_dims, L, p.numel(),
        h0.data_ptr(), eps.data_ptr(), s1.data_ptr(), acts.data_ptr(), dz0.data_ptr(), dz1.data_ptr(),
        loss_part.data_ptr(), bad.data_ptr(), count0.data_ptr(), count_out.data_ptr(), losses.data_ptr(),
        bp, n_epochs, n_batches, int(n_active), GUARDS[skip_nonfinite], int(compute_dtype == torch.bfloat16),
        1.0 / batch_real, lr, b1, 1.0 - b1, b2, 1.0 - b2, math.log(b1), math.log(b2), adam_eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "dsm_train_launch")
    fused_dsm_train_epochs.launches += 1

    def unflat(flat):
        return tuple((flat[a:b].view(params[k][0].shape), flat[b:b + params[k][1].numel()])
                     for k, (a, b) in enumerate(offs))

    return unflat(p), unflat(m), unflat(v), count_out.to(torch.int32).reshape(()), losses


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
):
    """Run n_epochs x n_batches fused DSM optimizer steps; same arguments
    and results as :func:`dsm_train_epochs_reference`.

    skip_nonfinite: True (a step with any non-finite gradient is skipped),
    'loss' (a step with a non-finite batch loss is skipped) or False.  On a
    CUDA tensor this is one launch of the kernel; on a CPU tensor it runs
    the plain version.
    """
    _check_args(params, mu, nu, h0, eps, s1, n_epochs, n_batches, batch_real, compute_dtype, skip_nonfinite)
    args = (params, mu, nu, count, h0, eps, s1, n_epochs, n_batches, batch_real, lr, n_active,
            b1, b2, adam_eps, compute_dtype, skip_nonfinite)
    if h0.device.type == "cpu":
        return dsm_train_epochs_reference(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return _launch(*args)


fused_dsm_train_epochs.launches = 0


def make_fused_dsm_epoch_fn(
    model,
    lr: float,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int = 1,
    compute_dtype=torch.bfloat16,
    skip_nonfinite=True,
):
    """Drop-in fused replacement for ``train.make_epoch_fn`` (DSM + Adam at
    a constant lr).

    Returns epochs(params, opt_state, seed, epoch0, n_active) with the
    signature and results of the autograd engine.  Each epoch's generator,
    its batches and every batch's t and eps are drawn exactly as the
    autograd engine and the DSM branch of ``DiffusionModel.make_loss_fn``
    draw them (same generator, same calls, same order), so both engines
    consume the same batches and noise.  ``opt_state`` must be a plain Adam
    state (no schedule).  For epochs >= n_active the kernel computes but
    freezes every step, so the losses it reports there are not the
    autograd engine's (which skips such epochs); params, optimizer state
    and losses[:n_active] agree.
    """
    from ..sde import sample_t
    from ..train import AdamState, epoch_generator

    base = model.sde.base

    def prep_epoch(gen):
        xb, yb = batch_fn(gen)
        dev = xb.device
        z0s, ts, eps = [], [], []
        for x, y in zip(xb, yb):
            z0, _ = model.diffusion_state(x, y)
            z0s.append(z0)
            # the loss's draws, in its order: t, then eps
            ts.append(torch.rand((z0.shape[0], 1), generator=gen, device=gen.device).to(dev))
            eps.append(torch.randn(z0.shape, generator=gen, device=gen.device, dtype=z0.dtype).to(dev))
        t = sample_t(model.sde, xb.shape[1], u=torch.stack(ts))
        ep = torch.stack(eps)
        z_t = base.diffuse(t, torch.stack(z0s), ep)
        h0 = torch.cat([z_t, yb, t] if model.conditions_on_y else [z_t, t], dim=-1)
        s1 = (base.std(t) / base.g(t)).expand(ep.shape)
        return h0, ep, s1

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, n_active: int = epochs_per_call):
        if opt_state.schedule_count is not None:
            raise ValueError("the fused engine takes a constant-lr Adam state")
        dev = params[0][0].device
        parts = [prep_epoch(epoch_generator(seed, epoch0 + j, dev)) for j in range(epochs_per_call)]
        h0, ep, s1 = (torch.stack(z) for z in zip(*parts))  # (E, nb, B, .)
        nb, bsz = h0.shape[1], h0.shape[2]
        flat = lambda a: a.reshape(-1, a.shape[-1]).contiguous()
        new_params, mu, nu, count, losses = fused_dsm_train_epochs(
            params, opt_state.mu, opt_state.nu, opt_state.count, flat(h0), flat(ep), flat(s1),
            n_epochs=epochs_per_call, n_batches=nb, batch_real=bsz, lr=lr, n_active=n_active,
            compute_dtype=compute_dtype, skip_nonfinite=skip_nonfinite,
        )
        return new_params, AdamState(count, mu, nu), losses, {}

    return epochs
