"""Trial-stacked (ensemble) training for grid search.

Port of ``dmip_tpu/ensemble.py``.  The trials of a grid that differ only in
the loss weights lam / lam2 share one program, so they train as one: the
trial axis is stacked into every operation by ``torch.func.vmap`` over
(params, Adam state, lam, lam2), while each step's batch and its draws (t,
eps and the Hutchinson probe) are made once and shared.  One step is then
one batched forward and backward for all K trials, and its Adam update,
global-norm clip and skip-nonfinite guard run inside the same ``vmap``, so
each trial clips by its own norm and keeps or skips its own step.

The schedule is the autograd engine's (:func:`dmip_tpu_torch.train.make_epoch_fn`):
epoch j draws its batches, then each batch's t, eps and probe, from
``train.epoch_generator(seed, epoch0 + j)``, in the order and shapes in
which the model's loss draws them (``DiffusionModel.loss_draws``).  Trial k
is therefore the sequential run with lam = lams[k]: the same init, batches
and draws (held in ``tests/test_torch_ensemble.py``).

Backends: ``vmap`` (this module) and ``auto`` (``vmap`` on one device, as
the JAX package picks it there).  The JAX package's ``pinned`` backend runs
one trial per device; it is multi-device work and raises here, as a
multi-device mesh does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from . import pytree
from .checkpoints import save_checkpoint
from .models.diffusion import DiffusionModel, LossConfig
from .train import AdamState, Optimizer, apply_updates, build_optimizer, epoch_generator, single_device
from .utils.metrics import MetricsWriter

Tensor = torch.Tensor

BACKENDS = ("auto", "vmap", "pinned")
MULTI_DEVICE = (
    "multi-device training is not ported yet (ROADMAP.md §A7, multi-GPU); "
    "the 'pinned' backend runs one trial per device, and a mesh shards the trial axis"
)


def init_ensemble(model: DiffusionModel, generator: torch.Generator, n_trials: int, device=None):
    """n_trials stacked copies of one init: a sequential grid inits every
    trial from the same seed, so identical starts keep the parity."""
    p = model.init(generator, device=device)
    return pytree.map(lambda a: a.unsqueeze(0).repeat(n_trials, *([1] * a.ndim)), p)


def trial_params(ens_params, i: int):
    """Trial i's parameter tree, cut from the stacked ensemble."""
    return pytree.map(lambda a: a[i].clone(), ens_params)


def pad_trials(lams: Sequence[float], lam2s: Sequence[float], multiple: int, device=None):
    """Pad the trial list to a multiple of ``multiple`` by repeating the
    last trial; returns (lams, lam2s, n_valid), the first two f32 tensors."""
    n = len(lams)
    rem = (-n) % multiple
    lams = list(lams) + [lams[-1]] * rem
    lam2s = list(lam2s) + [lam2s[-1]] * rem
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return as_t(lams), as_t(lam2s), n


def init_opt_state(optimizer: Optimizer, ens_params) -> AdamState:
    """Per-trial optimizer state of the stacked params: zero moments of the
    stacked shapes and a (K,) count (and schedule count)."""
    st = optimizer.init(ens_params)
    n = pytree.leaves(ens_params)[0].shape[0]
    per_trial = lambda c: None if c is None else c.expand(n).clone()
    return AdamState(per_trial(st.count), st.mu, st.nu, per_trial(st.schedule_count))


def _make_trial_step(model: DiffusionModel, cfg: LossConfig, optimizer: Optimizer,
                     loss_kwargs: Optional[Dict[str, Any]]):
    """One trial's (params, opt_state) update for a batch and its draws,
    with lam / lam2 given as 0-d tensors (sound because every loss uses them
    only as multipliers, ``losses.py``), and the autograd engine's
    skip-nonfinite guard.  ``ic`` is the initial-condition target of the
    batch, computed once outside the trial axis (it depends on neither the
    trial nor the params), or None."""
    loss_kwargs = dict(loss_kwargs or {})

    def loss_with(params, lam, lam2, x, y, t, eps, v, ic):
        kw = dict(loss_kwargs)
        if ic is not None:
            kw["initial_condition"] = lambda _x, _y: ic
        loss_fn = model.make_loss_fn(dataclasses.replace(cfg, lam=lam, lam2=lam2), **kw)
        draws = {"t": t, "eps": eps} if v is None else {"t": t, "eps": eps, "v": v}
        return loss_fn(params, None, x, y, **draws)

    def trial_step(params, opt_state, lam, lam2, x, y, t, eps, v, ic):
        grads, (loss, info) = grad_and_value(loss_with, has_aux=True)(params, lam, lam2, x, y, t, eps, v, ic)
        updates, new_state = optimizer.update(grads, opt_state)
        finite = torch.stack([torch.isfinite(g).all() for g in pytree.leaves(grads)]).all()
        keep = lambda new, old: torch.where(finite, new, old)
        new_params = pytree.map(keep, apply_updates(params, updates), params)
        return new_params, pytree.map(keep, new_state, opt_state), loss, info

    return trial_step


def make_ensemble_step(
    model: DiffusionModel,
    cfg: LossConfig,
    optimizer: Optimizer,
    loss_kwargs: Optional[Dict[str, Any]] = None,
):
    """The K-trial step: step(ens_params, ens_opt_state, lams, lam2s, x, y,
    t, eps, v) -> (ens_params, ens_opt_state, losses (K,), infos {name:
    (K,)}).  Params, Adam state, lam and lam2 carry the trial axis; the
    batch, its draws and the initial-condition target (computed here, once)
    are shared, as JAX's ``in_axes=(0, 0, None, None, None, 0, 0)``."""
    trial_step = _make_trial_step(model, cfg, optimizer, loss_kwargs)
    # the initial-condition target, for the losses that have the term
    ic_fn = (loss_kwargs or {}).get("initial_condition") if cfg.name in ("PINNLoss", "PINNLoss2") else None

    def step(params, opt_state: AdamState, lams: Tensor, lam2s: Tensor, x, y, t, eps, v):
        ic = ic_fn(x, y) if ic_fn is not None else None
        # an absent schedule count is a None leaf, which vmap maps over nothing
        state_dims = AdamState(0, 0, 0, None if opt_state.schedule_count is None else 0)
        return vmap(trial_step, in_dims=(0, state_dims, 0, 0, None, None, None, None, None, None),
                    out_dims=(0, state_dims, 0, 0))(params, opt_state, lams, lam2s, x, y, t, eps, v, ic)

    return step


def make_ensemble_epoch_fn(
    model: DiffusionModel,
    cfg: LossConfig,
    optimizer: Optimizer,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int = 1,
    loss_kwargs: Optional[Dict[str, Any]] = None,
    mesh=None,
):
    """The ``vmap`` backend: epochs(ens_params, ens_opt_state, seed, epoch0,
    lams, lam2s, n_active) -> (ens_params, ens_opt_state, losses
    (epochs_per_call, K), infos {name: (epochs_per_call, K)}): per-trial
    means over each epoch's batches, nan for epochs at j >= n_active, which
    are not run.

    ``lams`` / ``lam2s`` are (K,) tensors, replacing cfg's lam / lam2 per
    trial (:func:`make_ensemble_step`).  Epoch j draws its batches, then
    each batch's draws, from ``epoch_generator(seed, epoch0 + j)`` on the
    params' device, as :func:`dmip_tpu_torch.train.make_epoch_fn` does.  A
    multi-device mesh raises (ROADMAP.md §A7)."""
    if not single_device(mesh):
        raise NotImplementedError(MULTI_DEVICE + "; set mesh: null to train on one device")
    step = make_ensemble_step(model, cfg, optimizer, loss_kwargs)

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, lams: Tensor, lam2s: Tensor,
               n_active: int = epochs_per_call):
        dev = pytree.leaves(params)[0].device
        losses = torch.full((epochs_per_call, lams.shape[0]), float("nan"), device=dev)
        infos: Dict[str, Tensor] = {}
        for j in range(min(n_active, epochs_per_call)):
            gen = epoch_generator(seed, epoch0 + j, dev)
            xb, yb = batch_fn(gen)
            step_losses, step_infos = [], []
            for x, y in zip(xb, yb):
                t, eps, v = model.loss_draws(cfg, gen, x, y)
                params, opt_state, loss, info = step(params, opt_state, lams, lam2s, x, y, t, eps, v)
                step_losses.append(loss)
                step_infos.append(info)
            losses[j] = torch.stack(step_losses).mean(0)
            for k in step_infos[0]:
                infos.setdefault(k, torch.full_like(losses, float("nan")))[j] = torch.stack(
                    [i[k] for i in step_infos]).mean(0)
        return params, opt_state, losses, infos

    return epochs


def ensemble_fit(
    epoch_fn,
    ens_params,
    optimizer: Optimizer,
    seed: int,
    num_epochs: int,
    lams: Tensor,
    lam2s: Tensor,
    epochs_per_call: int = 1,
    log_every: int = 50,
    desc: str = "ensemble",
):
    """Run ``num_epochs`` epochs through ``epoch_fn`` (built with the same
    ``epochs_per_call``), the last call masking the epochs past num_epochs.
    Returns (ens_params, loss history (num_epochs, K) as numpy); per-trial
    params come out with :func:`trial_params`."""
    opt_state = init_opt_state(optimizer, ens_params)
    history = []
    t0 = time.time()
    n_calls = -(-num_epochs // epochs_per_call)
    epoch = 0
    for c in range(n_calls):
        n_active = min(epochs_per_call, num_epochs - epoch)
        ens_params, opt_state, losses, _ = epoch_fn(ens_params, opt_state, seed, epoch, lams, lam2s, n_active)
        losses = losses.cpu().numpy()
        history.append(losses[:n_active])
        epoch += n_active
        if log_every and (c % max(log_every // epochs_per_call, 1) == 0 or c == n_calls - 1):
            rate = epoch / (time.time() - t0)
            print(f"[{desc}] epoch {epoch}/{num_epochs} mean-loss={float(losses[n_active - 1].mean()):.4f} "
                  f"({rate:.1f} epochs/s x {losses.shape[1]} trials)", flush=True)
    return ens_params, np.concatenate(history, axis=0)


def resolve_backend(backend: str, mesh) -> str:
    """'vmap' for 'auto' or 'vmap' on one device; 'pinned' and a
    multi-device mesh raise (ROADMAP.md §A7); anything else raises with
    the options."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ensemble_backend {backend!r}; options: {', '.join(map(repr, BACKENDS))}")
    if backend == "pinned" or not single_device(mesh):
        raise NotImplementedError(MULTI_DEVICE + "; use ensemble_backend: vmap (or auto) on one device")
    return "vmap"


def make_train_many(
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    init_seed: int,
    train_seed: int,
    lr: float,
    n_epochs: int,
    epochs_per_call: int = 1,
    loss_kwargs: Optional[Dict[str, Any]] = None,
    grad_clip: Optional[float] = None,
    mesh="auto",
    backend: str = "auto",
    device=None,
):
    """The ``train_many`` callable of :func:`dmip_tpu_torch.gridsearch.grid_search`.

    The drivers' sequential ``train_fn`` schedule: params from
    ``model.init(torch.Generator().manual_seed(init_seed))`` on ``device``,
    Adam at ``lr`` (with ``grad_clip``), epochs from ``train_seed``.  Writes
    each trial's ``Train/Loss`` log and its checkpoint
    (``<train_dir>/checkpoint``, step n_epochs, the train seed and
    ``extra={'lam', 'lam2'}``), and returns the per-trial params.
    ``backend``: see :func:`resolve_backend`; it is checked here, before
    any grid trains."""
    be = resolve_backend(backend, mesh)

    def train_many(model, loss_cfg, full_cfgs, train_dirs, log_dirs) -> List[Any]:
        lams = [float(fc.get("lam", 1.0)) for fc in full_cfgs]
        lam2s = [float(fc.get("lam2", 1.0)) for fc in full_cfgs]
        lams_t, lam2s_t = (torch.tensor(v, dtype=torch.float32, device=device) for v in (lams, lam2s))
        ens = init_ensemble(model, torch.Generator().manual_seed(int(init_seed)), len(lams), device=device)
        optimizer = build_optimizer(lr, grad_clip)
        epoch_fn = make_ensemble_epoch_fn(model, loss_cfg, optimizer, batch_fn, epochs_per_call, loss_kwargs)
        desc = f"ensemble[{be}]:" + (os.path.basename(train_dirs[0]) if train_dirs else "")
        ens, hist = ensemble_fit(epoch_fn, ens, optimizer, train_seed, n_epochs, lams_t, lam2s_t,
                                 epochs_per_call=epochs_per_call, desc=desc)
        for i, ld in enumerate(log_dirs):
            with MetricsWriter(ld) as w:
                for e in range(hist.shape[0]):
                    w.scalar("Train/Loss", float(hist[e, i]), e)
        out = [trial_params(ens, i) for i in range(len(lams))]
        # per-trial checkpoints: finalists can be re-evaluated without
        # retraining, and a crash after training loses nothing
        for i, tdir in enumerate(train_dirs):
            save_checkpoint(os.path.join(tdir, "checkpoint"), out[i], step=n_epochs, seed=int(train_seed),
                            extra={"lam": lams[i], "lam2": lam2s[i]})
        return out

    return train_many
