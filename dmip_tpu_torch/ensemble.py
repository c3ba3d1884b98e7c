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

Backends (:func:`resolve_backend`): ``vmap``, which with a mesh of several
ranks gives each rank its block of the (padded) trial axis, with no
communication between trials; ``pinned``, one trial a rank in waves of the
world size, each running the unchanged sequential program
(:func:`make_pinned_ensemble_epoch_fn`); ``auto``, ``pinned`` on a mesh of
several ranks and ``vmap`` otherwise, as the JAX package picks them.  With
no ranks to pin trials to, ``pinned`` is ``vmap`` too.  Every rank ends a
call with every trial's state (an all-gather of the trial axis), and rank 0
writes the logs and checkpoints (``parallel.is_writer``).
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
from .models.diffusion import DiffusionModel, LossConfig, loss_keywords
from .parallel.mesh import Mesh
from .train import (AdamState, Optimizer, StepGraph, apply_updates, build_optimizer, make_epoch_fn, resolve_mesh,
                    run_epochs, use_capture)
from .utils.metrics import MetricsWriter

Tensor = torch.Tensor

BACKENDS = ("auto", "vmap", "pinned")


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
        return loss_fn(params, None, x, y, **loss_keywords(t, eps, v))

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
    capture: bool = True,
):
    """The ``vmap`` backend: epochs(ens_params, ens_opt_state, seed, epoch0,
    lams, lam2s, n_active) -> (ens_params, ens_opt_state, losses
    (epochs_per_call, K), infos {name: (epochs_per_call, K)}): per-trial
    means over each epoch's batches, nan for epochs at j >= n_active, which
    are not run.

    ``lams`` / ``lam2s`` are (K,) tensors, replacing cfg's lam / lam2 per
    trial (:func:`make_ensemble_step`).  Epoch j draws its batches, then
    each batch's draws (``model.loss_draws``, a batch at a time for every
    loss: the grids train no DSM), from ``epoch_generator(seed, epoch0 +
    j)`` on the params' device, as :func:`dmip_tpu_torch.train.make_epoch_fn`
    does for every loss but DSM, and
    on a CUDA device each K-trial step is one replay of a CUDA graph, as
    there (``capture`` as there).

    ``mesh`` (None, 'auto' or a Mesh): each rank trains its block of the K
    trials (K a multiple of the size: :func:`pad_trials`) on the same
    batches and draws, a step one replay with no collective inside, and
    returns every trial's state, gathered at the end of the call."""
    mesh = resolve_mesh(mesh)
    step = make_ensemble_step(model, cfg, optimizer, loss_kwargs)
    info_names: list = []

    def one_step(state, inputs):
        params, opt_state, loss, info = step(*state, *inputs)
        info_names[:] = info
        return (params, opt_state), torch.stack([loss, *info.values()])

    graph = StepGraph(one_step)

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, lams: Tensor, lam2s: Tensor,
               n_active: int = epochs_per_call):
        dev = pytree.leaves(params)[0].device
        captured = use_capture(capture, dev)
        losses = torch.full((epochs_per_call, lams.shape[0]), float("nan"), device=dev)
        inputs = lambda g, xb, yb: ((lams, lam2s, x, y, *model.loss_draws(cfg, g, x, y)) for x, y in zip(xb, yb))
        (params, opt_state), infos = run_epochs(one_step, graph if captured else None, batch_fn, inputs,
                                                (params, opt_state), seed, epoch0, min(n_active, epochs_per_call),
                                                losses, info_names)
        return params, opt_state, losses, infos

    epochs.graph = graph
    if mesh is None:
        return epochs

    def sharded(params, opt_state: AdamState, seed: int, epoch0: int, lams: Tensor, lam2s: Tensor,
                n_active: int = epochs_per_call):
        if lams.shape[0] % mesh.size:
            raise ValueError(f"{lams.shape[0]} trials do not split over {mesh.size} ranks; pad with pad_trials()")
        cut = lambda tree: pytree.map(mesh.local, tree)
        out = epochs(cut(params), cut(opt_state), seed, epoch0, mesh.local(lams), mesh.local(lam2s), n_active)
        return _gather_trials(mesh, *out)

    sharded.graph = graph
    return sharded


def make_pinned_ensemble_epoch_fn(
    model: DiffusionModel,
    cfg: LossConfig,
    optimizer: Optimizer,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    mesh: Mesh,
    epochs_per_call: int = 1,
    loss_kwargs: Optional[Dict[str, Any]] = None,
):
    """The ``pinned`` backend: one trial a rank.  Same signature as
    :func:`make_ensemble_epoch_fn`'s return, for a wave of K = mesh.size
    trials: rank r trains trial r as the sequential engine would
    (:func:`dmip_tpu_torch.train.make_epoch_fn` on the loss at lams[r],
    lam2s[r], with no trial axis), so the trial equals its sequential run;
    then every rank gets the wave's state, gathered.  For losses whose one
    trial already fills the card, where stacking trials into every product
    would not pay.

    A wave is a run of calls with the same ``lams`` / ``lam2s`` tensors:
    its first call reads rank r's lam and lam2 (one host read a wave) and,
    for a trial other than the last wave's, builds the trial's engine,
    which the wave's calls share, so on a card its step captures once a
    trial.  ``epochs.engines`` counts the engines built."""
    kw = dict(loss_kwargs or {})
    wave: Dict[str, Any] = {}  # the wave's lams and lam2s, its trial and rank r's engine for it

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, lams: Tensor, lam2s: Tensor,
               n_active: int = epochs_per_call):
        r = mesh.rank
        if lams.shape[0] != mesh.size:
            raise ValueError(f"the pinned ensemble needs n_trials == mesh.size ({lams.shape[0]} != {mesh.size}); "
                             "pad with pad_trials()")
        if wave.get("lams") is not lams or wave.get("lam2s") is not lam2s:
            trial = (lams[r].item(), lam2s[r].item())
            if trial != wave.get("trial"):
                trial_cfg = dataclasses.replace(cfg, lam=trial[0], lam2=trial[1])
                wave["run"] = make_epoch_fn(model.make_loss_fn(trial_cfg, **kw), optimizer, batch_fn,
                                            epochs_per_call)
                epochs.engines += 1
            wave.update(lams=lams, lam2s=lam2s, trial=trial)
        run = wave["run"]
        mine = lambda tree: pytree.map(lambda a: a[r], tree)
        p, st, losses, infos = run(mine(params), mine(opt_state), seed, epoch0, n_active)
        one = lambda tree: pytree.map(lambda a: a.unsqueeze(0), tree)
        out = (one(p), one(st), losses[:, None], {k: v[:, None] for k, v in infos.items()})
        return _gather_trials(mesh, *out)

    epochs.engines = 0
    return epochs


def _gather_trials(mesh: Mesh, params, opt_state: AdamState, losses: Tensor, infos: Dict[str, Tensor]):
    """Every rank's block of the trial axis (axis 0 of the state, axis 1 of
    the per-epoch losses and info), in rank order, on every rank."""
    gather = lambda tree: pytree.map(mesh.all_gather, tree)
    return (gather(params), gather(opt_state), mesh.all_gather(losses, axis=1),
            {k: mesh.all_gather(v, axis=1) for k, v in infos.items()})


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
    """The backend that runs: 'pinned' for 'auto' or 'pinned' on a mesh of
    several ranks, else 'vmap' (one rank has nothing to pin trials to).
    ``mesh``: None, 'auto' or a Mesh.  Anything else raises with the
    options."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ensemble_backend {backend!r}; options: {', '.join(map(repr, BACKENDS))}")
    mesh = resolve_mesh(mesh)
    return "pinned" if backend != "vmap" and mesh is not None and mesh.size > 1 else "vmap"


def make_train_many(
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    init_seed: int,
    train_seed: int,
    lr: float,
    n_epochs: int,
    epochs_per_call: int = 1,
    loss_kwargs: Optional[Dict[str, Any]] = None,
    grad_clip: Optional[float] = None,
    mesh=None,
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
    any grid trains.  ``mesh`` (None, 'auto' or a Mesh): the trial list is
    padded to a multiple of the size by repeating the last trial; 'pinned'
    trains it in waves of the size; every rank returns every trial's params,
    and rank 0 writes the files."""
    mesh = resolve_mesh(mesh)
    be = resolve_backend(backend, mesh)
    n_ranks = 1 if mesh is None else mesh.size

    def train_many(model, loss_cfg, full_cfgs, train_dirs, log_dirs) -> List[Any]:
        lams = [float(fc.get("lam", 1.0)) for fc in full_cfgs]
        lam2s = [float(fc.get("lam2", 1.0)) for fc in full_cfgs]
        lams_t, lam2s_t, n_valid = pad_trials(lams, lam2s, n_ranks, device=device)
        ens = init_ensemble(model, torch.Generator().manual_seed(int(init_seed)), lams_t.shape[0], device=device)
        optimizer = build_optimizer(lr, grad_clip)
        desc = f"ensemble[{be}]:" + (os.path.basename(train_dirs[0]) if train_dirs else "")
        fit_kw = dict(epochs_per_call=epochs_per_call, desc=desc)
        if be == "pinned":
            epoch_fn = make_pinned_ensemble_epoch_fn(model, loss_cfg, optimizer, batch_fn, mesh, epochs_per_call,
                                                     loss_kwargs)
            waves = [ensemble_fit(epoch_fn, pytree.map(lambda a: a[w0:w0 + n_ranks], ens), optimizer, train_seed,
                                  n_epochs, lams_t[w0:w0 + n_ranks], lam2s_t[w0:w0 + n_ranks], **fit_kw)
                     for w0 in range(0, lams_t.shape[0], n_ranks)]
            ens = pytree.map(lambda *parts: torch.cat(parts), *[w[0] for w in waves])
            hist = np.concatenate([w[1] for w in waves], axis=1)
        else:
            epoch_fn = make_ensemble_epoch_fn(model, loss_cfg, optimizer, batch_fn, epochs_per_call, loss_kwargs,
                                              mesh=mesh)
            ens, hist = ensemble_fit(epoch_fn, ens, optimizer, train_seed, n_epochs, lams_t, lam2s_t, **fit_kw)
        out = [trial_params(ens, i) for i in range(n_valid)]
        for i, ld in enumerate(log_dirs):
            with MetricsWriter(ld) as w:
                for e in range(hist.shape[0]):
                    w.scalar("Train/Loss", float(hist[e, i]), e)
        # per-trial checkpoints: finalists can be re-evaluated without
        # retraining, and a crash after training loses nothing
        for i, tdir in enumerate(train_dirs):
            save_checkpoint(os.path.join(tdir, "checkpoint"), out[i], step=n_epochs, seed=int(train_seed),
                            extra={"lam": lams[i], "lam2": lam2s[i]})
        return out

    return train_many
