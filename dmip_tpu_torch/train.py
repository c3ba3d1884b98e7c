"""Training: optax-exact Adam, train steps, epoch engines, ``fit`` and the
model factory.

Port of ``dmip_tpu/train.py``:

  * ``build_optimizer``  -- Adam with optional global-norm clipping and a
                            cosine schedule, as a small functional optimizer
                            (``init`` / ``update``) whose arithmetic is
                            optax's, not ``torch.optim``'s
  * ``make_train_step``  -- loss, parameter gradients by autograd, update,
                            and the skip-nonfinite guard
  * ``make_epoch_fn``    -- ``epochs_per_call`` epochs per call, each
                            drawing its batches and noise from a generator
                            seeded by (seed, global epoch index); with a
                            mesh, data-parallel over its ranks
  * ``resolve_mesh``     -- ``mesh: auto | null`` or a mesh -> a mesh or None
  * ``driver_mesh``      -- a driver's mesh: join torchrun's group, resolve
                            the config's ``mesh``
  * ``select_epoch_fn``  -- ``train_backend: xla | fused_pallas``
  * ``fit``              -- the Python-level epoch driver
  * ``get_model_from_args`` -- config keys -> (model, loss config)

Parameters and moments are trees of tensors (:mod:`dmip_tpu_torch.pytree`:
an MLP's tuple of (W, b) pairs, a flow's list of coupling dicts, a dict of
MLPs), taken in JAX's leaf order; every function returns new tensors and
leaves its arguments as they were.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import pytree
from .models.diffusion import CDE, CDiffE, DiffusionModel, LossConfig, PosteriorDiffusionEstimator
from .parallel.mesh import Mesh, get_mesh, init_multihost

Tensor = torch.Tensor
Tree = Any  # a tree of tensors, see dmip_tpu_torch.pytree

# optax.adam's defaults, the only values the configs use
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` (count, mu, nu), plus the schedule's own
    step count when the learning rate follows a schedule.  Counts are 0-d
    int32 tensors."""

    count: Tensor
    mu: Tree
    nu: Tree
    schedule_count: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr or cosine))``.

    Per step, as optax computes it in f32: the clip scales every gradient by
    max_norm / norm only when norm >= max_norm; m = (1-b1) g + b1 m,
    v = (1-b2) g^2 + b2 v, count += 1, bias corrections 1 - b^count, update
    (m / bc1) / (sqrt(v / bc2) + eps), times -lr read at the schedule's
    count before its increment.
    """

    lr: float
    grad_clip: Optional[float] = None
    decay_steps: Optional[int] = None  # cosine decay when set
    lr_min_ratio: float = 0.01

    def init(self, params: Tree) -> AdamState:
        zeros = lambda: pytree.map(torch.zeros_like, params)
        count = torch.zeros((), dtype=torch.int32, device=pytree.leaves(params)[0].device)
        return AdamState(count, zeros(), zeros(), count.clone() if self.decay_steps else None)

    def learning_rate(self, count: Tensor) -> Tensor:
        """optax.cosine_decay_schedule(lr, decay_steps, alpha=lr_min_ratio)
        at ``count``, or the constant lr."""
        if not self.decay_steps:
            return torch.tensor(self.lr, dtype=torch.float32, device=count.device)
        c = torch.minimum(count.to(torch.float32), torch.tensor(float(self.decay_steps), device=count.device))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps)))
        return self.lr * ((1 - self.lr_min_ratio) * cosine + self.lr_min_ratio)

    def update(self, grads: Tree, state: AdamState) -> Tuple[Tree, AdamState]:
        g = pytree.leaves(grads)
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.grad_clip
            g = [torch.where(keep, x, (x / norm) * self.grad_clip) for x in g]
        mu = [(1 - ADAM_B1) * x + ADAM_B1 * m for x, m in zip(g, pytree.leaves(state.mu))]
        nu = [(1 - ADAM_B2) * (x * x) + ADAM_B2 * v for x, v in zip(g, pytree.leaves(state.nu))]
        count = _safe_increment(state.count)
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, device=cf.device), cf)
        step = -self.learning_rate(state.schedule_count if self.decay_steps else count)
        updates = [step * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)) for m, v in zip(mu, nu)]
        sched = _safe_increment(state.schedule_count) if self.decay_steps else None
        tree = lambda flat: pytree.unflatten(grads, flat)
        return tree(updates), AdamState(count, tree(mu), tree(nu), sched)


def _safe_increment(count: Tensor) -> Tensor:
    """optax's numerics.safe_increment: +1, saturating at the int32 maximum."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return pytree.map(torch.add, params, updates)


def build_optimizer(
    lr: float,
    grad_clip: Optional[float] = None,
    schedule: Optional[str] = None,
    decay_steps: Optional[int] = None,
    lr_min_ratio: float = 0.01,
) -> Optimizer:
    """Adam with optional global-norm clipping (config ``grad_clip``) and
    optional decay (config ``lr_schedule``): ``'cosine'`` decays lr ->
    lr * lr_min_ratio over ``decay_steps`` optimizer steps."""
    if schedule in (None, "", "constant"):
        return Optimizer(float(lr), float(grad_clip) if grad_clip else None)
    if schedule == "cosine":
        if not decay_steps:
            raise ValueError("lr_schedule='cosine' requires decay_steps")
        return Optimizer(float(lr), float(grad_clip) if grad_clip else None, int(decay_steps), float(lr_min_ratio))
    raise ValueError(f"unknown lr schedule {schedule!r}; options: 'constant', 'cosine'")


def make_train_step(loss_fn, optimizer: Optimizer, skip_nonfinite: bool = True, mesh: Optional[Mesh] = None):
    """One step: (params, opt_state, generator, x, y) -> (params, opt_state,
    loss, info), loss and info detached.

    With ``skip_nonfinite`` a step whose gradients hold an inf or nan keeps
    the old params and the old optimizer state, counts included; the choice
    is made on the device, without a host sync.

    With a ``mesh`` the step is data-parallel: every rank is handed the same
    full batch and generator, draws the batch's t, eps and probe
    (``loss_fn.draws``, the loss's own draws in its order), and computes the
    loss and its gradient on its :meth:`~Mesh.rows` of the batch and of
    every draw.  Every term of the losses is a mean over rows, so the
    ranks' means, each weighted by its share of the rows and averaged, are
    the full batch's loss, info and gradient; the clip, the guard and Adam
    then run on the same numbers on every rank, and the parameters stay
    replicated.  A batch that the size does not divide is split into parts
    one row apart, each weighted by its true count; a batch with fewer rows
    than ranks raises.
    """

    def step(params, opt_state: AdamState, generator, x, y):
        leaves = [t.detach().requires_grad_(True) for t in pytree.leaves(params)]
        tree = lambda flat: pytree.unflatten(params, flat)
        if mesh is None:
            loss, info = loss_fn(tree(leaves), generator, x, y)
            grads = torch.autograd.grad(loss, leaves)
        else:
            loss, info = _shard_loss(loss_fn, mesh, tree(leaves), generator, x, y)
            grads, loss, info = _mean_over_ranks(mesh, torch.autograd.grad(loss, leaves), loss, info, x.shape[0])
        updates, new_state = optimizer.update(tree(grads), opt_state)
        new_params = apply_updates(tree([t.detach() for t in leaves]), updates)
        if skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            keep = lambda new, old: torch.where(finite, new, old)
            new_params = pytree.map(keep, new_params, params)
            new_state = pytree.map(keep, new_state, opt_state)
        return new_params, new_state, loss.detach(), {k: v.detach() for k, v in info.items()}

    return step


def _shard_loss(loss_fn, mesh: Mesh, params, generator, x: Tensor, y: Tensor):
    """This rank's loss on its rows of the batch and of the batch's draws."""
    if x.shape[0] < mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} rows cannot be split over {mesh.size} ranks")
    t, eps, v = loss_fn.draws(generator, x, y)
    draws = {"t": mesh.local(t), "eps": mesh.local(eps)}
    if v is not None:
        draws["v"] = mesh.local(v)
    return loss_fn(params, None, mesh.local(x), mesh.local(y), **draws)


def _mean_over_ranks(mesh: Mesh, grads, loss: Tensor, info: Dict[str, Tensor], n: int):
    """The batch's gradient, loss and info from every rank's mean over its
    rows: each weighted by its rows' share (1 when the parts are equal) and
    averaged over the ranks, in one all-reduce."""
    rows = mesh.rows(n)
    weight = (rows.stop - rows.start) * mesh.size / n
    parts = [g.reshape(-1) for g in grads] + [loss.detach().reshape(1)] + [v.detach().reshape(1) for v in info.values()]
    flat = torch.cat(parts)
    if weight != 1:
        flat = flat * weight
    flat = list(mesh.all_reduce(flat, mean=True).split([p.numel() for p in parts]))
    grads = [g.view_as(like) for g, like in zip(flat, grads)]
    loss = flat[len(grads)].reshape(())
    info = {k: v.reshape(()) for k, v in zip(info, flat[len(grads) + 1:])}
    return grads, loss, info


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch, seeded from (seed, global epoch index):
    the schedule does not depend on how epochs are grouped into calls, so
    re-chunking and resuming are exact."""
    if not 0 <= epoch < 2**32:
        raise ValueError(f"epoch index {epoch} outside [0, 2^32)")
    return torch.Generator(device=device).manual_seed((int(seed) % 2**31) * 2**32 + int(epoch))


def resolve_mesh(mesh) -> Optional[Mesh]:
    """The mesh to run on: ``None``, or a :class:`Mesh` as given; ``'auto'``
    is this process group's mesh when the world has more than one rank, and
    None otherwise.  One process on a host with several GPUs runs on its
    current device and notes once (stderr) that ``torchrun
    --nproc_per_node N`` would use the others: the JAX package's 'auto'
    spans every local chip from one process instead (ROADMAP.md,
    divergences)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if mesh != "auto":
        raise ValueError(f"mesh must be None, 'auto' or a Mesh, got {mesh!r}")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        return get_mesh()
    n = torch.cuda.device_count()
    if n > 1:
        _note_unused_gpus(n)
    return None


def driver_mesh(config: dict, device=None) -> Optional[Mesh]:
    """The mesh an entry point runs on: joins the process group when
    ``torchrun`` started this process (``init_multihost``; a no-op
    otherwise), then resolves the config's ``mesh`` (default 'auto')."""
    init_multihost(device=device)
    return resolve_mesh(config.get("mesh", "auto"))


@functools.lru_cache(maxsize=None)
def _note_unused_gpus(n: int) -> None:
    print(f"[mesh] one process on a host with {n} GPUs runs on one of them; "
          f"torchrun --nproc_per_node {n} uses the others", file=sys.stderr, flush=True)


def make_epoch_fn(
    loss_fn,
    optimizer: Optimizer,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int = 1,
    mesh=None,
):
    """The autograd epoch engine (``train_backend: xla`` in the config).

    ``batch_fn(generator) -> (xb, yb)`` of shape (n_batches, batch, dim).
    Returns epochs(params, opt_state, seed, epoch0, n_active) -> (params,
    opt_state, per-epoch mean losses (epochs_per_call,), per-epoch mean info
    {name: (epochs_per_call,)}).  Epoch j draws its batches, then each
    batch's t, eps and probe, from ``epoch_generator(seed, epoch0 + j)`` on
    the params' device.  Epochs at j >= n_active are not run; their losses
    and info are nan.

    ``mesh``: None, 'auto' or a :class:`Mesh` (:func:`resolve_mesh`).  With
    one, every rank builds the same batches and draws, and each step is
    data-parallel (:func:`make_train_step`); params and state must be the
    same on every rank, as the drivers' seeded inits and checkpoints make
    them, and stay so.  The loss must expose its draws (``loss_fn.draws``),
    as the diffusion models' losses do.
    """
    mesh = resolve_mesh(mesh)
    if mesh is not None and not hasattr(loss_fn, "draws"):
        raise ValueError("a loss trained over a mesh must expose its draws (loss_fn.draws), "
                         "as DiffusionModel.make_loss_fn's losses do")
    train_step = make_train_step(loss_fn, optimizer, mesh=mesh)

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, n_active: int = epochs_per_call):
        dev = pytree.leaves(params)[0].device
        losses = torch.full((epochs_per_call,), float("nan"), device=dev)
        infos: Dict[str, Tensor] = {}
        for j in range(min(n_active, epochs_per_call)):
            gen = epoch_generator(seed, epoch0 + j, dev)
            xb, yb = batch_fn(gen)
            step_losses, step_infos = [], []
            for x, y in zip(xb, yb):
                params, opt_state, loss, info = train_step(params, opt_state, gen, x, y)
                step_losses.append(loss)
                step_infos.append(info)
            losses[j] = torch.stack(step_losses).mean()
            for k in step_infos[0]:
                infos.setdefault(k, torch.full_like(losses, float("nan")))[j] = torch.stack(
                    [i[k] for i in step_infos]).mean()
        return params, opt_state, losses, infos

    return epochs


def select_epoch_fn(
    config: Dict[str, Any],
    model,
    loss_fn,
    optimizer: Optimizer,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int,
):
    """Build the epoch engine the config asks for.

    ``train_backend: xla`` (default) -- :func:`make_epoch_fn`.  The value
    keeps the JAX package's name; in the port it is the autograd engine.
    ``train_backend: fused_pallas`` -- the fused DSM training kernel
    (``ops/dsm_train_kernel.py``), whole epochs per launch.  Only for DSM
    with plain Adam at a constant lr (no grad_clip, no schedule), a CDE or a
    CDiffE, and one device (a mesh of one rank included); any other
    combination raises with the reasons.

    ``train_guard`` (fused engine only): 'grads' (default; the autograd
    engine's skip-nonfinite rule), 'loss' (skip a step whose batch loss is
    not finite) or 'off'.
    """
    backend = config.get("train_backend", "xla")
    if backend == "xla":
        return make_epoch_fn(loss_fn, optimizer, batch_fn, epochs_per_call=epochs_per_call,
                             mesh=config.get("mesh", "auto"))
    if backend == "fused_pallas":
        problems = []
        if config.get("loss_fn") != "DSM":
            problems.append(f"loss_fn must be 'DSM', got {config.get('loss_fn')!r}")
        if config.get("model") not in ("CDE", "CDiffE"):
            problems.append(f"model must be CDE/CDiffE, got {config.get('model')!r}")
        if config.get("grad_clip"):
            problems.append("grad_clip is not supported")
        if config.get("lr_schedule", "constant") not in (None, "constant"):
            problems.append("lr_schedule must be constant")
        mesh = resolve_mesh(config.get("mesh", "auto"))
        if mesh is not None and mesh.size > 1:
            problems.append("multi-device mesh is not supported (use train_backend: xla for data parallelism)")
        guard = config.get("train_guard", "grads")
        if guard not in ("grads", "loss", "off"):
            problems.append(f"train_guard must be 'grads'/'loss'/'off', got {guard!r}")
        if problems:
            raise ValueError("train_backend: fused_pallas — " + "; ".join(problems))
        from .ops.dsm_train_kernel import make_fused_dsm_epoch_fn

        return make_fused_dsm_epoch_fn(
            model, float(config.get("lr", 1e-4)), batch_fn, epochs_per_call=epochs_per_call,
            skip_nonfinite={"grads": True, "loss": "loss", "off": False}[guard],
        )
    raise ValueError(f"unknown train_backend {backend!r}; options: 'xla', 'fused_pallas'")


def fit(
    epoch_fn,
    params,
    optimizer: Optimizer,
    seed: int,
    num_epochs: int,
    epochs_per_call: int = 1,
    log_every: int = 50,
    logger=None,
    desc: str = "train",
    opt_state: Optional[AdamState] = None,
    start_epoch: int = 0,
):
    """Run epochs start_epoch .. num_epochs - 1 through ``epoch_fn`` (built
    with the same ``epochs_per_call``); the last call masks the epochs past
    num_epochs.  ``logger``: an optional :class:`MetricsWriter`.  Returns
    (params, opt_state, last epoch's info)."""
    if opt_state is None:
        opt_state = optimizer.init(params)
    last_info: Dict[str, float] = {}
    t0 = time.time()
    n_calls = -(-max(num_epochs - start_epoch, 0) // epochs_per_call)
    epoch = start_epoch
    for c in range(n_calls):
        n_active = min(epochs_per_call, num_epochs - epoch)
        params, opt_state, losses, infos = epoch_fn(params, opt_state, seed, epoch, n_active)
        losses = losses.tolist()
        infos = {k: v.tolist() for k, v in infos.items()}
        for j in range(n_active):
            if logger is not None:
                logger.scalar("Train/Loss", float(losses[j]), epoch)
                for k, v in infos.items():
                    logger.scalar("Train/" + k, float(v[j]), epoch)
            epoch += 1
        if log_every and (c % max(log_every // epochs_per_call, 1) == 0 or c == n_calls - 1):
            rate = (epoch - start_epoch) / (time.time() - t0)
            print(f"[{desc}] epoch {epoch}/{num_epochs} loss={float(losses[n_active - 1]):.4f} "
                  f"({rate:.1f} epochs/s)", flush=True)
        last_info = {k: float(v[n_active - 1]) for k, v in infos.items()}
    return params, opt_state, last_info


_MODELS = {"CDE": CDE, "CDiffE": CDiffE, "Posterior": PosteriorDiffusionEstimator}


def get_model_from_args(
    config: Dict[str, Any], forward_model_params: Dict[str, Any]
) -> Tuple[DiffusionModel, LossConfig]:
    """Map the YAML keys ``model``, ``hidden_layers`` and ``loss_fn`` (and
    the loss weights) to (model, loss config).  The Posterior model takes
    the PosteriorLoss, its default; another loss name raises."""
    name = config["model"]
    if name not in _MODELS:
        raise ValueError(
            'No valid value for "model" passed. Has to be one of '
            '"CDE", "CDiffE" or "Posterior".'
        )
    model = _MODELS[name](
        xdim=int(forward_model_params["xdim"]),
        ydim=int(forward_model_params["ydim"]),
        hidden_layers=tuple(config.get("hidden_layers", (512, 512, 512))),
    )
    loss_name = config.get("loss_fn")
    if name == "Posterior":
        if loss_name not in (None, "PosteriorLoss"):
            raise ValueError(
                "PosteriorDiffusionEstimator trains with the PosteriorLoss; "
                f"got loss_fn={loss_name!r}"
            )
        loss_name = "PosteriorLoss"
    if loss_name is None:
        raise ValueError(
            'No valid loss_fn was specified. Options are: "PINNLoss", '
            '"PINNLoss2", "DSM" or "DSM_PDE". When the model is '
            "PosteriorDiffusionEstimator, the PosteriorLoss is used as default."
        )
    cfg = LossConfig(
        name=loss_name,
        lam=float(config.get("lam", 1.0)),
        lam2=float(config.get("lam2", 1.0)),
        pde_loss=config.get("pde_loss", "FPE"),
        pde_metric=config.get("pde_metric", "L1"),
        ic_metric=config.get("ic_metric", "L1"),
        divergence_method=config.get("divergence_method", "exact"),
    )
    return model, cfg
