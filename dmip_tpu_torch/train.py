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
                            seeded by (seed, global epoch index)
  * ``select_epoch_fn``  -- ``train_backend: xla | fused_pallas``
  * ``fit``              -- the Python-level epoch driver
  * ``get_model_from_args`` -- config keys -> (model, loss config)

Parameters and moments are tuples of (W, b) tensors; every function returns
new tensors and leaves its arguments as they were.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .models.diffusion import CDE, CDiffE, DiffusionModel, LossConfig, PosteriorDiffusionEstimator

Tensor = torch.Tensor
Pairs = Tuple[Tuple[Tensor, Tensor], ...]

# optax.adam's defaults, the only values the configs use
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _flat(tree: Pairs):
    return [t for pair in tree for t in pair]


def _pairs(flat) -> Pairs:
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` (count, mu, nu), plus the schedule's own
    step count when the learning rate follows a schedule.  Counts are 0-d
    int32 tensors."""

    count: Tensor
    mu: Pairs
    nu: Pairs
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

    def init(self, params: Pairs) -> AdamState:
        zeros = lambda: tuple((torch.zeros_like(w), torch.zeros_like(b)) for w, b in params)
        count = torch.zeros((), dtype=torch.int32, device=params[0][0].device)
        return AdamState(count, zeros(), zeros(), count.clone() if self.decay_steps else None)

    def learning_rate(self, count: Tensor) -> Tensor:
        """optax.cosine_decay_schedule(lr, decay_steps, alpha=lr_min_ratio)
        at ``count``, or the constant lr."""
        if not self.decay_steps:
            return torch.tensor(self.lr, dtype=torch.float32, device=count.device)
        c = torch.minimum(count.to(torch.float32), torch.tensor(float(self.decay_steps), device=count.device))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps)))
        return self.lr * ((1 - self.lr_min_ratio) * cosine + self.lr_min_ratio)

    def update(self, grads: Pairs, state: AdamState) -> Tuple[Pairs, AdamState]:
        g = _flat(grads)
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.grad_clip
            g = [torch.where(keep, x, (x / norm) * self.grad_clip) for x in g]
        mu = [(1 - ADAM_B1) * x + ADAM_B1 * m for x, m in zip(g, _flat(state.mu))]
        nu = [(1 - ADAM_B2) * (x * x) + ADAM_B2 * v for x, v in zip(g, _flat(state.nu))]
        count = _safe_increment(state.count)
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, device=cf.device), cf)
        step = -self.learning_rate(state.schedule_count if self.decay_steps else count)
        updates = [step * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)) for m, v in zip(mu, nu)]
        sched = _safe_increment(state.schedule_count) if self.decay_steps else None
        return _pairs(updates), AdamState(count, _pairs(mu), _pairs(nu), sched)


def _safe_increment(count: Tensor) -> Tensor:
    """optax's numerics.safe_increment: +1, saturating at the int32 maximum."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def apply_updates(params: Pairs, updates: Pairs) -> Pairs:
    return tuple((w + uw, b + ub) for (w, b), (uw, ub) in zip(params, updates))


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


def make_train_step(loss_fn, optimizer: Optimizer, skip_nonfinite: bool = True):
    """One step: (params, opt_state, generator, x, y) -> (params, opt_state,
    loss, info), loss and info detached.

    With ``skip_nonfinite`` a step whose gradients hold an inf or nan keeps
    the old params and the old optimizer state, counts included; the choice
    is made on the device, without a host sync.
    """

    def step(params, opt_state: AdamState, generator, x, y):
        leaves = [t.detach().requires_grad_(True) for t in _flat(params)]
        loss, info = loss_fn(_pairs(leaves), generator, x, y)
        grads = torch.autograd.grad(loss, leaves)
        updates, new_state = optimizer.update(_pairs(list(grads)), opt_state)
        new_params = apply_updates(_pairs([t.detach() for t in leaves]), updates)
        if skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            keep = lambda new, old: torch.where(finite, new, old)
            new_params = _pairs([keep(n, o) for n, o in zip(_flat(new_params), _flat(params))])
            new_state = _keep_state(keep, new_state, opt_state)
        return new_params, new_state, loss.detach(), {k: v.detach() for k, v in info.items()}

    return step


def _keep_state(keep, new: AdamState, old: AdamState) -> AdamState:
    pick = lambda a, b: _pairs([keep(n, o) for n, o in zip(_flat(a), _flat(b))])
    sched = None if new.schedule_count is None else keep(new.schedule_count, old.schedule_count)
    return AdamState(keep(new.count, old.count), pick(new.mu, old.mu), pick(new.nu, old.nu), sched)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch, seeded from (seed, global epoch index):
    the schedule does not depend on how epochs are grouped into calls, so
    re-chunking and resuming are exact."""
    if not 0 <= epoch < 2**32:
        raise ValueError(f"epoch index {epoch} outside [0, 2^32)")
    return torch.Generator(device=device).manual_seed((int(seed) % 2**31) * 2**32 + int(epoch))


def single_device(mesh) -> bool:
    """True for the meshes the port trains on: none, or ``'auto'`` on a
    host with at most one CUDA device."""
    return mesh is None or (mesh == "auto" and torch.cuda.device_count() <= 1)


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
    """
    if not single_device(mesh):
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP.md §A item 13); "
            "set mesh: null to train on one device"
        )
    train_step = make_train_step(loss_fn, optimizer)

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, n_active: int = epochs_per_call):
        dev = params[0][0].device
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
    CDiffE, and one device; any other combination raises with the reasons.

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
        if not single_device(config.get("mesh", "auto")):
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
