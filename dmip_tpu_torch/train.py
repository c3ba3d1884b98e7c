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
                            seeded by (seed, global epoch index); on a CUDA
                            device each step one replay of a CUDA graph
                            (``StepGraph``, where JAX compiles a scan); with
                            a mesh, data-parallel over its ranks, two replays
                            around the all-reduce (``SplitStep``)
  * ``resolve_mesh``     -- ``mesh: auto | null`` or a mesh -> a mesh or None
  * ``driver_mesh``      -- a driver's mesh: join torchrun's group, resolve
                            the config's ``mesh``
  * ``select_epoch_fn``  -- ``train_backend: xla | fused_pallas``
  * ``SeededGraph``      -- work drawing from per-epoch generators captured
                            as a CUDA graph, replayed with them re-seeded
                            (the fused engine's preparation)
  * ``fit``              -- the Python-level epoch driver, reading each
                            call one call late
  * ``get_model_from_args`` -- config keys -> (model, loss config)

Parameters and moments are trees of tensors (:mod:`dmip_tpu_torch.pytree`:
an MLP's tuple of (W, b) pairs, a flow's list of coupling dicts, a dict of
MLPs), taken in JAX's leaf order; every function returns new tensors and
leaves its arguments as they were.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import math
import sys
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import device_constant, pytree
from .models.diffusion import CDE, CDiffE, DiffusionModel, LossConfig, PosteriorDiffusionEstimator
from .parallel.mesh import Mesh, get_mesh, init_multihost
from .utils import profiling

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
            return device_constant(self.lr, torch.float32, count.device)
        steps = device_constant(float(self.decay_steps), torch.float32, count.device)
        c = torch.minimum(count.to(torch.float32), steps)
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
        bc1 = 1 - torch.pow(device_constant(ADAM_B1, torch.float32, cf.device), cf)
        bc2 = 1 - torch.pow(device_constant(ADAM_B2, torch.float32, cf.device), cf)
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
    """One step: (params, opt_state, generator, x, y, draws=None) ->
    (params, opt_state, loss, info), loss and info detached.  ``draws``, the
    batch's numbers as the loss's keywords (``loss_fn.draws(generator, x,
    y)``), hands the loss its random numbers; without them the loss draws
    from ``generator``.

    With ``skip_nonfinite`` a step whose gradients hold an inf or nan keeps
    the old params and the old optimizer state, counts included; the choice
    is made on the device, without a host sync.

    With a ``mesh`` the step is data-parallel: every rank is handed the same
    full batch and its draws (or the generator, and draws them through
    ``loss_fn.draws``), and runs :func:`data_parallel_parts` around one
    all-reduce: its loss and gradient on its :meth:`~Mesh.rows` of the
    batch and of every draw, the ranks' sum of them in place, then the
    update.  The parameters stay replicated.
    """
    if mesh is not None:
        first, second = data_parallel_parts(loss_fn, optimizer, mesh, skip_nonfinite)

        def meshed_step(params, opt_state: AdamState, generator, x, y, draws: Optional[Dict[str, Tensor]] = None):
            if draws is None:
                draws = loss_fn.draws(generator, x, y)
            flat = first(params, x, y, draws)
            mesh.all_reduce_(flat)
            return second(params, opt_state, flat)

        return meshed_step

    def step(params, opt_state: AdamState, generator, x, y, draws: Optional[Dict[str, Tensor]] = None):
        leaves = [t.detach().requires_grad_(True) for t in pytree.leaves(params)]
        loss, info = loss_fn(pytree.unflatten(params, leaves), generator, x, y, **(draws or {}))
        grads = torch.autograd.grad(loss, leaves)
        return _update(optimizer, skip_nonfinite, params, opt_state, grads, loss, info)

    return step


def _update(optimizer: Optimizer, skip_nonfinite: bool, params, opt_state: AdamState, grads, loss: Tensor,
            info: Dict[str, Tensor]):
    """A step's end from its gradient (a sequence in the params' leaf
    order): the clip and Adam, the skip-nonfinite guard, loss and info
    detached."""
    tree = lambda flat: pytree.unflatten(params, flat)
    updates, new_state = optimizer.update(tree(grads), opt_state)
    new_params = apply_updates(tree([t.detach() for t in pytree.leaves(params)]), updates)
    if skip_nonfinite:
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        keep = lambda new, old: torch.where(finite, new, old)
        new_params = pytree.map(keep, new_params, params)
        new_state = pytree.map(keep, new_state, opt_state)
    return new_params, new_state, loss.detach(), {k: v.detach() for k, v in info.items()}


def data_parallel_parts(loss_fn, optimizer: Optimizer, mesh: Mesh, skip_nonfinite: bool = True):
    """The data-parallel step as its two parts around the all-reduce,
    (first, second):

      * ``first(params, x, y, draws) -> flat``: this rank's loss on its
        rows of the batch and of every draw (the rows first, as the
        diffusion losses' t, eps and probe, or where the loss's
        ``local_draws`` finds them), its gradient, and
        the flat vector (gradient, loss, info) times the rows' share, the
        buffer that ``mesh.all_reduce_`` sums over the ranks in place;
      * ``second(params, opt_state, flat) -> (params, opt_state, loss,
        info)``: the sum divided by the size, split back, then the clip,
        Adam and the guard (:func:`make_train_step`), the same numbers on
        every rank.

    Every term of the losses is a mean over rows, so the ranks' means, each
    weighted by its share of the rows and averaged, are the full batch's
    loss, info and gradient.  A batch that the size does not divide is
    split into parts one row apart, each weighted by its true count (a
    Python number, fixed when a graph captures the part: another batch size
    is another signature); a batch with fewer rows than ranks raises.  The
    engines run the three pieces in this order whether or not they capture
    the parts (:class:`SplitStep`)."""
    names: list = []  # the info's keys, in order, from the last run of first

    def first(params, x: Tensor, y: Tensor, draws: Dict[str, Tensor]) -> Tensor:
        leaves = [t.detach().requires_grad_(True) for t in pytree.leaves(params)]
        loss, info = _shard_loss(loss_fn, mesh, pytree.unflatten(params, leaves), x, y, draws)
        grads = torch.autograd.grad(loss, leaves)
        names[:] = info
        rows = mesh.rows(x.shape[0])
        weight = (rows.stop - rows.start) * mesh.size / x.shape[0]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]
                         + [v.detach().reshape(1) for v in info.values()])
        return flat * weight if weight != 1 else flat

    def second(params, opt_state: AdamState, flat: Tensor):
        leaves = pytree.leaves(params)
        parts = (flat / mesh.size).split([t.numel() for t in leaves] + [1] * (1 + len(names)))
        grads = [g.view_as(t) for g, t in zip(parts, leaves)]
        info = {k: v.reshape(()) for k, v in zip(names, parts[len(leaves) + 1:])}
        return _update(optimizer, skip_nonfinite, params, opt_state, grads, parts[len(leaves)].reshape(()), info)

    return first, second


def _shard_loss(loss_fn, mesh: Mesh, params, x: Tensor, y: Tensor, draws: Dict[str, Tensor]):
    """This rank's loss on its rows of the batch and of the batch's draws:
    each draw's first axis, or the loss's own cut where its draws are laid
    out otherwise (``loss_fn.local_draws(mesh, draws)``, the SNF's)."""
    if x.shape[0] < mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} rows cannot be split over {mesh.size} ranks")
    if hasattr(loss_fn, "local_draws"):
        local = loss_fn.local_draws(mesh, draws)
    else:
        local = {k: mesh.local(v) for k, v in draws.items()}
    return loss_fn(params, None, mesh.local(x), mesh.local(y), **local)


def epoch_seed(seed: int, epoch: int, device) -> int:
    """The seed of epoch ``epoch``'s generator on ``device``, from (seed,
    global epoch index): the schedule does not depend on how epochs are
    grouped into calls, so re-chunking and resuming are exact.  The CPU's
    mt19937 keeps only the low 32 bits of its seed, so there the seed is
    mixed into them (times an odd constant: two seeds below 2^31 differ at
    every epoch); CUDA's Philox takes all 64."""
    if not 0 <= epoch < 2**32:
        raise ValueError(f"epoch index {epoch} outside [0, 2^32)")
    seed = int(seed) % 2**31
    if torch.device(device).type == "cpu":
        return (seed * 0x9E3779B1 + int(epoch)) % 2**32
    return seed * 2**32 + int(epoch)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with :func:`epoch_seed`."""
    gen = torch.Generator(device=device)
    return gen.manual_seed(epoch_seed(seed, epoch, gen.device))


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


# steps run eagerly on a side stream before a capture, their results thrown
# away (PyTorch's recipe for capturing autograd: its first runs allocate and
# initialise what the captured run then reuses)
GRAPH_WARMUP = 2


def _signature(tree) -> str:
    """The structure of a tree of tensors with each leaf's shape, dtype and
    device: a captured step replays only on trees of its own signature."""
    return repr(pytree.map(lambda t: (tuple(t.shape), t.dtype, t.device), tree))


@dataclasses.dataclass(frozen=True)
class SplitStep:
    """A train step in two parts around an eager call: ``first(state,
    inputs) -> carry``, a tensor; ``between(carry)``, which changes it in
    place (the data-parallel step's all-reduce); ``second(state, inputs,
    carry) -> (state, out)``.  Called, it runs the three in that order: the
    eager step.  :class:`StepGraph` captures each part as a graph of its own
    and calls ``between`` between their replays."""

    first: Callable
    between: Callable
    second: Callable

    def __call__(self, state, inputs):
        carry = self.first(state, inputs)
        self.between(carry)
        return self.second(state, inputs, carry)


class StepGraph:
    """A train step captured once as a CUDA graph, then replayed.

    ``step(state, inputs) -> (state, out)``: ``state`` the tree the step
    updates (params, Adam state), ``inputs`` the tree of one step's tensors
    (the batch and its draws), ``out`` a tensor of results.  The graph reads
    and writes static buffers: :meth:`start` hands it a call's state,
    each call copies one step's inputs into their buffers, replays and
    returns the static ``out`` (overwritten by the next replay), and
    :meth:`state` returns clones of the state buffers, so a caller who
    keeps an earlier tree sees no aliasing.

    A :class:`SplitStep` is captured as two graphs in one memory pool: the
    first part's output ``carry`` is a static buffer of that pool, which
    ``between`` changes in place between the two replays of a call (under
    NCCL a collective queued on the stream, so the second replay follows it
    with no host wait) and the second part reads.

    A step whose state or inputs differ from the captured ones in structure,
    shape, dtype or device captures anew: ``GRAPH_WARMUP`` eager runs of
    the whole step on a side stream, then the capture in a private memory
    pool, the state's update written back into its buffers inside the
    (last) graph.  Every rank of a mesh captures at the same steps, as its
    warm-up runs the same collectives.  The step must draw nothing and wait
    for nothing on the host (a host sync or a copy from pageable memory
    fails the capture); an error in capture or replay raises.
    """

    def __init__(self, step: Callable):
        self._step = step
        self._key: Optional[str] = None
        self._graphs: list = []
        self._state = self._inputs = self._carry = self._out = self._dev = None
        self._pending = None
        self.captures = 0

    def start(self, state) -> None:
        """Begin a call from ``state``: copied into the buffers at the first step."""
        self._pending = state

    def __call__(self, inputs) -> Tensor:
        src = self._state if self._pending is None else self._pending
        key = _signature((src, inputs))
        captured = key != self._key
        if captured:
            with profiling.span("train.capture"):
                self._capture(src, inputs)
            self._key = key
        with profiling.device_span("train.inputs", self._dev):
            if not captured and self._pending is not None:
                for dst, t in zip(pytree.leaves(self._state), pytree.leaves(self._pending)):
                    dst.copy_(t)
            self._pending = None
            for dst, t in zip(pytree.leaves(self._inputs), pytree.leaves(inputs)):
                dst.copy_(t)
        with profiling.device_span("train.replay", self._dev):
            self._graphs[0].replay()
            if len(self._graphs) == 2:
                self._step.between(self._carry)
                self._graphs[1].replay()
        return self._out

    @property
    def cuda_graphs(self) -> list:
        """The captured ``torch.cuda.CUDAGraph``s (none before the first
        step): one, or a :class:`SplitStep`'s two, whose replays around
        ``between`` are one step on the static buffers."""
        return list(self._graphs)

    def state(self):
        """The state after the call's last step: clones of the buffers (the
        tree handed to :meth:`start` if no step ran)."""
        if self._pending is not None:
            return self._pending
        return pytree.map(torch.clone, self._state)

    def _capture(self, state, inputs) -> None:
        self._graphs, self._carry, self._out = [], None, None  # the old graphs' pool goes first
        dev = pytree.leaves(state)[0].device
        keep = profiling.enabled()  # the recorder counts the graphs' kernels before they are instantiated
        with torch.cuda.device(dev):
            static_state = pytree.map(lambda t: t.detach().clone(), state)
            static_in = pytree.map(lambda t: t.detach().clone(), inputs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self._step(static_state, static_in)
            torch.cuda.current_stream().wait_stream(side)
            if isinstance(self._step, SplitStep):
                graphs = [torch.cuda.CUDAGraph(keep_graph=keep), torch.cuda.CUDAGraph(keep_graph=keep)]
                with _capturing(graphs[0]):
                    carry = self._step.first(static_state, static_in)
                pool, last = graphs[0].pool(), lambda: self._step.second(static_state, static_in, carry)
            else:
                graphs, pool, carry = [torch.cuda.CUDAGraph(keep_graph=keep)], None, None
                last = lambda: self._step(static_state, static_in)
            with _capturing(graphs[-1], pool):
                new_state, out = last()
                for dst, t in zip(pytree.leaves(static_state), pytree.leaves(new_state)):
                    if t is not dst:
                        dst.copy_(t)
            if keep:
                profiling.count("graph_kernels", sum(profiling.graph_kernels(g) for g in graphs))
                for g in graphs:
                    g.instantiate()
        self._graphs, self._state, self._inputs, self._carry, self._out = graphs, static_state, static_in, carry, out
        self._dev = dev
        self.captures += 1


@contextlib.contextmanager
def _capturing(graph, pool=None):
    """``torch.cuda.graph`` with the cyclic garbage collector off, in the
    thread-local capture mode.  A collection inside a capture may free an
    unreachable engine of earlier calls (a PINN loss's closures hold a
    cycle), and destroying its graph there fails the capture; and the
    capture fails on what this thread does, not on what a process group's
    watchdog thread queries meanwhile."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


class SeededGraph:
    """``fn(generators)`` captured once as a CUDA graph over generators of
    its own, then replayed with them re-seeded.

    ``fn`` takes a list of generators on one CUDA device and returns a tree
    of tensors; it must draw only from those generators and wait for
    nothing on the host (as a step of :class:`StepGraph`).  A call with
    ``seeds`` seeds the i-th generator with seeds[i] and replays: the
    numbers are those of ``fn`` on fresh generators of these seeds, and the
    host's work is one replay whatever ``fn`` launches.  It returns the
    static outputs, which the next call overwrites (on the same stream, so
    work queued on them before it reads them first).  The first call on a
    device, or with another number of seeds, captures: each generator
    registered with the graph, ``GRAPH_WARMUP`` eager runs on a side
    stream, then the capture; an error in capture or replay raises.
    """

    def __init__(self, fn: Callable):
        self._fn = fn
        self._key = None
        self._graph = self._gens = self._out = None
        self.captures = 0

    def __call__(self, seeds, device):
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device(dev.type, torch.cuda.current_device())
        key = (len(seeds), dev)
        if key != self._key:
            self._capture(*key)
            self._key = key
        for gen, s in zip(self._gens, seeds):
            gen.manual_seed(s)
        self._graph.replay()
        return self._out

    def _capture(self, n: int, dev: torch.device) -> None:
        self._graph = self._out = None  # the old graph's pool goes first
        with torch.cuda.device(dev):
            gens = [torch.Generator(device=dev) for _ in range(n)]
            graph = torch.cuda.CUDAGraph()
            for gen in gens:
                graph.register_generator_state(gen)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self._fn(gens)
            torch.cuda.current_stream().wait_stream(side)
            for gen in gens:
                gen.manual_seed(0)
            with _capturing(graph):
                out = self._fn(gens)
        self._graph, self._gens, self._out = graph, gens, out
        self.captures += 1


def use_capture(capture: bool, device: torch.device) -> bool:
    """Whether an epoch engine captures its step: when asked to, on a CUDA
    device, with or without a mesh (the CPU has no graphs)."""
    return capture and device.type == "cuda"


def run_epochs(one_step, graph: Optional[StepGraph], batch_fn, epoch_inputs, state, seed: int, epoch0: int,
               n_run: int, losses: Tensor, info_names: list):
    """Epochs epoch0 .. epoch0 + n_run - 1 of an epoch engine: epoch j's
    generator ``epoch_generator(seed, epoch0 + j)``, its batches (xb, yb),
    and the steps' inputs ``epoch_inputs(generator, xb, yb)``, one a batch
    in order, each through ``one_step(state, inputs) -> (state, out)``, or
    through a replay of ``graph`` (started from ``state``) when given.
    ``out`` holds the step's loss, then its info terms (named by
    ``info_names`` once a step ran); epoch j's means over its steps go to
    ``losses[j]`` and to the info dict returned with the final state.

    With the recorder on (:mod:`dmip_tpu_torch.utils.profiling`) a call is
    the span ``train.call``, an epoch's batches ``train.batches``, the
    draws ``train.draws``, and a replay's input copies and replays
    ``train.inputs`` and ``train.replay``, each also timed on the card;
    a capture is ``train.capture`` and counts its graphs' kernels
    (``graph_kernels``)."""
    infos: Dict[str, Tensor] = {}
    dev = losses.device
    with profiling.device_span("train.call", dev):
        if graph is not None:
            graph.start(state)
        for j in range(n_run):
            gen = epoch_generator(seed, epoch0 + j, dev)
            with profiling.device_span("train.batches", dev):
                xb, yb = batch_fn(gen)
            rows = None
            for i, inputs in enumerate(epoch_inputs(gen, xb, yb)):
                if graph is not None:
                    out = graph(inputs)
                else:
                    state, out = one_step(state, inputs)
                if rows is None:
                    rows = torch.empty((out.shape[0], len(xb), *out.shape[1:]), dtype=out.dtype, device=out.device)
                rows[:, i] = out
            losses[j] = rows[0].mean(0)
            for k, name in enumerate(info_names, 1):
                infos.setdefault(name, torch.full_like(losses, float("nan")))[j] = rows[k].mean(0)
        return (graph.state() if graph is not None else state), infos


def loss_inputs(loss_fn):
    """``epoch_inputs(generator, xb, yb)`` of :func:`run_epochs` for a loss
    of the autograd engine: each step's (x, y, draws).  A loss with
    ``epoch_draws`` (DSM) draws its epoch's numbers at once, right after
    the batches, and step i takes row i of each; any other draws a batch's
    numbers through ``draws`` just before its step."""
    if hasattr(loss_fn, "epoch_draws"):
        def epoch_inputs(gen, xb, yb):
            with profiling.device_span("train.draws", xb.device):
                draws = loss_fn.epoch_draws(gen, xb, yb)
            return [(x, y, {k: v[i] for k, v in draws.items()}) for i, (x, y) in enumerate(zip(xb, yb))]
        return epoch_inputs

    def batch_inputs(gen, xb, yb):
        dev = xb.device
        for x, y in zip(xb, yb):
            with profiling.device_span("train.draws", dev):
                draws = loss_fn.draws(gen, x, y)
            yield x, y, draws
    return batch_inputs


def make_epoch_fn(
    loss_fn,
    optimizer: Optimizer,
    batch_fn: Callable[[torch.Generator], Tuple[Tensor, Tensor]],
    epochs_per_call: int = 1,
    mesh=None,
    capture: bool = True,
):
    """The autograd epoch engine (``train_backend: xla`` in the config).

    ``batch_fn(generator) -> (xb, yb)`` of shape (n_batches, batch, dim).
    Returns epochs(params, opt_state, seed, epoch0, n_active) -> (params,
    opt_state, per-epoch mean losses (epochs_per_call,), per-epoch mean info
    {name: (epochs_per_call,)}).  Epoch j draws its batches, then each
    batch's t, eps and probe, from ``epoch_generator(seed, epoch0 + j)`` on
    the params' device.  Epochs at j >= n_active are not run; their losses
    and info are nan.

    The loss exposes its draws: ``loss_fn.draws(generator, x, y)`` gives
    the batch's numbers, in the loss's order, as the keywords that hand
    them to it ({} for a loss that draws nothing), as the losses of
    ``DiffusionModel.make_loss_fn`` and ``flows`` do.  The engine draws
    them before each step and hands them over, the numbers the loss would
    draw itself; for a loss with ``epoch_draws`` (DSM) it draws the whole
    epoch's at once after its batches and hands step i row i
    (:func:`loss_inputs`).  With ``capture`` (the default) on a CUDA device
    each step is one replay of a CUDA graph (:class:`StepGraph`): the loss,
    its gradient, the clip, Adam and the guard, captured at the first step;
    ``capture=False`` runs the step eagerly there too (to compare).

    ``mesh``: None, 'auto' or a :class:`Mesh` (:func:`resolve_mesh`).  With
    one, every rank builds the same batches and draws, and each step is
    data-parallel (:func:`data_parallel_parts`): on a card two replays, the
    rank's loss and gradient, then the update, around one eager all-reduce
    of the first's output (a :class:`SplitStep`; eagerly the same three
    pieces in the same order).  Params and state must be the same on every
    rank, as the drivers' seeded inits and checkpoints make them, and stay
    so.
    """
    mesh = resolve_mesh(mesh)
    if not hasattr(loss_fn, "draws"):
        raise ValueError("the epoch engine draws a batch's numbers through the loss's draws "
                         "(loss_fn.draws; {} for a loss that draws nothing)")
    epoch_inputs = loss_inputs(loss_fn)
    info_names: list = []

    def result(params, opt_state, loss, info):
        info_names[:] = info
        return (params, opt_state), torch.stack([loss, *info.values()])

    if mesh is None:
        train_step = make_train_step(loss_fn, optimizer)

        def one_step(state, inputs):
            (params, opt_state), (x, y, draws) = state, inputs
            return result(*train_step(params, opt_state, None, x, y, draws=draws))
    else:
        first, second = data_parallel_parts(loss_fn, optimizer, mesh)
        one_step = SplitStep(lambda state, inputs: first(state[0], *inputs), mesh.all_reduce_,
                             lambda state, inputs, flat: result(*second(*state, flat)))
    graph = StepGraph(one_step)

    def epochs(params, opt_state: AdamState, seed: int, epoch0: int, n_active: int = epochs_per_call):
        dev = pytree.leaves(params)[0].device
        captured = use_capture(capture, dev)
        losses = torch.full((epochs_per_call,), float("nan"), device=dev)
        (params, opt_state), infos = run_epochs(one_step, graph if captured else None, batch_fn, epoch_inputs,
                                                (params, opt_state), seed, epoch0, min(n_active, epochs_per_call),
                                                losses, info_names)
        return params, opt_state, losses, infos

    epochs.graph = graph
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
    (params, opt_state, last epoch's info).

    Each call is read one call late: call k's losses and info are copied
    to pinned host memory behind its work, call k + 1 is queued, and only
    then does the host wait for the copy (an event, the one wait for the
    card a call: not the stream, which holds call k + 1 by then) and log
    call k, so the host prepares a call while the card runs the one before.
    The last call is read before returning.  What is logged and printed is
    the order of reading at once."""
    if opt_state is None:
        opt_state = optimizer.init(params)
    last_info: Dict[str, float] = {}
    t0 = time.time()
    n_calls = -(-max(num_epochs - start_epoch, 0) // epochs_per_call)
    every = max(log_every // epochs_per_call, 1) if log_every else 0

    def read(c: int, epoch: int, n_active: int, names: list, host: list, done):
        with profiling.span("train.read"):
            profiling.count("host_waits")
            if done is not None:
                done.synchronize()
            losses, *rows = [t.tolist() for t in host]
        infos = dict(zip(names, rows))
        for j in range(n_active):
            if logger is not None:
                logger.scalar("Train/Loss", float(losses[j]), epoch + j)
                for k, v in infos.items():
                    logger.scalar("Train/" + k, float(v[j]), epoch + j)
        if every and (c % every == 0 or c == n_calls - 1):
            rate = (epoch + n_active - start_epoch) / (time.time() - t0)
            print(f"[{desc}] epoch {epoch + n_active}/{num_epochs} loss={float(losses[n_active - 1]):.4f} "
                  f"({rate:.1f} epochs/s)", flush=True)
        return {k: float(v[n_active - 1]) for k, v in infos.items()}

    epoch, pending = start_epoch, None
    for c in range(n_calls):
        n_active = min(epochs_per_call, num_epochs - epoch)
        params, opt_state, losses, infos = epoch_fn(params, opt_state, seed, epoch, n_active)
        staged = (c, epoch, n_active, list(infos), *_queue_to_host([losses, *infos.values()]))
        if pending is not None:
            last_info = read(*pending)
        pending = staged
        epoch += n_active
    if pending is not None:
        last_info = read(*pending)
    return params, opt_state, last_info


def _queue_to_host(tensors: list):
    """(host copies of ``tensors``, the event that follows the copies): on
    a card the copies go to pinned memory, queued behind the work that
    makes the tensors, and the event says when they have landed; off the
    card clones, and no event."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.clone() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


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
