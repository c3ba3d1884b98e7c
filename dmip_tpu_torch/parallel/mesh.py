"""The multi-GPU layer: one process a GPU over ``torch.distributed``.

Port of ``dmip_tpu/parallel/mesh.py``.  The JAX package is one process
over every local chip: a ``Mesh`` of devices, arrays placed on it by
``NamedSharding``, and XLA inserting the collectives.  Here a mesh is the
process group that ``torchrun --nproc_per_node N`` starts: every rank runs
the same program on its own device and host thread (each training step is
two CUDA-graph replays around an all-reduce, but the batches, the draws
and the evaluation's scoring are host work, which one thread issuing to N
cards would do N times in turn), and the code calls the collectives
itself:

  * :meth:`Mesh.rows` / :meth:`Mesh.local` -- this rank's part of an axis
    (``batch_sharding`` / ``shard_batch``);
  * :meth:`Mesh.all_reduce` / :meth:`Mesh.all_reduce_` -- sum or mean
    over the ranks, the second in place (the gradient all-reduce of data
    parallelism);
  * :meth:`Mesh.all_gather` / :meth:`Mesh.all_gather_objects` -- every
    rank's part, in rank order, on every rank;
  * :meth:`Mesh.broadcast` -- rank 0's value (``replicate``).

Rank 0 writes the run's files and the other ranks write none
(:func:`is_writer`): every writer of the package asks it -- the
directories, the metrics logs, checkpoints, results.csv, the plots, the
ground truth -- so a run of N ranks leaves the tree of one process, and a
driver needs no rule of its own.

The backend is NCCL when every rank of a host has a CUDA device of its
own, and gloo on the CPU or when ranks share a device (NCCL refuses two
ranks on one device).  Gloo takes CUDA tensors for every collective used
here (it stages them through host memory itself), so no tensor is copied
by this module.  A rank that fails makes the run fail: there is no
fallback.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

Tensor = torch.Tensor

_MASK64 = 2**64 - 1

# This process's device, chosen by init_multihost with its process group;
# read only while that group is up.
_device: Optional[torch.device] = None


def _placement(device, local_rank: int, local_world: int) -> Tuple[str, torch.device]:
    """(backend, device) of a rank: NCCL on ``cuda:local_rank`` when the
    host's ranks have a card each, gloo on ``cuda:local_rank % cards`` when
    they share, gloo on the CPU when the caller asks for it."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", dev
    n = torch.cuda.device_count()
    if local_world <= n:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % n)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group of a multi-GPU (or multi-host) run.

    The coordinator ``host:port``, the world size and this rank come from
    the arguments or, when omitted, from the variables ``torchrun`` sets
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the host's share).  With
    explicit arguments every rank is on this host.  ``device``: 'cuda' (the
    default; this rank's card, made the current device) or 'cpu'.  Prints
    the backend and device it chose to stderr.

    Returns True when the group is (now) up, False without a coordinator (a
    plain one-process run: a safe no-op, so drivers call this
    unconditionally).  Idempotent: once the group is up it returns True
    without joining again.
    """
    global _device
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return False
        coordinator_address = f"{addr}:{port}"
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None else int(num_processes)
    if process_id is None:
        rank = int(os.environ.get("RANK", 0))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        rank = local_rank = int(process_id)
        local_world = world
    backend, dev = _placement(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)
    _device = dev
    share = f", {local_world} ranks share {torch.cuda.device_count()} CUDA device(s)" if (
        dev.type == "cuda" and backend == "gloo") else ""
    print(f"[mesh] rank {rank} of {world}: {backend} on {dev}{share}", file=sys.stderr, flush=True)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the process group: ``size`` ranks, this
    ``rank``, its ``device`` and the ``backend``.  The collectives take
    tensors on ``device`` (NCCL needs them there; gloo also takes CPU
    ones)."""

    size: int
    rank: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's part of an axis of length ``n``: contiguous, in rank
        order, the parts' lengths differing by at most one (equal when
        ``size`` divides ``n``; empty for the last ranks when n < size)."""
        base, extra = divmod(n, self.size)
        start = self.rank * base + min(self.rank, extra)
        return slice(start, start + base + (self.rank < extra))

    def local(self, x: Tensor, axis: int = 0) -> Tensor:
        """This rank's :meth:`rows` of ``x``'s ``axis`` (a view)."""
        s = self.rows(x.shape[axis])
        return x.narrow(axis, s.start, s.stop - s.start)

    def all_reduce(self, t: Tensor, mean: bool = False) -> Tensor:
        """The sum over the ranks of ``t`` (or the mean: the sum divided by
        the size, so a world of one gives ``t`` bit for bit)."""
        out = self.all_reduce_(t.clone())
        return out / self.size if mean else out

    def all_reduce_(self, t: Tensor) -> Tensor:
        """``t`` replaced by the sum over the ranks, in place (a world of
        one leaves it as it was); returns ``t``.  Under NCCL the sum is
        queued on the current stream with no host wait, so a captured step
        reduces its static buffer between two replays."""
        dist.all_reduce(t)
        return t

    def all_gather(self, t: Tensor, axis: int = 0) -> Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``axis`` in
        rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=axis)

    def all_gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast(self, t: Tensor) -> Tensor:
        """Rank 0's ``t`` on every rank."""
        out = t.clone().contiguous()
        dist.broadcast(out, 0)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def get_mesh() -> Mesh:
    """The mesh of this process's group (see :func:`init_multihost`).  A
    group started elsewhere gets ``cuda:<current>`` under NCCL, else the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_multihost() first (torchrun sets its environment)")
    backend = dist.get_backend()
    dev = _device
    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    return Mesh(dist.get_world_size(), dist.get_rank(), dev, backend)


def is_writer() -> bool:
    """Whether this process writes the run's files: the only process, or
    rank 0 of the process group.  The other ranks compute the same run and
    write nothing; a rank that reads a file rank 0 has just written waits
    for it (:func:`barrier`) first."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing to wait for without a mesh)."""
    if mesh is not None:
        mesh.barrier()


def pad_to_multiple(x: Tensor, multiple: int, axis: int = 0) -> Tuple[Tensor, int]:
    """Zero-pad ``axis`` to a multiple of ``multiple``; returns (padded,
    n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def fold_in(seed: int, i: int) -> int:
    """A 62-bit seed derived from (seed, i): splitmix64 of seed + (i + 1)
    times the golden-ratio increment; the counterpart of
    ``jax.random.fold_in`` for the port's integer seeds."""
    z = (int(seed) + (int(i) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 2


def local_address() -> str:
    """``localhost:<port>`` with a port free at the time of the call, for a
    coordinator on this host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"
