"""Checkpoints in the JAX package's format, and carrying JAX state across.

The format of ``dmip_tpu/checkpoints.py``: a directory with one
``<name>.npz`` per tree (``leaf_0 .. leaf_{n-1}`` in JAX's flatten order)
beside ``<name>.treedef.json``, and ``manifest.json`` with the step.  The
port writes params as the (W, b) pairs, W of shape (fan_in, fan_out), and an
:class:`~dmip_tpu_torch.train.AdamState` in optax's flatten order:

  ``adam``             [count, mu W0, mu b0, ..., nu W0, nu b0, ...]
  ``adam`` + cosine    the same, then the schedule's count
  clip + ``adam``      the same as ``adam`` (the clip state has no leaves)

so each package restores the other's checkpoint.  The training seed, an int
in the port, goes into the manifest as ``seed``; the JAX package's PRNG key
file is left to the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .nets import MLPParams

_PAIRS_TREEDEF = re.compile(r"^PyTreeDef\(\((\(\*, \*\)(, )?)+\)\)$")


def params_from_numpy(
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]], device=None, dtype=torch.float32
) -> MLPParams:
    """JAX (W, b) numpy pairs -> the port's tuple of (W, b) tensors."""
    return tuple(
        (
            torch.as_tensor(np.array(w, order="C"), dtype=dtype, device=device),
            torch.as_tensor(np.array(b, order="C"), dtype=dtype, device=device),
        )
        for w, b in pairs
    )


def adam_state_from_numpy(count, mu, nu, schedule_count=None, device=None):
    """optax Adam state as numpy (count, mu pairs, nu pairs[, schedule
    count]) -> the port's :class:`~dmip_tpu_torch.train.AdamState`."""
    from .train import AdamState

    as_count = lambda c: torch.as_tensor(np.asarray(c), dtype=torch.int32, device=device).reshape(())
    return AdamState(
        as_count(count), params_from_numpy(mu, device), params_from_numpy(nu, device),
        None if schedule_count is None else as_count(schedule_count),
    )


def load_archived_params(ckpt_dir: str, device=None, dtype=torch.float32) -> MLPParams:
    """Read ``<ckpt_dir>/params.npz`` written by the JAX package, e.g.
    ``benchmarks/checkpoints/cde_500k``.  Only MLP trees (a tuple of (W, b)
    pairs) are accepted; anything else raises."""
    with open(os.path.join(ckpt_dir, "params.treedef.json")) as f:
        treedef = json.load(f)
    if not _PAIRS_TREEDEF.match(treedef):
        raise ValueError(f"{ckpt_dir}: not an MLP (W, b) pair tree: {treedef}")
    n_pairs = treedef.count("(*, *)")
    leaves = _read_leaves(ckpt_dir, "params")
    if len(leaves) != 2 * n_pairs:
        raise ValueError(
            f"{ckpt_dir}: {len(leaves)} leaves for {n_pairs} (W, b) pairs"
        )
    return params_from_numpy(
        zip(leaves[0::2], leaves[1::2]), device=device, dtype=dtype
    )


def _leaves(tree) -> list:
    """Leaves in JAX's flatten order: a tuple of pairs is walked in order;
    an AdamState gives count, mu, nu and the schedule count."""
    from .train import AdamState

    if isinstance(tree, AdamState):
        sched = [] if tree.schedule_count is None else [tree.schedule_count]
        return [tree.count, *_leaves(tree.mu), *_leaves(tree.nu), *sched]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _treedef(tree) -> str:
    from .train import AdamState

    if isinstance(tree, AdamState):
        return f"AdamState(count, mu, nu{', schedule_count' if tree.schedule_count is not None else ''})"
    return "PyTreeDef((" + ", ".join("(*, *)" for _ in tree) + "))"


def _read_leaves(path: str, name: str) -> list:
    with np.load(os.path.join(path, f"{name}.npz")) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def save_pytree(path: str, tree, name: str) -> None:
    leaves = _leaves(tree)
    np.savez(
        os.path.join(path, f"{name}.npz"),
        **{f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)},
    )
    with open(os.path.join(path, f"{name}.treedef.json"), "w") as f:
        json.dump(_treedef(tree), f)


def load_pytree(path: str, like, name: str, device=None):
    """Restore a tree with the structure of ``like`` (params pairs or an
    AdamState); tensors go to ``device`` (default: like's)."""
    from .train import AdamState

    leaves = _read_leaves(path, name)
    want = len(_leaves(like))
    if len(leaves) != want:
        raise ValueError(f"{path}/{name}.npz: {len(leaves)} leaves, the structure takes {want}")
    dev = device if device is not None else _leaves(like)[0].device
    if isinstance(like, AdamState):
        n = len(_leaves(like.mu))
        pairs = lambda flat: tuple(zip(flat[0::2], flat[1::2]))
        sched = leaves[2 * n + 1] if like.schedule_count is not None else None
        return adam_state_from_numpy(leaves[0], pairs(leaves[1:n + 1]), pairs(leaves[n + 1:2 * n + 1]),
                                     sched, device=dev)
    return params_from_numpy(zip(leaves[0::2], leaves[1::2]), device=dev)


def save_checkpoint(
    ckpt_dir: str,
    params,
    opt_state=None,
    step: int = 0,
    seed: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    save_pytree(ckpt_dir, params, "params")
    manifest: Dict[str, Any] = {"step": int(step)}
    if opt_state is not None:
        save_pytree(ckpt_dir, opt_state, "opt_state")
        manifest["has_opt_state"] = True
    if seed is not None:
        manifest["seed"] = int(seed)
    if extra:
        manifest["extra"] = extra
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(ckpt_dir: str, params_like, opt_state_like=None, device=None) -> Dict[str, Any]:
    """{'params', 'step', 'extra'[, 'opt_state'][, 'seed']} from a
    checkpoint written by either package."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {
        "params": load_pytree(ckpt_dir, params_like, "params", device),
        "step": manifest["step"],
        "extra": manifest.get("extra", {}),
    }
    if manifest.get("has_opt_state") and opt_state_like is not None:
        out["opt_state"] = load_pytree(ckpt_dir, opt_state_like, "opt_state", device)
    if "seed" in manifest:
        out["seed"] = manifest["seed"]
    return out
