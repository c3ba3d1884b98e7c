"""Checkpoints in the JAX package's format, and carrying JAX state across.

The format of ``dmip_tpu/checkpoints.py``: a directory with one
``<name>.npz`` per tree (``leaf_0 .. leaf_{n-1}`` in JAX's flatten order)
beside ``<name>.treedef.json``, and ``manifest.json`` with the step.  Any
tree of :mod:`dmip_tpu_torch.pytree` is written with JAX's leaf order and
its ``PyTreeDef(...)`` string: an MLP's (W, b) pairs (W of shape (fan_in,
fan_out)), a dict of MLPs such as a ``PosteriorDiffusionEstimator``'s
``{'likelihood', 'prior'}``, the flows' lists of ``{'s1', 's2'}``
couplings with ``()`` for the SNF's stochastic layers.  An
:class:`~dmip_tpu_torch.train.AdamState` goes in optax's flatten order:

  ``adam``             [count, mu leaves..., nu leaves...]
  ``adam`` + cosine    the same, then the schedule's count
  clip + ``adam``      the same as ``adam`` (the clip state has no leaves)

so each package restores the other's checkpoint.  The training seed, an int
in the port, goes into the manifest as ``seed``; the JAX package's PRNG key
file is left to the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import pytree
from .parallel.mesh import is_writer
from .pytree import leaves as _leaves


def _is_pair_list(seq) -> bool:
    return all(
        isinstance(p, (tuple, list)) and len(p) == 2 and all(hasattr(a, "shape") for a in p) for p in seq
    )


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """A JAX params tree as numpy arrays -> the port's tree of tensors.

    A sequence of (W, b) pairs (or an iterator of them) becomes an MLP, a
    tuple of (W, b) tensor pairs; a dict keeps its keys, a list stays a
    list and another tuple a tuple (``()`` for an SNF's stochastic layer),
    each converted inside."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and (not tree or not _is_pair_list(tree)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    as_t = lambda a: torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
    return tuple((as_t(w), as_t(b)) for w, b in tree)


def adam_state_from_numpy(count, mu, nu, schedule_count=None, device=None):
    """optax Adam state as numpy (count, mu tree, nu tree[, schedule
    count]) -> the port's :class:`~dmip_tpu_torch.train.AdamState`."""
    from .train import AdamState

    as_count = lambda c: torch.as_tensor(np.asarray(c), dtype=torch.int32, device=device).reshape(())
    return AdamState(
        as_count(count), params_from_numpy(mu, device), params_from_numpy(nu, device),
        None if schedule_count is None else as_count(schedule_count),
    )


def _is_mlp(node) -> bool:
    return isinstance(node, tuple) and len(node) > 0 and all(
        isinstance(p, tuple) and len(p) == 2 and all(a is pytree.LEAF for a in p) for p in node
    )


def _is_mlp_tree(node) -> bool:
    """An MLP, or a tuple, list or dict whose every entry is one (empty
    tuples and lists included)."""
    if _is_mlp(node):
        return True
    if isinstance(node, dict):
        return len(node) > 0 and all(_is_mlp_tree(v) for v in node.values())
    if isinstance(node, (tuple, list)):
        return all(_is_mlp_tree(v) for v in node)
    return False


def load_archived_params(ckpt_dir: str, device=None, dtype=torch.float32):
    """Read ``<ckpt_dir>/params.npz`` written by the JAX package into the
    tree its ``params.treedef.json`` describes: an MLP as a tuple of (W, b)
    pairs (``benchmarks/checkpoints/cde_500k``), a dict of MLPs
    (``dps_prior``), a flow's list of ``{'s1', 's2'}`` couplings
    (``baselines_inn``) or an SNF's list of such lists and ``()``
    (``baselines_snf``).  A tree with a leaf outside an MLP's (W, b) pairs
    raises."""
    with open(os.path.join(ckpt_dir, "params.treedef.json")) as f:
        treedef = json.load(f)
    structure = pytree.parse_treedef(treedef)
    if not _is_mlp_tree(structure):
        raise ValueError(f"{ckpt_dir}: not an MLP (W, b) pair tree or a tree of such MLPs: {treedef}")
    flat = _read_leaves(ckpt_dir, "params")
    want = len(_leaves(structure))
    if len(flat) != want:
        raise ValueError(f"{ckpt_dir}: {len(flat)} leaves for a structure of {want}")
    as_t = lambda a: torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
    return pytree.unflatten(structure, [as_t(a) for a in flat])


def _treedef(tree) -> str:
    from .train import AdamState

    if isinstance(tree, AdamState):
        return f"AdamState(count, mu, nu{', schedule_count' if tree.schedule_count is not None else ''})"
    return pytree.treedef(tree)


def _read_leaves(path: str, name: str) -> list:
    with np.load(os.path.join(path, f"{name}.npz")) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def save_pytree(path: str, tree, name: str) -> None:
    np.savez(
        os.path.join(path, f"{name}.npz"),
        **{f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(_leaves(tree))},
    )
    with open(os.path.join(path, f"{name}.treedef.json"), "w") as f:
        json.dump(_treedef(tree), f)


def load_pytree(path: str, like, name: str, device=None):
    """Restore a tree with the structure of ``like`` (any params tree or an
    AdamState); each leaf takes the dtype of like's and goes to ``device``
    (default: like's)."""
    flat = _read_leaves(path, name)
    like_leaves = _leaves(like)
    if len(flat) != len(like_leaves):
        raise ValueError(f"{path}/{name}.npz: {len(flat)} leaves, the structure takes {len(like_leaves)}")
    return pytree.unflatten(like, [
        torch.as_tensor(np.array(a, order="C"), dtype=ref.dtype, device=ref.device if device is None else device)
        for a, ref in zip(flat, like_leaves)
    ])


def save_checkpoint(
    ckpt_dir: str,
    params,
    opt_state=None,
    step: int = 0,
    seed: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write params (and opt_state) with a manifest of step, seed and
    ``extra``; off rank 0 of a multi-rank run, nothing
    (``parallel.is_writer``)."""
    if not is_writer():
        return
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
