"""Carrying trained weights from the JAX package into the port.

The JAX checkpoints (``dmip_tpu/checkpoints.py``) store a params pytree as
``params.npz`` (``leaf_0 .. leaf_{n-1}`` in flatten order) beside
``params.treedef.json``.  For the MLPs on the serving path the tree is a
tuple of (W, b) pairs, W of shape (fan_in, fan_out); the port keeps that
layout at its public API.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, Tuple

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


def load_archived_params(ckpt_dir: str, device=None, dtype=torch.float32) -> MLPParams:
    """Read ``<ckpt_dir>/params.npz`` written by the JAX package, e.g.
    ``benchmarks/checkpoints/cde_500k``.  Only MLP trees (a tuple of (W, b)
    pairs) are accepted; anything else raises."""
    with open(os.path.join(ckpt_dir, "params.treedef.json")) as f:
        treedef = json.load(f)
    if not _PAIRS_TREEDEF.match(treedef):
        raise ValueError(f"{ckpt_dir}: not an MLP (W, b) pair tree: {treedef}")
    n_pairs = treedef.count("(*, *)")
    with np.load(os.path.join(ckpt_dir, "params.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(leaves) != 2 * n_pairs:
        raise ValueError(
            f"{ckpt_dir}: {len(leaves)} leaves for {n_pairs} (W, b) pairs"
        )
    return params_from_numpy(
        zip(leaves[0::2], leaves[1::2]), device=device, dtype=dtype
    )
