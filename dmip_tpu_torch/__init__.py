"""dmip_tpu_torch: the PyTorch/CUDA port of :mod:`dmip_tpu`.

Module names mirror the JAX package so each counterpart is easy to find
(``dmip_tpu/sde.py`` -> ``dmip_tpu_torch/sde.py`` and so on).  The port
imports neither JAX nor ``dmip_tpu``; the JAX package is the reference it is
tested against (``tests/test_torch_*.py``).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; on a host without a card they raise instead of falling
back.  The hot loops are hand-written CUDA kernels (``ops/``, sources in
``csrc/``), each with a plain PyTorch version beside it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dmip_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
