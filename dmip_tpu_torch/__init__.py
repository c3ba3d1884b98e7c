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

import functools

import torch

__all__ = ["device_constant", "resolve_device"]


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


@functools.lru_cache(maxsize=None)
def device_constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 0-d tensor ``torch.tensor(value, dtype=dtype, device=device)``,
    made once per (value, dtype, device) and shared; never write to it.
    ``torch.tensor`` of a Python number copies it from pageable host memory,
    which on a card waits for the stream, and cannot be captured in a CUDA
    graph: a train step takes its constants from here instead."""
    with torch.inference_mode(False), torch.no_grad():
        return torch.tensor(value, dtype=dtype, device=device)
