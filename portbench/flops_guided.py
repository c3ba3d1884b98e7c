"""Operation counts of the guided sampler (kernel B5) from the nets' widths.

As in ``flops.py``: 2 operations a multiply-add, whatever implements it.
A sample-step of the ``dps`` guidance is four passes:

* the prior net's forward over [x, t]: (xdim + 1) h1, the hidden layers,
  h_last xdim;
* the surrogate's forward at Tweedie's estimate: its every layer;
* the surrogate's VJP of the folded cotangent: its every layer again;
* the prior net's VJP at x (the chain rule through Tweedie): its layers
  with the first one over x only, xdim h1.

At the prior 4 -> 512^3 -> 3 and the surrogate 3 -> 256^3 -> 23:
527,872 + 137,728 + 137,728 + 527,360 = 1,330,688 MACs, 2,661,376
operations.  The noise, the guidance's elementwise terms, the cap and the
update are not products and are left out.
"""

from __future__ import annotations

from typing import Sequence

from .flops import layer_macs


def is_b5(kernel_name: str) -> bool:
    """The guided sampler kernel B5, by the name the trace gives it."""
    return "guided_em_kernel" in kernel_name


def guided_sample_step(xdim: int, prior_hidden: Sequence[int], surrogate_dims: Sequence[int]) -> int:
    """B5's operations for one sample and one step of the ``dps`` guidance."""
    prior_fwd = (xdim + 1) * prior_hidden[0] + layer_macs([*prior_hidden, xdim])
    prior_vjp = xdim * prior_hidden[0] + layer_macs([*prior_hidden, xdim])
    surrogate = layer_macs(surrogate_dims)
    return 2 * (prior_fwd + prior_vjp + 2 * surrogate)


def guided_launch(xdim: int, prior_hidden: Sequence[int], surrogate_dims: Sequence[int], samples: int,
                  steps: int) -> int:
    """One guided posterior: every sample-step."""
    return samples * steps * guided_sample_step(xdim, prior_hidden, surrogate_dims)
