"""Operation counts from the nets' widths, and the card's peaks.

Counts are what the algorithm needs, 2 operations a multiply-add, whatever
implements it.  ``F(rows)``, one forward pass of the score net over
``rows`` rows, is 2 rows sum(fan_in fan_out) over its layers.

* The E-M sampler (kernel B1), a sample-step: layer 0 over [x, t] only, as
  the condition's part y . W1y + b1 is the same at every step and sample
  and is taken once a posterior (2 ydim h1 a launch), then the hidden
  layers and the output layer.  At 5 -> 512^3 -> 2: 1,053,696.
* The linear evaluation's scoring, a repeat: one net pass over the
  analytic samples at t = 0 (the score-MSE); histograms, NLL and W2 are
  not products.
* The PINN FPE training step with its gradient, counted in net passes:
  IC and DSM each a forward and its backward with the weights' gradient
  (3 F each); ds/dt one forward-mode JVP (primal and tangent, 2 F) and the
  backward of both with the weights' gradient (4 F); grad_z of h at fixed
  t, the primal and one tangent per state dimension forward, then their
  backward for the inputs only ((1 + d) F twice).  20 F for d = 3, 18 F
  for d = 2.  The surrogate's simulation of the data (the data layer) and
  Adam's elementwise update are left out.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA's H100 SXM data sheet, dense, at the 700 W limit (FLOP/s)
PEAKS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def layer_macs(dims: Sequence[int]) -> int:
    return sum(i * o for i, o in zip(dims[:-1], dims[1:]))


def forward_pass(dims: Sequence[int], rows: int) -> int:
    """F(rows): one forward pass of the MLP of widths ``dims``."""
    return 2 * rows * layer_macs(dims)


def is_b1(kernel_name: str) -> bool:
    """The sampler kernel B1, in its bf16 mode, by the name the trace gives it."""
    return "em_sampler_kernel" in kernel_name and "f32" not in kernel_name


def sampler_sample_step(xdim: int, hidden: Sequence[int]) -> int:
    """B1's operations for one sample and one step."""
    return 2 * ((xdim + 1) * hidden[0] + layer_macs([*hidden, xdim]))


def sampler_launch(xdim: int, ydim: int, hidden: Sequence[int], samples: int, steps: int) -> int:
    """One posterior: every sample-step, and the condition's fold once."""
    return samples * steps * sampler_sample_step(xdim, hidden) + 2 * ydim * hidden[0]


def linear_condition(xdim: int, ydim: int, hidden: Sequence[int], samples: int, steps: int, repeats: int) -> int:
    """One condition of the linear evaluation: per repeat a posterior and
    the score-MSE's net pass over as many analytic samples."""
    dims = [xdim + ydim + 1, *hidden, xdim]
    return repeats * (sampler_launch(xdim, ydim, hidden, samples, steps) + forward_pass(dims, samples))


def pinn_passes(xdim: int) -> int:
    """Net passes (in F) of a PINN FPE step with its gradient."""
    return 3 + 3 + 6 + 2 * (1 + xdim)


def pinn_step(xdim: int, ydim: int, hidden: Sequence[int], batch: int) -> int:
    return pinn_passes(xdim) * forward_pass([xdim + ydim + 1, *hidden, xdim], batch)
