"""Metropolis-Hastings annealing to an energy.

Port of ``dmip_tpu/mcmc.py:84-130`` (``anneal_to_energy``), Gaussian
random-walk proposals only; the Langevin (MALA) proposal comes with a later
slice.  An energy maps (n, d) -> (n,) and returns the NEGATIVE log density.

This is also the plain version of the fused MH kernel
(:mod:`dmip_tpu_torch.ops.mh_kernel`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
EnergyFn = Callable[[Tensor], Tensor]


def anneal_to_energy(
    x_curr: Tensor,
    energy: EnergyFn,
    metr_steps_per_block: int,
    noise_std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    langevin_prop: bool = False,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Run ``metr_steps_per_block`` Metropolis steps on every chain.

    Returns (x_final, e_final - e_initial).  The accepted energy is carried
    from step to step.  ``noise`` (steps, n, d) and ``uniforms`` (steps, n)
    replace the draws from ``generator``, so two implementations can be fed
    the same random numbers.  Accept iff u < exp(e - e_prop): an overflow to
    inf accepts and a NaN energy rejects.
    """
    if langevin_prop:
        raise NotImplementedError(
            "Langevin (MALA) proposals are not ported yet; see ROADMAP.md §A"
        )
    gen_dev = generator.device if generator is not None else "cpu"
    dev = x_curr.device
    x = x_curr
    e0 = energy(x)
    e = e0
    for i in range(metr_steps_per_block):
        xi = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=gen_dev, dtype=x.dtype)
        x_prop = x + noise_std * xi.to(dev)
        e_prop = energy(x_prop)
        u = uniforms[i] if uniforms is not None else torch.rand(
            e.shape, generator=generator, device=gen_dev, dtype=x.dtype)
        acc = u.to(dev) < torch.exp(e - e_prop)
        x = torch.where(acc[:, None], x_prop, x)
        e = torch.where(acc, e_prop, e)
    return x, e - e0
