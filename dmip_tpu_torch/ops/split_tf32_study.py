"""How far the split-TF32 hidden products move the MH chains: the numerics
study behind B2's tensor-core design, run on any device.

Follows ``chip_smoke.py``'s ``check_b2`` recipe on the committed surrogate:
uniform starts, one step with the same randomness, then many steps with
the same randomness.  Each form of the chains' energy, the f32 plain one
and the split-TF32 model with 3 and 4 terms (:func:`split_tf32_matmul`),
is held against the same chains run in float64 (the split model's lo
parts enter as a tensor core reads them, truncated to TF32):

* the energies of the starts and the first proposals, relative to
  max(|e|, 1): p50, p999 and max;
* the first step's decisions that differ from float64's, with raw uniforms;
* the first step with the uniforms kept 2e-3 from the f32 threshold (as
  ``check_b2`` keeps them): the largest state difference against the f32
  plain version (``check_b2`` allows 1e-5);
* after ``steps`` steps, the share of chains that end more than 1e-4 from
  the f32 plain version's and from float64's (``check_b2`` allows 0.02
  against the plain version).

Usage: python -m dmip_tpu_torch.ops.split_tf32_study [--chains 4096]
          [--steps 1000] [--seed 0] [--device cpu]
Runs on the card unless ``--device cpu`` is given.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..problems import scatterometry as scat
from .mh_kernel import mh_chains_reference, mh_energy

KW = dict(noise_std=0.5, a=0.2, b=0.01, lambd_bd=1000.0)
FORMS = (("f32", None), ("split3", 3), ("split4", 4))


def _quantiles(rel: torch.Tensor) -> dict:
    q = torch.quantile(rel.double(), torch.tensor([0.5, 0.999], dtype=torch.float64, device=rel.device))
    return {"p50": float(q[0]), "p999": float(q[1]), "max": float(rel.max())}


def study(chains: int = 4096, steps: int = 1000, seed: int = 0, device=None) -> dict:
    """The study's numbers (above) on ``device``: the card unless the caller
    passes ``device="cpu"``; raises without a card."""
    device = resolve_device(device)
    weights = scat.load_surrogate_weights(device=device)
    w64 = [(w.double(), b.double()) for w, b in weights]
    gen = torch.Generator(device=device).manual_seed(seed)
    fwd = lambda x: scat.surrogate_apply(weights, x)
    y = scat.noisy_forward(fwd, torch.tensor([[0.3, -0.5, 0.1]], device=device), KW["a"], KW["b"], gen)[0]
    x0 = torch.rand(chains, 3, generator=gen, device=device) * 2 - 1
    z = torch.randn(steps, chains, 3, generator=gen, device=device)
    u = torch.rand(steps, chains, generator=gen, device=device)
    ekw = dict(a=KW["a"], b=KW["b"], lambd_bd=KW["lambd_bd"])
    xp = x0 + KW["noise_std"] * z[0]
    states = torch.cat([x0, xp])
    e64 = mh_energy(w64, y, **ekw)(states.double())
    acc64 = u[0].double() < torch.exp(e64[:chains] - e64[chains:])
    # one step's uniforms kept 2e-3 from the f32 plain threshold
    e32 = mh_energy(weights, y, **ekw)(states)
    thr = torch.exp(e32[:chains] - e32[chains:]).clamp(max=2.0)
    u1 = torch.where((u[0] - thr).abs() < 1e-3, torch.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u[0])[None]
    plain1 = mh_chains_reference(weights, x0, y, 1, noise=z[:1], uniforms=u1, **KW)
    plain = mh_chains_reference(weights, x0, y, steps, noise=z, uniforms=u, **KW)
    ref64 = mh_chains_reference(weights, x0, y, steps, noise=z, uniforms=u, dtype=torch.float64, **KW)
    differ = lambda a, b: float(((a - b).abs().amax(dim=1) > 1e-4).float().mean())
    out = {"chains": chains, "steps": steps, "seed": seed, "device": str(device),
           "f64_vs_f32_plain_share": differ(ref64, plain)}
    for name, terms in FORMS:
        e = mh_energy(weights, y, terms=terms, **ekw)(states)
        acc = u[0] < torch.exp(e[:chains] - e[chains:])
        res = {f"energy_rel_{k}": v for k, v in _quantiles((e.double() - e64).abs() / e64.abs().clamp(min=1.0)).items()}
        res["flips_vs_f64_step1"] = int((acc != acc64).sum())
        if terms is not None:
            one = mh_chains_reference(weights, x0, y, 1, noise=z[:1], uniforms=u1, terms=terms, **KW)
            res["step1_max_abs_vs_plain"] = float((one - plain1).abs().max())
            end = mh_chains_reference(weights, x0, y, steps, noise=z, uniforms=u, terms=terms, **KW)
            res["share_vs_plain"] = differ(end, plain)
            res["share_vs_f64"] = differ(end, ref64)
        out[name] = res
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chains", type=int, default=4096)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps(study(args.chains, args.steps, args.seed, args.device)))


if __name__ == "__main__":
    main()
