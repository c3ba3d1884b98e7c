"""Guided posteriors as traffic: the ``posterior`` traffic's closed loop of
one client (a request one posterior for the next observation of the pool,
its mean and covariance read back), served by diffusion posterior sampling
with the exact likelihood through the frozen surrogate.

The model is built as the port's evaluation builds it: a
``PosteriorDiffusionEstimator``, the surrogate from
``problems.scatterometry.load_forward_model`` and
``mains.eval_diffusion.analytic_row``, so a request is
``AnalyticGuidanceDPS.sample`` and on the card kernel B5.  The
configuration gives ``hidden_layers`` (the prior net's), ``surrogate_layers``
(checked against the committed surrogate), ``guidance``, ``guidance_clip``,
``n_samples_x`` and ``eval_num_steps``; the traffic ``pool``,
``check_requests``, ``check_within`` and ``trace_units``.

``correct`` cannot hold the samples row by row as the CDE's posterior does:
near s = T Tweedie's estimate divides x by alpha ~ 0.007 and the capped
guidance turns a difference in x about tenfold a step, so two f32
computations of one trajectory part within ten steps, and most samples end
as far from their reference as from an unrelated sample.  A few percent of
the rows stay together to f32 rounding, and the precision decides how many:
``near_gap`` is the 1st percentile of a sample's distance from its
reference sample over the reference's RMS spread, in the worst of eight
contiguous blocks of rows, so a block that follows no trajectory of its own
(rows skipped, copied or misplaced) fails too.  ``summary_gap`` (the mean's
and the covariance's gaps) holds the distribution.

The parameters are laid out as ``PosteriorDiffusionEstimator.init`` lays
them out.  The prior net is made from the seed: its hidden layers as
torch.nn.Linear initialises them, its output layer fitted by least squares
to the score of the diffused N(0, I / 3) at points of the prior's
diffusion, with inputs [z, t].  The likelihood net is drawn from the seed
and never read: guided sampling reads only ``params['prior']``.  The
reference (``reference/dps.py``) differentiates the likelihood by autograd.
"""

from __future__ import annotations

import math

import torch

from .. import common, flops_guided
from ..common import Check
from ..reference import dps as ref_dps, mlp as ref_mlp, scatterometry as ref_scat
from ..reference.precision import REFERENCE
from . import posterior
from .eval import gap_quantiles

BLOCKS = 8


def near_gaps(prog: torch.Tensor, ref: torch.Tensor) -> list:
    """Each of ``BLOCKS`` contiguous blocks of rows: the 1st percentile of a
    sample's distance from its reference sample, over the reference's RMS
    spread; inf where the shapes differ or a value is not finite."""
    if prog.shape != ref.shape or not bool(torch.isfinite(prog).all()):
        return [math.inf] * BLOCKS
    d = torch.linalg.norm(prog.double().to(ref.device) - ref.double(), dim=1)
    spread = float(torch.sqrt(torch.mean((ref.double() - ref.double().mean(0)) ** 2)))
    return [float(torch.quantile(part, 0.01)) / spread for part in d.chunk(BLOCKS)]


def fitted_prior(cell: common.Cell, n_fit: int = 32768):
    """The prior net's (W, b) pairs from the seed (see the module docstring)."""
    cfg = cell.config
    xdim = cfg["xdim"]
    layers = common.mlp_weights(cell.generator(0), [xdim + 1, *cfg["hidden_layers"], xdim])
    g = cell.generator(1)
    x = ref_scat.sample_prior(n_fit, g)
    t = 1e-3 + (1.0 - 1e-3) * torch.rand(n_fit, 1, generator=g, device=g.device)
    a, s = ref_mlp.alpha(t), ref_mlp.std(t)
    z = a * x + s * torch.randn(n_fit, xdim, generator=g, device=g.device)
    return common.fit_output_layer(layers, torch.cat([z, t], dim=1), -z / (a**2 / 3.0 + s**2))


class Driver(posterior.Driver):
    def __init__(self, cell: common.Cell, spans: common.Spans):
        super().__init__(cell, spans)
        if cell.config["guidance"] != "dps":
            raise NotImplementedError(f"the guided traffic counts the 'dps' guidance, not {cell.config['guidance']!r}")

    def setup(self) -> None:
        cfg, dev = self.cell.config, self.cell.device
        with self.spans.span("setup.program"):
            from dmip_tpu_torch.mains.eval_diffusion import analytic_row
            from dmip_tpu_torch.models.diffusion import PosteriorDiffusionEstimator
            from dmip_tpu_torch.problems import scatterometry

            base = PosteriorDiffusionEstimator(xdim=cfg["xdim"], ydim=cfg["ydim"],
                                               hidden_layers=tuple(cfg["hidden_layers"]))
            forward_model, fparams = scatterometry.load_forward_model(device=dev)
            self.model, _ = analytic_row(base, forward_model, fparams, cfg)
        with self.spans.span("setup.inputs"):
            self.surrogate = ref_scat.surrogate(common.ROOT, dev)
            dims = [self.surrogate[0][0].shape[0], *[w.shape[1] for w, _ in self.surrogate]]
            if dims != cfg["surrogate_layers"]:
                raise ValueError(f"the committed surrogate is {dims}, the configuration states {cfg['surrogate_layers']}")
            if (fparams["a"], fparams["b"]) != (cfg["a"], cfg["b"]):
                raise ValueError(f"the forward model's noise is {fparams}, the configuration states a, b = "
                                 f"{cfg['a']}, {cfg['b']}")
            likelihood = common.mlp_weights(self.cell.generator(4), common.net_dims(cfg))
            self.params = {"prior": fitted_prior(self.cell), "likelihood": likelihood}
            g = self.cell.generator(2)
            self.ys = ref_scat.noisy_forward(self.surrogate, ref_scat.sample_prior(int(self.cell.traffic["pool"]), g),
                                             g)
        with self.spans.span("setup.warmup"):
            self._request(-1)  # builds B5

    def flops_per_unit(self) -> dict:
        cfg = self.cell.config
        b5 = flops_guided.guided_launch(cfg["xdim"], cfg["hidden_layers"], cfg["surrogate_layers"], self.n,
                                        self.steps)
        return {"requests": b5, "b5_launch": b5}

    def details(self, prog: dict, ref: dict) -> dict:
        """Each block's ``near_gaps``, and the samples' gap quantiles (0.5,
        0.99, 0.999, 1) over the spread."""
        return {"near_gaps": [near_gaps(prog[r]["x"], ref[r]["x"]) for r in ref],
                "sample_quantiles": [gap_quantiles(prog[r]["x"], ref[r]["x"]) for r in ref]}

    def compare(self, prog: dict, ref: dict) -> list:
        """``near_gap``: the largest of the checked requests' ``near_gaps``;
        ``summary_gap``: the mean's and the covariance's gaps
        (``posterior.summary_rel``)."""
        lim, d = self.cell.limits, self.cell.config["xdim"]
        if not ref or set(prog) != set(ref):
            return [Check("near_gap", math.inf, lim["near_gap"]), Check("summary_gap", math.inf, lim["summary_gap"])]
        near = max(max(near_gaps(prog[r]["x"], ref[r]["x"])) for r in ref)
        summary_gap = max(posterior.summary_rel(prog[r]["summary"], ref[r]["summary"], d) for r in ref)
        return [Check("near_gap", near, lim["near_gap"]), Check("summary_gap", summary_gap, lim["summary_gap"])]

    def reference(self, precision=REFERENCE) -> dict:
        cfg, out, dev = self.cell.config, {}, self.cell.device
        for r in sorted(self.kept):
            x0, seed, noise = ref_mlp.sampler_draws(self._generator(r), self.n, cfg["xdim"])
            x = ref_dps.sample(self.params["prior"], self.surrogate, x0.to(dev), self._y(r), self.steps, seed,
                               precision, noise, a=cfg["a"], b=cfg["b"], clip=cfg["guidance_clip"])
            out[r] = {"x": x, "summary": posterior.summary(x.double()).cpu()}
        return out
