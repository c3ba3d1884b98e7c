"""Amortised inference as traffic: a closed loop of one client, each request
one posterior for the next observation of a pool, through the model's
sampler (``CDE.sample``), summarised on the card and read back.

A request hands over y and ends when its summary (the posterior mean and
covariance) is on the host; its latency is that time.  Traffic parameters:
``pool`` (observations drawn from the seed in set-up: x from the prior,
through the problem's forward model and noise), ``check_requests``
(requests the reference recomputes after the window, drawn from the seed
among the first ``check_within``), ``trace_units``.  The configuration
gives ``n_samples_x`` and ``eval_num_steps``.  Request r draws from its own
generator, seeded from (seed, r).

The net is made from the seed: its hidden layers as torch.nn.Linear
initialises them, its output layer fitted by least squares to g(t) times
the score of the diffused Gaussian with the prior's moments, N(0, I / 3),
at points of the prior's diffusion, so that its posteriors stay in the
prior's box [-1, 1]^3 as a trained net's do (with the initial weights they
grow e^5-fold over the 200 steps).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from .. import common, flops
from ..common import Check, derive
from ..reference import mlp as ref_mlp, scatterometry as ref_scat
from ..reference.precision import REFERENCE
from .eval import gap_quantiles


def summary(x: torch.Tensor) -> torch.Tensor:
    """The posterior mean and covariance, flattened: (d + d^2,)."""
    mean = x.mean(0)
    c = x - mean
    return torch.cat([mean, (c.T @ c / (x.shape[0] - 1)).reshape(-1)])


def fitted_net(cell: common.Cell, surrogate, n_fit: int = 32768):
    """The scatterometry CDE's net from the seed (see the module docstring)."""
    cfg = cell.config
    layers = common.mlp_weights(cell.generator(0), common.net_dims(cfg))
    g = cell.generator(1)
    x = ref_scat.sample_prior(n_fit, g)
    y = ref_scat.noisy_forward(surrogate, x, g)
    t = 1e-3 + (1.0 - 1e-3) * torch.rand(n_fit, 1, generator=g, device=g.device)
    a, s = ref_mlp.alpha(t), ref_mlp.std(t)
    z = a * x + s * torch.randn(n_fit, cfg["xdim"], generator=g, device=g.device)
    target = -ref_mlp.g(t) * z / (a**2 / 3.0 + s**2)
    return common.fit_output_layer(layers, torch.cat([z, y, t], dim=1), target)


class Driver:
    def __init__(self, cell: common.Cell, spans: common.Spans):
        self.cell, self.spans = cell, spans
        cfg = cell.config
        if cfg["problem"] != "scatterometry":
            raise NotImplementedError(f"the posterior traffic draws scatterometry observations, not {cfg['problem']!r}")
        self.n, self.steps = int(cfg["n_samples_x"]), int(cfg["eval_num_steps"])
        tr = cell.traffic
        self.to_check = sorted({derive(cell.seed, 6, i) % int(tr["check_within"])
                                for i in range(int(tr["check_requests"]))})
        self.latency, self.kept, self.summaries = [], {}, {}

    def setup(self) -> None:
        cfg, dev = self.cell.config, self.cell.device
        with self.spans.span("setup.program"):
            from dmip_tpu_torch.models.diffusion import CDE

            self.model = CDE(xdim=cfg["xdim"], ydim=cfg["ydim"], hidden_layers=tuple(cfg["hidden_layers"]))
        with self.spans.span("setup.inputs"):
            surrogate = ref_scat.surrogate(common.ROOT, dev)
            self.params = fitted_net(self.cell, surrogate)
            g = self.cell.generator(2)
            self.ys = ref_scat.noisy_forward(surrogate, ref_scat.sample_prior(int(self.cell.traffic["pool"]), g), g)
        with self.spans.span("setup.warmup"):
            self._request(-1)  # builds B1

    def _generator(self, r: int) -> torch.Generator:
        return self.cell.generator(3, r + 1)

    def _y(self, r: int) -> torch.Tensor:
        return self.ys[r % self.ys.shape[0]]

    def _request(self, r: int):
        t0 = time.perf_counter()
        with self.spans.span("request"):
            x = self.model.sample(self.params, self._y(r), self.n, self.steps, generator=self._generator(r),
                                  device=self.cell.device)
            s = summary(x).cpu()
        return time.perf_counter() - t0, x, s

    def window(self, seconds: float, tracer) -> dict:
        r, summaries, t0 = 0, [], time.perf_counter()
        while True:
            tracer.start(r)
            lat, x, s = self._request(r)
            tracer.count(r, requests=1)
            tracer.stop(r)
            self.latency.append(lat)
            summaries.append(s)
            if r in self.to_check:
                self.kept[r], self.summaries[r] = x, s
            r += 1
            t_end = time.perf_counter()
            if t_end - t0 - tracer.paused >= seconds:
                break
        failed = int((~torch.isfinite(torch.stack(summaries)).all(dim=1)).sum())
        p95 = statistics.quantiles(self.latency, n=20, method="inclusive")[-1] if len(self.latency) > 1 \
            else self.latency[0]
        return {"posterior_p95_ms": 1e3 * p95, "attempted": r, "failed": failed, "t_end": t_end}

    def flops_per_unit(self) -> dict:
        cfg = self.cell.config
        b1 = flops.sampler_launch(cfg["xdim"], cfg["ydim"], cfg["hidden_layers"], self.n, self.steps)
        return {"requests": b1, "b1_launch": b1}

    def free(self) -> None:
        del self.model
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self) -> dict:
        return {r: {"x": self.kept[r], "summary": self.summaries[r]} for r in sorted(self.kept)}

    def reference(self, precision=REFERENCE) -> dict:
        out, dev = {}, self.cell.device
        for r in sorted(self.kept):
            g = self._generator(r)
            x0, seed, noise = ref_mlp.sampler_draws(g, self.n, self.cell.config["xdim"])
            x = ref_mlp.sample(self.params, x0.to(dev), self._y(r), self.steps, seed, precision, noise)
            out[r] = {"x": x, "summary": summary(x.double()).cpu()}
        return out

    def details(self, prog: dict, ref: dict) -> dict:
        """The samples' gap quantiles (0.5, 0.99, 0.999, 1) over the spread."""
        return {"sample_quantiles": [gap_quantiles(prog[r]["x"], ref[r]["x"]) for r in ref]}

    def compare(self, prog: dict, ref: dict) -> list:
        """``sample_gap``: B1's samples against the reference's, the 99th
        percentile of a sample's distance over the reference's RMS spread;
        ``summary_gap``: the mean's and the covariance's gaps (``summary_rel``)."""
        lim = self.cell.limits
        if not ref or set(prog) != set(ref):
            return [Check("sample_gap", math.inf, lim["sample_gap"]), Check("summary_gap", math.inf, lim["summary_gap"])]
        sample_gap = max(gap_quantiles(prog[r]["x"], ref[r]["x"])[1] for r in ref)
        summary_gap = max(summary_rel(prog[r]["summary"], ref[r]["summary"], self.cell.config["xdim"]) for r in ref)
        return [Check("sample_gap", sample_gap, lim["sample_gap"]), Check("summary_gap", summary_gap, lim["summary_gap"])]


def summary_rel(prog: torch.Tensor, ref: torch.Tensor, d: int) -> float:
    """The mean's gap over the spread (sqrt of the covariance's trace), and
    the covariance's gap over its norm; the larger."""
    p, r = prog.double(), ref.double()
    cov_r = r[d:].view(d, d)
    spread = float(torch.sqrt(torch.trace(cov_r)))
    mean_gap = float(torch.linalg.norm(p[:d] - r[:d])) / spread
    cov_gap = float(torch.linalg.norm(p[d:] - r[d:])) / float(torch.linalg.norm(r[d:]))
    v = max(mean_gap, cov_gap)
    return v if math.isfinite(v) else math.inf
