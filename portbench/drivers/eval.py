"""The thesis's evaluation protocol as traffic: chunks of conditions through
the program's evaluation engine (``evaluate.make_eval_many_<problem>``),
each chunk queued whole and read once, as ``evaluate_linear`` walks them.

Traffic parameters: ``chunk`` (conditions a chunk), ``check_conditions``
(chunks the reference judges after the window: one condition of each in
full, every condition's statistics that read no model sample), ``trace_units``
([first, stop) chunks of the window that a traced run profiles).  The
configuration gives the sizes: ``n_samples_x``, ``n_repeats``,
``eval_num_steps``, ``nbins`` and the box ``xlim``; its ``n_samples_y``
conditions are drawn from the seed as the problem's test set is (x from
the prior, y = f(x)), and chunk k takes the next ``chunk`` of them in
turn.  Condition j of the window draws from its own generator, seeded from
(seed, j).

The net is made from the seed: its hidden layers as torch.nn.Linear
initialises them, its output layer fitted by least squares to g(t) times
the score of the diffused posterior at points of the diffusion, so that
its posteriors land in the histograms' box as a trained net's do.
"""

from __future__ import annotations

import math
import time

import torch

from .. import common, flops
from ..common import Check, derive
from ..reference import linear as ref_linear, mlp as ref_mlp
from ..reference.precision import REFERENCE

SCORES = ("nll_true", "mse_score")  # the statistics that read no model sample


def fitted_net(cell: common.Cell, n_fit: int = 32768):
    """The linear CDE's net from the seed (see the module docstring)."""
    cfg, dev = cell.config, cell.device
    layers = common.mlp_weights(cell.generator(0), common.net_dims(cfg))
    g = cell.generator(1)
    x = torch.randn(n_fit, cfg["xdim"], generator=g, device=dev)
    y = ref_linear.forward(x) + ref_linear.NOISE_STD * torch.randn(n_fit, cfg["ydim"], generator=g, device=dev)
    t = 1e-3 + (1.0 - 1e-3) * torch.rand(n_fit, 1, generator=g, device=dev)
    _, _, _, cov, chol, _, _ = ref_linear.constants(dev)
    m = ref_linear.posterior_mean(y)
    xp = m + torch.randn(n_fit, cfg["xdim"], generator=g, device=dev) @ chol.T
    a, s = ref_mlp.alpha(t), ref_mlp.std(t)
    z = a * xp + s * torch.randn(n_fit, cfg["xdim"], generator=g, device=dev)
    cov_t = (a**2)[:, :, None] * cov + (s**2)[:, :, None] * torch.eye(cfg["xdim"], device=dev)
    target = -ref_mlp.g(t) * torch.linalg.solve(cov_t, (z - a * m)[:, :, None])[:, :, 0]
    return common.fit_output_layer(layers, torch.cat([z, y, t], dim=1), target)


class Driver:
    def __init__(self, cell: common.Cell, spans: common.Spans):
        self.cell, self.spans = cell, spans
        cfg, tr = cell.config, cell.traffic
        if cfg["problem"] != "linear":
            raise NotImplementedError(f"the eval traffic drives the linear problem, not {cfg['problem']!r}")
        self.chunk = int(tr["chunk"])
        self.n, self.repeats = int(cfg["n_samples_x"]), int(cfg["n_repeats"])
        self.steps, self.nbins = int(cfg["eval_num_steps"]), int(cfg["nbins"])
        self.box = tuple(cfg["xlim"])
        self.rows, self.kept = {}, {}

    def setup(self) -> None:
        cfg, dev = self.cell.config, self.cell.device
        with self.spans.span("setup.program"):
            from dmip_tpu_torch import evaluate
            from dmip_tpu_torch.models.diffusion import CDE
            from dmip_tpu_torch.problems.linear import LinearForwardProblem

            model = CDE(xdim=cfg["xdim"], ydim=cfg["ydim"], hidden_layers=tuple(cfg["hidden_layers"]))
            self.engine = evaluate.make_eval_many_linear(model, LinearForwardProblem(), self.n, self.repeats,
                                                         self.steps, self.nbins, self.box)
            self.read = evaluate.read_stats
        with self.spans.span("setup.inputs"):
            self.params = fitted_net(self.cell)
            x = torch.randn(int(cfg["n_samples_y"]), cfg["xdim"], generator=self.cell.generator(2), device=dev)
            self.ys = ref_linear.forward(x)
        with self.spans.span("setup.warmup"):
            self._chunk(-1)  # the warm-up chunk: builds B1, its own conditions' streams

    def _conditions(self, k: int):
        return [k * self.chunk + i for i in range(self.chunk)]

    def _generator(self, j: int) -> torch.Generator:
        return self.cell.generator(3, j + 1)

    def _y(self, j: int) -> torch.Tensor:
        return self.ys[j % self.ys.shape[0]]

    def _chunk(self, k: int):
        conds = self._conditions(k)
        keep = derive(self.cell.seed, 4, k + 1) % self.chunk
        with self.spans.span("queue"):
            gens = [self._generator(j) for j in conds]
            ys = torch.stack([self._y(j) for j in conds])
            out = self.engine(self.params, gens, ys, keep=[keep])
        with self.spans.span("read"):
            rows = self.read(out)
        return rows, keep, out["samples"][keep]["x_pred_last"]

    def window(self, seconds: float, tracer) -> dict:
        k, t0 = 0, time.perf_counter()
        while True:
            tracer.start(k)
            rows, keep, x_last = self._chunk(k)
            t_end = time.perf_counter()
            tracer.count(k, conditions=self.chunk)
            tracer.stop(k)
            self.rows[k], self.kept[k] = rows, (keep, x_last)
            k += 1
            if t_end - t0 - tracer.paused >= seconds:
                break
        attempted = k * self.chunk
        failed = sum(1 for rows in self.rows.values() for r in rows if not all(map(math.isfinite, r)))
        return {"conditions_per_s": attempted / (t_end - t0), "attempted": attempted, "failed": failed,
                "t_end": t_end}

    def flops_per_unit(self) -> dict:
        cfg = self.cell.config
        cond = flops.linear_condition(cfg["xdim"], cfg["ydim"], cfg["hidden_layers"], self.n, self.steps,
                                      self.repeats)
        b1 = flops.sampler_launch(cfg["xdim"], cfg["ydim"], cfg["hidden_layers"], self.n, self.steps)
        return {"conditions": cond, "b1_launch": b1}

    def free(self) -> None:
        del self.engine
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self):
        """The (chunk, position) pairs the reference recomputes in full:
        chunks drawn from the seed among the window's, each its kept
        condition."""
        ks = sorted(self.rows)
        order = sorted(ks, key=lambda k: derive(self.cell.seed, 5, k))
        return [(k, self.kept[k][0]) for k in sorted(order[: int(self.cell.traffic["check_conditions"])])]

    def outputs(self) -> dict:
        full = {(k, i): {"stats": dict(zip(ref_linear.STATS, self.rows[k][i])), "x_last": self.kept[k][1]}
                for k, i in self.checked()}
        scores = {(k, i): {s: self.rows[k][i][ref_linear.STATS.index(s)] for s in SCORES}
                  for k, _ in self.checked() for i in range(self.chunk)}
        return {"full": full, "scores": scores}

    def reference(self, precision=REFERENCE) -> dict:
        """The checked chunks' conditions from their own generators: the kept
        one in full (the sampler, every statistic), the others' draws
        replayed in the program's order and only their sample-free
        statistics computed."""
        dev, xdim = self.cell.device, self.cell.config["xdim"]
        _, _, _, _, chol, _, _ = ref_linear.constants(dev)
        full, scores = {}, {}
        for k, kept in self.checked():
            for i, j in enumerate(self._conditions(k)):
                g, y = self._generator(j), self._y(j)
                hists_t, hists_m, rows, score_rows = [], [], [], []
                for _ in range(self.repeats):
                    x0, seed, noise = ref_mlp.sampler_draws(g, self.n, xdim)
                    if i == kept:
                        x_model = ref_mlp.sample(self.params, x0.to(dev), y, self.steps, seed, precision, noise)
                    elif noise is not None:
                        noise(0, self.steps)  # the plain sampler's normals, drawn and left
                    z = torch.randn(self.n, xdim, generator=g, device=g.device)
                    dirs = torch.randn(128, xdim, generator=g, device=g.device)
                    x_true = ref_linear.posterior_mean(y) + z.to(dev) @ chol.T
                    if i == kept:
                        h_t, h_m, row = ref_linear.repeat_stats(self.params, y, x_model, x_true, dirs.to(dev),
                                                                self.nbins, self.box, precision)
                        hists_t.append(h_t), hists_m.append(h_m), rows.append(row)
                        score_rows.append((row[0], row[2]))
                    else:
                        score_rows.append(ref_linear.score_stats(self.params, y, x_true, precision))
                scores[(k, i)] = {s: sum(r[n] for r in score_rows) / len(score_rows) for n, s in enumerate(SCORES)}
                if i == kept:
                    full[(k, i)] = {"stats": ref_linear.condition_stats(hists_t, hists_m, rows), "x_last": x_model}
        return {"full": full, "scores": scores}

    def details(self, prog: dict, ref: dict) -> dict:
        """Each statistic's largest relative gap and the reference's values
        (the kept conditions), the sample-free statistics' largest gaps over
        every checked condition, and the samples' gap quantiles (0.5, 0.99,
        0.999, 1) over the spread."""
        p, r = prog["full"], ref["full"]
        out = {s: [max(common.rel_gap(p[u]["stats"][s], r[u]["stats"][s]) for u in r),
                   [r[u]["stats"][s] for u in r]] for s in ref_linear.STATS}
        out["every_condition"] = {s: max(common.rel_gap(prog["scores"][u][s], ref["scores"][u][s])
                                         for u in ref["scores"]) for s in SCORES}
        out["sample_quantiles"] = [gap_quantiles(p[u]["x_last"], r[u]["x_last"]) for u in r]
        return out

    def compare(self, prog: dict, ref: dict) -> list:
        """``sample_gap``: B1's samples against the reference's, the 99th
        percentile of a sample's distance over the reference's RMS spread
        (a few trajectories in 10^4 may part ways under rounding, so not
        the largest or the RMS), over the kept conditions; ``kl_gap``: the
        statistics that read the samples (kl, kl_reverse, nll_model, w2) of
        the kept conditions; ``score_gap``: those that do not (nll_true,
        mse_score) of every condition of the checked chunks; each the
        largest relative gap."""
        lim = self.cell.limits
        p, r = prog["full"], ref["full"]
        if not r or set(p) != set(r) or set(prog["scores"]) != set(ref["scores"]):
            return [Check(k, math.inf, lim[k]) for k in ("sample_gap", "kl_gap", "score_gap")]
        sample_gap = max(gap_quantiles(p[u]["x_last"], r[u]["x_last"])[1] for u in r)
        kl_gap = max(common.rel_gap(p[u]["stats"][s], r[u]["stats"][s])
                     for u in r for s in ("kl", "kl_reverse", "nll_model", "w2"))
        score_gap = max(common.rel_gap(prog["scores"][u][s], ref["scores"][u][s]) for u in ref["scores"] for s in SCORES)
        return [Check("sample_gap", sample_gap, lim["sample_gap"]), Check("kl_gap", kl_gap, lim["kl_gap"]),
                Check("score_gap", score_gap, lim["score_gap"])]


def gap_quantiles(prog: torch.Tensor, ref: torch.Tensor) -> list:
    """Quantiles 0.5, 0.99, 0.999 and 1 of a sample's distance from its
    reference sample, over the reference's RMS spread; inf where the shapes
    differ or a value is not finite."""
    if prog.shape != ref.shape:
        return [math.inf] * 4
    d = torch.linalg.norm(prog.double().to(ref.device) - ref.double(), dim=1)
    spread = float(torch.sqrt(torch.mean((ref.double() - ref.double().mean(0)) ** 2)))
    q = torch.quantile(d, torch.tensor([0.5, 0.99, 0.999, 1.0], dtype=torch.float64, device=d.device))
    return [float(v) / spread if math.isfinite(float(v)) else math.inf for v in q]
