"""What every cell shares: the cell's files, seeds, weights made from the
seed, the host spans, and the comparison of a number with its limit."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


def load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it: its entry in BENCHMARK.json, its
    configuration and traffic files, the seed and the device."""

    name: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    limits: dict

    @classmethod
    def load(cls, name: str, seed: int, device, bench: Optional[dict] = None) -> "Cell":
        bench = bench or load_json("BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        traffic = load_json(os.path.join("portbench", "traffic", f"{w['traffic']}.json"))
        limits = load_json(os.path.join("portbench", "limits", f"{name}.json"))
        return cls(name, load_json(conf["file"]), traffic, int(seed), torch.device(device), limits)

    def generator(self, *stream: int) -> torch.Generator:
        """A generator on the cell's device for the sub-stream ``stream`` of
        the seed: the same seed and stream give the same numbers."""
        return torch.Generator(device=self.device).manual_seed(derive(self.seed, *stream))


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed from the run's seed and a stream of small integers."""
    h = int(seed) & (2**64 - 1)
    for s in stream:
        h = (h * 0x9E3779B97F4A7C15 + int(s) + 1) & (2**64 - 1)
        h ^= h >> 29
    return h & (2**63 - 1)


def mlp_weights(gen: torch.Generator, dims: Sequence[int]) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """An MLP's (W, b) pairs, W of shape (fan_in, fan_out), float32, drawn in
    one call on the generator's device: each entry uniform on
    [-1/sqrt(fan_in), 1/sqrt(fan_in)], torch.nn.Linear's default."""
    sizes = [(i, o) for i, o in zip(dims[:-1], dims[1:])]
    total = sum(i * o + o for i, o in sizes)
    u = torch.rand(total, generator=gen, device=gen.device) * 2.0 - 1.0
    out, k = [], 0
    for i, o in sizes:
        w = u[k:k + i * o].view(i, o) / math.sqrt(i)
        b = u[k + i * o:k + i * o + o] / math.sqrt(i)
        out.append((w, b))
        k += i * o + o
    return tuple(out)


RIDGE = 1e-4  # per row, on the features' Gram matrix


def fit_output_layer(layers, inputs: torch.Tensor, target: torch.Tensor):
    """``layers`` (an MLP's (W, b) pairs) with the output layer replaced by
    the ridge least-squares fit of ``target`` on the last hidden layer's
    tanh features of ``inputs``: random features, fitted in float64.  The
    ridge keeps the output weights as small as a trained net's (|W| ~ 50
    at 512 wide): a near-exact fit (|W| ~ 250) amplifies the bf16 rounding
    of the activations fivefold."""
    h = inputs
    for w, b in layers[:-1]:
        h = torch.tanh(h @ w + b)
    hb = torch.cat([h, torch.ones(h.shape[0], 1, device=h.device)], dim=1).double()
    gram = hb.T @ hb + RIDGE * h.shape[0] * torch.eye(hb.shape[1], device=h.device, dtype=torch.float64)
    sol = torch.linalg.solve(gram, hb.T @ target.double()).float()
    return (*layers[:-1], (sol[:-1].contiguous(), sol[-1].contiguous()))


def net_dims(config: dict) -> List[int]:
    return [config["xdim"] + config["ydim"] + 1, *config["hidden_layers"], config["xdim"]]


class Spans:
    """Host spans recorded by the benchmark around its calls into the
    program: (name, start, end) on the host clock, and, while a trace runs,
    a ``record_function`` of the same name so the trace can label idle
    gaps."""

    def __init__(self):
        self.rows: List[Tuple[str, float, float]] = []
        self.tracing = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.tracing:
            self.rf = torch.profiler.record_function(f"portbench.{self.name}")
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.rows.append((self.name, self.t0, t1))
        return False


@dataclasses.dataclass
class Check:
    """One number compared with its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(a: float, b: float, floor: float = 0.0) -> float:
    """|a - b| / max(|b|, floor); inf for a number that is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-30)


def leaf_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and the median leaf's."""
    pn = [float(torch.linalg.norm(p.double())) for p in prog]
    rn = [float(torch.linalg.norm(r.double())) for r in ref]
    med = sorted(rn)[len(rn) // 2]
    return [rel_gap(a, b, med) for a, b in zip(pn, rn)]


def leaf_norm_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                   keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's :func:`leaf_gaps`, leaves with ``keep`` False left out."""
    gaps = [g for k, g in enumerate(leaf_gaps(prog, ref)) if keep is None or keep[k]]
    return max(gaps) if gaps else math.inf
