"""Run one cell of the benchmark of ``dmip_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  Set-up makes
the cell's weights and inputs from the seed and warms its shapes; the
window then runs whole units of the cell's traffic for ``--seconds``; the
reference then recomputes a sample of the window's outputs, drawn from the
seed, and judges them.  The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit), which the last lines of standard error repeat.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled part of the window.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the perf_counter clock (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

from portbench import common, drivers, trace  # noqa: E402
from portbench.metrics import reader  # noqa: E402
from portbench.reference.precision import REFERENCE  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dmip_tpu")


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced window's summary
    (``trace.reduce_events``), the traced units' work (``counted``), the
    work of the untraced units after the trace (``after``) and the host's
    seconds from the trace's stop to the window's end (``after_s``),
    operations a unit (``flops``), the traffic's kind and whether TF32
    matmuls were allowed."""

    summary: dict
    counted: dict
    after: dict
    after_s: float
    flops: dict
    kind: str
    tf32: bool


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def span_summary(spans: common.Spans) -> dict:
    """Each span's count and quantiles (0, 0.5, 0.95, 1) in ms, and its
    first 40 durations: how the window's units spread."""
    out = {}
    for name in sorted({n for n, _, _ in spans.rows}):
        d = [1e3 * (t1 - t0) for n, t0, t1 in spans.rows if n == name]
        s = sorted(d)
        out[name] = {"n": len(d), "q": [s[0], s[len(s) // 2], s[int(0.95 * (len(s) - 1))], s[-1]],
                     "first": [round(x, 3) for x in d[:40]]}
    return out


def cell_metrics(bench: dict, cell: str, section: str):
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def run(args, device="cuda", cell=None, bench=None) -> dict:
    """One run; returns the result line's object (without printing it)."""
    bench = bench or common.load_json("BENCHMARK.json")
    cell = cell or common.Cell.load(args.workload, args.seed, device, bench)
    spans = common.Spans()
    driver = drivers.load(cell.traffic["kind"])(cell, spans)
    on_card = cell.device.type == "cuda"
    if on_card:
        with spans.span("setup.cuda"):
            torch.cuda.init()
            torch.ones(1, device=cell.device).add_(1)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    if on_card:
        if args.trace:
            trace.warm_profiler()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    parts = {"start_and_torch_import": T_IMPORTED - T_START}
    parts.update({n: t1 - t0 for n, t0, t1 in spans.rows})
    print(f"setup parts (s): {json.dumps(parts)}", file=sys.stderr)
    spans.rows.clear()
    tracer = trace.Tracer(bool(args.trace) and on_card, range(*cell.traffic["trace_units"]), spans)
    window = driver.window(float(args.seconds), tracer)
    tracer.close()
    print(f"window spans (ms): {json.dumps(span_summary(spans))}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    driver.free()
    checks = driver.compare(driver.outputs(), driver.reference(REFERENCE))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run imported {found}: the benchmark measures dmip_tpu_torch alone")

    metrics = {}
    if not args.trace:
        for m in cell_metrics(bench, cell.name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else window.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        after_s = window["t_end"] - tracer.t_stop if tracer.t_stop is not None else 0.0
        r = Reading(tracer.summary, dict(tracer.counted), dict(tracer.after), after_s, driver.flops_per_unit(),
                    cell.traffic["kind"], tf32)
        for m in cell_metrics(bench, cell.name, "per_layer"):
            value = reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(c.ok for c in checks) and window["failed"] == 0, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if args.trace and tracer.summary is not None:
        dev["busy_s"], dev["window_s"] = tracer.summary["busy_s"], tracer.summary["window_s"]
        out["breakdown"] = {"device_ops": trace.top_device_ops(tracer.summary),
                            "idle_gaps": tracer.summary["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def _finite(v):
    """v with every number that is not finite (a gap that could not be
    computed) as null, so the line stays JSON."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = common.load_json("BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if work is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"{args.workload} needs {work['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    out = run(args, bench=bench)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(_finite(out), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
