"""Readings that the limits of ``correct`` are set from, for one cell, in one
process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 4

For each seed of ``--seeds``: set-up, a short window at the cell's own
load, and the numbers the run compares, the program against the
reference.  For each seed of ``--control-seeds``: the same numbers with
the control, the reference one precision lower, in the program's place;
for a training cell also the half-batch fault (the reference on half of
each batch) in its place.  One JSON line a reading on standard output.
Not part of a benchmark run.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import common, drivers, trace  # noqa: E402
from portbench.reference.precision import CONTROL, REFERENCE  # noqa: E402


def readings(name: str, seed: int, seconds: float, control: bool, device="cuda") -> list:
    """[(what, {check: value})] for one seed."""
    cell = common.Cell.load(name, seed, device)
    spans = common.Spans()
    driver = drivers.load(cell.traffic["kind"])(cell, spans)
    driver.setup()
    driver.window(seconds, trace.Tracer(False, range(0), spans))
    driver.free()
    ref = driver.reference(REFERENCE)
    value = lambda out: {c.name: c.value for c in driver.compare(out, ref)}
    rows = [("program", value(driver.outputs()))]
    if hasattr(driver, "details"):
        rows.append(("details", driver.details(driver.outputs(), ref)))
    if not control:
        return rows
    control_out = driver.reference(CONTROL)
    rows.append(("control", value(control_out)))
    if hasattr(driver, "details"):
        rows.append(("control_details", driver.details(control_out, ref)))
    if cell.traffic["kind"] == "train":
        rows.append(("half_batch", value(driver.reference(REFERENCE, batch_keep=driver.batch // 2))))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        for what, vals in readings(args.workload, seed, args.seconds, control):
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **vals,
                              "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
