"""Time the linear evaluation of two checkouts of the repository in turns.

    python -m dmip_tpu_torch.utils.compare_checkouts --other <checkout> [--device cuda]
        [--conditions 10] [--samples 30000] [--repeats 10] [--steps 200] [--calls 3]

Runs ``evaluate_linear`` of ``benchmarks/checkpoints/linear_refined_winner``
on the first ``--conditions`` linear test conditions from one seed, each run
in a process of its own with that checkout's package first on the path, in
the order other, this, this, other (so that a drift of the card's clock
falls on both alike).  Each process makes ``--calls`` calls (the first
pays the build and the first-call work) and writes its results.csv under
``--out_dir`` (default: ``runs/compare_checkouts`` in this checkout).  Prints a JSON line a run (its checkout and ms a condition
of each call) and last one JSON line: the runs, and whether the two
checkouts' results.csv are equal byte for byte.  Exits 1 if a run fails.
The other checkout needs ``evaluate_linear``, ``load_archived_params``,
``linear_test_conditions``, ``load_config`` and ``get_model_from_args``
with the signatures they have here.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# what each process runs, with its checkout's package
_RUN = r"""
import json, os, sys, time
import torch
from dmip_tpu_torch import evaluate, train
from dmip_tpu_torch.checkpoints import load_archived_params
from dmip_tpu_torch.mains.eval_diffusion import linear_test_conditions
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.utils import load_config

root, out_dir, device, n_y, n_x, repeats, steps, calls = sys.argv[1:9]
dev = torch.device(device)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = load_config(os.path.join(root, "configs", "config_linear.yml"))
prob = LinearForwardProblem()
model, _ = train.get_model_from_args(cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
params = load_archived_params(os.path.join(root, "benchmarks", "checkpoints", "linear_refined_winner"), device=dev)
ys = linear_test_conditions(cfg, prob, dev)[: int(n_y)]
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
ms = []
for _ in range(int(calls)):
    sync()
    t = time.perf_counter()
    evaluate.evaluate_linear(model, params, prob, ys, torch.Generator(device=dev).manual_seed(11), out_dir=out_dir,
                             n_samples_x=int(n_x), n_repeats=int(repeats), num_steps=int(steps), verbose=False)
    sync()
    ms.append(1e3 * (time.perf_counter() - t) / int(n_y))
print(json.dumps({"checkout": root, "ms_per_condition": ms}))
"""


def run(other: str, device: str = "cuda", conditions: int = 10, samples: int = 30000, repeats: int = 10,
        steps: int = 200, calls: int = 3, out_dir: str = None) -> dict:
    """The runs (other, this, this, other) and whether the two checkouts'
    rows are equal; raises RuntimeError if a run fails."""
    out_dir = out_dir or os.path.join(THIS, "runs", "compare_checkouts")
    trees = {"other": os.path.abspath(other), "this": THIS}
    runs = []
    for name in ("other", "this", "this", "other"):
        out = os.path.join(out_dir, name)
        args = [trees[name], out, device, conditions, samples, repeats, steps, calls]
        env = dict(os.environ, PYTHONPATH=trees[name])
        r = subprocess.run([sys.executable, "-c", _RUN, *map(str, args)], env=env, cwd=trees[name],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"the run of {trees[name]} failed:\n{r.stderr[-4000:]}")
        runs.append(dict(json.loads(r.stdout.strip().splitlines()[-1]), run=name))
        print(json.dumps(runs[-1]), flush=True)
    rows = [open(os.path.join(out_dir, name, "results.csv"), "rb").read() for name in ("other", "this")]
    return {"runs": runs, "rows_equal": rows[0] == rows[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="the other checkout's root")
    p.add_argument("--device", default="cuda")
    p.add_argument("--conditions", type=int, default=10)
    p.add_argument("--samples", type=int, default=30000)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--out_dir", default=None)
    a = p.parse_args(argv)
    try:
        res = run(a.other, a.device, a.conditions, a.samples, a.repeats, a.steps, a.calls, a.out_dir)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
