"""Time two checkouts of the repository in turns: the linear evaluation or
fused linear training.

    python -m dmip_tpu_torch.utils.compare_checkouts --other <checkout> [--device cuda]
        [--mode eval|train_fused] [--conditions 10] [--samples 30000] [--repeats 10] [--steps 200]
        [--epochs 300] [--calls 3]

``--mode eval`` (the default) runs ``evaluate_linear`` of
``benchmarks/checkpoints/linear_refined_winner`` on the first
``--conditions`` linear test conditions from one seed; ``--mode
train_fused`` trains ``configs/config_linear.yml``'s net (its widths,
batch, lr and data) with ``train_backend: fused_pallas``, ``loss_fn: DSM``
and ``epochs_per_call`` 25 through ``train.fit`` for ``--epochs`` epochs
from the driver's seeds.  Each run is a process of its own with that
checkout's package first on the path, in the order other, this, this,
other (so that a drift of the card's clock falls on both alike).  Each
process makes ``--calls`` calls (the first pays the build and the
first-call work) and prints a JSON line: its checkout and, a call, ms a
condition (eval; its results.csv goes under ``--out_dir``, default
``runs/compare_checkouts`` in this checkout) or seconds and the last
epoch's loss (train_fused).  Last comes one JSON line: the runs, and for
eval whether the two checkouts' results.csv are equal byte for byte.
Exits 1 if a run fails.  The other checkout needs ``evaluate_linear``,
``load_archived_params``, ``linear_test_conditions``, ``linear_split``,
``load_config``, ``get_model_from_args``, ``build_optimizer``,
``select_epoch_fn`` and ``fit`` with the signatures they have here.
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

# fused linear training, with the checkout's package
_TRAIN = r"""
import json, os, sys, time
import torch
from dmip_tpu_torch import data, train
from dmip_tpu_torch.mains.eval_diffusion import linear_split
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.utils import load_config

root, device, epochs, calls = sys.argv[1:5]
dev = torch.device(device)
cfg = dict(load_config(os.path.join(root, "configs", "config_linear.yml")), loss_fn="DSM",
           train_backend="fused_pallas", epochs_per_call=25)
prob = LinearForwardProblem()
seed = int(cfg["random_state"])
x_train, _, y_train, _ = linear_split(cfg, prob, dev)
model, _ = train.get_model_from_args(cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
opt = train.build_optimizer(float(cfg["lr"]))
fn = train.select_epoch_fn(cfg, model, None, opt,
                           lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std,
                                                               int(cfg["batch_size"])), 25)
p0 = model.init(torch.Generator().manual_seed(seed + 1), device=dev)
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


class Last:
    loss = None

    def scalar(self, tag, value, step):
        if tag == "Train/Loss":
            self.loss = value


seconds, losses = [], []
for _ in range(int(calls)):
    log = Last()
    sync()
    t = time.perf_counter()
    train.fit(fn, p0, opt, seed + 2, int(epochs), epochs_per_call=25, log_every=0, logger=log)
    sync()
    seconds.append(time.perf_counter() - t)
    losses.append(log.loss)
print(json.dumps({"checkout": root, "seconds": seconds, "last_loss": losses}))
"""


def _runs(trees: dict, args_of, script: str) -> list:
    """One process a run (other, this, this, other), each printing a JSON
    line; raises RuntimeError if one fails."""
    runs = []
    for name in ("other", "this", "this", "other"):
        env = dict(os.environ, PYTHONPATH=trees[name])
        r = subprocess.run([sys.executable, "-c", script, *map(str, args_of(name))], env=env, cwd=trees[name],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"the run of {trees[name]} failed:\n{r.stderr[-4000:]}")
        runs.append(dict(json.loads(r.stdout.strip().splitlines()[-1]), run=name))
        print(json.dumps(runs[-1]), flush=True)
    return runs


def run_train_fused(other: str, device: str = "cuda", epochs: int = 300, calls: int = 3) -> dict:
    """Fused linear training of both checkouts in turns (other, this, this,
    other): seconds a call of ``train.fit`` over ``epochs`` epochs; raises
    RuntimeError if a run fails."""
    trees = {"other": os.path.abspath(other), "this": THIS}
    return {"runs": _runs(trees, lambda name: [trees[name], device, epochs, calls], _TRAIN)}


def run(other: str, device: str = "cuda", conditions: int = 10, samples: int = 30000, repeats: int = 10,
        steps: int = 200, calls: int = 3, out_dir: str = None) -> dict:
    """The runs (other, this, this, other) and whether the two checkouts'
    rows are equal; raises RuntimeError if a run fails."""
    out_dir = out_dir or os.path.join(THIS, "runs", "compare_checkouts")
    trees = {"other": os.path.abspath(other), "this": THIS}
    args_of = lambda name: [trees[name], os.path.join(out_dir, name), device, conditions, samples, repeats, steps,
                            calls]
    runs = _runs(trees, args_of, _RUN)
    rows = [open(os.path.join(out_dir, name, "results.csv"), "rb").read() for name in ("other", "this")]
    return {"runs": runs, "rows_equal": rows[0] == rows[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="the other checkout's root")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mode", choices=("eval", "train_fused"), default="eval")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--conditions", type=int, default=10)
    p.add_argument("--samples", type=int, default=30000)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--out_dir", default=None)
    a = p.parse_args(argv)
    try:
        if a.mode == "train_fused":
            res = run_train_fused(a.other, a.device, a.epochs, a.calls)
        else:
            res = run(a.other, a.device, a.conditions, a.samples, a.repeats, a.steps, a.calls, a.out_dir)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
