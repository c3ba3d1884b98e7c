"""The benchmark's cells cut to a size the CPU runs in seconds: the same
drivers, program paths (the plain PyTorch ones off the card) and
reference, with narrow nets, few samples and steps, and short epochs."""

from __future__ import annotations

import types

from portbench import common, run

TINY = {"hidden_layers": [32, 32, 32], "n_samples_x": 512, "n_repeats": 2, "eval_num_steps": 20,
        "n_samples_y": 7, "dataset_size": 4000, "batch_size": 200, "epochs_per_call": 2, "batches_per_epoch": 3}
TRAFFIC = {"eval": {"chunk": 2}, "posterior": {"check_within": 4}, "train": {}}
CELLS = ("linear_cde.eval", "scat_cde.posterior", "scat_cde.train", "linear_cde.train")


def tiny_cell(name: str, seed: int = 2**31 + 12345) -> common.Cell:
    cell = common.Cell.load(name, seed, "cpu")
    cell.config.update({k: v for k, v in TINY.items() if k in cell.config})
    cell.traffic.update(TRAFFIC[cell.traffic["kind"]])
    return cell


def tiny_run(name: str, seconds: float = 0.5, seed: int = 2**31 + 12345) -> dict:
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=seconds, trace=0)
    return run.run(args, device="cpu", cell=tiny_cell(name, seed))
