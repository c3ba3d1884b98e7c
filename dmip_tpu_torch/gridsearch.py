"""Hyper-parameter grid search and best-model selection.

Port of ``dmip_tpu/gridsearch.py``: the trial list is the Cartesian product
of ``config['params']`` (``utils.config.product_dict``) less the invalid
and duplicate combinations (:func:`should_skip`); trials that differ only
in lam / lam2 train together through ``train_many`` (the trial-stacked
ensemble, :mod:`dmip_tpu_torch.ensemble`), the others one by one through
``train``; every trial is evaluated into ``<trial_dir>/results/results.csv``
and the whole grid summarised in ``<src_dir>/grid_summary.csv``.
``skip_existing`` resumes a grid trial by trial.  Under a multi-rank run
every rank walks the same trials, the ensemble and the evaluation split
their work among the ranks, and rank 0 alone makes the directories and
writes the files (``parallel.is_writer``), so the tree is the one-process
tree.  The post-hoc walker
(:func:`traverse_subfolders`, :func:`main`) reads a results tree back and
names the best trials.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .parallel.mesh import is_writer
from .train import get_model_from_args
from .utils.config import product_dict, set_directories


def trial_dir(src_dir: str, cfg: Dict[str, Any], loss_name: str) -> str:
    """The trial's directory, its params encoded in the path."""
    if loss_name == "DSM_PDE":
        return os.path.join(
            src_dir, cfg["pde_loss"], "DSM_PDELoss", cfg["pde_metric"],
            "lam:{}".format(cfg["lam"]),
        )
    return os.path.join(
        src_dir, cfg["pde_loss"], loss_name, cfg["pde_metric"],
        cfg.get("ic_metric", "L1"),
        "lam:{}".format(cfg["lam"]), "lam2:{}".format(cfg["lam2"]),
    )


def should_skip(cfg: Dict[str, Any], already_visited: List[Tuple[Any, Any, Any]]) -> bool:
    """True for an invalid or a duplicate trial: cScoreFPE has no L1
    PDE-metric variant in the search, and DSM_PDE trials (which use neither
    lam2 nor ic_metric) are deduplicated by (lam, pde_metric, pde_loss),
    recorded in ``already_visited``."""
    if cfg.get("pde_metric") == "L1" and cfg.get("pde_loss") == "cScoreFPE":
        return True
    if cfg.get("loss_fn") == "DSM_PDE":
        sig = (cfg.get("lam"), cfg.get("pde_metric"), cfg.get("pde_loss"))
        if sig in already_visited:
            return True
        already_visited.append(sig)
    return False


def ensemble_signature(trial_cfg: Dict[str, Any]) -> Tuple:
    """Trials with equal signatures differ only in lam / lam2 and can train
    as one trial-stacked ensemble."""
    return tuple(sorted((k, repr(v)) for k, v in trial_cfg.items() if k not in ("lam", "lam2")))


def _metrics_from_results(path: str) -> Tuple[float, float, float]:
    """(KL, NLPD, score-MSE) of a finished trial's results.csv."""
    cols = _read_results_csv(path)
    kl = float(np.mean(cols["KL2"]))
    nll_true_col = next((c for c in ("NLL_true", "NLL_mcmc") if c in cols), None)
    nlpd = (float(np.mean(np.abs(cols["NLL_diffusion"] - cols[nll_true_col])))
            if nll_true_col and "NLL_diffusion" in cols else np.inf)
    fisher = float(np.mean(cols["MSE"])) if "MSE" in cols else np.inf
    return kl, nlpd, fisher


def grid_search(
    y_test,
    config: Dict[str, Any],
    forward_model_params: Dict[str, Any],
    train: Callable[..., Any],
    evaluate: Callable[..., Tuple[float, float, float]],
    train_args: Dict[str, Any],
    eval_args: Dict[str, Any],
    trial_filter: Optional[Callable[[int, Dict[str, Any]], bool]] = None,
    train_many: Optional[Callable[..., List[Any]]] = None,
    skip_existing: bool = False,
    device=None,
) -> Dict[str, Any]:
    """The Cartesian grid over config['params'], tracking the best trial by
    KL, NLPD and Fisher divergence (score-MSE).

    ``train(model, loss_cfg, trial_config, train_dir, log_dir, **train_args)
    -> params`` and ``evaluate(model, params, y_test, out_dir, **eval_args)
    -> (kl, nlpd, fisher)`` come from the driver.  ``trial_filter(index,
    config)`` keeps a host's share of the trials.

    ``train_many(model, loss_cfg, full_cfgs, train_dirs, log_dirs,
    **train_args) -> [params]``: when given, each group of two or more
    trials with one :func:`ensemble_signature` trains through it in one
    go; single trials fall back to ``train``.

    ``skip_existing``: a trial whose results.csv exists is neither trained
    nor evaluated again, and its metrics are read back; its directories are
    left as they are.  An ensemble group trains only its members with
    neither results nor a checkpoint; a trial with a checkpoint and no
    results is evaluated from the checkpoint, loaded onto ``device`` (the
    CPU when None).
    """
    already_visited: List[Tuple[Any, Any, Any]] = []
    best = {"kl": (np.inf, {}), "nlpd": (np.inf, {}), "fisher": (np.inf, {})}
    results = []

    # the trial list (skip rules, then the host filter), in order
    trials: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []
    for idx, trial_cfg in enumerate(product_dict(**config["params"])):
        full_cfg = {**config, **trial_cfg}
        if should_skip(full_cfg, already_visited):
            continue
        if trial_filter is not None and not trial_filter(idx, full_cfg):
            continue
        trials.append((trial_cfg, full_cfg))

    def tdir_of(full_cfg):
        return trial_dir(config["src_dir"], full_cfg, get_model_from_args(full_cfg, forward_model_params)[1].name)

    # phase 1 (optional): the groups that share a signature, as ensembles
    trained: Dict[int, Any] = {}
    if train_many is not None:
        groups: Dict[Tuple, List[int]] = {}
        for pos, (trial_cfg, _full) in enumerate(trials):
            groups.setdefault(ensemble_signature(trial_cfg), []).append(pos)
        for poss in groups.values():
            if len(poss) < 2:
                continue
            if skip_existing:
                def _done(p):
                    tdir = tdir_of(trials[p][1])
                    return (os.path.exists(os.path.join(tdir, "results", "results.csv"))
                            or os.path.exists(os.path.join(tdir, "checkpoint", "manifest.json")))

                poss = [p for p in poss if not _done(p)]
                if not poss:
                    continue
            full_cfgs = [trials[p][1] for p in poss]
            model, loss_cfg = get_model_from_args(full_cfgs[0], forward_model_params)
            tdirs, log_dirs = [], []
            for fc in full_cfgs:
                tdir = trial_dir(config["src_dir"], fc, loss_cfg.name)
                log_dirs.append(set_directories(tdir, os.path.join(tdir, "results")))
                tdirs.append(tdir)
            print("=================")
            print(f"ensemble of {len(poss)} trials: {[trials[p][0] for p in poss]}", flush=True)
            params_list = train_many(model, loss_cfg, full_cfgs, tdirs, log_dirs, **train_args)
            for p, params in zip(poss, params_list):
                trained[p] = params

    # phase 2: each trial trained (unless phase 1 did) and evaluated
    for pos, (trial_cfg, full_cfg) in enumerate(trials):
        model, loss_cfg = get_model_from_args(full_cfg, forward_model_params)
        tdir = trial_dir(config["src_dir"], full_cfg, loss_cfg.name)
        out_dir = os.path.join(tdir, "results")
        print("-----------------")
        print(trial_cfg, flush=True)

        existing = os.path.join(out_dir, "results.csv")
        if skip_existing and os.path.exists(existing):
            # no set_directories on this branch: it would wipe the results
            # being reused
            kl, nlpd, fisher = _metrics_from_results(existing)
            print(f"(existing results reused: KL={kl:.4f})", flush=True)
        else:
            log_dir = set_directories(tdir, out_dir)
            ckpt_dir = os.path.join(tdir, "checkpoint")
            if pos in trained:
                params = trained[pos]
            elif skip_existing and os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
                # crash-resume: trained by an earlier run, which died before
                # the evaluation
                from .checkpoints import load_checkpoint

                params = load_checkpoint(ckpt_dir, model.init(torch.Generator().manual_seed(0)), None,
                                         device=device)["params"]
                print("(checkpoint reused, eval only)", flush=True)
            else:
                params = train(model, loss_cfg, full_cfg, tdir, log_dir, **train_args)
            kl, nlpd, fisher = evaluate(model, params, y_test, out_dir, **eval_args)
        results.append({**trial_cfg, "kl": kl, "nlpd": nlpd, "fisher": fisher})

        for metric, val in (("kl", kl), ("nlpd", nlpd), ("fisher", fisher)):
            if val < best[metric][0]:
                best[metric] = (val, trial_cfg)

        print("---------------------------------")
        for metric, label in (("kl", "Best KL"), ("nlpd", "Best NLPD"), ("fisher", "Best Fisher divergence")):
            print(f"{label}: ", best[metric][0])
            print(best[metric][1])
            print("-------------------", flush=True)

    # one row per trial at the tree's root
    if results and is_writer():
        os.makedirs(config["src_dir"], exist_ok=True)
        with open(os.path.join(config["src_dir"], "grid_summary.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
            w.writeheader()
            w.writerows(results)

    return {"best_kl": best["kl"], "best_nlpd": best["nlpd"], "best_fisher": best["fisher"], "results": results}


# ---------------------------------------------------------------------------
# Post-hoc best-model walker
# ---------------------------------------------------------------------------


def get_params_from_path(path: str) -> Dict[str, Any]:
    """The hyper-params a :func:`trial_dir` path encodes (either layout)."""
    parts = path.replace("\\", "/").split("/")
    out: Dict[str, Any] = {}
    for p in parts:
        if p in ("FPE", "cScoreFPE"):
            out["pde_loss"] = p
        elif p in ("PINNLoss", "PINNLoss2", "DSM_PDELoss"):
            out["loss_fn"] = p
        elif p.startswith("lam:"):
            out["lam"] = float(p[4:])
        elif p.startswith("lam2:"):
            out["lam2"] = float(p[5:])
        elif p in ("L1", "L2"):
            # the first metric is pde_metric, the second ic_metric
            if "pde_metric" not in out:
                out["pde_metric"] = p
            else:
                out["ic_metric"] = p
    return out


def _read_results_csv(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        reader = csv.DictReader(f)
        cols: Dict[str, List[float]] = {}
        for row in reader:
            for k, v in row.items():
                if k in ("", None):
                    continue
                cols.setdefault(k, []).append(float(v))
    return {k: np.asarray(v) for k, v in cols.items()}


def traverse_subfolders(src_dir: str, exclude: Iterable[str] = ()) -> Dict[str, Any]:
    """Walk a results tree and report the best trials by mean KL, reverse
    KL, |NLL difference| and score-MSE: {metric: (value, {'path', params})}."""
    best = {"kl": (np.inf, None), "kl_reverse": (np.inf, None), "nll_diff": (np.inf, None), "mse": (np.inf, None)}
    for root, _dirs, files in os.walk(src_dir):
        if any(e and e in root for e in exclude):
            continue
        if "results.csv" not in files:
            continue
        cols = _read_results_csv(os.path.join(root, "results.csv"))
        entry = {"path": root, **get_params_from_path(os.path.relpath(root, src_dir))}
        if "KL2" in cols:
            m = float(np.mean(cols["KL2"]))
            if m < best["kl"][0]:
                best["kl"] = (m, entry)
        if "KL_reverse" in cols:
            m = float(np.mean(cols["KL_reverse"]))
            if m < best["kl_reverse"][0]:
                best["kl_reverse"] = (m, entry)
        nll_true_col = next((c for c in ("NLL_true", "NLL_mcmc") if c in cols), None)
        if nll_true_col and "NLL_diffusion" in cols:
            m = float(np.mean(np.abs(cols["NLL_diffusion"] - cols[nll_true_col])))
            if m < best["nll_diff"][0]:
                best["nll_diff"] = (m, entry)
        if "MSE" in cols:
            m = float(np.mean(cols["MSE"]))
            if m < best["mse"][0]:
                best["mse"] = (m, entry)
    return best


def main(argv=None) -> Dict[str, Any]:
    """CLI of the walker: ``--src_dir`` and ``--exclude`` (comma-separated
    substrings of paths to leave out); prints and returns the best trials."""
    import argparse

    p = argparse.ArgumentParser(description="Report the best trials of a grid-search results tree.")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--exclude", default="", help="comma-separated substrings")
    args = p.parse_args(argv)
    best = traverse_subfolders(args.src_dir, args.exclude.split(","))
    for metric, (val, entry) in best.items():
        print(f"best {metric}: {val}")
        print(f"  {entry}")
    return best
