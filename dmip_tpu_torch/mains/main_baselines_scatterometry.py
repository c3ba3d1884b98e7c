"""Baselines driver, scatterometry: SNF vs diffusion (DSM) vs INN vs MCMC GT.

Port of ``mains/main_baselines_scatterometry.py``: trains the three models
through the autograd epoch engine, each epoch on a fresh prior sample
simulated through the surrogate (5 / 100 / 25 epochs a call), saves them
under ``train_dir`` as ``snf``, ``diffusion`` and ``INN``, and evaluates
them against the MCMC ground truth that
``generate_scatterometry_ground_truth`` wrote for the same conditions:
forward and reverse 75^3 histogram KL of each model, each sample set's
NLL under the posterior energy, the diffusion net's score-MSE at t = 0 and
the sliced W2 of each model against the ground truth (the same directions
for the three), into ``out_dir/results.csv`` with the JAX driver's
columns, and for each condition index in ``plot_ys`` the corner plots
``posterior-{true,snf,diffusion,inn}-<i>.svg`` of the last repeat's samples
(``true`` is the ground truth).  The diffusion row samples through the
config's ``eval_method`` ('auto': the fused E-M kernel on the card).

``--eval_only`` re-scores the checkpoints in ``train_dir`` without
training; it does not call ``set_directories``, so the training run's logs
and the previous results stay until the new results.csv replaces them.

Seeds, from ``RANDOM_STATE``: the test conditions as the ground-truth
driver draws them, the initial params ``+ 2``, the training epochs ``+ 3``,
the evaluation ``+ 4``.

Usage: python -m dmip_tpu_torch.mains.main_baselines_scatterometry \\
          [--config configs/config_baselines_scatterometry.yml] [--gt_dir data/gt...] \\
          [--eval_only] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch

from .. import data, evaluate, resolve_device
from ..problems import scatterometry as scat
from ..utils import load_config, set_directories
from .generate_scatterometry_ground_truth import test_conditions
from .main_baselines_linear import (PLOT_TAGS, build_models, init_params, load_params, sample_all, train_all,
                                    write_results)

COLUMNS = ("KL_SNF", "KL_SNF_reverse", "KL_diffusion", "KL_diffusion_reverse", "KL_INN", "KL_INN_reverse",
           "NLL_mcmc", "NLL_snf", "NLL_diffusion", "NLL_inn", "MSE", "W2_SNF", "W2_diffusion", "W2_INN")


@torch.no_grad()
def evaluate_all(config: dict, gt_dir: str, forward_model, fparams: dict, ys: torch.Tensor, models,
                 params: tuple, generator: Optional[torch.Generator], nbins: int = 75,
                 xlim: Tuple[float, float] = (-1.2, 1.2)) -> Dict[str, float]:
    """The JAX driver's protocol on ys's device; returns the column means."""
    n_x, n_repeats = int(config["n_samples_x"]), int(config.get("n_repeats", 10))
    method = str(config.get("eval_method", "auto"))
    a, b, lambd_bd = fparams["a"], fparams["b"], fparams["lambd_bd"]
    score_post = scat.score_posterior(forward_model, a, b, lambd_bd)
    diffusion, d_p = models[1][0], params[1]
    load_gt = data.gt_loader(gt_dir)
    rows = []
    for i in range(ys.shape[0]):
        y = ys[i]
        hists, stats = [0] * 4, []
        for j in range(n_repeats):
            x_true = torch.as_tensor(load_gt(i, j), dtype=torch.float32, device=ys.device)
            x_snf, x_diff, x_inn = sample_all(models, params, y, n_x, generator, method)
            ys_t = y.expand(x_true.shape[0], -1)
            mse = evaluate._score_mse(diffusion, d_p, x_true, ys_t, score_post(x_true, ys_t))
            samples = (x_true, x_snf, x_diff, x_inn)
            hists = [h + evaluate.histogramdd_flat(s, nbins, *xlim) for h, s in zip(hists, samples)]
            energy = lambda s: scat.get_log_posterior(s, forward_model, a, b, y.expand(s.shape[0], -1), lambd_bd)
            nlls = [torch.sum(energy(s)) / n_x for s in samples]
            n_w2 = min(n_x, x_true.shape[0])
            dirs = torch.randn(128, x_true.shape[1], generator=generator,
                               device=generator.device if generator is not None else ys.device).to(ys.device)
            w2s = [evaluate.sliced_w2(s[:n_w2], x_true[:n_w2], dirs=dirs) for s in samples[1:]]
            stats.append(torch.stack(nlls + [mse] + w2s))
        if i in config.get("plot_ys", ()):
            evaluate.plot_posteriors(config["out_dir"], i, dict(zip(PLOT_TAGS, samples)), nbins, xlim, [-1, 0, 1])
        kls = [float(v) for m in (1, 2, 3) for v in evaluate.kl_pair(hists[0], hists[m])]
        rows.append(dict(zip(COLUMNS, kls + torch.stack(stats).mean(0).tolist())))
        r = rows[-1]
        print(f"y {i + 1}/{ys.shape[0]} KL_SNF={r['KL_SNF']:.3f} KL_diffusion={r['KL_diffusion']:.3f} "
              f"KL_INN={r['KL_INN']:.3f}", flush=True)
    mean = write_results(config["out_dir"], rows)
    for k in ("KL_SNF", "KL_diffusion", "KL_INN", "W2_SNF", "W2_diffusion", "W2_INN"):
        print(f"{k}: {mean[k]}")
    return mean


def run(config: dict, gt_dir: str, eval_only: bool = False, device=None) -> Dict[str, float]:
    """Train the three models (or, with ``eval_only``, load them from
    ``train_dir``) and evaluate them; returns the column means."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    dev = resolve_device(device)
    forward_model, fparams = scat.load_forward_model(device=dev)
    a, b, lambd_bd = fparams["a"], fparams["b"], fparams["lambd_bd"]
    seed = int(config.get("RANDOM_STATE", 13))
    y_test = test_conditions(config, forward_model, fparams, dev)
    models = build_models(config, lambda x, ys: scat.get_log_posterior(x, forward_model, a, b, ys, lambd_bd),
                          fparams["xdim"], fparams["ydim"])
    params = init_params(models, seed + 2, dev)
    if eval_only:
        params = load_params(config["train_dir"], params, dev)
    else:
        log_dir = set_directories(config["train_dir"], config["out_dir"])
        batch_fn = lambda g: data.scatterometry_epoch_batches(g, forward_model, a, b, lambd_bd,
                                                              int(config["batch_size"]))
        params = train_all(config, models, params, batch_fn, seed + 3, log_dir, config["train_dir"],
                           dsm_epochs_per_call=100)
    return evaluate_all(config, gt_dir, forward_model, fparams, y_test, models, params,
                        torch.Generator(device=dev).manual_seed(seed + 4))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_baselines_scatterometry.yml")
    p.add_argument("--gt_dir", default="data/gt_samples_scatterometry")
    p.add_argument("--eval_only", action="store_true",
                   help="re-score the checkpoints in train_dir (skip the three training runs)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(load_config(args.config), args.gt_dir, eval_only=args.eval_only, device=args.device)


if __name__ == "__main__":
    main()
