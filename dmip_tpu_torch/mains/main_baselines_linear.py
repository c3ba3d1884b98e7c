"""Baselines driver, linear problem: SNF vs diffusion (DSM) vs INN.

Port of ``mains/main_baselines_linear.py``: trains the SNF, a DSM CDE and
the INN on the same data through the autograd epoch engine (the config's
epochs, ``lr`` for the SNF and the CDE, ``lr_INN`` for the INN, 5 / 25 / 25
epochs a call), saves each under ``train_dir`` as ``snf``, ``diffusion``
and ``INN``, and evaluates them side by side against the analytic
posterior: per condition, ``n_repeats`` x 30k samples of each, the 75^2
histogram KL of each model against the true posterior (KL1 SNF, KL2
diffusion, KL3 INN), each sample set's NLL under the true posterior, and
the diffusion net's score-MSE at t = 0, into ``out_dir/results.csv``, and
for each condition index in ``plot_ys`` the corner plots
``posterior-{true,snf,diffusion,inn}-<i>.svg`` of the last repeat's
samples.  The diffusion row samples through the config's ``eval_method``
('auto': the fused E-M kernel on the card).

Seeds, from ``random_state``: the data as the training drivers draw it,
the three models' initial params from one generator seeded ``+ 1``, the
training epochs ``+ 2`` (the three models see the same epoch batches),
the evaluation ``+ 3``.

Usage: python -m dmip_tpu_torch.mains.main_baselines_linear \\
          [--config configs/config_baselines_linear.yml] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import checkpoints, data, evaluate, flows, resolve_device, train
from ..problems import LinearForwardProblem
from ..utils import MetricsWriter, load_config, set_directories
from .eval_diffusion import linear_split

NAMES = ("snf", "diffusion", "INN")
PLOT_TAGS = ("true", "snf", "diffusion", "inn")  # the reference samples, then the three models
SNF_EPOCHS_PER_CALL = 5    # MCMC layers inside the loss
INN_EPOCHS_PER_CALL = 25
EVAL_STEPS = 200


def build_models(config: dict, energy_fn: Callable, xdim: int, ydim: int):
    """(snf, (diffusion, loss config), inn) from the config's keys; the SNF
    anneals to ``energy_fn(x, ys)``, the problem's negative log posterior."""
    n_layers, width = int(config["num_layers_INN"]), int(config["size_hidden_layers_INN"])
    snf = flows.create_snf(
        n_layers, width, energy_fn, metr_steps_per_block=int(config["metr_steps_per_block"]),
        dimension=xdim, dimension_condition=ydim, noise_std=float(config["noise_std"]),
    )
    diffusion = train.get_model_from_args({**config, "loss_fn": "DSM"}, {"xdim": xdim, "ydim": ydim})
    inn = flows.create_inn(n_layers, width, dimension=xdim, dimension_condition=ydim)
    return snf, diffusion, inn


def init_params(models, seed: int, device) -> tuple:
    """The three models' initial params, in order, from one CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    snf, (diffusion, _), inn = models
    return snf.init(gen, device), diffusion.init(gen, device), inn.init(gen, device)


def load_params(train_dir: str, like: tuple, device) -> tuple:
    """The three models' params from their checkpoints under ``train_dir``."""
    return tuple(checkpoints.load_checkpoint(os.path.join(train_dir, name), p, device=device)["params"]
                 for name, p in zip(NAMES, like))


def train_all(config: dict, models, params: tuple, batch_fn, seed: int, log_dir: str, save_dir: str,
              dsm_epochs_per_call: int) -> tuple:
    """Train SNF, diffusion and INN in turn through the autograd engine,
    logging every epoch's loss to ``log_dir``, and save each to
    ``save_dir/<name>``.  Returns the trained params."""
    snf, (diffusion, loss_cfg), inn = models
    runs = (
        (float(config["lr"]), flows.snf_loss_fn(snf), int(config["n_epochs_SNF"]), SNF_EPOCHS_PER_CALL),
        (float(config["lr"]), diffusion.make_loss_fn(loss_cfg), int(config["n_epochs_dsm"]), dsm_epochs_per_call),
        (float(config["lr_INN"]), flows.inn_loss_fn(inn), int(config["n_epochs_INN"]), INN_EPOCHS_PER_CALL),
    )
    trained = []
    with MetricsWriter(log_dir) as logger:
        for name, p, (lr, loss_fn, n_epochs, epc) in zip(NAMES, params, runs):
            optimizer = train.build_optimizer(lr)
            epoch_fn = train.make_epoch_fn(loss_fn, optimizer, batch_fn, epochs_per_call=epc)
            p, _, _ = train.fit(epoch_fn, p, optimizer, seed, num_epochs=n_epochs, epochs_per_call=epc,
                                logger=logger, desc=name.lower())
            checkpoints.save_checkpoint(os.path.join(save_dir, name), p)
            trained.append(p)
    return tuple(trained)


def sample_all(models, params: tuple, y: torch.Tensor, n: int, generator, method: str):
    """(SNF, diffusion, INN) posterior samples given y, in that order of
    draws; the diffusion row through ``method``."""
    snf, (diffusion, _), inn = models
    snf_p, d_p, inn_p = params
    x_diff = diffusion.sample(d_p, y, n, EVAL_STEPS, generator=generator, device=y.device, method=method)
    return snf.sample(snf_p, y, n, generator), x_diff, inn.sample(inn_p, y, n, generator)


def write_results(out_dir: str, rows: list) -> Dict[str, float]:
    """results.csv (one row per condition) and the column means."""
    evaluate._write_results_csv(os.path.join(out_dir, "results.csv"), {k: [r[k] for r in rows] for k in rows[0]})
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


@torch.no_grad()
def evaluate_all(config: dict, prob: LinearForwardProblem, models, params: tuple, ys: torch.Tensor,
                 generator: Optional[torch.Generator], out_dir: str, nbins: int = 75,
                 xlim: Tuple[float, float] = (-3.5, 3.5)) -> Dict[str, float]:
    """The JAX driver's protocol on ys's device; returns the column means."""
    n_x, n_repeats = int(config["n_samples_x"]), int(config.get("n_repeats", 10))
    method = str(config.get("eval_method", "auto"))
    diffusion, d_p = models[1][0], params[1]
    rows = []
    for i in range(ys.shape[0]):
        y = ys[i]
        hists, stats = [0] * 4, []
        for _ in range(n_repeats):
            x_true = prob.sample_posterior(y, n_x, generator)
            x_snf, x_diff, x_inn = sample_all(models, params, y, n_x, generator, method)
            ys_t = y.expand(n_x, -1)
            mse = evaluate._score_mse(diffusion, d_p, x_true, ys_t, prob.score_posterior(x_true, ys_t))
            samples = (x_true, x_snf, x_diff, x_inn)
            hists = [h + evaluate.histogramdd_flat(s, nbins, *xlim) for h, s in zip(hists, samples)]
            stats.append(torch.stack([-torch.mean(prob.posterior_log_prob(s, y)) for s in samples] + [mse]))
        if i in config.get("plot_ys", ()):
            evaluate.plot_posteriors(out_dir, i, dict(zip(PLOT_TAGS, samples)), nbins, xlim, list(xlim),
                                     show_mean=True)
        kls = [float(evaluate.kl_pair(hists[0], hists[m])[0]) for m in (1, 2, 3)]
        nlls_mse = torch.stack(stats).mean(0).tolist()
        rows.append(dict(zip(("KL1", "KL2", "KL3", "NLL_true", "NLL_snf", "NLL_diffusion", "NLL_inn", "MSE"),
                             kls + nlls_mse)))
        print(f"y {i + 1}/{ys.shape[0]} KL snf={kls[0]:.3f} diff={kls[1]:.3f} inn={kls[2]:.3f}", flush=True)
    mean = write_results(out_dir, rows)
    print("means:", mean)
    return mean


def run(config: dict, device=None) -> Dict[str, float]:
    """Train the three models and evaluate them; returns the column means."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    dev = resolve_device(device)
    prob = LinearForwardProblem()
    seed = int(config.get("random_state", 7))
    x_train, _, y_train, y_test = linear_split(config, prob, dev)
    models = build_models(config, lambda x, ys: prob.log_posterior(x, ys)[:, 0], prob.xdim, prob.ydim)
    params = init_params(models, seed + 1, dev)
    log_dir = set_directories(config["train_dir"], config["out_dir"])
    batch_fn = lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(config["batch_size"]))
    params = train_all(config, models, params, batch_fn, seed + 2, log_dir, config["train_dir"],
                       dsm_epochs_per_call=25)
    return evaluate_all(config, prob, models, params, y_test[: int(config["n_samples_y"])],
                        torch.Generator(device=dev).manual_seed(seed + 3), config["out_dir"])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_baselines_linear.yml")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
