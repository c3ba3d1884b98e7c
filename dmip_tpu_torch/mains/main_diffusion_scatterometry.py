"""Scatterometry diffusion experiment: train a CDE, CDiffE or DPS model, checkpoint, evaluate.

Port of ``mains/main_diffusion_scatterometry.py``: every epoch draws a fresh
prior sample and simulates it through the surrogate (8 batches), the lr
optionally follows a cosine schedule over n_epochs x 8 steps, and the
trained net is evaluated against the MCMC ground truth written by
``generate_scatterometry_ground_truth`` for the same config, through the
config's ``eval_method`` for ``eval_num_steps`` steps, with the corner
plots of the conditions in ``plot_ys``.  A config with ``refine`` (the
grammar string or the dict form) also scores the energy-refined row,
refined on the surrogate posterior's energy, into ``out_dir + "_refined"``.

``model: Posterior`` trains the DPS model's {'prior', 'likelihood'} nets
with the PosteriorLoss through the surrogate (autograd engine), scores the
learned likelihood row (the plain scan unless ``eval_method`` names
another sampler) and, with ``eval_analytic_guidance``, re-serves the
trained prior net under analytic guidance (``guidance_clip``; the fused
guided kernel on the card, 200 steps whatever ``eval_method`` says, as in
the JAX driver) into ``out_dir + "_analytic"``.

Under ``torchrun --nproc_per_node N`` the config's ``mesh`` (default
``auto``) trains data-parallel over the N ranks and splits the evaluation's
conditions (and their ground truth) among them; rank 0 writes the logs,
the checkpoint and results.csv.

Usage: python -m dmip_tpu_torch.mains.main_diffusion_scatterometry \
          [--config configs/config_scatterometry.yml] [--gt_dir data/gt...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import checkpoints, data, evaluate, resolve_device, train
from ..models.refined import for_problem
from ..problems import scatterometry as scat
from ..utils import MetricsWriter, load_config, set_directories
from .eval_diffusion import analytic_row
from .generate_scatterometry_ground_truth import test_conditions


def run(config: dict, gt_dir: str, device=None) -> tuple:
    """Train and evaluate; returns (params, (KL, NLPD, score-MSE)) of the
    learned row."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    mesh = train.driver_mesh(config, device)
    dev = resolve_device(device)
    forward_model, fparams = scat.load_forward_model(device=dev)
    seed = int(config.get("RANDOM_STATE", 13))
    y_test = test_conditions(config, forward_model, fparams, dev)
    score_post = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])

    model, loss_cfg = train.get_model_from_args(config, fparams)
    loss_fn = model.make_loss_fn(loss_cfg, initial_condition=score_post, forward_model=forward_model,
                                 forward_params=fparams)
    params = model.init(torch.Generator().manual_seed(seed + 2), device=dev)
    train_seed = seed + 3

    resume = bool(config.get("resume_training", False))
    ckpt_dir = os.path.join(config["train_dir"], "checkpoint")
    n_epochs = int(config["n_epochs"])
    optimizer = train.build_optimizer(
        float(config.get("lr", 1e-4)), config.get("grad_clip"), schedule=config.get("lr_schedule"),
        decay_steps=n_epochs * data.SCATTEROMETRY_BATCHES_PER_EPOCH,
        lr_min_ratio=float(config.get("lr_min_ratio", 0.01)),
    )
    opt_state, start_epoch = None, 0
    if resume and os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        restored = checkpoints.load_checkpoint(ckpt_dir, params, optimizer.init(params), device=dev)
        params, opt_state = restored["params"], restored.get("opt_state")
        start_epoch = restored["step"]
        train_seed = restored.get("seed", train_seed)
        print(f"resumed from epoch {start_epoch}")

    log_dir = set_directories(config["train_dir"], config["out_dir"], resume)
    epc = int(config.get("epochs_per_call", 100))
    epoch_fn = train.select_epoch_fn(
        config, model, loss_fn, optimizer,
        lambda g: data.scatterometry_epoch_batches(
            g, forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"], int(config["batch_size"])),
        epochs_per_call=epc,
    )
    with MetricsWriter(log_dir) as logger:
        params, opt_state, _ = train.fit(
            epoch_fn, params, optimizer, train_seed, num_epochs=n_epochs, epochs_per_call=epc,
            logger=logger, desc="diffusion-scat", opt_state=opt_state, start_epoch=start_epoch,
        )
    checkpoints.save_checkpoint(ckpt_dir, params, opt_state=opt_state, step=n_epochs, seed=train_seed)

    def score(m, out_dir, plot_ys=(), method=str(config.get("eval_method", "auto")),
              num_steps=int(config.get("eval_num_steps", 200))):
        return evaluate.evaluate_scatterometry(
            m, params, forward_model, fparams, score_post, y_test, data.gt_loader(gt_dir),
            torch.Generator(device=dev).manual_seed(seed + 4), out_dir=out_dir,
            n_samples_x=int(config["n_samples_x"]), n_repeats=int(config.get("n_repeats", 10)),
            num_steps=num_steps, method=method, plot_ys=plot_ys, mesh=mesh,
        )

    metrics = score(model, config["out_dir"], config.get("plot_ys", ()))
    if config.get("refine"):
        refined, tag, suffix = for_problem("scatterometry", model, config["refine"], forward_model, fparams)
        kl, nlpd, mse = score(refined, config["out_dir"] + suffix)
        print(f"energy-refined ({tag}): KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}", flush=True)
    if config.get("eval_analytic_guidance") and config.get("model") == "Posterior":
        # sampled at the evaluation's defaults, as the JAX driver does: the
        # config's eval_method names the learned row's sampler
        guided, suffix = analytic_row(model, forward_model, fparams, config)
        kl, nlpd, mse = score(guided, config["out_dir"] + suffix, method="auto", num_steps=200)
        print(f"analytic-guidance DPS: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}", flush=True)
    return params, metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_scatterometry.yml")
    p.add_argument("--gt_dir", default="data/gt_samples_scatterometry")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    _, (kl, nlpd, mse) = run(load_config(args.config), args.gt_dir, device=args.device)
    print(f"final: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}")


if __name__ == "__main__":
    main()
