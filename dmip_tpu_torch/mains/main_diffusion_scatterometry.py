"""Scatterometry diffusion experiment: train a CDE or CDiffE, checkpoint, evaluate.

Port of ``mains/main_diffusion_scatterometry.py``: every epoch draws a fresh
prior sample and simulates it through the surrogate (8 batches), the lr
optionally follows a cosine schedule over n_epochs x 8 steps, and the
trained net is evaluated against the MCMC ground truth written by
``generate_scatterometry_ground_truth`` for the same config.

Usage: python -m dmip_tpu_torch.mains.main_diffusion_scatterometry \
          [--config configs/config_scatterometry.yml] [--gt_dir data/gt...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import checkpoints, data, evaluate, resolve_device, train
from ..problems import scatterometry as scat
from ..utils import MetricsWriter, load_config, set_directories
from .generate_scatterometry_ground_truth import test_conditions


def run(config: dict, gt_dir: str, device=None) -> tuple:
    """Train and evaluate; returns (params, (KL, NLPD, score-MSE))."""
    if config.get("refine"):
        raise NotImplementedError("refine is not ported yet; see ROADMAP.md §A item 8")
    if config.get("model") == "Posterior":
        raise NotImplementedError(
            "training the Posterior model (PosteriorLoss) is not ported yet: the optimizer and the "
            "checkpoints take a tuple of (W, b) pairs, not its {'prior', 'likelihood'} dict; see "
            "ROADMAP.md §A item 11.  A trained checkpoint (e.g. benchmarks/checkpoints/dps_prior) "
            "is served, with analytic guidance, by dmip_tpu_torch.mains.eval_diffusion"
        )
    dev = resolve_device(device)
    forward_model, fparams = scat.load_forward_model(device=dev)
    seed = int(config.get("RANDOM_STATE", 13))
    y_test = test_conditions(config, forward_model, fparams, dev)
    score_post = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])

    model, loss_cfg = train.get_model_from_args(config, fparams)
    loss_fn = model.make_loss_fn(loss_cfg, initial_condition=score_post)
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

    metrics = evaluate.evaluate_scatterometry(
        model, params, forward_model, fparams, score_post, y_test, data.gt_loader(gt_dir),
        torch.Generator(device=dev).manual_seed(seed + 4), out_dir=config["out_dir"],
        n_samples_x=int(config["n_samples_x"]), n_repeats=int(config.get("n_repeats", 10)),
        num_steps=int(config.get("eval_num_steps", 200)), method=str(config.get("eval_method", "auto")),
    )
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
