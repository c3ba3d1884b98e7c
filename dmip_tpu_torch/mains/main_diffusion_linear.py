"""Linear-problem diffusion experiment: train a CDE or CDiffE, checkpoint, evaluate.

Port of ``mains/main_diffusion_linear.py``: load the config, draw the
dataset, build the (model, loss) pair from the config keys, train with the
epoch engine of ``train_backend`` (``xla``: autograd; ``fused_pallas``: the
fused DSM training kernel), save the full training state, and evaluate
against the analytic posterior (KL / NLPD / score-MSE into results.csv)
through the model's fused E-M sampler (B1 for the CDE, B4 for the CDiffE).
``model: Posterior`` raises: its PosteriorLoss training is not ported.

Usage: python -m dmip_tpu_torch.mains.main_diffusion_linear \
          [--config configs/config_linear.yml] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import checkpoints, data, evaluate, resolve_device, train
from ..problems import LinearForwardProblem
from ..utils import MetricsWriter, load_config, set_directories
from .eval_diffusion import linear_split


def run(config: dict, device=None) -> tuple:
    """Train and evaluate; returns (params, (KL, NLPD, score-MSE))."""
    if config.get("refine"):
        raise NotImplementedError("refine is not ported yet; see ROADMAP.md §A item 8")
    dev = resolve_device(device)
    prob = LinearForwardProblem()
    seed = int(config.get("random_state", 7))
    x_train, _, y_train, y_test = linear_split(config, prob, dev)

    model, loss_cfg = train.get_model_from_args(config, {"xdim": prob.xdim, "ydim": prob.ydim})
    loss_fn = model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior)
    params = model.init(torch.Generator().manual_seed(seed + 1), device=dev)
    train_seed = seed + 2

    resume = bool(config.get("resume_training", False))
    ckpt_dir = os.path.join(config["train_dir"], "checkpoint")
    optimizer = train.build_optimizer(float(config["lr"]), config.get("grad_clip"))
    opt_state, start_epoch = None, 0
    if resume and os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        restored = checkpoints.load_checkpoint(ckpt_dir, params, optimizer.init(params), device=dev)
        params, opt_state = restored["params"], restored.get("opt_state")
        start_epoch = restored["step"]
        train_seed = restored.get("seed", train_seed)
        print(f"resumed from epoch {start_epoch}")

    log_dir = set_directories(config["train_dir"], config["out_dir"], resume)
    epc = int(config.get("epochs_per_call", 25))
    epoch_fn = train.select_epoch_fn(
        config, model, loss_fn, optimizer,
        lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(config["batch_size"])),
        epochs_per_call=epc,
    )
    n_epochs = int(config["n_epochs"])
    with MetricsWriter(log_dir) as logger:
        params, opt_state, _ = train.fit(
            epoch_fn, params, optimizer, train_seed, num_epochs=n_epochs, epochs_per_call=epc,
            logger=logger, desc="diffusion-linear", opt_state=opt_state, start_epoch=start_epoch,
        )
    checkpoints.save_checkpoint(ckpt_dir, params, opt_state=opt_state, step=n_epochs, seed=train_seed)

    metrics = evaluate.evaluate_linear(
        model, params, prob, y_test[: int(config["n_samples_y"])],
        torch.Generator(device=dev).manual_seed(seed + 3), out_dir=config["out_dir"],
        n_samples_x=int(config["n_samples_x"]), n_repeats=int(config.get("n_repeats", 10)),
        num_steps=int(config.get("eval_num_steps", 200)), method=str(config.get("eval_method", "auto")),
    )
    return params, metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_linear.yml")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    _, (kl, nlpd, mse) = run(load_config(args.config), device=args.device)
    print(f"final: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}")


if __name__ == "__main__":
    main()
