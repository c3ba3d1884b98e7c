"""Linear-problem diffusion experiment: train a CDE or CDiffE, checkpoint, evaluate.

Port of ``mains/main_diffusion_linear.py``: load the config, draw the
dataset, build the (model, loss) pair from the config keys, train with the
epoch engine of ``train_backend`` (``xla``: autograd; ``fused_pallas``: the
fused DSM training kernel), save the full training state, and evaluate
against the analytic posterior (KL / NLPD / score-MSE into results.csv,
the corner plots of the conditions in ``plot_ys``) through the model's
sampler: ``eval_method`` ('auto': the fused E-M kernel, B1 for the CDE, B4
for the CDiffE; or 'heun', 'expint...') for ``eval_num_steps`` steps.  A
config with ``refine`` (or ``--refine``) also scores the energy-refined
row, refined on the analytic posterior's energy, into ``out_dir +
"_refined_<tag>"``.  ``model: Posterior`` raises, as in the JAX package:
its PosteriorLoss needs a forward model, which the linear problem does not
hand it.

Under ``torchrun --nproc_per_node N`` the config's ``mesh`` (default
``auto``) trains data-parallel over the N ranks and splits the evaluation's
conditions among them; rank 0 writes the logs, the checkpoint and
results.csv.

Usage: python -m dmip_tpu_torch.mains.main_diffusion_linear \
          [--config configs/config_linear.yml] [--refine mh,20,0.2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import checkpoints, data, evaluate, resolve_device, train
from ..models.refined import for_problem
from ..problems import LinearForwardProblem
from ..utils import MetricsWriter, load_config, set_directories
from .eval_diffusion import linear_split


def run(config: dict, device=None) -> tuple:
    """Train and evaluate; returns (params, (KL, NLPD, score-MSE))."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    mesh = train.driver_mesh(config, device)
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

    def score(m, out_dir, plot_ys=()):
        return evaluate.evaluate_linear(
            m, params, prob, y_test[: int(config["n_samples_y"])],
            torch.Generator(device=dev).manual_seed(seed + 3), out_dir=out_dir,
            n_samples_x=int(config["n_samples_x"]), n_repeats=int(config.get("n_repeats", 10)),
            num_steps=int(config.get("eval_num_steps", 200)), method=str(config.get("eval_method", "auto")),
            plot_ys=plot_ys, mesh=mesh,
        )

    metrics = score(model, config["out_dir"], config.get("plot_ys", ()))
    if config.get("refine"):
        refined, tag, suffix = for_problem("linear", model, config["refine"])
        kl, nlpd, mse = score(refined, config["out_dir"] + suffix)
        print(f"refined[{tag}]: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}", flush=True)
    return params, metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_linear.yml")
    p.add_argument("--refine", default=None,
                   help="override the config's refine spec (models/refined grammar, e.g. mala,60,0.05)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    config = load_config(args.config)
    if args.refine is not None:
        config["refine"] = args.refine
    _, (kl, nlpd, mse) = run(config, device=args.device)
    print(f"final: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}")


if __name__ == "__main__":
    main()
