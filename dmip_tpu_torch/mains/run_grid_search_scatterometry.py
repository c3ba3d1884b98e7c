"""Grid search over the loss hyper-parameters, scatterometry.

Port of ``mains/run_grid_search_scatterometry.py``: the test conditions
and score of ``main_diffusion_scatterometry``, then every trial of the
config's grid (``gridsearch.grid_search``), trained as in the linear grid
driver (``run_grid_search_linear``: the trial-stacked ensemble unless
``no_ensemble``) on fresh surrogate simulations each epoch, and scored
against the MCMC ground truth in ``--gt_dir`` (written by
``generate_scatterometry_ground_truth`` for the same ``RANDOM_STATE``),
kept on the device after its first load unless ``eval_gt_cache: false``.
Seeds follow ``main_diffusion_scatterometry``: conditions ``RANDOM_STATE``,
init ``+ 2``, training ``+ 3``, evaluation ``+ 4``.
Under ``torchrun --nproc_per_node N`` the config's ``mesh`` works as in
the linear grid driver; each rank loads the ground truth of its own
conditions only.

Usage: python -m dmip_tpu_torch.mains.run_grid_search_scatterometry \
          [--config configs/config_gridsearch_scatterometry.yml] \
          [--gt_dir data/gt_samples_scatterometry] [--host 0 --n_hosts 1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import data, ensemble, evaluate, gridsearch, resolve_device, train
from ..problems import scatterometry as scat
from ..utils import MetricsWriter, load_config
from .generate_scatterometry_ground_truth import test_conditions
from .run_grid_search_linear import host_filter


def run(config: dict, gt_dir: str, device=None, host: int = 0, n_hosts: int = 1) -> dict:
    """Run the grid; returns ``grid_search``'s result."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    mesh = train.driver_mesh(config, device)
    dev = resolve_device(device)
    forward_model, fparams = scat.load_forward_model(device=dev)
    seed = int(config.get("RANDOM_STATE", 13))
    y_test = test_conditions(config, forward_model, fparams, dev)
    score_post = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])
    loss_kwargs = {"initial_condition": score_post, "forward_model": forward_model, "forward_params": fparams}
    epc = int(config.get("epochs_per_call", 100))
    n_epochs = int(config["n_epochs"])

    def batch_fn(g):
        return data.scatterometry_epoch_batches(g, forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"],
                                                int(config["batch_size"]))

    def train_fn(model, loss_cfg, trial_cfg, train_dir, log_dir):
        loss_fn = model.make_loss_fn(loss_cfg, **loss_kwargs)
        params = model.init(torch.Generator().manual_seed(seed + 2), device=dev)
        optimizer = train.build_optimizer(float(config["lr"]), config.get("grad_clip"))
        epoch_fn = train.make_epoch_fn(loss_fn, optimizer, batch_fn, epochs_per_call=epc, mesh=mesh)
        with MetricsWriter(log_dir) as logger:
            params, _, _ = train.fit(epoch_fn, params, optimizer, seed + 3, num_epochs=n_epochs,
                                     epochs_per_call=epc, logger=logger, desc=os.path.basename(train_dir))
        return params

    gt_loader = (data.cached_gt_loader(gt_dir, device=dev) if config.get("eval_gt_cache", True)
                 else data.gt_loader(gt_dir))

    def eval_fn(model, params, y_eval, out_dir):
        return evaluate.evaluate_scatterometry(
            model, params, forward_model, fparams, score_post, y_eval, gt_loader,
            torch.Generator(device=dev).manual_seed(seed + 4), out_dir=out_dir,
            plot_ys=config.get("plot_ys", ()), n_samples_x=int(config["n_samples_x"]),
            # the selection protocol: fewer repeats rank trials at a fraction
            # of the full protocol's cost
            n_repeats=int(config.get("eval_n_repeats", 10)), num_steps=int(config.get("eval_num_steps", 200)),
            chunk=int(config.get("eval_chunk", 0)) or None, mesh=mesh,
        )

    train_many = None
    if not config.get("no_ensemble"):
        train_many = ensemble.make_train_many(
            batch_fn, seed + 2, seed + 3, float(config["lr"]), n_epochs=n_epochs, epochs_per_call=epc,
            loss_kwargs=loss_kwargs, grad_clip=config.get("grad_clip"),
            mesh=mesh, backend=str(config.get("ensemble_backend", "auto")), device=dev,
        )

    return gridsearch.grid_search(
        y_test, config, fparams, train_fn, eval_fn, {}, {}, trial_filter=host_filter(host, n_hosts),
        train_many=train_many, skip_existing=bool(config.get("skip_existing", False)), device=dev,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_gridsearch_scatterometry.yml")
    p.add_argument("--gt_dir", default="data/gt_samples_scatterometry")
    p.add_argument("--host", type=int, default=0)
    p.add_argument("--n_hosts", type=int, default=1)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(load_config(args.config), args.gt_dir, device=args.device, host=args.host, n_hosts=args.n_hosts)


if __name__ == "__main__":
    main()
