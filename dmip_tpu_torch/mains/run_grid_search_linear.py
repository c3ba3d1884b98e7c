"""Grid search over the loss hyper-parameters, linear problem.

Port of ``mains/run_grid_search_linear.py``: the dataset and test
conditions of ``main_diffusion_linear``, then every trial of the config's
grid (``gridsearch.grid_search``).  Trials that differ only in lam / lam2
train together through the trial-stacked ensemble (``ensemble``; off with
``no_ensemble: true``, ``ensemble_backend`` 'auto', 'vmap' or 'pinned'); each trial
is scored against the analytic posterior through the model's sampler (on
the card the fused E-M kernel) on ``eval_n_repeats`` repeats of
``eval_num_steps`` steps, into ``<trial_dir>/results/results.csv``, and the
grid into ``<src_dir>/grid_summary.csv``.  ``skip_existing`` resumes trial
by trial.  Seeds follow ``main_diffusion_linear``: data ``random_state``,
init ``+ 1``, training ``+ 2``, evaluation ``+ 3``, so a trial is that
driver's run of the trial's config.  ``--host`` / ``--n_hosts`` keep the
trials whose index is ``host`` modulo ``n_hosts``.  Under ``torchrun
--nproc_per_node N`` the config's ``mesh`` (default ``auto``) spreads each
group's trials over the N ranks ('auto' is then 'pinned': one trial a
rank), trains single trials data-parallel and splits every evaluation's
conditions; rank 0 writes the tree.

Usage: python -m dmip_tpu_torch.mains.run_grid_search_linear \
          [--config configs/config_gridsearch_linear.yml] [--host 0 --n_hosts 1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import data, ensemble, evaluate, gridsearch, resolve_device, train
from ..problems import LinearForwardProblem
from ..utils import MetricsWriter, load_config
from .eval_diffusion import linear_split


def host_filter(host: int, n_hosts: int):
    """The trial filter of one host among ``n_hosts``, or None for one."""
    if n_hosts > 1:
        return lambda idx, cfg: idx % n_hosts == host
    return None


def run(config: dict, device=None, host: int = 0, n_hosts: int = 1) -> dict:
    """Run the grid; returns ``grid_search``'s result."""
    evaluate.require_plotting(config.get("plot_ys", ()))
    mesh = train.driver_mesh(config, device)
    dev = resolve_device(device)
    prob = LinearForwardProblem()
    seed = int(config.get("random_state", 7))
    x_train, _, y_train, y_test = linear_split(config, prob, dev)
    epc = int(config.get("epochs_per_call", 25))
    n_epochs = int(config["n_epochs"])

    def batch_fn(g):
        return data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(config["batch_size"]))

    def train_fn(model, loss_cfg, trial_cfg, train_dir, log_dir):
        loss_fn = model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior)
        params = model.init(torch.Generator().manual_seed(seed + 1), device=dev)
        optimizer = train.build_optimizer(float(config["lr"]), config.get("grad_clip"))
        epoch_fn = train.make_epoch_fn(loss_fn, optimizer, batch_fn, epochs_per_call=epc, mesh=mesh)
        with MetricsWriter(log_dir) as logger:
            params, _, _ = train.fit(epoch_fn, params, optimizer, seed + 2, num_epochs=n_epochs,
                                     epochs_per_call=epc, logger=logger, desc=os.path.basename(train_dir))
        return params

    def eval_fn(model, params, y_eval, out_dir):
        return evaluate.evaluate_linear(
            model, params, prob, y_eval, torch.Generator(device=dev).manual_seed(seed + 3),
            out_dir=out_dir, plot_ys=config.get("plot_ys", ()), n_samples_x=int(config["n_samples_x"]),
            n_repeats=int(config.get("eval_n_repeats", 10)), num_steps=int(config.get("eval_num_steps", 200)),
            chunk=int(config.get("eval_chunk", 0)) or None, mesh=mesh,
        )

    train_many = None
    if not config.get("no_ensemble"):
        train_many = ensemble.make_train_many(
            batch_fn, seed + 1, seed + 2, float(config["lr"]), n_epochs=n_epochs, epochs_per_call=epc,
            loss_kwargs={"initial_condition": prob.score_posterior}, grad_clip=config.get("grad_clip"),
            mesh=mesh, backend=str(config.get("ensemble_backend", "auto")), device=dev,
        )

    return gridsearch.grid_search(
        y_test[: int(config["n_samples_y"])], config, {"xdim": prob.xdim, "ydim": prob.ydim},
        train_fn, eval_fn, {}, {}, trial_filter=host_filter(host, n_hosts), train_many=train_many,
        skip_existing=bool(config.get("skip_existing", False)), device=dev,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_gridsearch_linear.yml")
    p.add_argument("--host", type=int, default=0)
    p.add_argument("--n_hosts", type=int, default=1)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(load_config(args.config), device=args.device, host=args.host, n_hosts=args.n_hosts)


if __name__ == "__main__":
    main()
