"""Ground-truth MCMC samples for the scatterometry test conditions.

Port of ``mains/generate_scatterometry_ground_truth.py``: for each of the
``n_samples_y`` test conditions, run ``METR_STEPS`` Metropolis steps on
``n_repeats`` x ``n_samples_x`` chains annealing to the posterior energy,
and save each repeat as ``<gt_dir>/<i>/<j>.npy``.  All of a condition's
chains (every repeat) go through one launch of the fused MH kernel.

``--mcmc_seed`` draws fresh chains for the same conditions: held-out
ground truth, to check that a knob chosen against the default set is not
fit to its noise.  Each condition index in the config's ``plot_ys`` (or
``plot_y``) also gets ``<gt_dir>/<i>/posterior-mcmc-<i>.svg``, the corner
plot of its last repeat; ``plot_ys: []`` draws none.

Under ``torchrun --nproc_per_node N`` the config's ``mesh`` (default
``auto``), as in every driver, shards each condition's chains over the N
ranks: every rank draws the condition's starting points and kernel seed as
one process does, runs its block of the chains with the seed folded with
its rank (as the JAX driver folds the axis index), and rank 0 gathers the
chains in rank order and writes them.  ``--devices N`` (the JAX driver's
flag) is a check: the run fails unless the world has N ranks (0 or -1:
whatever it has).

Usage: python -m dmip_tpu_torch.mains.generate_scatterometry_ground_truth \
          [--config configs/config_scatterometry.yml] [--gt_dir data/gt...] \
          [--n_samples_y N] [--mcmc_seed S] [--devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import data, evaluate, resolve_device, train
from ..ops.mh_kernel import fused_mh_scatterometry
from ..parallel.mesh import barrier, fold_in, is_writer, pad_to_multiple
from ..problems import scatterometry as scat
from ..utils import load_config


def test_conditions(config: dict, forward_model, fparams, device) -> torch.Tensor:
    """The ``n_samples_y`` scatterometry test observations (n, 23), drawn
    from a CPU generator seeded with ``RANDOM_STATE``, so the ground-truth
    generator and the evaluation driver see the same conditions."""
    gen = torch.Generator().manual_seed(int(config.get("RANDOM_STATE", 13)))
    _, y_test = data.generate_dataset_scatterometry(
        forward_model, fparams["a"], fparams["b"], size=int(config["n_samples_y"]),
        generator=gen, device=device,
    )
    return y_test


def gt_mesh(devices=None, mesh="auto"):
    """The mesh the chains shard over, ``train.resolve_mesh(mesh)``.
    ``devices``, when given, must be its number of ranks (0 and -1: any)."""
    mesh = train.resolve_mesh(mesh)
    world = 1 if mesh is None else mesh.size
    if devices not in (None, 0, -1) and int(devices) != world:
        raise ValueError(f"--devices {devices} needs a world of {devices} ranks (torchrun --nproc_per_node "
                         f"{devices}); this one has {world}")
    return mesh


def run(config: dict, gt_dir: str, device=None, mcmc_seed=None, devices=None) -> None:
    """Writes the ground truth of every test condition.  The chains draw
    from a generator seeded with ``RANDOM_STATE + 1``, or with
    ``mcmc_seed`` when given; the conditions do not change with it.
    ``devices``: the number of ranks the run must have (see the module
    docstring)."""
    plot_ys = config.get("plot_ys", config.get("plot_y", ()))
    evaluate.require_plotting(plot_ys)
    mesh = gt_mesh(devices, train.driver_mesh(config, device))
    dev = resolve_device(device)
    forward_model, fparams = scat.load_forward_model(device=dev)
    y_test = test_conditions(config, forward_model, fparams, dev)
    # chains draw from their own stream, apart from the conditions'
    chain_seed = int(config.get("RANDOM_STATE", 13)) + 1 if mcmc_seed is None else int(mcmc_seed)
    gen = torch.Generator().manual_seed(chain_seed)
    n_repeats = int(config.get("n_repeats", 10))
    n_x = int(config["n_samples_x"])
    for i in range(y_test.shape[0]):
        x0 = torch.rand(n_repeats * n_x, 3, generator=gen) * 2.0 - 1.0
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        if mesh is not None:
            # padding chains start at 0 and are dropped after the gather
            x0 = mesh.local(pad_to_multiple(x0, mesh.size)[0])
            seed = fold_in(seed, mesh.rank)
        x = fused_mh_scatterometry(
            forward_model.weights, x0.to(dev), y_test[i], int(config["METR_STEPS"]),
            noise_std=float(config["NOISE_STD_MCMC"]), a=fparams["a"], b=fparams["b"],
            lambd_bd=fparams["lambd_bd"], seed=seed,
        )
        if mesh is not None:
            x = mesh.all_gather(x)[: n_repeats * n_x]
        if is_writer():
            x = x.reshape(n_repeats, n_x, 3).cpu()
            out_dir = os.path.join(gt_dir, str(i))
            os.makedirs(out_dir, exist_ok=True)
            for j in range(n_repeats):
                np.save(os.path.join(out_dir, f"{j}.npy"), x[j].numpy())
            if i in plot_ys:
                evaluate.plot_posteriors(out_dir, i, {"mcmc": x[-1]}, 75, (-1.2, 1.2), [-1, 0, 1])
        print(f"gt {i + 1}/{y_test.shape[0]} done", flush=True)
    barrier(mesh)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config_scatterometry.yml")
    p.add_argument("--gt_dir", default="data/gt_samples_scatterometry")
    p.add_argument("--n_samples_y", type=int, default=None,
                   help="draw N conditions instead of the config's n_samples_y (the conditions depend on N, "
                        "so use the n_samples_y of the config that will be evaluated)")
    p.add_argument("--mcmc_seed", type=int, default=None,
                   help="fresh-seed GT: same conditions, independent chains")
    p.add_argument("--devices", type=int, default=None,
                   help="the number of ranks the chains shard over: fail unless the world has it (0 or -1: any)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    config = load_config(args.config)
    if args.n_samples_y is not None:
        config["n_samples_y"] = args.n_samples_y
    run(config, args.gt_dir, device=args.device, mcmc_seed=args.mcmc_seed, devices=args.devices)


if __name__ == "__main__":
    main()
