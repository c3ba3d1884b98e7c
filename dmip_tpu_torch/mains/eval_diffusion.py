"""Evaluate a trained CDE checkpoint on the linear or scatterometry problem.

Serving-only driver: loads ``benchmarks/checkpoints/<name>/params.npz``
(written by the JAX package), builds the model from the YAML config, draws
the test conditions as the training drivers do, samples each posterior
with the fused E-M kernel and scores it.  Linear is scored against the
analytic posterior; scatterometry against the MCMC ground truth in
``--gt_dir`` (see ``generate_scatterometry_ground_truth``).

Usage: python -m dmip_tpu_torch.mains.eval_diffusion --problem linear \
          --checkpoint benchmarks/checkpoints/linear_refined_winner \
          [--config configs/config_linear.yml] [--n_samples_y N] [--device cuda|cpu]
       python -m dmip_tpu_torch.mains.eval_diffusion --problem scatterometry \
          --checkpoint benchmarks/checkpoints/cde_500k --gt_dir data/gt... \
          [--config configs/config_scatterometry.yml] [--n_samples_y N]
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from .. import data, evaluate, resolve_device, train
from ..checkpoints import load_archived_params
from ..problems import LinearForwardProblem
from ..problems import scatterometry as scat
from ..utils import load_config
from .generate_scatterometry_ground_truth import test_conditions

DEFAULT_CONFIGS = {
    "linear": "configs/config_linear.yml",
    "scatterometry": "configs/config_scatterometry.yml",
}


def _load_net(config: dict, dims: dict, checkpoint: str, dev):
    model, _ = train.get_model_from_args(config, dims)
    params = load_archived_params(checkpoint, device=dev)
    widths = [w.shape[1] for w, _ in params[:-1]]
    if params[0][0].shape[0] != model.net_in or list(model.hidden_layers) != widths:
        raise ValueError(
            f"{checkpoint}: net {params[0][0].shape[0]}->{widths} does not match the "
            f"config's {model.net_in}->{list(model.hidden_layers)}"
        )
    return model, params


def linear_split(config: dict, prob: LinearForwardProblem, device):
    """(x_train, x_test, y_train, y_test): the linear dataset drawn from a
    CPU generator seeded with ``random_state``, split as the training
    driver splits it."""
    dgen = torch.Generator().manual_seed(int(config.get("random_state", 7)))
    xs, ys = data.generate_dataset_linear(
        prob.xdim, prob.forward, int(config["dataset_size"]), dgen, device
    )
    return data.train_test_split(xs, ys, float(config["train_size"]), dgen)


def linear_test_conditions(config: dict, prob: LinearForwardProblem, device) -> torch.Tensor:
    """The linear test observations: the held-out split of ``linear_split``."""
    return linear_split(config, prob, device)[3]


def run(
    problem: str,
    checkpoint: str,
    config: dict,
    gt_dir: Optional[str] = None,
    device=None,
    out_dir: Optional[str] = None,
    method: Optional[str] = None,
) -> Tuple[float, float, float]:
    """Returns (mean KL, mean NLPD, mean score-MSE) over the conditions.
    ``method`` overrides the config's ``eval_method`` ('auto', 'kernel' or
    'plain')."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_x = int(config["n_samples_x"])
    n_repeats = int(config.get("n_repeats", 10))
    num_steps = int(config.get("eval_num_steps", 200))
    method = method or str(config.get("eval_method", "auto"))
    out_dir = out_dir or config.get("out_dir")
    if problem == "linear":
        prob = LinearForwardProblem()
        y_test = linear_test_conditions(config, prob, dev)
        model, params = _load_net(config, {"xdim": prob.xdim, "ydim": prob.ydim}, checkpoint, dev)
        return evaluate.evaluate_linear(
            model, params, prob, y_test[: int(config["n_samples_y"])], gen,
            out_dir=out_dir, n_samples_x=n_x, n_repeats=n_repeats,
            num_steps=num_steps, method=method,
        )
    if problem == "scatterometry":
        if gt_dir is None:
            raise ValueError("scatterometry evaluation needs --gt_dir")
        forward_model, fparams = scat.load_forward_model(device=dev)
        y_test = test_conditions(config, forward_model, fparams, dev)
        model, params = _load_net(config, fparams, checkpoint, dev)
        score_post = scat.score_posterior(
            forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"]
        )
        return evaluate.evaluate_scatterometry(
            model, params, forward_model, fparams, score_post, y_test,
            data.gt_loader(gt_dir), gen, out_dir=out_dir, n_samples_x=n_x,
            n_repeats=n_repeats, num_steps=num_steps, method=method,
        )
    raise ValueError(f"unknown problem {problem!r}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--problem", choices=sorted(DEFAULT_CONFIGS), required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--gt_dir", default=None)
    p.add_argument("--n_samples_y", type=int, default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    config = load_config(args.config or DEFAULT_CONFIGS[args.problem])
    if args.n_samples_y is not None:
        config["n_samples_y"] = args.n_samples_y
    kl, nlpd, mse = run(args.problem, args.checkpoint, config, args.gt_dir,
                        device=args.device, out_dir=args.out_dir)
    print(f"final: KL={kl:.4f} NLPD={nlpd:.4f} score-MSE={mse:.4f}")


if __name__ == "__main__":
    main()
