"""Evaluate a trained checkpoint on the linear or scatterometry problem.

Serving-only driver: loads ``benchmarks/checkpoints/<name>/params.npz``
(written by the JAX package), builds the model from the YAML config, draws
the test conditions as the training drivers do, samples each posterior
with the model's fused kernel and scores it.  Linear is scored against the
analytic posterior; scatterometry against the MCMC ground truth in
``--gt_dir`` (see ``generate_scatterometry_ground_truth``).

The config's ``model`` picks the net: ``CDE`` (kernel B1), ``CDiffE``
(B4), or ``Posterior`` (a {'prior', 'likelihood'} checkpoint).  A Posterior
config with ``eval_analytic_guidance: True`` (scatterometry) evaluates the
prior net under analytic DPS guidance through the surrogate, with the
config's ``guidance_clip`` (kernel B5), and writes to ``out_dir +
"_analytic"``; without it the learned likelihood net is sampled by the
plain scan.

Usage: python -m dmip_tpu_torch.mains.eval_diffusion --problem linear \
          --checkpoint benchmarks/checkpoints/linear_refined_winner \
          [--config configs/config_linear.yml] [--n_samples_y N] [--device cuda|cpu]
       python -m dmip_tpu_torch.mains.eval_diffusion --problem scatterometry \
          --checkpoint benchmarks/checkpoints/cde_500k --gt_dir data/gt... \
          [--config configs/config_scatterometry.yml] [--n_samples_y N]
       (--checkpoint benchmarks/checkpoints/cdiffe_scat --config configs/config_scatterometry_cdiffe.yml,
        --checkpoint benchmarks/checkpoints/dps_prior --config configs/config_scatterometry_dps.yml)
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from .. import data, evaluate, resolve_device, train
from ..checkpoints import load_archived_params
from ..models import AnalyticGuidanceDPS, PosteriorDiffusionEstimator
from ..problems import LinearForwardProblem
from ..problems import scatterometry as scat
from ..utils import load_config
from .generate_scatterometry_ground_truth import test_conditions

DEFAULT_CONFIGS = {
    "linear": "configs/config_linear.yml",
    "scatterometry": "configs/config_scatterometry.yml",
}


def _check_mlp(checkpoint: str, name: str, params, n_in: int, hidden, n_out: int) -> None:
    if not isinstance(params, tuple):
        raise ValueError(f"{checkpoint}: {name} is not an MLP (W, b) pair tree")
    got = [params[0][0].shape[0], *[w.shape[1] for w, _ in params]]
    want = [n_in, *hidden, n_out]
    if got != want:
        raise ValueError(f"{checkpoint}: {name} net {got} does not match the config's {want}")


def _load_net(config: dict, dims: dict, checkpoint: str, dev):
    """(model, params) with the checkpoint's shapes checked against the
    config: one MLP, or for the Posterior model the {'prior',
    'likelihood'} dict (the prior takes [x, t], the likelihood [x, y, t])."""
    model, _ = train.get_model_from_args(config, dims)
    params = load_archived_params(checkpoint, device=dev)
    hidden = list(model.hidden_layers)
    if isinstance(model, PosteriorDiffusionEstimator):
        if not isinstance(params, dict) or sorted(params) != ["likelihood", "prior"]:
            raise ValueError(f"{checkpoint}: a Posterior checkpoint holds {{'likelihood', 'prior'}} nets")
        _check_mlp(checkpoint, "prior", params["prior"], model.xdim + 1, hidden, model.xdim)
        _check_mlp(checkpoint, "likelihood", params["likelihood"], model.net_in, hidden, model.xdim)
    else:
        _check_mlp(checkpoint, "the", params, model.net_in, hidden, model.net_out)
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
    seed: int = 0,
) -> Tuple[float, float, float]:
    """Returns (mean KL, mean NLPD, mean score-MSE) over the conditions.
    ``method`` overrides the config's ``eval_method`` ('auto', 'kernel' or
    'plain'); ``seed`` seeds the sampling generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
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
        if isinstance(model, PosteriorDiffusionEstimator) and config.get("eval_analytic_guidance"):
            model = AnalyticGuidanceDPS(
                model, forward_model, fparams, guidance_clip=float(config.get("guidance_clip", 100.0)),
                surrogate_weights=forward_model.weights,
            )
            out_dir = None if out_dir is None else out_dir + "_analytic"
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
