"""The port's posterior plots: ``utils/plotting`` byte for byte against
``dmip_tpu.utils.plotting`` under a fixed date and SVG hash salt, the JAX
package's file names from both evaluation harnesses and from every driver
that draws (toy size, CPU), and ``dmip_tpu_torch`` importing where
matplotlib cannot be imported."""

import csv
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch
import yaml

from dmip_tpu.utils import plotting as jplotting
from dmip_tpu_torch import evaluate
from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
from dmip_tpu_torch.mains import (main_baselines_linear, main_baselines_scatterometry, main_diffusion_linear,
                                  main_diffusion_scatterometry)
from dmip_tpu_torch.models import CDE
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat
from dmip_tpu_torch.utils import plotting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fixed_svg(monkeypatch):
    """matplotlib's SVG writer stamps the date and salts its element ids:
    fix both so that two writers of the same figure give the same bytes."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "dmip")


# the JAX drivers' two forms: linear (2-d, mode line, ticks at the box) and
# scatterometry (3-d, ticks at -1, 0, 1); and the box taken from the samples
PLOT_CASES = {
    "linear": (2, dict(limits=(-3.5, 3.5), xticks=[-3.5, 3.5], show_mean=True)),
    "scatterometry": (3, dict(limits=(-1.2, 1.2), xticks=[-1, 0, 1])),
    "sample_box": (3, dict()),
}


@pytest.mark.parametrize("case", sorted(PLOT_CASES))
def test_plot_density_writes_the_jax_packages_bytes(tmp_path, fixed_svg, case):
    dim, kw = PLOT_CASES[case]
    x = (np.random.default_rng(3).normal(size=(500, dim)) * 0.6).astype(np.float32)
    for name, mod in (("jax", jplotting), ("port", plotting)):
        mod.plot_density(x, 75, size=(12, 12), labelsize=30, fname=str(tmp_path / f"{name}.svg"), **kw)
    port = (tmp_path / "port.svg").read_bytes()
    assert len(port) > 1000 and port == (tmp_path / "jax.svg").read_bytes()


def test_plot_csv_writes_the_jax_packages_bytes(tmp_path, fixed_svg):
    path = tmp_path / "Train_Loss.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Step", "Value"])
        w.writerows([i, 1.0 / (1 + i)] for i in range(30))
    for name, mod in (("jax", jplotting), ("port", plotting)):
        mod.plot_csv(str(path), str(tmp_path / f"{name}.svg"), labelsize=10, max_step=20)
    assert (tmp_path / "port.svg").read_bytes() == (tmp_path / "jax.svg").read_bytes()
    (tmp_path / "bad.csv").write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="Step"):
        plotting.plot_csv(str(tmp_path / "bad.csv"), str(tmp_path / "bad.svg"), labelsize=10)


def _svgs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".svg")) if os.path.isdir(path) else []


def _nonempty(path, names):
    return all(os.path.getsize(os.path.join(path, n)) > 1000 for n in names)


def test_evaluation_harnesses_write_the_jax_file_names(tmp_path):
    """plot_ys=[0] of two conditions: the linear harness draws the true and
    the model posterior, the scatterometry harness the MCMC and the model
    posterior, each from its last repeat; no other condition is drawn."""
    model = CDE(xdim=2, ydim=2, hidden_layers=(16,))
    params = model.init(torch.Generator().manual_seed(0))
    prob = LinearForwardProblem()
    ys = torch.randn(2, 2, generator=torch.Generator().manual_seed(1))
    kw = dict(n_samples_x=200, n_repeats=2, num_steps=5, verbose=False, plot_ys=[0])
    evaluate.evaluate_linear(model, params, prob, ys, torch.Generator().manual_seed(2), out_dir=str(tmp_path / "lin"),
                             **kw)
    assert _svgs(tmp_path / "lin") == ["posterior-diffusion-0.svg", "posterior-true-0.svg"]

    forward_model, fp = scat.load_forward_model(device="cpu")
    smodel = CDE(xdim=3, ydim=23, hidden_layers=(16,))
    sparams = smodel.init(torch.Generator().manual_seed(0))
    ys = forward_model(torch.rand(2, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1)
    gt_x = np.random.default_rng(5).uniform(-1, 1, size=(200, 3)).astype(np.float32)
    score_post = scat.score_posterior(forward_model, fp["a"], fp["b"], fp["lambd_bd"])
    evaluate.evaluate_scatterometry(smodel, sparams, forward_model, fp, score_post, ys, lambda i, j: gt_x,
                                    torch.Generator().manual_seed(6), out_dir=str(tmp_path / "scat"), **kw)
    assert _svgs(tmp_path / "scat") == ["posterior-diffusion-0.svg", "posterior-mcmc-0.svg"]
    assert _nonempty(tmp_path / "scat", _svgs(tmp_path / "scat"))


def _config(name, tmp_path, **kw):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", name)))
    cfg.update(train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"), **kw)
    return cfg


def test_diffusion_drivers_draw_the_learned_row_only(tmp_path):
    """The linear driver draws the true and the diffusion posterior of each
    plotted condition; the scatterometry GT driver the MCMC posterior
    beside the ground truth; the scatterometry driver (the DPS config) the
    learned row, and neither the analytic row nor the other condition."""
    lin = _config("config_linear.yml", tmp_path / "lin", dataset_size=600, n_epochs=1, epochs_per_call=1,
                  batch_size=50, hidden_layers=[16], n_samples_y=2, n_samples_x=200, n_repeats=1,
                  eval_num_steps=5, loss_fn="DSM", plot_ys=[1])
    main_diffusion_linear.run(lin, device="cpu")
    assert _svgs(lin["out_dir"]) == ["posterior-diffusion-1.svg", "posterior-true-1.svg"]

    dps = _config("config_scatterometry_dps.yml", tmp_path / "dps", n_epochs=1, epochs_per_call=1, batch_size=50,
                  hidden_layers=[16], n_samples_y=2, n_samples_x=200, n_repeats=1, eval_num_steps=5,
                  METR_STEPS=5, plot_ys=[1])
    gt_dir = str(tmp_path / "gt")
    gt.run(dps, gt_dir, device="cpu")
    assert _svgs(os.path.join(gt_dir, "1")) == ["posterior-mcmc-1.svg"] and not _svgs(os.path.join(gt_dir, "0"))
    main_diffusion_scatterometry.run(dps, gt_dir, device="cpu")
    assert _svgs(dps["out_dir"]) == ["posterior-diffusion-1.svg", "posterior-mcmc-1.svg"]
    assert _nonempty(dps["out_dir"], _svgs(dps["out_dir"]))
    assert os.path.exists(os.path.join(dps["out_dir"] + "_analytic", "results.csv"))
    assert not _svgs(dps["out_dir"] + "_analytic")

    gt.run(dict(dps, plot_ys=[]), str(tmp_path / "gt_unplotted"), device="cpu")
    assert not _svgs(str(tmp_path / "gt_unplotted" / "1"))


BASELINES = dict(num_layers_INN=2, size_hidden_layers_INN=16, metr_steps_per_block=2, hidden_layers=[16],
                 n_epochs_SNF=1, n_epochs_dsm=1, n_epochs_INN=1, batch_size=100, n_samples_y=2, n_samples_x=200,
                 n_repeats=1, plot_ys=[0])
BASELINE_FIGURES = ["posterior-diffusion-0.svg", "posterior-inn-0.svg", "posterior-snf-0.svg", "posterior-true-0.svg"]


def test_baseline_drivers_draw_four_posteriors(tmp_path):
    lin = _config("config_baselines_linear.yml", tmp_path / "lin", dataset_size=600, **BASELINES)
    main_baselines_linear.run(lin, device="cpu")
    assert _svgs(lin["out_dir"]) == BASELINE_FIGURES

    gt_dir = tmp_path / "gt"
    rng = np.random.default_rng(0)
    for i in range(2):
        os.makedirs(gt_dir / str(i))
        np.save(gt_dir / str(i) / "0.npy", rng.uniform(-1, 1, size=(200, 3)).astype(np.float32))
    sc = _config("config_baselines_scatterometry.yml", tmp_path / "scat", **BASELINES)
    main_baselines_scatterometry.run(sc, str(gt_dir), device="cpu")
    assert _svgs(sc["out_dir"]) == BASELINE_FIGURES and _nonempty(sc["out_dir"], BASELINE_FIGURES)


# each driver that draws, with a shipped config whose plot_ys is not empty
DRIVERS_THAT_DRAW = {
    "ground_truth": ("config_scatterometry.yml", lambda c, d: gt.run(c, d, device="cpu")),
    "diffusion_linear": ("config_linear.yml", lambda c, d: main_diffusion_linear.run(c, device="cpu")),
    "diffusion_scatterometry": ("config_scatterometry.yml",
                                lambda c, d: main_diffusion_scatterometry.run(c, d, device="cpu")),
    "baselines_linear": ("config_baselines_linear.yml", lambda c, d: main_baselines_linear.run(c, device="cpu")),
    "baselines_scatterometry": ("config_baselines_scatterometry.yml",
                                lambda c, d: main_baselines_scatterometry.run(c, d, device="cpu")),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS_THAT_DRAW))
def test_drivers_with_plot_ys_stop_before_training_without_matplotlib(tmp_path, monkeypatch, driver):
    """A host without matplotlib: a driver handed a non-empty plot_ys
    raises ImportError, naming the way out, before it writes or trains
    anything; an empty plot_ys asks nothing of matplotlib."""
    name, run = DRIVERS_THAT_DRAW[driver]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "dmip_tpu_torch.utils.plotting")
    cfg = _config(name, tmp_path)
    assert cfg["plot_ys"]
    # toy sizes, so that a driver which failed to stop would fail fast
    cfg.update(BASELINES, dataset_size=600, n_epochs=1, epochs_per_call=1, batch_size=50, eval_num_steps=5,
               METR_STEPS=5)
    with pytest.raises(ImportError, match=r"plot_ys: \[\]"):
        run(cfg, str(tmp_path / "gt"))
    assert not os.listdir(tmp_path)
    evaluate.require_plotting([])


_NO_MATPLOTLIB = r"""
import sys, importlib
for name in ("matplotlib", "seaborn", "jax", "dmip_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import dmip_tpu_torch
for m in ("eval_diffusion", "generate_scatterometry_ground_truth", "main_baselines_linear",
          "main_baselines_scatterometry", "main_diffusion_linear", "main_diffusion_scatterometry"):
    importlib.import_module("dmip_tpu_torch.mains." + m)
import dmip_tpu_torch.evaluate, chip_smoke
try:
    import dmip_tpu_torch.utils.plotting
except ImportError:
    print("plotting needs matplotlib")
"""


def test_package_and_drivers_import_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB.format(repo=REPO)], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "plotting needs matplotlib"
