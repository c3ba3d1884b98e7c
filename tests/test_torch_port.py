"""dmip_tpu_torch as a package: import hygiene (no JAX, no dmip_tpu, nothing
built at import), the CUDA-by-default entry points, and the drivers end to
end on the CPU at a tiny size."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from dmip_tpu_torch import resolve_device
from dmip_tpu_torch.mains import eval_diffusion
from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
from dmip_tpu_torch.mains import main_diffusion_linear, main_diffusion_scatterometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import sys, pkgutil, importlib
for name in ("jax", "jaxlib", "dmip_tpu", "triton"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import dmip_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dmip_tpu_torch.__path__, "dmip_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from dmip_tpu_torch.ops import build
assert not build._loaded
assert not any(k.startswith(("jax", "dmip_tpu.")) for k in sys.modules if sys.modules[k] is not None)
print(len(mods))
"""


def test_port_and_chip_smoke_import_without_jax_or_dmip_tpu():
    """Every submodule and chip_smoke.py import in a process where jax,
    dmip_tpu and triton cannot be imported, and nothing is built."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(repo=REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 27


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear.yml")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_diffusion.run("linear", os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"), cfg)
    scat_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.run(scat_cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_diffusion_linear.run(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_diffusion_scatterometry.run(scat_cfg, str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_a_card():
    _no_cuda()
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_drivers_end_to_end_on_cpu(tmp_path):
    """GT generation and both evaluations through the drivers' main() on the
    CPU, at a tiny size, reading the repository's configs unchanged apart
    from the sizes."""
    scat_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
    scat_cfg.update(n_samples_x=300, n_repeats=2, METR_STEPS=20, eval_num_steps=10)
    scat_path = tmp_path / "scat.yml"
    scat_path.write_text(yaml.safe_dump(scat_cfg))
    gt_dir = tmp_path / "gt"
    gt.main(["--config", str(scat_path), "--gt_dir", str(gt_dir), "--n_samples_y", "2", "--device", "cpu"])
    arrs = [np.load(gt_dir / str(i) / f"{j}.npy") for i in range(2) for j in range(2)]
    assert all(a.shape == (300, 3) and np.isfinite(a).all() for a in arrs)
    assert not np.array_equal(arrs[0], arrs[1])
    eval_diffusion.main(["--problem", "scatterometry", "--config", str(scat_path),
                         "--checkpoint", os.path.join(REPO, "benchmarks/checkpoints/cde_500k"),
                         "--gt_dir", str(gt_dir), "--n_samples_y", "2", "--device", "cpu",
                         "--out_dir", str(tmp_path / "scat_out")])
    rows = (tmp_path / "scat_out" / "results.csv").read_text().splitlines()
    assert rows[0] == ",KL2,KL_reverse,NLL_mcmc,NLL_diffusion,MSE,W2" and len(rows) == 3
    lin_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear.yml")))
    lin_cfg.update(n_samples_x=500, n_repeats=2, eval_num_steps=10, dataset_size=1000)
    lin_path = tmp_path / "lin.yml"
    lin_path.write_text(yaml.safe_dump(lin_cfg))
    eval_diffusion.main(["--problem", "linear", "--config", str(lin_path),
                         "--checkpoint", os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"),
                         "--n_samples_y", "3", "--device", "cpu", "--out_dir", str(tmp_path / "lin_out")])
    rows = (tmp_path / "lin_out" / "results.csv").read_text().splitlines()
    assert rows[0] == ",KL2,NLL_true,NLL_diffusion,MSE,W2" and len(rows) == 4


def test_gt_driver_mcmc_seed_keeps_conditions_and_changes_chains(tmp_path, monkeypatch):
    """``--mcmc_seed`` at 2 conditions: the chains see the same conditions
    and start elsewhere, so every file changes; ``--mcmc_seed`` equal to
    the default chain seed (RANDOM_STATE + 1) writes the files of a run
    without the flag, bit for bit."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
    cfg.update(n_samples_x=200, n_repeats=2, METR_STEPS=10)
    path = tmp_path / "scat.yml"
    path.write_text(yaml.safe_dump(cfg))
    seen, run = {}, [None]
    chains = gt.fused_mh_scatterometry

    def spy(weights, x0, y, *args, **kwargs):
        seen.setdefault(run[0], []).append(y.clone())
        return chains(weights, x0, y, *args, **kwargs)

    monkeypatch.setattr(gt, "fused_mh_scatterometry", spy)
    runs = {"default": [], "same": ["--mcmc_seed", str(int(cfg["RANDOM_STATE"]) + 1)], "fresh": ["--mcmc_seed", "99"]}
    for name, extra in runs.items():
        run[0] = name
        gt.main(["--config", str(path), "--gt_dir", str(tmp_path / name), "--n_samples_y", "2", "--device", "cpu",
                 *extra])
    files = {name: [np.load(tmp_path / name / str(i) / f"{j}.npy") for i in range(2) for j in range(2)]
             for name in runs}
    assert all(np.array_equal(a, b) for a, b in zip(files["default"], files["same"]))
    assert not any(np.array_equal(a, b) for a, b in zip(files["default"], files["fresh"]))
    assert all(len(seen[name]) == 2 for name in runs)
    for name in ("same", "fresh"):
        assert all(torch.equal(a, b) for a, b in zip(seen["default"], seen[name]))


@pytest.mark.parametrize("config,checkpoint,out_suffix", [
    ("config_scatterometry_cdiffe.yml", "cdiffe_scat", ""),
    ("config_scatterometry_dps.yml", "dps_prior", "_analytic"),
])
def test_eval_driver_serves_cdiffe_and_analytic_dps_on_cpu(tmp_path, config, checkpoint, out_suffix):
    """The CDiffE checkpoint (CDiffE.sample) and the DPS prior under the
    config's analytic guidance (AnalyticGuidanceDPS, clip 100, results in
    out_dir + '_analytic') through the eval driver's main() on the CPU, at a
    tiny size, against GT made for the same conditions (all three
    scatterometry configs have RANDOM_STATE 13)."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", config)))
    cfg.update(n_samples_x=200, n_repeats=2, METR_STEPS=20, eval_num_steps=8)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    gt.main(["--config", str(path), "--gt_dir", str(tmp_path / "gt"), "--n_samples_y", "2", "--device", "cpu"])
    eval_diffusion.main(["--problem", "scatterometry", "--config", str(path),
                         "--checkpoint", os.path.join(REPO, "benchmarks/checkpoints", checkpoint),
                         "--gt_dir", str(tmp_path / "gt"), "--n_samples_y", "2", "--device", "cpu",
                         "--out_dir", str(tmp_path / "out")])
    rows = (tmp_path / f"out{out_suffix}" / "results.csv").read_text().splitlines()
    assert rows[0] == ",KL2,KL_reverse,NLL_mcmc,NLL_diffusion,MSE,W2" and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])


@pytest.mark.parametrize("config,problem,checkpoint,out_suffix", [
    ("config_linear_refined.yml", "linear", "linear_refined_winner", "_refined_mh20_0.2"),
    ("config_linear_pinn2.yml", "linear", "linear_pinn2", "_refined_mh20_0.2"),
    ("config_scatterometry_refined.yml", "scatterometry", "cde_500k", "_refined"),
    ("config_scatterometry_refined_20k.yml", "scatterometry", "cde_20k_best", "_refined"),
])
def test_eval_driver_raises_for_a_refined_config(tmp_path, config, problem, checkpoint, out_suffix):
    """Each shipped config with ``refine`` is served as its refined row by
    the eval driver's main() on the CPU, at a tiny size, with its committed
    proposal net: the row lands in out_dir + the JAX drivers' suffix
    ('_refined_<tag>' linear, '_refined' scatterometry) with finite
    metrics, and nothing raises for ``refine`` any more."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", config)))
    cfg.update(n_samples_x=200, n_repeats=2, eval_num_steps=8, dataset_size=1000)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--problem", problem, "--config", str(path), "--checkpoint",
            os.path.join(REPO, "benchmarks/checkpoints", checkpoint), "--n_samples_y", "2", "--device", "cpu",
            "--out_dir", str(tmp_path / "out")]
    if problem == "scatterometry":
        # the GT driver's MCMC settings come from the base config (same RANDOM_STATE, same conditions)
        base = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
        base.update(n_samples_x=200, n_repeats=2, METR_STEPS=10)
        (tmp_path / "base.yml").write_text(yaml.safe_dump(base))
        gt.main(["--config", str(tmp_path / "base.yml"), "--gt_dir", str(tmp_path / "gt"), "--n_samples_y", "2",
                 "--device", "cpu"])
        args += ["--gt_dir", str(tmp_path / "gt")]
    eval_diffusion.main(args)
    rows = (tmp_path / f"out{out_suffix}" / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    assert not (tmp_path / "out").exists()


def test_eval_driver_rejects_a_mismatched_checkpoint():
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear.yml")))
    cfg.update(hidden_layers=[256, 256])
    with pytest.raises(ValueError, match="does not match"):
        eval_diffusion.run("linear", os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"),
                           cfg, device="cpu")
    dps_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry_dps.yml")))
    with pytest.raises(ValueError, match="prior net"):
        eval_diffusion._load_net(dict(dps_cfg, hidden_layers=[512, 512]), {"xdim": 3, "ydim": 23},
                                 os.path.join(REPO, "benchmarks/checkpoints/dps_prior"), "cpu")
    with pytest.raises(ValueError, match="likelihood"):
        eval_diffusion._load_net(dps_cfg, {"xdim": 3, "ydim": 23},
                                 os.path.join(REPO, "benchmarks/checkpoints/cdiffe_scat"), "cpu")


TINY_TRAIN = dict(dataset_size=600, n_epochs=3, epochs_per_call=2, batch_size=50, hidden_layers=[32, 32],
                  n_samples_y=2, n_samples_x=300, n_repeats=2, eval_num_steps=10, METR_STEPS=10,
                  plot_ys=[])  # the figures are held in test_torch_plotting.py


@pytest.mark.parametrize("problem,overrides", [
    ("linear", {"loss_fn": "DSM", "train_backend": "fused_pallas", "train_guard": "loss"}),
    ("linear", {}),  # the shipped PINNLoss, autograd engine
    ("scatterometry", {"loss_fn": "DSM", "train_backend": "fused_pallas"}),
    ("scatterometry", {"loss_fn": "DSM", "lr_schedule": "cosine", "grad_clip": 1.0}),
    ("scatterometry", {"model": "CDiffE", "loss_fn": "DSM", "train_backend": "fused_pallas"}),
    ("scatterometry", {"model": "Posterior", "loss_fn": "PosteriorLoss", "lam": 1.0, "eval_analytic_guidance": True,
                       "guidance_clip": 100.0}),
    # the learned row through Heun; the analytic row keeps its own sampler
    ("scatterometry", {"model": "Posterior", "loss_fn": "PosteriorLoss", "lam": 1.0, "eval_analytic_guidance": True,
                       "guidance_clip": 100.0, "eval_method": "heun"}),
])
def test_training_drivers_end_to_end_on_cpu(tmp_path, problem, overrides):
    """Train (3 epochs in calls of 2, the last masked), checkpoint and
    evaluate through each training driver's main() on the CPU, at a tiny
    size, from the repository's config with only sizes and paths changed;
    then resume from the checkpoint.  The Posterior model also logs both
    loss terms, checkpoints its {'prior', 'likelihood'} tree and writes the
    analytic-guidance row."""
    cfg = yaml.safe_load(open(os.path.join(REPO, f"configs/config_{problem}.yml")))
    cfg.update(TINY_TRAIN, train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"), **overrides)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--device", "cpu"]
    if problem == "scatterometry":
        gt.main(["--config", str(path), "--gt_dir", str(tmp_path / "gt"), "--device", "cpu"])
        main_diffusion_scatterometry.main(args + ["--gt_dir", str(tmp_path / "gt")])
    else:
        main_diffusion_linear.main(args)
    losses = (tmp_path / "train" / "logs" / "Train_Loss.csv").read_text().splitlines()
    assert losses[0] == "Step,Value" and [r.split(",")[0] for r in losses[1:]] == ["0", "1", "2"]
    assert all(np.isfinite(float(r.split(",")[1])) for r in losses[1:])
    rows = (tmp_path / "out" / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    manifest = yaml.safe_load((tmp_path / "train" / "checkpoint" / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["has_opt_state"]
    if overrides.get("model") == "Posterior":
        for name in ("Train_PriorLoss", "Train_LikelihoodLoss"):
            terms = (tmp_path / "train" / "logs" / f"{name}.csv").read_text().splitlines()
            assert len(terms) == 4 and all(np.isfinite(float(r.split(",")[1])) for r in terms[1:])
        treedef = (tmp_path / "train" / "checkpoint" / "params.treedef.json").read_text()
        assert treedef.startswith("\"PyTreeDef({'likelihood': ((*, *), (*, *), (*, *)), 'prior'")
        rows = (tmp_path / "out_analytic" / "results.csv").read_text().splitlines()
        assert len(rows) == 3 and all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    cfg.update(resume_training=True, n_epochs=4)
    run = main_diffusion_linear.run if problem == "linear" else (
        lambda c, device: main_diffusion_scatterometry.run(c, str(tmp_path / "gt"), device=device))
    run(cfg, device="cpu")
    assert len((tmp_path / "train" / "logs" / "Train_Loss.csv").read_text().splitlines()) == 5


def test_training_drivers_reject_branches_not_ported():
    """A malformed refine spec is refused (the refine branch itself is
    ported), and the linear training driver refuses the Posterior model as
    dmip_tpu's does: its PosteriorLoss needs a forward model, which only the
    scatterometry driver hands it (trained there in the driver test
    above)."""
    with pytest.raises(ValueError, match="unknown refinement options"):
        eval_diffusion.main(["--problem", "linear", "--checkpoint",
                             os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"),
                             "--refine", "mala,60,0.05,bogus=1", "--device", "cpu"])
    lin_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear.yml")))
    with pytest.raises(ValueError, match="requires the forward model"):
        main_diffusion_linear.run(dict(lin_cfg, model="Posterior", loss_fn=None, dataset_size=600), device="cpu")
