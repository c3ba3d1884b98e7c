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
                  n_samples_y=2, n_samples_x=300, n_repeats=2, eval_num_steps=10, METR_STEPS=10)


@pytest.mark.parametrize("problem,overrides", [
    ("linear", {"loss_fn": "DSM", "train_backend": "fused_pallas", "train_guard": "loss"}),
    ("linear", {}),  # the shipped PINNLoss, autograd engine
    ("scatterometry", {"loss_fn": "DSM", "train_backend": "fused_pallas"}),
    ("scatterometry", {"loss_fn": "DSM", "lr_schedule": "cosine", "grad_clip": 1.0}),
    ("scatterometry", {"model": "CDiffE", "loss_fn": "DSM", "train_backend": "fused_pallas"}),
])
def test_training_drivers_end_to_end_on_cpu(tmp_path, problem, overrides):
    """Train (3 epochs in calls of 2, the last masked), checkpoint and
    evaluate through each training driver's main() on the CPU, at a tiny
    size, from the repository's config with only sizes and paths changed;
    then resume from the checkpoint."""
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
    cfg.update(resume_training=True, n_epochs=4)
    run = main_diffusion_linear.run if problem == "linear" else (
        lambda c, device: main_diffusion_scatterometry.run(c, str(tmp_path / "gt"), device=device))
    run(cfg, device="cpu")
    assert len((tmp_path / "train" / "logs" / "Train_Loss.csv").read_text().splitlines()) == 5


def test_training_drivers_reject_branches_not_ported():
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear.yml")))
    with pytest.raises(NotImplementedError, match="item 8"):
        main_diffusion_linear.run(dict(cfg, refine="mala,60,0.05"), device="cpu")
    scat_cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
    with pytest.raises(NotImplementedError, match="item 11"):
        main_diffusion_scatterometry.run(dict(scat_cfg, model="Posterior", eval_analytic_guidance=True), "gt",
                                         device="cpu")
