"""The port's baseline drivers (SNF, DSM CDE, INN) end to end on the CPU
at toy scale, as ``tests/test_mains.py`` drives the JAX package's: finite
metrics under the JAX drivers' CSV columns, and the scatterometry
``--eval_only`` re-score equal to the trained run's without touching the
training log."""

import csv
import os

import numpy as np

from dmip_tpu_torch.mains import main_baselines_linear, main_baselines_scatterometry

FLOWS = dict(num_layers_INN=2, size_hidden_layers_INN=16, metr_steps_per_block=2, noise_std=0.4,
             hidden_layers=[16, 16], model="CDE", lr=1e-3, lr_INN=1e-3, n_repeats=2, plot_ys=[])


def _header(out_dir):
    with open(os.path.join(out_dir, "results.csv")) as f:
        return next(csv.reader(f))


def test_main_baselines_linear_e2e(tmp_path):
    cfg = dict(FLOWS, dataset_size=1000, train_size=0.9, random_state=7, batch_size=100, n_epochs_SNF=2,
               n_epochs_dsm=2, n_epochs_INN=2, n_samples_y=2, n_samples_x=300,
               train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"))
    mean = main_baselines_linear.run(cfg, device="cpu")
    assert all(np.isfinite(v) for v in mean.values()), mean
    assert _header(cfg["out_dir"]) == ["", "KL1", "KL2", "KL3", "NLL_true", "NLL_snf", "NLL_diffusion", "NLL_inn",
                                       "MSE"]
    for name in ("snf", "diffusion", "INN"):
        assert os.path.exists(tmp_path / "train" / name / "params.npz")


def test_main_baselines_scatterometry_e2e_and_eval_only(tmp_path):
    gt_dir = tmp_path / "gt"
    rng = np.random.default_rng(0)
    for i in range(2):
        os.makedirs(gt_dir / str(i))
        for j in range(2):
            np.save(gt_dir / str(i) / f"{j}.npy", rng.uniform(-1, 1, size=(300, 3)).astype(np.float32))
    cfg = dict(FLOWS, n_samples_y=2, n_samples_x=300, RANDOM_STATE=13, n_epochs_dsm=4, n_epochs_SNF=2,
               n_epochs_INN=2, batch_size=100, train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"))
    mean = main_baselines_scatterometry.run(cfg, str(gt_dir), device="cpu")
    assert all(np.isfinite(v) for v in mean.values()), mean
    assert _header(cfg["out_dir"]) == ["", *main_baselines_scatterometry.COLUMNS]
    assert main_baselines_scatterometry.COLUMNS == (
        "KL_SNF", "KL_SNF_reverse", "KL_diffusion", "KL_diffusion_reverse", "KL_INN", "KL_INN_reverse",
        "NLL_mcmc", "NLL_snf", "NLL_diffusion", "NLL_inn", "MSE", "W2_SNF", "W2_diffusion", "W2_INN")

    # eval_only must not wipe the training run's logs (set_directories is
    # skipped on that path); the same checkpoints and evaluation seed give
    # the same numbers
    log_file = tmp_path / "train" / "logs" / "events.jsonl"
    log_bytes = log_file.stat().st_size
    mean2 = main_baselines_scatterometry.run(cfg, str(gt_dir), eval_only=True, device="cpu")
    for k in mean:
        np.testing.assert_allclose(mean2[k], mean[k], rtol=1e-5, err_msg=k)
    assert log_file.stat().st_size == log_bytes
