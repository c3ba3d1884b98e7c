"""dmip_tpu_torch evaluation, held against dmip_tpu: the metric kernels on
shared inputs, and the whole serving slice (sample -> score) for the
committed linear and scatterometry nets at a small protocol."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmip_tpu import evaluate as jeval
from dmip_tpu import train as jtrain
from dmip_tpu.checkpoints import load_pytree
from dmip_tpu.nets import mlp_init
from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import evaluate, train
from dmip_tpu_torch.checkpoints import load_archived_params
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "benchmarks", "checkpoints")


@pytest.mark.parametrize("d,lo,hi", [(2, -3.5, 3.5), (3, -1.2, 1.2)])
def test_histogramdd_flat_counts_match_jax_and_numpy(d, lo, hi):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(20000, d)) * (hi - lo) / 3).astype(np.float32)
    x[:5] = hi  # upper edge lands in the last bin
    x[5:10] = lo
    h_t = evaluate.histogramdd_flat(torch.from_numpy(x), 75, lo, hi)
    h_j = np.asarray(jeval.histogramdd_flat(jnp.asarray(x), 75, lo, hi))
    np.testing.assert_array_equal(h_t.numpy(), h_j)
    # numpy's edges in float64 from the float32 box (the points are float32)
    h_np, _ = np.histogramdd(x, bins=75, range=[(float(np.float32(lo)), float(np.float32(hi)))] * d)
    np.testing.assert_array_equal(h_t.numpy(), h_np.reshape(-1))


def test_kl_pair_and_sliced_w2_match_jax():
    """kl_pair to 1e-5 (float32 sums over 75^3 bins); sliced W2 on the same
    projection directions to rtol 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5000, 3)).astype(np.float32) * 0.4
    b = (rng.normal(size=(5000, 3)) * 0.5 + 0.1).astype(np.float32)
    ha = jeval.histogramdd_flat(jnp.asarray(a), 75, -1.2, 1.2)
    hb = jeval.histogramdd_flat(jnp.asarray(b), 75, -1.2, 1.2)
    kj = [float(v) for v in jeval.kl_pair(ha, hb)]
    kt = [float(v) for v in evaluate.kl_pair(evaluate.histogramdd_flat(torch.from_numpy(a), 75, -1.2, 1.2),
                                             evaluate.histogramdd_flat(torch.from_numpy(b), 75, -1.2, 1.2))]
    np.testing.assert_allclose(kt, kj, rtol=1e-5)
    key = jax.random.PRNGKey(1)
    dirs = np.array(jax.random.normal(key, (128, 3)))
    w_j = float(jeval.sliced_w2(key, jnp.asarray(a), jnp.asarray(b)))
    w_t = float(evaluate.sliced_w2(torch.from_numpy(a), torch.from_numpy(b), dirs=torch.from_numpy(dirs)))
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0][1:], np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def test_evaluate_scatterometry_slice_matches_jax(tmp_path):
    """cde_500k on 2 conditions x 2 repeats x 2000 samples x 40 steps, on the
    same GT files.  Deterministic columns (NLL_mcmc, MSE) to rtol 1e-4 (f32
    means of 2000 energies and scores).  Sampled columns within their
    sampling spread at this size: KL2 and KL_reverse (sparse 75^3
    histograms of 4000 points) to 15%, NLL_diffusion to 5% (a mean energy
    whose rare samples outside the box carry 1000x boundary penalties), W2
    to 10% (128 random projection directions, drawn apart on each side)."""
    jfwd, fp = jscat.load_forward_model()
    tfwd, _ = scat.load_forward_model()
    rng = np.random.default_rng(0)
    x_cond = rng.uniform(-0.8, 0.8, size=(2, 3)).astype(np.float32)
    ys = np.array(jscat.noisy_forward(jax.random.PRNGKey(5), jfwd, jnp.asarray(x_cond), 0.2, 0.01))
    gt_dir = tmp_path / "gt"
    for i in range(2):  # a stand-in GT around each truth: the metrics only read it
        (gt_dir / str(i)).mkdir(parents=True)
        for j in range(2):
            g = x_cond[i] + 0.05 * rng.normal(size=(2000, 3)).astype(np.float32)
            np.save(gt_dir / str(i) / f"{j}.npy", g.astype(np.float32))
    gt_loader = lambda i, j: np.load(gt_dir / str(i) / f"{j}.npy")
    cfg = {"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [512, 512, 512]}
    jm, _ = jtrain.get_model_from_args(cfg, fp)
    jp = load_pytree(os.path.join(CKPT, "cde_500k"), mlp_init(jax.random.PRNGKey(0), 27, 3), "params")
    tm, _ = train.get_model_from_args(cfg, fp)
    tp = load_archived_params(os.path.join(CKPT, "cde_500k"))
    prot = dict(n_samples_x=2000, n_repeats=2, num_steps=40, verbose=False)
    jeval.evaluate_scatterometry(
        jm, jp, jfwd, fp, jscat.score_posterior(jfwd, 0.2, 0.01, 1000.0), jnp.asarray(ys),
        gt_loader, jax.random.PRNGKey(0),
        out_dir=str(tmp_path / "jax"), mesh=None, **prot)
    evaluate.evaluate_scatterometry(
        tm, tp, tfwd, fp, scat.score_posterior(tfwd, 0.2, 0.01, 1000.0), torch.from_numpy(ys),
        gt_loader, torch.Generator().manual_seed(0), out_dir=str(tmp_path / "torch"), **prot)
    cols_j, vj = _read_csv(tmp_path / "jax" / "results.csv")
    cols_t, vt = _read_csv(tmp_path / "torch" / "results.csv")
    assert cols_t == cols_j == ["KL2", "KL_reverse", "NLL_mcmc", "NLL_diffusion", "MSE", "W2"]
    c = {k: i for i, k in enumerate(cols_j)}
    np.testing.assert_allclose(vt[:, c["NLL_mcmc"]], vj[:, c["NLL_mcmc"]], rtol=1e-4)
    np.testing.assert_allclose(vt[:, c["MSE"]], vj[:, c["MSE"]], rtol=1e-4)
    np.testing.assert_allclose(vt[:, c["KL2"]], vj[:, c["KL2"]], rtol=0.15)
    np.testing.assert_allclose(vt[:, c["KL_reverse"]], vj[:, c["KL_reverse"]], rtol=0.15)
    np.testing.assert_allclose(vt[:, c["NLL_diffusion"]], vj[:, c["NLL_diffusion"]], rtol=0.05)
    np.testing.assert_allclose(vt[:, c["W2"]], vj[:, c["W2"]], rtol=0.1)


def test_evaluate_linear_slice_matches_jax(tmp_path):
    """linear_refined_winner on 2 conditions x 2 repeats x 4000 samples x 40
    steps.  Every column is sampled (the posterior reference too): KL2 to
    25% (sparse 75^2 histograms of 8000 points), NLLs to 0.05 nats, MSE to
    50% of a ~1e-3 value, W2 to 0.02."""
    jprob, tprob = JLinear(), LinearForwardProblem()
    ys = np.array([[0.5, 0.2], [-0.8, 1.1]], np.float32)
    cfg = {"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [512, 512, 512]}
    dims = {"xdim": 2, "ydim": 2}
    jm, _ = jtrain.get_model_from_args(cfg, dims)
    jp = load_pytree(os.path.join(CKPT, "linear_refined_winner"), mlp_init(jax.random.PRNGKey(0), 5, 2), "params")
    tm, _ = train.get_model_from_args(cfg, dims)
    tp = load_archived_params(os.path.join(CKPT, "linear_refined_winner"))
    prot = dict(n_samples_x=4000, n_repeats=2, num_steps=40, verbose=False)
    jeval.evaluate_linear(jm, jp, jprob, jnp.asarray(ys), jax.random.PRNGKey(0),
                          out_dir=str(tmp_path / "jax"), mesh=None, **prot)
    evaluate.evaluate_linear(tm, tp, tprob, torch.from_numpy(ys), torch.Generator().manual_seed(0),
                             out_dir=str(tmp_path / "torch"), **prot)
    cols_j, vj = _read_csv(tmp_path / "jax" / "results.csv")
    cols_t, vt = _read_csv(tmp_path / "torch" / "results.csv")
    assert cols_t == cols_j == ["KL2", "NLL_true", "NLL_diffusion", "MSE", "W2"]
    np.testing.assert_allclose(vt[:, 0], vj[:, 0], rtol=0.25)
    np.testing.assert_allclose(vt[:, 1:3], vj[:, 1:3], atol=0.05)
    np.testing.assert_allclose(vt[:, 3], vj[:, 3], rtol=0.5, atol=2e-4)
    np.testing.assert_allclose(vt[:, 4], vj[:, 4], atol=0.02)


def test_progress_heartbeat_matches_jax(tmp_path, capsys):
    """evaluate_scatterometry(progress_every=2) on 5 conditions prints the
    JAX package's heartbeat lines (done 2, 4 and the last, 5; the running
    rate aside) on a tiny run of the same net and GT, and none without it."""
    jfwd, fp = jscat.load_forward_model()
    tfwd, _ = scat.load_forward_model()
    rng = np.random.default_rng(1)
    x_cond = rng.uniform(-0.8, 0.8, size=(5, 3)).astype(np.float32)
    ys = np.array(jscat.noisy_forward(jax.random.PRNGKey(6), jfwd, jnp.asarray(x_cond), 0.2, 0.01))
    gt = {i: x_cond[i] + 0.05 * rng.normal(size=(100, 3)).astype(np.float32) for i in range(5)}
    gt_loader = lambda i, j: gt[i]
    cfg = {"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [512, 512, 512]}
    jm, _ = jtrain.get_model_from_args(cfg, fp)
    jp = load_pytree(os.path.join(CKPT, "cde_500k"), mlp_init(jax.random.PRNGKey(0), 27, 3), "params")
    tm, _ = train.get_model_from_args(cfg, fp)
    tp = load_archived_params(os.path.join(CKPT, "cde_500k"))
    prot = dict(n_samples_x=100, n_repeats=1, num_steps=4, verbose=False)

    def beats(out):
        return [ln.split(" (")[0] + " " + ln.rsplit(", ", 1)[1] for ln in out.splitlines()
                if ln.startswith("[eval-scat]")]

    capsys.readouterr()
    jeval.evaluate_scatterometry(jm, jp, jfwd, fp, jscat.score_posterior(jfwd, 0.2, 0.01, 1000.0),
                                 jnp.asarray(ys), gt_loader, jax.random.PRNGKey(0), mesh=None,
                                 progress_every=2, **prot)
    want = beats(capsys.readouterr().out)
    args = (tm, tp, tfwd, fp, scat.score_posterior(tfwd, 0.2, 0.01, 1000.0), torch.from_numpy(ys), gt_loader,
            torch.Generator().manual_seed(0))
    evaluate.evaluate_scatterometry(*args, progress_every=2, **prot)
    got = beats(capsys.readouterr().out)
    assert want == ["[eval-scat] 2/5 conditions 1 repeats)", "[eval-scat] 4/5 conditions 1 repeats)",
                    "[eval-scat] 5/5 conditions 1 repeats)"]
    assert got == want
    evaluate.evaluate_scatterometry(*args, **prot)
    assert beats(capsys.readouterr().out) == []
