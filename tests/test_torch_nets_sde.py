"""dmip_tpu_torch nets, SDE closed forms, checkpoint loading and the model
factory, held against dmip_tpu on the same inputs (CPU, float32)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmip_tpu import nets as jnets
from dmip_tpu import sde as jsde
from dmip_tpu import train as jtrain
from dmip_tpu.checkpoints import load_pytree
from dmip_tpu_torch import nets, sde, train
from dmip_tpu_torch.checkpoints import load_archived_params, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {
    "cde_500k": (3, 23),
    "linear_refined_winner": (2, 2),
}


def _jax_params(name, xdim, ydim):
    like = jnets.mlp_init(__import__("jax").random.PRNGKey(0), xdim + ydim + 1, xdim, (512, 512, 512))
    return load_pytree(os.path.join(REPO, "benchmarks", "checkpoints", name), like, "params")


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_score_mlp_on_committed_nets_matches_jax(name):
    """Full-width committed nets through both score_mlp_apply at f32.
    rtol 1e-5 / atol 1e-5: same products, different f32 sum order."""
    xdim, ydim = CKPTS[name]
    jp = _jax_params(name, xdim, ydim)
    tp = load_archived_params(os.path.join(REPO, "benchmarks", "checkpoints", name))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, xdim)).astype(np.float32)
    y = rng.normal(size=(64, ydim)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, size=(64, 1)).astype(np.float32)
    ref = np.asarray(jnets.score_mlp_apply(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t)))
    out = nets.score_mlp_apply(tp, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the same net carried by params_from_numpy
    tp2 = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    for (w1, b1), (w2, b2) in zip(tp, tp2):
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_score_mlp_scalar_t_and_no_condition():
    """Scalar t broadcasts to a column; y=None drops the condition block."""
    rng = np.random.default_rng(1)
    pairs = [(rng.normal(size=(3, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32)),
             (rng.normal(size=(8, 2)).astype(np.float32), rng.normal(size=2).astype(np.float32))]
    x = rng.normal(size=(5, 2)).astype(np.float32)
    ref = np.asarray(jnets.score_mlp_apply(tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs),
                                           jnp.asarray(x), None, 0.3))
    out = nets.score_mlp_apply(params_from_numpy(pairs), torch.from_numpy(x), None, 0.3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_mlp_init_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    params = nets.mlp_init(26, 3, (512, 512, 512), generator=gen)
    assert [tuple(w.shape) for w, _ in params] == [(26, 512), (512, 512), (512, 512), (512, 3)]
    for w, b in params:
        bound = 1.0 / np.sqrt(w.shape[0])
        assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound


def test_vpsde_and_reverse_sde_closed_forms():
    """beta, int_beta, mean_weight, std, f, g, mu and sigma against JAX;
    rtol 1e-6: the same f32 elementwise formulas."""
    rng = np.random.default_rng(2)
    t = rng.uniform(0.0, 1.0, size=(7, 1)).astype(np.float32)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    a = rng.normal(size=(7, 3)).astype(np.float32)
    jv, tv = jsde.VPSDE(), sde.VPSDE()
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    for name in ("beta", "int_beta", "mean_weight", "std", "g"):
        np.testing.assert_allclose(getattr(tv, name)(tt).numpy(), np.asarray(getattr(jv, name)(jt)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tv.f(tt, torch.from_numpy(x)).numpy(), np.asarray(jv.f(jt, jnp.asarray(x))),
                               rtol=1e-6)
    jr, tr = jsde.ReverseSDE(), sde.ReverseSDE()
    for lmbd in (0.0, 0.5):
        mu_t = tr.mu(lambda z, c, s: torch.from_numpy(a), tt, torch.from_numpy(x), None, lmbd)
        mu_j = jr.mu(lambda z, c, s: jnp.asarray(a), jt, jnp.asarray(x), None, lmbd)
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tr.sigma(tt, lmbd).numpy(), np.asarray(jr.sigma(jt, lmbd)), rtol=1e-6)


def test_load_archived_params_rejects_non_mlp_tree(tmp_path):
    np.savez(tmp_path / "params.npz", leaf_0=np.zeros(3))
    (tmp_path / "params.treedef.json").write_text('"PyTreeDef({\'a\': *})"')
    with pytest.raises(ValueError, match="not an MLP"):
        load_archived_params(str(tmp_path))


@pytest.mark.parametrize("config", [
    {"model": "CDE", "loss_fn": "PINNLoss", "lam": 0.01, "lam2": 0.001, "pde_loss": "FPE",
     "ic_metric": "L2", "hidden_layers": [512, 512, 512]},
    {"model": "CDE", "loss_fn": "DSM", "hidden_layers": [64, 32]},
])
def test_get_model_from_args_matches_jax(config):
    dims = {"xdim": 3, "ydim": 23}
    jm, jc = jtrain.get_model_from_args(config, dims)
    tm, tc = train.get_model_from_args(config, dims)
    assert (tm.xdim, tm.ydim, tm.hidden_layers, tm.net_in) == (jm.xdim, jm.ydim, jm.hidden_layers, jm.net_in)
    assert tc.__dict__ == jc.__dict__


@pytest.mark.parametrize("name", ["CDiffE", "Posterior"])
def test_get_model_from_args_unported_models_raise(name, tmp_path):
    """Both models are built and trained now, as in dmip_tpu.  The
    Posterior's PosteriorLoss raises without a forward model, with the JAX
    package's message, and with one gives a finite loss and both info
    terms; a CDiffE config reaches the training driver's refinement branch
    as a CDE config does, and it runs (tiny size, CPU)."""
    from dmip_tpu_torch.mains import main_diffusion_linear
    from dmip_tpu_torch.problems import LinearForwardProblem

    dims = {"xdim": 2, "ydim": 2}
    if name == "Posterior":
        model, cfg = train.get_model_from_args({"model": name, "hidden_layers": [16]}, dims)
        assert cfg.name == "PosteriorLoss"
        with pytest.raises(ValueError, match="requires the forward model"):
            model.make_loss_fn(cfg)
        loss = model.make_loss_fn(cfg, forward_model=LinearForwardProblem().forward,
                                  forward_params={"a": 0.1, "b": 0.05})
        gen = torch.Generator().manual_seed(0)
        x, y = torch.randn(8, 2, generator=gen), torch.randn(8, 2, generator=gen)
        val, info = loss(model.init(gen), gen, x, y)
        assert np.isfinite(float(val)) and sorted(info) == ["LikelihoodLoss", "PriorLoss"]
    else:
        model, cfg = train.get_model_from_args({"model": name, "loss_fn": "DSM"}, dims)
        assert (model.net_in, model.net_out, cfg.name) == (5, 4, "DSM")
        cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_linear_cdiffe.yml")))
        cfg.update(dataset_size=600, n_epochs=1, epochs_per_call=1, batch_size=50, hidden_layers=[16],
                   n_samples_y=1, n_samples_x=100, n_repeats=1, eval_num_steps=5, refine="mh,5,0.2",
                   train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"))
        main_diffusion_linear.run(cfg, device="cpu")
        rows = (tmp_path / "out_refined_mh5_0.2" / "results.csv").read_text().splitlines()
        assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])


def test_fourier_embedding_and_temporal_mlp_match_jax():
    """The Gaussian Fourier embedding and the TemporalMLP on weights carried
    across from dmip_tpu's init: the embedding to rtol 1e-6, the MLP on it
    also within 1e-7 absolute (its f32 sums run in another order, a few
    ulps at outputs of ~0.4); the port's init gives the same shapes."""
    import jax

    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, size=(16, 1)).astype(np.float32)
    w = jnets.fourier_init(jax.random.PRNGKey(0), 8, scale=30.0)
    got = nets.fourier_apply(torch.from_numpy(np.array(w)), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnets.fourier_apply(w, jnp.asarray(t))), rtol=1e-6)

    jw, jmlp = jnets.temporal_mlp_init(jax.random.PRNGKey(1), 4, 2, embed_dim=8, hidden_layers=(16,))
    tp = (torch.from_numpy(np.array(jw)), params_from_numpy([(np.asarray(a), np.asarray(b)) for a, b in jmlp]))
    x, y = (rng.normal(size=(16, 2)).astype(np.float32) for _ in range(2))
    want = jnets.temporal_mlp_apply((jw, jmlp), jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    got = nets.temporal_mlp_apply(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)

    pw, pmlp = nets.temporal_mlp_init(4, 2, 8, (16,), generator=torch.Generator().manual_seed(0))
    assert pw.shape == jw.shape and [a.shape for pair in pmlp for a in pair] == [a.shape for pair in jmlp for a in pair]
