"""dmip_tpu_torch nets, SDE closed forms, checkpoint loading and the model
factory, held against dmip_tpu on the same inputs (CPU, float32)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
def test_get_model_from_args_unported_models_raise(name):
    """Both models are built now, as in dmip_tpu; what of them is not
    ported yet raises NotImplementedError naming ROADMAP.md: the
    Posterior's PosteriorLoss training, and the training drivers'
    refinement branch, which a CDiffE config reaches as a CDE config does."""
    from dmip_tpu_torch.mains import main_diffusion_linear

    dims = {"xdim": 2, "ydim": 2}
    if name == "Posterior":
        model, cfg = train.get_model_from_args({"model": name}, dims)
        assert cfg.name == "PosteriorLoss"
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.make_loss_fn(cfg)
    else:
        model, cfg = train.get_model_from_args({"model": name, "loss_fn": "DSM"}, dims)
        assert (model.net_in, model.net_out, cfg.name) == (5, 4, "DSM")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main_diffusion_linear.run({"model": name, "loss_fn": "DSM", "refine": "mh5"}, device="cpu")
