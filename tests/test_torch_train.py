"""Training infrastructure against dmip_tpu: the t samplers and the prior's
inverse CDF on shared uniforms, the epoch batches, the optimizer against
optax on identical gradients, the skip-nonfinite step against
``make_train_step``, the epoch engine's chunking and resume, and
checkpoints that each package restores from the other."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmip_tpu import checkpoints as jckpt
from dmip_tpu import losses as JL
from dmip_tpu import train as jtrain
from dmip_tpu.nets import mlp_init, score_mlp_apply
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu.sde import VPSDE as JVPSDE
from dmip_tpu.sde import ReverseSDE as JReverseSDE
from dmip_tpu.sde import sample_t as jax_sample_t
from dmip_tpu_torch import checkpoints, data, train
from dmip_tpu_torch.checkpoints import adam_state_from_numpy, params_from_numpy
from dmip_tpu_torch.parallel import Mesh
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat
from dmip_tpu_torch.sde import VPSDE, ReverseSDE, sample_t


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30)


# --- SDE, prior and batches ------------------------------------------------


@pytest.mark.parametrize("debias", [True, False])
def test_sample_t_matches_jax_on_shared_uniforms(debias):
    key = jax.random.PRNGKey(4)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (500, 1))))
    ref = np.asarray(jax_sample_t(JReverseSDE(debias=debias), key, 500))
    out = sample_t(ReverseSDE(debias=debias), 500, u=u)
    _close(out.numpy(), ref, 1e-6)
    assert float(out.min()) >= 1e-4 and float(out.max()) <= 1.0
    if debias:
        d = VPSDE().sample_debiasing_t((500, 1), u=u)
        _close(d.numpy(), np.asarray(JVPSDE().sample_debiasing_t(key, (500, 1))), 1e-6)
    # the marginal sample is the diffusion of its own noise
    y0 = torch.randn(500, 2, generator=torch.Generator().manual_seed(1))
    yt, e, std, g = VPSDE().marginal_sample(out, y0, torch.Generator().manual_seed(2))
    torch.testing.assert_close(yt, VPSDE().diffuse(out, y0, e))
    assert g.shape == y0.shape and std.shape == out.shape


def test_inverse_cdf_prior_matches_jax():
    u = np.concatenate([[1e-7, 1e-4, 0.3, 0.5, 0.9995, 1 - 1e-7],
                        np.random.default_rng(0).uniform(size=200)]).astype(np.float32)
    ref = np.asarray(jscat.inverse_cdf_prior(jnp.asarray(u), 1000.0))
    _close(scat.inverse_cdf_prior(torch.from_numpy(u), 1000.0).numpy(), ref, 1e-6)
    # the prior puts 1/(lambd_bd + 1) of its mass outside [-1, 1], in
    # exponential tails that the u clip ends at |x| < 1 + log(1/(2e-7 lambd_bd)) ~ 9.5
    x = scat.sample_prior(20000, 1000.0, generator=torch.Generator().manual_seed(0))
    assert x.shape == (20000, 3) and bool(torch.isfinite(x).all()) and float(x.abs().max()) < 9.6
    assert float((x.abs() > 1).float().mean()) < 3e-3


def test_epoch_batches_shapes_and_noise():
    prob = LinearForwardProblem()
    gen = torch.Generator().manual_seed(0)
    xs, ys = data.generate_dataset_linear(2, prob.forward, 9050, gen)
    xb, yb = data.linear_epoch_batches(gen, xs, ys, prob.noise_std, 1000)
    assert xb.shape == (9, 1000, 2) and yb.shape == (9, 1000, 2)
    noise = (yb - prob.forward(xb.reshape(-1, 2)).reshape(9, 1000, 2)).reshape(-1)
    assert abs(float(noise.std()) / prob.noise_std - 1) < 0.03 and abs(float(noise.mean())) < 0.02
    # every row is one of the dataset's, once
    assert len({tuple(r) for r in xb.reshape(-1, 2).tolist()}) == 9000
    fwd, fp = scat.load_forward_model()
    xb, yb = data.scatterometry_epoch_batches(gen, fwd, fp["a"], fp["b"], fp["lambd_bd"], 50)
    assert xb.shape == (data.SCATTEROMETRY_BATCHES_PER_EPOCH, 50, 3) and yb.shape == (8, 50, 23)
    assert bool(torch.isfinite(yb).all())


# --- optimizer ----------------------------------------------------------------


def _grads(rng, shapes, scale):
    return [(scale * rng.normal(size=w).astype(np.float32), scale * rng.normal(size=b).astype(np.float32))
            for w, b in shapes]


@pytest.mark.parametrize("kind", ["adam", "clip", "cosine"])
def test_optimizer_matches_optax(kind):
    """Five steps on identical gradients.  With the clip at 1.0 the steps
    alternate between gradients of norm ~20 (clipped) and ~0.02 (not);
    the cosine schedule decays over 4 steps, so the fifth runs at the floor."""
    shapes = [((5, 8), (8,)), ((8, 2), (2,))]
    rng = np.random.default_rng(0)
    p0 = [(rng.normal(size=w).astype(np.float32), rng.normal(size=b).astype(np.float32)) for w, b in shapes]
    kw = {"adam": {}, "clip": {"grad_clip": 1.0}, "cosine": {"schedule": "cosine", "decay_steps": 4,
                                                             "lr_min_ratio": 0.1}}[kind]
    tx = jtrain.build_optimizer(1e-2, **kw)
    opt = train.build_optimizer(1e-2, **kw)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in p0)
    js = tx.init(jp)
    tp = params_from_numpy(p0)
    ts = opt.init(tp)
    for i in range(5):
        g = _grads(rng, shapes, 3.0 if i % 2 == 0 else 3e-3)
        u, js = tx.update(tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = opt.update(params_from_numpy(g), ts)
        tp = train.apply_updates(tp, tu)
    for (a, b), (c, d) in zip(tp, jp):
        _close(a.numpy(), c, 1e-6)
        _close(b.numpy(), d, 1e-6)
    jl = jax.tree_util.tree_leaves(js)
    tl = checkpoints._leaves(ts)
    assert len(jl) == len(tl)
    assert int(tl[0]) == int(jl[0]) == 5
    for a, b in zip(tl[1:], jl[1:]):
        _close(a.numpy(), b, 1e-6)


def _dsm_setup(hidden=(16,)):
    jp = mlp_init(jax.random.PRNGKey(0), 5, 2, hidden)
    rng = np.random.default_rng(1)
    x, y, eps = (rng.normal(size=(8, 2)).astype(np.float32) for _ in range(3))
    t = rng.uniform(0.1, 0.9, size=(8, 1)).astype(np.float32)
    return jp, x, y, eps, t


def test_train_step_matches_jax_and_skips_nonfinite():
    """A finite step matches make_train_step under optax.adam; a step whose
    gradients hold a nan keeps params and state, count included, on both
    sides."""
    jp, x, y, eps, t = _dsm_setup()
    jsde, sde = JVPSDE(), VPSDE()

    def jloss(p, key, xx, yy):
        z = jsde.diffuse(t, xx, eps)
        s = score_mlp_apply(p, z, yy, t) / jsde.g(t)
        return jnp.mean(JL.dsm_loss(s, jsde.std(t), eps)), {}

    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [16]},
                                           {"xdim": 2, "ydim": 2})
    loss = model.make_loss_fn(cfg)
    tloss = lambda p, g, xx, yy: loss(p, None, xx, yy, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    tx, opt = optax.adam(1e-3), train.build_optimizer(1e-3)
    jstep, tstep = jtrain.make_train_step(jloss, tx), train.make_train_step(tloss, opt)
    js, tp = tx.init(jp), params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    ts = opt.init(tp)
    bad = x.copy()
    bad[2, 0] = np.nan
    for xx in (x, bad):
        jp, js, jl, _ = jstep(jp, js, jax.random.PRNGKey(0), jnp.asarray(xx), jnp.asarray(y))
        prev = tp, ts
        tp, ts, tl, _ = tstep(tp, ts, None, torch.from_numpy(xx), torch.from_numpy(y))
    assert int(ts.count) == int(js[0].count) == 1
    assert all(torch.equal(a, b) for a, b in zip(checkpoints._leaves(tp), checkpoints._leaves(prev[0])))
    assert all(torch.equal(a, b) for a, b in zip(checkpoints._leaves(ts), checkpoints._leaves(prev[1])))
    for (a, b), (c, d) in zip(tp, jp):
        _close(a.numpy(), c, 1e-6)
        _close(b.numpy(), d, 1e-6)
    assert not np.isfinite(float(tl)) and not np.isfinite(float(jl))


# --- epoch engine and checkpoints -------------------------------------------


def _engine(epochs_per_call, loss_fn="PINNLoss"):
    prob = LinearForwardProblem()
    gen = torch.Generator().manual_seed(0)
    xs, ys = data.generate_dataset_linear(2, prob.forward, 48, gen)
    model, cfg = train.get_model_from_args(
        {"model": "CDE", "loss_fn": loss_fn, "hidden_layers": [16, 16], "divergence_method": "hutchinson",
         "lam": 0.1, "lam2": 0.1}, {"xdim": 2, "ydim": 2})
    opt = train.build_optimizer(1e-3, schedule="cosine", decay_steps=12)
    fn = train.make_epoch_fn(model.make_loss_fn(cfg, initial_condition=prob.score_posterior), opt,
                             lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 16),
                             epochs_per_call=epochs_per_call)
    return model, opt, fn


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(checkpoints._leaves(a), checkpoints._leaves(b)))


def test_epoch_engine_chunking_and_resume_are_exact(tmp_path):
    """Three epochs as 3 calls of 1, 1 call of 3, or 2 calls of 2 with the
    surplus epoch masked give identical params and state; so does stopping
    after 2 epochs, checkpointing, restoring and finishing."""
    model, opt, fn1 = _engine(1)
    params = model.init(torch.Generator().manual_seed(3))
    ref = train.fit(fn1, params, opt, 5, num_epochs=3, epochs_per_call=1, log_every=0)
    for epc in (3, 2):
        _, _, fn = _engine(epc)
        out = train.fit(fn, params, opt, 5, num_epochs=3, epochs_per_call=epc, log_every=0)
        assert _equal(out[0], ref[0]) and _equal(out[1], ref[1])
    half = train.fit(fn1, params, opt, 5, num_epochs=2, epochs_per_call=1, log_every=0)
    checkpoints.save_checkpoint(str(tmp_path), half[0], half[1], step=2, seed=5)
    back = checkpoints.load_checkpoint(str(tmp_path), params, opt.init(params))
    assert back["step"] == 2 and back["seed"] == 5
    out = train.fit(fn1, back["params"], opt, back["seed"], num_epochs=3, epochs_per_call=1, log_every=0,
                    opt_state=back["opt_state"], start_epoch=2)
    assert _equal(out[0], ref[0]) and _equal(out[1], ref[1])
    assert int(out[1].count) == 9 and int(out[1].schedule_count) == 9


@pytest.mark.parametrize("kind", ["adam", "clip", "cosine"])
def test_checkpoints_cross_load_between_packages(tmp_path, kind):
    kw = {"adam": {}, "clip": {"grad_clip": 1.0}, "cosine": {"schedule": "cosine", "decay_steps": 10}}[kind]
    tx, opt = jtrain.build_optimizer(1e-3, **kw), train.build_optimizer(1e-3, **kw)
    jp = mlp_init(jax.random.PRNGKey(0), 5, 2, (8,))
    g = jax.tree_util.tree_map(lambda a: 0.1 * jnp.ones_like(a), jp)
    js = tx.init(jp)
    for _ in range(3):
        u, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, opt_state=js, step=3)
    tp_like = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    back = checkpoints.load_checkpoint(str(tmp_path / "jax"), tp_like, opt.init(tp_like))
    assert back["step"] == 3
    for a, b in zip(checkpoints._leaves(back["opt_state"]), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert _equal(back["params"], tp_like)
    assert back["opt_state"].count.dtype == torch.int32

    checkpoints.save_checkpoint(str(tmp_path / "torch"), back["params"], back["opt_state"], step=3, seed=1)
    restored = jckpt.load_checkpoint(str(tmp_path / "torch"), jp, tx.init(jp))
    assert restored["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(restored["opt_state"]), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    inner = js[1][0] if kind == "clip" else js[0]
    st = adam_state_from_numpy(inner.count, inner.mu, inner.nu)
    assert int(st.count) == 3 and _equal(st.mu, back["opt_state"].mu) and _equal(st.nu, back["opt_state"].nu)


def test_select_epoch_fn_rejects_what_the_fused_engine_does_not_take():
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM"}, {"xdim": 2, "ydim": 2})
    opt = train.build_optimizer(1e-3)
    bad = {"model": "CDE", "loss_fn": "PINNLoss", "train_backend": "fused_pallas", "grad_clip": 1.0,
           "lr_schedule": "cosine", "train_guard": "always"}
    with pytest.raises(ValueError) as e:
        train.select_epoch_fn(bad, model, None, opt, None, 1)
    for why in ("loss_fn must be 'DSM'", "grad_clip", "lr_schedule", "train_guard"):
        assert why in str(e.value)
    with pytest.raises(ValueError, match="unknown train_backend"):
        train.select_epoch_fn({"train_backend": "fused"}, model, None, opt, None, 1)
    # a mesh of two ranks: the autograd engine takes it, the fused engine
    # refuses it with the JAX package's reason
    two = Mesh(2, 0, torch.device("cpu"), "gloo")
    assert callable(train.make_epoch_fn(model.make_loss_fn(cfg), opt, None, mesh=two))
    with pytest.raises(ValueError, match=r"multi-device mesh is not supported \(use train_backend: xla"):
        train.select_epoch_fn({"model": "CDE", "loss_fn": "DSM", "train_backend": "fused_pallas", "mesh": two},
                              model, None, opt, None, 1)
    with pytest.raises(ValueError, match="cosine"):
        train.build_optimizer(1e-3, schedule="cosine")
