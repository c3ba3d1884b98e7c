"""DPS-family training: the port's ``posterior_loss`` and
``PosteriorDiffusionEstimator.make_loss_fn`` against dmip_tpu's on the same
params, x, y, t and eps (the loss, both info values and every gradient leaf
of the prior and the likelihood net), a non-detached target as a negative
control of the gradient check, one train step on the {'prior',
'likelihood'} tree against JAX's under optax.adam, and the Posterior
model's checkpoints across packages and against the committed
``dps_prior``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmip_tpu import checkpoints as jckpt
from dmip_tpu import losses as JL
from dmip_tpu import nets as jnets
from dmip_tpu import train as jtrain
from dmip_tpu.sde import VPSDE as JVPSDE
from dmip_tpu.sde import sample_t as jax_sample_t
from dmip_tpu_torch import checkpoints, data, nets, pytree, train
from dmip_tpu_torch import losses as L
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.models import LossConfig
from dmip_tpu_torch.sde import VPSDE, sample_t
from dmip_tpu_torch.utils import MetricsWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shapes of tests/test_posterior_loss_parity.py
XDIM, YDIM, HID, B = 3, 4, (8, 8), 6
A_ERR, B_ERR, LAM = 0.2, 0.01, 0.5
# the tolerances of the JAX package's own torch mirror of the loss
# (tests/test_posterior_loss_parity.py), f32 on both sides: the target runs
# through three VJPs of the surrogate and three of the prior net in another
# sum order
LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 5e-3, 2e-6
# t per case: the JAX test's range, near t = 1e-3 (alpha ~ 1, std ~ 0.01)
# and near T = 1 (alpha ~ 0.007, the Tweedie estimate large)
T_RANGES = {"mid": (0.1, 0.9), "t_near_0": (1e-3, 1.2e-3), "t_near_T": (0.99, 1.0)}


def _forward_nets(seed=2):
    """The surrogate stand-in 3 -> 16 -> 4 relu: JAX's per-sample form and
    the port's batched form on the same weights."""
    jf = jnets.mlp_init(jax.random.PRNGKey(seed), XDIM, YDIM, (16,))
    tf = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jf])
    jfwd = lambda xi: jnets.mlp_apply(jf, xi[None], activation=jax.nn.relu)[0]
    tfwd = lambda x: nets.mlp_apply(tf, x, activation=torch.relu)
    return jfwd, tfwd


def _setup(case, seed=0):
    rng = np.random.default_rng(seed)
    prior = jnets.mlp_init(jax.random.PRNGKey(3), XDIM + 1, XDIM, HID)
    lik = jnets.mlp_init(jax.random.PRNGKey(4), XDIM + YDIM + 1, XDIM, HID)
    x, y, eps = (rng.normal(size=(B, d)).astype(np.float32) for d in (XDIM, YDIM, XDIM))
    lo, hi = T_RANGES[case]
    t = rng.uniform(lo, hi, size=(B, 1)).astype(np.float32)
    return {"prior": prior, "likelihood": lik}, x, y, eps, t


def _jax_value_and_grad(jparams, jfwd, x, y, eps, t):
    def loss_of(p):
        return JL.posterior_loss(
            jnets.prior_mlp_apply, jnets.score_mlp_apply, p["prior"], p["likelihood"], JVPSDE(), jfwd,
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(eps), jnp.asarray(t), a=A_ERR, b=B_ERR, lam=LAM,
        )

    return jax.value_and_grad(loss_of, has_aux=True)(jparams)


def _to_port(jparams):
    return params_from_numpy({k: [(np.asarray(w), np.asarray(b)) for w, b in v] for k, v in jparams.items()})


def _port_value_and_grad(loss_fn, tparams):
    leaves = [a.clone().requires_grad_(True) for a in pytree.leaves(tparams)]
    val, info = loss_fn(pytree.unflatten(tparams, leaves))
    return val, info, torch.autograd.grad(val, leaves)


def _grad_pairs(tgrads, jgrads, net):
    """(port, JAX) gradient leaves of one net, in JAX's leaf order."""
    names = ["likelihood"] * (2 * len(HID) + 2) + ["prior"] * (2 * len(HID) + 2)
    jl = jax.tree_util.tree_leaves(jgrads)
    return [(g.numpy(), np.asarray(h)) for g, h, n in zip(tgrads, jl, names) if n == net]


def _assert_matches(tval, tinfo, tgrads, jval, jinfo, jgrads):
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=LOSS_RTOL)
    assert sorted(tinfo) == sorted(jinfo) == ["LikelihoodLoss", "PriorLoss"]
    for k in jinfo:
        np.testing.assert_allclose(float(tinfo[k].detach()), float(jinfo[k]), rtol=LOSS_RTOL)
    for net in ("prior", "likelihood"):
        for g, h in _grad_pairs(tgrads, jgrads, net):
            np.testing.assert_allclose(g, h, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", sorted(T_RANGES))
def test_posterior_loss_matches_jax(case):
    """The loss, both info values and every gradient leaf of both nets."""
    jparams, x, y, eps, t = _setup(case)
    jfwd, tfwd = _forward_nets()
    (jval, jinfo), jgrads = _jax_value_and_grad(jparams, jfwd, x, y, eps, t)
    sde = VPSDE()
    xs = [torch.from_numpy(a) for a in (x, y, eps, t)]
    loss_fn = lambda p: L.posterior_loss(nets.prior_mlp_apply, nets.score_mlp_apply, p["prior"], p["likelihood"],
                                         sde, tfwd, xs[0], xs[1], xs[2], xs[3], a=A_ERR, b=B_ERR, lam=LAM)
    _assert_matches(*_port_value_and_grad(loss_fn, _to_port(jparams)), jval, jinfo, jgrads)


def test_a_target_kept_in_the_graph_fails_the_gradient_check():
    """Negative control: the same loss with the target left in the graph
    (s_prior attached, the VJPs under grad).  The target depends on the
    prior net only, so the prior net's gradient moves off JAX's
    ``stop_gradient`` one while the likelihood net's stays: the gradient
    check above tells the two forms apart."""
    jparams, x, y, eps, t = _setup("mid")
    jfwd, tfwd = _forward_nets()
    (jval, _), jgrads = _jax_value_and_grad(jparams, jfwd, x, y, eps, t)
    sde = VPSDE()
    xx, yy, ee, tt = (torch.from_numpy(a) for a in (x, y, eps, t))

    def undetached(p):
        x_t = sde.diffuse(tt, xx, ee)
        s_prior = nets.prior_mlp_apply(p["prior"], x_t, tt)
        s_lik = nets.score_mlp_apply(p["likelihood"], x_t, yy, tt)
        target = L.likelihood_score_target(nets.prior_mlp_apply, p["prior"], sde, tfwd, x_t, yy, tt,
                                           a=A_ERR, b=B_ERR, s_prior=s_prior)
        lik = torch.sum((sde.mean_weight(tt) * s_lik - target) ** 2, dim=1)
        return torch.mean(L.dsm_loss(s_prior, sde.std(tt), ee) + LAM * lik), {}

    val, _, grads = _port_value_and_grad(undetached, _to_port(jparams))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=LOSS_RTOL)
    for g, h in _grad_pairs(grads, jgrads, "likelihood"):
        np.testing.assert_allclose(g, h, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pytest.raises(AssertionError):
        for g, h in _grad_pairs(grads, jgrads, "prior"):
            np.testing.assert_allclose(g, h, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _models(hidden=HID):
    config = {"model": "Posterior", "lam": LAM, "hidden_layers": list(hidden)}
    dims = {"xdim": XDIM, "ydim": YDIM}
    return jtrain.get_model_from_args(config, dims), train.get_model_from_args(config, dims)


def test_make_loss_fn_matches_jax_on_its_draws():
    """dmip_tpu's loss_fn(params, key, x, y) against the port's on JAX's own
    t and eps (rebuilt from its key schedule: t from the first split, eps
    from the second); with a generator the port draws t, then eps."""
    (jmodel, jcfg), (model, cfg) = _models()
    jfwd, tfwd = _forward_nets()
    fparams = {"a": A_ERR, "b": B_ERR}
    jloss = jmodel.make_loss_fn(jcfg, forward_model=jfwd, forward_params=fparams)
    loss = model.make_loss_fn(cfg, forward_model=tfwd, forward_params=fparams)
    jparams, x, y, _, _ = _setup("mid", seed=5)
    key = jax.random.PRNGKey(9)
    (jval, jinfo), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams, key, jnp.asarray(x), jnp.asarray(y))
    kt, keps = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_t(jmodel.sde, kt, B)))
    eps = torch.from_numpy(np.array(jax.random.normal(keps, x.shape, jnp.float32)))
    xx, yy = torch.from_numpy(x), torch.from_numpy(y)
    tparams = _to_port(jparams)
    res = _port_value_and_grad(lambda p: loss(p, None, xx, yy, t=t, eps=eps), tparams)
    _assert_matches(*res, jval, jinfo, jgrads)

    gen = lambda: torch.Generator().manual_seed(4)
    g2 = gen()
    t2 = sample_t(model.sde, B, g2)
    eps2 = torch.randn(x.shape, generator=g2)
    drawn, _ = loss(tparams, gen(), xx, yy)
    given, _ = loss(tparams, None, xx, yy, t=t2, eps=eps2)
    assert torch.equal(drawn, given)


def test_make_loss_fn_refuses_another_loss_or_no_forward_model():
    (_, _), (model, cfg) = _models()
    _, tfwd = _forward_nets()
    with pytest.raises(ValueError, match="trains with the PosteriorLoss"):
        model.make_loss_fn(LossConfig(name="DSM"), forward_model=tfwd, forward_params={"a": 0.2, "b": 0.01})
    with pytest.raises(ValueError, match="requires the forward model"):
        model.make_loss_fn(cfg)
    with pytest.raises(ValueError, match="requires the forward model"):
        model.make_loss_fn(cfg, forward_model=tfwd)


def test_train_step_on_the_posterior_tree_matches_jax_and_skips_nonfinite():
    """One step of make_train_step on the {'prior', 'likelihood'} dict
    under optax.adam, on JAX's draws, matches dmip_tpu's; a batch holding a
    nan keeps params and Adam state, count included, on both sides."""
    (jmodel, jcfg), (model, cfg) = _models()
    jfwd, tfwd = _forward_nets()
    fparams = {"a": A_ERR, "b": B_ERR}
    jloss = jmodel.make_loss_fn(jcfg, forward_model=jfwd, forward_params=fparams)
    loss = model.make_loss_fn(cfg, forward_model=tfwd, forward_params=fparams)
    jp, x, y, _, _ = _setup("mid", seed=6)
    key = jax.random.PRNGKey(2)
    kt, keps = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_t(jmodel.sde, kt, B)))
    eps = torch.from_numpy(np.array(jax.random.normal(keps, x.shape, jnp.float32)))
    tloss = lambda p, g, xx, yy: loss(p, None, xx, yy, t=t, eps=eps)
    tx, opt = optax.adam(1e-3), train.build_optimizer(1e-3)
    jstep, tstep = jtrain.make_train_step(jloss, tx), train.make_train_step(tloss, opt)
    js, tp = tx.init(jp), _to_port(jp)
    ts = opt.init(tp)
    bad = x.copy()
    bad[1, 2] = np.nan
    for xx in (x, bad):
        jp, js, _, jinfo = jstep(jp, js, key, jnp.asarray(xx), jnp.asarray(y))
        prev = tp, ts
        tp, ts, _, tinfo = tstep(tp, ts, None, torch.from_numpy(xx), torch.from_numpy(y))
    assert sorted(tinfo) == ["LikelihoodLoss", "PriorLoss"]
    assert int(ts.count) == int(js[0].count) == 1
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(tp), pytree.leaves(prev[0])))
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(ts), pytree.leaves(prev[1])))
    # an Adam step moves each weight by ~lr; f32 in another sum order
    for a, b in zip(pytree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _tiny_run(tmp_path, num_epochs, epochs_per_call=1, **fit_kw):
    """The Posterior model (hidden (8,)) on scatterometry-shaped toy data
    through the autograd engine; returns (model, opt, fit's output)."""
    model, cfg = train.get_model_from_args({"model": "Posterior", "lam": 1.0, "hidden_layers": [8]},
                                           {"xdim": XDIM, "ydim": YDIM})
    _, tfwd = _forward_nets()
    gen = torch.Generator().manual_seed(0)
    xs = torch.rand(64, XDIM, generator=gen) * 2 - 1
    ys = tfwd(xs) + 0.01 * torch.randn(64, YDIM, generator=gen)
    loss = model.make_loss_fn(cfg, forward_model=tfwd, forward_params={"a": A_ERR, "b": B_ERR})
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(loss, opt, lambda g: data.linear_epoch_batches(g, xs, ys, 0.0, 16),
                             epochs_per_call=epochs_per_call)
    params = model.init(torch.Generator().manual_seed(1))
    return model, opt, train.fit(fn, params, opt, 5, num_epochs=num_epochs, epochs_per_call=epochs_per_call,
                                 log_every=0, **fit_kw)


def test_posterior_training_logs_both_terms_chunks_exactly_and_checkpoints(tmp_path):
    """Two epochs of the Posterior model: the per-epoch generator makes one
    call of 2 equal two calls of 1; both info terms reach their CSVs; the
    checkpoint with Adam state restores bit for bit, and JAX's
    load_checkpoint reads the same leaves."""
    with MetricsWriter(str(tmp_path / "logs")) as logger:
        model, opt, (params, state, info) = _tiny_run(tmp_path, 2, logger=logger)
    _, _, (params2, state2, _) = _tiny_run(tmp_path, 2, epochs_per_call=2)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves((params, state)), pytree.leaves((params2, state2))))
    assert sorted(info) == ["LikelihoodLoss", "PriorLoss"]
    for name in ("Train_Loss", "Train_PriorLoss", "Train_LikelihoodLoss"):
        rows = (tmp_path / "logs" / f"{name}.csv").read_text().splitlines()
        assert rows[0] == "Step,Value" and len(rows) == 3 and all(np.isfinite(float(r.split(",")[1])) for r in rows[1:])

    ckpt = str(tmp_path / "ckpt")
    checkpoints.save_checkpoint(ckpt, params, opt_state=state, step=2, seed=5)
    like = model.init(torch.Generator().manual_seed(9))
    back = checkpoints.load_checkpoint(ckpt, like, opt.init(like))
    assert back["step"] == 2 and back["seed"] == 5
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves((back["params"], back["opt_state"])),
                                                 pytree.leaves((params, state))))
    jmodel = _models(hidden=(8,))[0][0]
    jlike = jmodel.init(jax.random.PRNGKey(0))
    jback = jckpt.load_checkpoint(ckpt, jlike, optax.adam(1e-3).init(jlike))
    for a, b in zip(jax.tree_util.tree_leaves((jback["params"], jback["opt_state"])), pytree.leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_jax_posterior_checkpoint_and_dps_prior_load_as_the_driver_writes(tmp_path):
    """A Posterior checkpoint written by dmip_tpu.checkpoints loads in the
    port with the same leaves and Adam state, and the committed dps_prior
    archive parses to the tree the training driver writes (same treedef
    string, same shapes)."""
    jmodel = _models()[0][0]
    jp = jmodel.init(jax.random.PRNGKey(1))
    tx = optax.adam(1e-3)
    js = tx.init(jp)
    g = jax.tree_util.tree_map(lambda a: 0.1 * jnp.ones_like(a), jp)
    u, js = tx.update(g, js, jp)
    jp = optax.apply_updates(jp, u)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, opt_state=js, step=1)
    model = _models()[1][0]
    like = model.init(torch.Generator().manual_seed(0))
    opt = train.build_optimizer(1e-3)
    back = checkpoints.load_checkpoint(str(tmp_path / "jax"), like, opt.init(like))
    assert back["step"] == 1 and int(back["opt_state"].count) == 1
    for a, b in zip(pytree.leaves((back["params"], back["opt_state"].mu, back["opt_state"].nu)),
                    jax.tree_util.tree_leaves((jp, js[0].mu, js[0].nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    served = checkpoints.load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/dps_prior"))
    full, _ = train.get_model_from_args({"model": "Posterior"}, {"xdim": 3, "ydim": 23})
    written = full.init(torch.Generator().manual_seed(0))
    checkpoints.save_checkpoint(str(tmp_path / "driver"), written, step=0)
    with open(tmp_path / "driver" / "params.treedef.json") as f:
        assert f.read() == open(os.path.join(REPO, "benchmarks/checkpoints/dps_prior/params.treedef.json")).read()
    assert [a.shape for a in pytree.leaves(served)] == [a.shape for a in pytree.leaves(written)]
