"""The trial-stacked ensemble trainer (``dmip_tpu_torch.ensemble``) against
``dmip_tpu.ensemble`` and against the port's sequential autograd engine.

One K-trial step is held against JAX's vmapped ``_make_trial_step`` on the
same params and batch, with JAX's draws rebuilt from its key (as
``tests/test_torch_losses.py`` rebuilds them): per-trial loss, info, new
params and Adam state.  Whole runs are held against the port's
``train.make_epoch_fn`` run trial by trial, as ``tests/test_ensemble.py``
holds JAX's.  Small nets ([16, 16]), batches of at most 500."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmip_tpu import ensemble as jens
from dmip_tpu import train as jtrain
from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.sde import sample_t as jax_sample_t
from dmip_tpu_torch import checkpoints, data, ensemble, pytree, train
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.parallel import Mesh
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

B = 64
# f32 on both sides in other sum orders, through third derivatives of the
# net: tests/test_torch_losses.py's tolerance
REL = 2e-5
LAMS, LAM2S = [0.5, 0.05, 1.0], [1.0, 0.1, 0.3]
DIMS = {"xdim": 2, "ydim": 2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _config(loss_fn, pde_loss="FPE", pde_metric="L1", ic_metric="L1", div="exact"):
    return {"model": "CDE", "loss_fn": loss_fn, "hidden_layers": [16, 16], "pde_loss": pde_loss,
            "pde_metric": pde_metric, "ic_metric": ic_metric, "divergence_method": div}


@pytest.mark.parametrize("config,grad_clip,lams", [
    (_config("PINNLoss"), None, LAMS),
    (_config("PINNLoss"), 0.05, LAMS),
    (_config("DSM_PDE", pde_metric="L2"), None, LAMS),
    (_config("DSM_PDE", pde_metric="L2"), 0.05, LAMS),
    (_config("PINNLoss", pde_metric="L2", ic_metric="L2", div="hutchinson"), None, LAMS),
    # trial 1's loss and gradients are not finite: it keeps its params and
    # state while the other two update
    (_config("PINNLoss"), 0.05, [0.5, float("inf"), 1.0]),
])
def test_one_ensemble_step_matches_jax(config, grad_clip, lams):
    jmodel, jcfg = jtrain.get_model_from_args(config, DIMS)
    jopt = jtrain.build_optimizer(1e-3, grad_clip)
    jstep = jax.vmap(jens._make_trial_step(jmodel, jcfg, jopt, {"initial_condition": JLinear().score_posterior},
                                           True), in_axes=(0, 0, None, None, None, 0, 0))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 2)).astype(np.float32)
    y = rng.normal(size=(B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jens_p = jens.init_ensemble(jmodel, jax.random.PRNGKey(1), 3)
    jst = jax.vmap(jopt.init)(jens_p)
    jp, js, jloss, jinfo = jstep(jens_p, jst, key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lams),
                                 jnp.asarray(LAM2S))
    kt, keps, kprobe = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax_sample_t(jmodel.sde, kt, B)))
    eps = torch.from_numpy(np.array(jax.random.normal(keps, (B, 2))))
    v = (torch.from_numpy(np.array(jax.random.rademacher(kprobe, (B, 2), jnp.float32)))
         if config["divergence_method"] != "exact" else None)

    model, cfg = train.get_model_from_args(config, DIMS)
    opt = train.build_optimizer(1e-3, grad_clip)
    p0 = params_from_numpy([(np.asarray(w[0]), np.asarray(b[0])) for w, b in jens_p])
    ens = pytree.map(lambda a: a.unsqueeze(0).repeat(3, *([1] * a.ndim)), p0)
    step = ensemble.make_ensemble_step(model, cfg, opt, {"initial_condition": LinearForwardProblem().score_posterior})
    p, st, loss, info = step(ens, ensemble.init_opt_state(opt, ens), torch.tensor(lams), torch.tensor(LAM2S),
                             torch.from_numpy(x), torch.from_numpy(y), t, eps, v)

    ok = [i for i, lam in enumerate(lams) if np.isfinite(lam)]
    assert _rel(loss.numpy()[ok], np.asarray(jloss)[ok]) < REL
    assert sorted(info) == sorted(jinfo)
    for k in info:
        assert _rel(info[k].numpy()[ok], np.asarray(jinfo[k])[ok]) < REL, k
    for a, b in zip(pytree.leaves(p), jax.tree_util.tree_leaves(jp)):
        assert _rel(a.numpy()[ok], np.asarray(b)[ok]) < REL
    for a, b in zip(pytree.leaves(st), jax.tree_util.tree_leaves(js)):
        assert _rel(a.numpy()[ok], np.asarray(b)[ok]) < REL
    for i in set(range(3)) - set(ok):
        assert not np.isfinite(float(loss[i])) and not np.isfinite(float(jloss[i]))
        assert int(st.count[i]) == 0 == int(jax.tree_util.tree_leaves(js)[0][i])
        for a, b in zip(pytree.leaves(p), pytree.leaves(ens)):
            assert torch.equal(a[i], b[i])
    if ok != [0, 1, 2]:
        assert all(int(st.count[i]) == 1 for i in ok)


def _linear_batch_fn(n=2000, batch=500):
    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, n, torch.Generator().manual_seed(0))
    return prob, lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, batch)


def _sequential(model, cfg, opt, batch_fn, kw, lam, lam2, n_epochs, epc, init_seed=1, seed=2):
    loss_fn = model.make_loss_fn(dataclasses.replace(cfg, lam=lam, lam2=lam2), **kw)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=epc)
    params, _, _ = train.fit(fn, model.init(torch.Generator().manual_seed(init_seed)), opt, seed,
                             num_epochs=n_epochs, epochs_per_call=epc, log_every=0)
    return params


@pytest.mark.parametrize("problem,config,grad_clip", [
    ("linear", _config("PINNLoss"), None),
    ("linear", _config("DSM_PDE", pde_loss="cScoreFPE", pde_metric="L2"), 1.0),
    ("linear", _config("PINNLoss2", pde_metric="L2", div="hutchinson"), None),
    ("scatterometry", dict(_config("PINNLoss", ic_metric="L2"), hidden_layers=[16]), None),
])
def test_ensemble_matches_the_sequential_engine(problem, config, grad_clip):
    """3 trials, 2 epochs x 2 calls (the last call's second epoch masked
    away by num_epochs 3): each trial's params equal the sequential run
    with its lam / lam2 from the same init and seed; the history is (3, K)."""
    if problem == "linear":
        prob, batch_fn = _linear_batch_fn()
        kw, dims = {"initial_condition": prob.score_posterior}, DIMS
    else:
        fwd, fp = scat.load_forward_model()
        batch_fn = lambda g: data.scatterometry_epoch_batches(g, fwd, fp["a"], fp["b"], fp["lambd_bd"], 50)
        kw = {"initial_condition": scat.score_posterior(fwd, fp["a"], fp["b"], fp["lambd_bd"]),
              "forward_model": fwd, "forward_params": fp}
        dims = fp
    model, cfg = train.get_model_from_args(config, dims)
    opt = train.build_optimizer(1e-3, grad_clip)
    efn = ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, epochs_per_call=2, loss_kwargs=kw)
    ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 3)
    ens, hist = ensemble.ensemble_fit(efn, ens, opt, 2, 3, torch.tensor(LAMS), torch.tensor(LAM2S),
                                      epochs_per_call=2, log_every=0)
    assert hist.shape == (3, 3) and np.isfinite(hist).all()
    for i, (lam, lam2) in enumerate(zip(LAMS, LAM2S)):
        seq = _sequential(model, cfg, opt, batch_fn, kw, lam, lam2, 3, 2)
        for a, b in zip(pytree.leaves(ensemble.trial_params(ens, i)), pytree.leaves(seq)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_make_train_many_writes_logs_and_checkpoints(tmp_path):
    """The grid's train_many: per-trial Train/Loss logs and checkpoints that
    the port's load_checkpoint restores, with lam / lam2 in the manifest
    and the training seed; the params returned are the checkpoints' and the
    sequential runs'."""
    prob, batch_fn = _linear_batch_fn(1000)
    kw = {"initial_condition": prob.score_posterior}
    tm = ensemble.make_train_many(batch_fn, 1, 2, 1e-3, n_epochs=3, epochs_per_call=2, loss_kwargs=kw,
                                  device="cpu")
    model, cfg = train.get_model_from_args(_config("PINNLoss"), DIMS)
    full = [dict(_config("PINNLoss"), lam=lam, lam2=lam2) for lam, lam2 in zip(LAMS[:2], LAM2S[:2])]
    tdirs = [str(tmp_path / f"t{i}") for i in range(2)]
    logs = [str(tmp_path / f"t{i}" / "logs") for i in range(2)]
    out = tm(model, cfg, full, tdirs, logs)
    for i, (p, tdir) in enumerate(zip(out, tdirs)):
        back = checkpoints.load_checkpoint(tdir + "/checkpoint", model.init(torch.Generator().manual_seed(0)))
        assert back["extra"] == {"lam": LAMS[i], "lam2": LAM2S[i]} and back["step"] == 3 and back["seed"] == 2
        seq = _sequential(model, cfg, train.build_optimizer(1e-3), batch_fn, kw, LAMS[i], LAM2S[i], 3, 2)
        for a, b, c in zip(pytree.leaves(back["params"]), pytree.leaves(p), pytree.leaves(seq)):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)
        rows = (tmp_path / f"t{i}" / "logs" / "Train_Loss.csv").read_text().splitlines()
        assert rows[0] == "Step,Value" and [r.split(",")[0] for r in rows[1:]] == ["0", "1", "2"]


def test_backend_and_mesh_guards():
    """'pinned' resolves: on a mesh of several ranks it is pinned, as
    'auto' is, and on one device vmap; a mesh of several ranks is taken by
    the vmap engine; an unknown backend lists the options; 'auto' and
    'vmap' select vmap on one device."""
    _, batch_fn = _linear_batch_fn(1000)
    two = Mesh(2, 0, torch.device("cpu"), "gloo")
    assert ensemble.resolve_backend("pinned", two) == ensemble.resolve_backend("auto", two) == "pinned"
    assert ensemble.resolve_backend("pinned", None) == "vmap"
    assert callable(ensemble.make_train_many(batch_fn, 1, 2, 1e-3, 1, backend="pinned", mesh=None))
    with pytest.raises(ValueError, match="'auto', 'vmap', 'pinned'"):
        ensemble.make_train_many(batch_fn, 1, 2, 1e-3, 1, backend="shard_map")
    model, cfg = train.get_model_from_args(_config("PINNLoss"), DIMS)
    assert callable(ensemble.make_ensemble_epoch_fn(model, cfg, train.build_optimizer(1e-3), batch_fn, mesh=two))
    assert ensemble.resolve_backend("auto", None) == ensemble.resolve_backend("vmap", "auto") == "vmap"


def test_init_pad_and_trial_params_match_jax():
    lams, lam2s, n = ensemble.pad_trials([0.5, 0.05, 1.0], [1.0, 0.1, 0.3], 4)
    jl, jl2, jn = jens.pad_trials([0.5, 0.05, 1.0], [1.0, 0.1, 0.3], 4)
    assert n == jn == 3 and lams.tolist() == np.asarray(jl).tolist() and lam2s.tolist() == np.asarray(jl2).tolist()
    model, _ = train.get_model_from_args(_config("DSM_PDE"), DIMS)
    ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(4), 3)
    one = model.init(torch.Generator().manual_seed(4))
    for i in range(3):
        assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(ensemble.trial_params(ens, i)),
                                                     pytree.leaves(one)))
    st = ensemble.init_opt_state(train.build_optimizer(1e-3), ens)
    assert st.count.shape == (3,) and st.schedule_count is None and st.mu[0][0].shape == (3, 5, 16)


@pytest.mark.parametrize("config", [
    {"model": "CDE", "loss_fn": "DSM"},
    _config("PINNLoss"),
    _config("PINNLoss", div="hutchinson"),
    dict(_config("DSM_PDE", div="hutchinson"), model="CDiffE"),
])
def test_loss_draws_are_the_losses_own(config):
    """``loss_draws`` draws what the loss draws from the same generator, so
    the loss on the injected draws equals the loss on the generator."""
    prob = LinearForwardProblem()
    model, cfg = train.get_model_from_args(dict(config, hidden_layers=[8]), DIMS)
    loss = model.make_loss_fn(cfg, initial_condition=prob.score_posterior)
    params = model.init(torch.Generator().manual_seed(0))
    x, y = torch.randn(32, 2), torch.randn(32, 2)
    a, info_a = loss(params, torch.Generator().manual_seed(9), x, y)
    t, eps, v = model.loss_draws(cfg, torch.Generator().manual_seed(9), x, y)
    assert (v is not None) == (config.get("divergence_method") == "hutchinson")
    b, info_b = loss(params, None, x, y, t=t, eps=eps, v=v)
    assert a.item() == b.item() and all(info_a[k].item() == info_b[k].item() for k in info_a)
