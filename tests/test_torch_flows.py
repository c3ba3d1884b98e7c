"""dmip_tpu_torch's flows (GLOW coupling, INN, SNF), their losses and
gradients, the tree-general optimizer and checkpoints, held against
dmip_tpu on the CPU.

The same parameters go to both packages (JAX's init, carried across by
``params_from_numpy``).  Every stochastic layer is fed the JAX package's own
draws: its key schedule is rebuilt here (``SNF._apply`` splits the key once
a layer in the order the layers run; a layer's chain splits as
``dmip_tpu.mcmc`` does) and passed to the port's ``z=`` / ``draws=``.
Outputs then agree to f32 rounding: 1e-5 (an MH layer's log-det, a
difference of energies, relative to its size), gradients of the SNF loss
1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmip_tpu import checkpoints as jckpt
from dmip_tpu import flows as jflows
from dmip_tpu.nets import score_mlp_apply as jscore
from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import checkpoints, flows, pytree, train
from dmip_tpu_torch.checkpoints import load_archived_params, params_from_numpy
from dmip_tpu_torch.nets import score_mlp_apply
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "benchmarks", "checkpoints")
TOL = 1e-5
GRAD_TOL = 1e-4
N = 200


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _close_logdet(port, want):
    """An MH layer's log-det is a difference of two energies, each exact to
    f32 rounding of its own size: held at TOL of the largest log-det (the
    scatterometry energy reaches hundreds outside the prior's box)."""
    want = np.asarray(want)
    _close(port, want, TOL * max(1.0, float(np.abs(want).max())))


def _energies(problem):
    """(jax energy, torch energy, d, cond_dim, y) of a problem; y made from
    a numpy seed."""
    rng = np.random.default_rng(3)
    if problem == "linear":
        jp, tp = JLinear(), LinearForwardProblem()
        y = rng.normal(size=2).astype(np.float32)
        return (lambda x, ys: jp.log_posterior(x, ys)[:, 0]), (lambda x, ys: tp.log_posterior(x, ys)[:, 0]), 2, 2, y
    jf, fp = jscat.load_forward_model()
    tf, _ = scat.load_forward_model()
    a, b, lb = fp["a"], fp["b"], fp["lambd_bd"]
    f = np.asarray(jf(jnp.asarray([0.3, -0.5, 0.1])))
    y = (f + b * rng.normal(size=f.shape) + a * f * rng.normal(size=f.shape)).astype(np.float32)
    return (lambda x, ys: jscat.get_log_posterior(x, jf, a, b, ys, lb)), \
        (lambda x, ys: scat.get_log_posterior(x, tf, a, b, ys, lb)), 3, 23, y


# the SNF kinds: every stochastic layer kind, each behind a deterministic one
SNF_KINDS = {
    "mcmc": dict(),
    "mala": dict(langevin_prop=True, lang_steps_prop=2, step_size=5e-3),
    "langevin": dict(lang_steps=2, step_size=5e-3),
}


def _snfs(problem, kind):
    je, te, d, dc, y = _energies(problem)
    kw = dict(metr_steps_per_block=2, dimension=d, dimension_condition=dc, noise_std=0.4, **SNF_KINDS[kind])
    if problem == "scatterometry" and kind != "mcmc":
        kw["step_size"] = 1e-4
    jsnf = jflows.create_snf(2, 16, je, **kw)
    tsnf = flows.create_snf(2, 16, te, **kw)
    jp = jsnf.init(jax.random.PRNGKey(1))
    return jsnf, tsnf, jp, params_from_numpy(_np(jp)), d, dc, y


def _layer_draws(layer, key, n, d):
    """The draws a JAX stochastic layer makes from ``key``, in the port's
    layout."""
    shape = (n, d)
    if isinstance(layer, jflows.LangevinLayer):
        return {"eta": np.stack([jax.random.normal(k, shape) for k in jax.random.split(key, layer.lang_steps)])}
    noise, unif = [], []
    for k in jax.random.split(key, layer.metr_steps_per_block):
        kp, ka = jax.random.split(k)
        if isinstance(layer, jflows.MALALayer):
            noise.append(np.stack([jax.random.normal(kk, shape) for kk in jax.random.split(kp, layer.lang_steps)]))
        else:
            noise.append(np.asarray(jax.random.normal(kp, shape)))
        unif.append(np.asarray(jax.random.uniform(ka, (n,))))
    return {"noise": np.stack(noise), "uniforms": np.stack(unif)}


def _snf_draws(jsnf, key, n, d, backward=False):
    """Per layer (None for a deterministic one) the draws ``SNF._apply``
    makes from ``key``."""
    order = range(len(jsnf.layers))
    draws = [None] * len(jsnf.layers)
    for i in (reversed(order) if backward else order):
        key, k = jax.random.split(key)
        if not isinstance(jsnf.layers[i], jflows.DeterministicLayer):
            layer_draws = _layer_draws(jsnf.layers[i], k, n, d)
            draws[i] = {name: torch.as_tensor(np.asarray(v)) for name, v in layer_draws.items()}
    return draws


def _sample_draws(jsnf, key, n, d):
    """(z, per-layer draws) of ``SNF.sample(params, key, y, n)``."""
    kz, kf = jax.random.split(key)
    return torch.as_tensor(np.asarray(jax.random.normal(kz, (n, d)))), _snf_draws(jsnf, kf, n, d)


# --- coupling blocks and the INN ---------------------------------------------


@pytest.mark.parametrize("d,dc", [(2, 2), (3, 23)])
def test_coupling_and_inn_match_jax(d, dc):
    rng = np.random.default_rng(0)
    s = (3 * rng.normal(size=(N, 4))).astype(np.float32)
    _close(flows._log_e(torch.as_tensor(s), 1.4), jflows._log_e(jnp.asarray(s), 1.4))
    x = rng.normal(size=(N, d)).astype(np.float32)
    c = rng.normal(size=(N, dc)).astype(np.float32)
    jp = jflows.coupling_init(jax.random.PRNGKey(0), d, dc, 16)
    tp = params_from_numpy(_np(jp))
    for jfn, tfn in ((jflows.coupling_forward, flows.coupling_forward),
                     (jflows.coupling_inverse, flows.coupling_inverse)):
        want = jfn(jp, jnp.asarray(x), jnp.asarray(c), d)
        got = tfn(tp, torch.as_tensor(x), torch.as_tensor(c), d)
        _close(got[0], want[0])
        _close(got[1], want[1])
    jinn, tinn = jflows.create_inn(2, 16, d, dc), flows.create_inn(2, 16, d, dc)
    jp = jinn.init(jax.random.PRNGKey(2))
    tp = params_from_numpy(_np(jp))
    for name in ("forward", "inverse"):
        want = getattr(jinn, name)(jp, jnp.asarray(x), jnp.asarray(c))
        got = getattr(tinn, name)(tp, torch.as_tensor(x), torch.as_tensor(c))
        _close(got[0], want[0])
        _close(got[1], want[1])
    fx = tinn.forward(tp, torch.as_tensor(x), torch.as_tensor(c))[0]
    _close(tinn.inverse(tp, fx, torch.as_tensor(c))[0], x)
    key = jax.random.PRNGKey(4)
    y = c[0]
    want = jinn.sample(jp, key, jnp.asarray(y), 64)
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (64, d))))
    _close(tinn.sample(tp, torch.as_tensor(y), 64, z=z), want)


@pytest.mark.parametrize("d,dc", [(2, 2), (3, 23)])
def test_inn_ml_loss_and_gradient_match_jax(d, dc):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, d)).astype(np.float32)
    c = rng.normal(size=(N, dc)).astype(np.float32)
    jinn, tinn = jflows.create_inn(2, 16, d, dc), flows.create_inn(2, 16, d, dc)
    jp = jinn.init(jax.random.PRNGKey(3))
    jl, jg = jax.value_and_grad(lambda p: jflows.inn_ml_loss(jinn, p, jnp.asarray(x), jnp.asarray(c)))(jp)
    leaves = [t.requires_grad_(True) for t in pytree.leaves(params_from_numpy(_np(jp)))]
    tp = pytree.unflatten(params_from_numpy(_np(jp)), leaves)
    tl = flows.inn_ml_loss(tinn, tp, torch.as_tensor(x), torch.as_tensor(c))
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        _close(a, b)


# --- the SNF ------------------------------------------------------------------


@pytest.mark.parametrize("problem,kind", [("linear", "mcmc"), ("linear", "mala"), ("linear", "langevin"),
                                          ("scatterometry", "mcmc"), ("scatterometry", "mala")])
def test_snf_passes_match_jax_on_its_draws(problem, kind):
    """backward and forward on JAX's own draws; forward_all and sample
    (JAX's sample is a forward pass of its z) take the same path."""
    jsnf, tsnf, jp, tp, d, dc, y = _snfs(problem, kind)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.normal(size=(N, d))).astype(np.float32)
    ys = np.broadcast_to(y, (N, dc)).copy()
    key = jax.random.PRNGKey(5)
    for name, backward in (("backward", True), ("forward", False)):
        want = getattr(jsnf, name)(jp, key, jnp.asarray(x), jnp.asarray(ys))
        got = getattr(tsnf, name)(tp, torch.as_tensor(x), torch.as_tensor(ys),
                                  draws=_snf_draws(jsnf, key, N, d, backward))
        _close(got[0], want[0])
        _close_logdet(got[1], want[1])
    draws = _snf_draws(jsnf, key, N, d)
    outs = tsnf.forward_all(tp, torch.as_tensor(x), torch.as_tensor(ys), draws=draws)
    assert len(outs) == len(jsnf.layers) + 1 and torch.equal(outs[0], torch.as_tensor(x))
    _close(outs[-1], want[0])
    with torch.no_grad():
        got = tsnf.sample(tp, torch.as_tensor(y), N, z=torch.as_tensor(x), draws=draws)
    _close(got, want[0])


@pytest.mark.parametrize("kind", sorted(SNF_KINDS))
def test_snf_ml_loss_gradient_matches_jax(kind):
    """jax.grad differentiates through the Langevin gradient of the MALA
    and Langevin layers (dmip_tpu.mcmc has no stop_gradient).  The port
    matches only because ``mcmc.energy_grad`` keeps the graph inside a
    loss: with the gradient detached, as it was for the refinement chains,
    the MALA and Langevin cases fail."""
    jsnf, tsnf, jp, tp, d, dc, y = _snfs("linear", kind)
    rng = np.random.default_rng(4)
    x = (0.5 * rng.normal(size=(N, d))).astype(np.float32)
    ys = np.broadcast_to(y, (N, dc)).copy()
    key = jax.random.PRNGKey(6)
    jl, jg = jax.value_and_grad(lambda p: jflows.snf_ml_loss(jsnf, p, key, jnp.asarray(x), jnp.asarray(ys)))(jp)
    leaves = [t.requires_grad_(True) for t in pytree.leaves(tp)]
    tl = flows.snf_ml_loss(tsnf, pytree.unflatten(tp, leaves), torch.as_tensor(x), torch.as_tensor(ys),
                           draws=_snf_draws(jsnf, key, N, d, backward=True))
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, GRAD_TOL)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        _close(a, b, GRAD_TOL)


def test_snf_constructors_match_jax_layers():
    e = lambda x, ys: x.sum(1)
    for create in ("create_snf", "create_snf_last_layer"):
        for kw in SNF_KINDS.values():
            j = getattr(jflows, create)(3, 8, e, metr_steps_per_block=2, dimension=2, dimension_condition=2, **kw)
            t = getattr(flows, create)(3, 8, e, metr_steps_per_block=2, dimension=2, dimension_condition=2, **kw)
            assert [(type(a).__name__, vars(a)) for a in t.layers] == [(type(a).__name__, vars(a)) for a in j.layers]
            tp = t.init(torch.Generator().manual_seed(0))
            assert pytree.treedef(tp) == str(jax.tree_util.tree_structure(j.init(jax.random.PRNGKey(0))))


# --- the tree-general optimizer and checkpoints --------------------------------


def test_optimizer_on_a_flow_tree_matches_optax():
    jsnf, _, jp, tp, *_ = _snfs("linear", "mcmc")
    rng = np.random.default_rng(5)
    tx, opt = optax.adam(1e-2), train.build_optimizer(1e-2)
    js, ts = tx.init(jp), opt.init(tp)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), _np(jp))
        u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = opt.update(params_from_numpy(g), ts)
        tp = train.apply_updates(tp, tu)
    assert pytree.treedef(tp) == str(jax.tree_util.tree_structure(jp))
    for a, b in zip(pytree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(a, b, 1e-6)
    tl, jl = checkpoints._leaves(ts), jax.tree_util.tree_leaves(js)
    assert len(tl) == len(jl) and int(tl[0]) == int(jl[0]) == 3
    for a, b in zip(tl[1:], jl[1:]):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("name", ["inn", "snf"])
def test_flow_checkpoints_cross_load_between_packages(tmp_path, name):
    if name == "inn":
        jp = jflows.create_inn(2, 8, 2, 2).init(jax.random.PRNGKey(0))
    else:
        jp = _snfs("linear", "mcmc")[2]
    tx = optax.adam(1e-3)
    js = tx.init(jp)
    u, js = tx.update(jax.tree_util.tree_map(jnp.ones_like, jp), js, jp)
    jp = optax.apply_updates(jp, u)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, opt_state=js, step=1)
    like = params_from_numpy(_np(jp))
    opt = train.build_optimizer(1e-3)
    back = checkpoints.load_checkpoint(str(tmp_path / "jax"), like, opt.init(like))
    assert pytree.treedef(back["params"]) == str(jax.tree_util.tree_structure(jp))
    for a, b in zip(checkpoints._leaves(back["params"]) + checkpoints._leaves(back["opt_state"]),
                    jax.tree_util.tree_leaves(jp) + jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    checkpoints.save_checkpoint(str(tmp_path / "torch"), back["params"], back["opt_state"], step=1)
    with open(tmp_path / "torch" / "params.treedef.json") as f:
        assert json.load(f) == str(jax.tree_util.tree_structure(jp))
    restored = jckpt.load_checkpoint(str(tmp_path / "torch"), jp, tx.init(jp))
    for a, b in zip(jax.tree_util.tree_leaves((restored["params"], restored["opt_state"])),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(load_archived_params(str(tmp_path / "torch")), list)


def test_treedef_strings_round_trip():
    trees = [((1, 2),), [], {}, None, [(1,), {"a": None, "b": 2}], [[{"s1": ((1, 2),), "s2": ((3, 4),)}], ()]]
    for tree in trees:
        text = str(jax.tree_util.tree_structure(tree))
        parsed = pytree.parse_treedef(text)
        assert pytree.treedef(parsed) == text
        assert len(pytree.leaves(parsed)) == len(jax.tree_util.tree_leaves(tree))
    for bad in ("PyTreeDef({'b': *, 'a': *})", "PyTreeDef(CustomNode(namedtuple[S], [*]))", "PyTreeDef((*, *)"):
        with pytest.raises(ValueError):
            pytree.parse_treedef(bad)


def test_committed_baselines_load_and_match_jax():
    """benchmarks/checkpoints/baselines_{inn,snf,dsm}: the port's INN and SNF
    on a fixed z (and the SNF's MH layers on JAX's draws) against
    dmip_tpu.flows on the same archives; the DSM net's output likewise."""
    jf, fp = jscat.load_forward_model()
    tf, _ = scat.load_forward_model()
    a, b, lb = fp["a"], fp["b"], fp["lambd_bd"]
    y = np.asarray(jf(jnp.asarray([0.2, -0.4, 0.6])))
    key = jax.random.PRNGKey(7)
    n = 128

    jinn, tinn = jflows.create_inn(4, 64, 3, 23), flows.create_inn(4, 64, 3, 23)
    jp = jckpt.load_pytree(os.path.join(CKPT, "baselines_inn"), jinn.init(key), "params")
    tp = load_archived_params(os.path.join(CKPT, "baselines_inn"))
    z = jax.random.normal(key, (n, 3))
    _close(tinn.sample(tp, torch.as_tensor(y), n, z=torch.as_tensor(np.asarray(z))),
           jinn.sample(jp, key, jnp.asarray(y), n))

    kw = dict(metr_steps_per_block=10, dimension=3, dimension_condition=23, noise_std=0.4)
    jsnf = jflows.create_snf(4, 64, lambda x, ys: jscat.get_log_posterior(x, jf, a, b, ys, lb), **kw)
    tsnf = flows.create_snf(4, 64, lambda x, ys: scat.get_log_posterior(x, tf, a, b, ys, lb), **kw)
    jp = jckpt.load_pytree(os.path.join(CKPT, "baselines_snf"), jsnf.init(key), "params")
    tp = load_archived_params(os.path.join(CKPT, "baselines_snf"))
    assert pytree.treedef(tp) == str(jax.tree_util.tree_structure(jp))
    z, draws = _sample_draws(jsnf, key, n, 3)
    with torch.no_grad():
        got = tsnf.sample(tp, torch.as_tensor(y), n, z=z, draws=draws)
    _close(got, jsnf.sample(jp, key, jnp.asarray(y), n))

    tp = load_archived_params(os.path.join(CKPT, "baselines_dsm"))
    assert [w.shape for w, _ in tp] == [(27, 512), (512, 512), (512, 512), (512, 3)]
    jp = [(jnp.asarray(w.numpy()), jnp.asarray(bb.numpy())) for w, bb in tp]
    x = np.asarray(jax.random.uniform(key, (n, 3), minval=-1, maxval=1))
    ys = np.broadcast_to(y, (n, 23)).copy()
    _close(score_mlp_apply(tp, torch.as_tensor(x), torch.as_tensor(ys), 0.3),
           jscore(jp, jnp.asarray(x), jnp.asarray(ys), 0.3), 1e-4)
