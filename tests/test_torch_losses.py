"""Training losses: the port's DSM, DSM_PDE, PINNLoss and PINNLoss2 against
dmip_tpu's on the same params, x, y, t, eps and Hutchinson probe -- the
loss value, the info dict and the parameter gradients (JAX side:
``jax.value_and_grad`` over ``DiffusionModel.make_loss_fn``, with t, eps and
the probe rebuilt from its key schedule and fed to the port's injection
form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmip_tpu import train as jtrain
from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.sde import sample_t as jax_sample_t
from dmip_tpu_torch import losses as L
from dmip_tpu_torch import train
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.sde import VPSDE

B = 16
# f32 on both sides; the sums run in other orders, and the PDE terms go
# through third derivatives of the net
REL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name,pde_loss,div,pde_metric,ic_metric", [
    ("DSM", "FPE", "exact", "L1", "L1"),
    ("DSM_PDE", "FPE", "exact", "L1", "L1"),
    ("DSM_PDE", "FPE", "hutchinson", "L2", "L1"),
    ("DSM_PDE", "cScoreFPE", "exact", "L2", "L1"),
    ("PINNLoss", "FPE", "exact", "L1", "L2"),
    ("PINNLoss", "FPE", "hutchinson", "L2", "L1"),
    ("PINNLoss", "cScoreFPE", "exact", "L1", "L2"),
    ("PINNLoss2", "FPE", "exact", "L2", "L1"),
    ("PINNLoss2", "FPE", "approx", "L1", "L2"),
    ("PINNLoss2", "cScoreFPE", "exact", "L2", "L2"),
])
def test_loss_value_info_and_grads_match_jax(name, pde_loss, div, pde_metric, ic_metric):
    config = {"model": "CDE", "loss_fn": name, "hidden_layers": [32, 32], "lam": 0.3, "lam2": 0.7,
              "pde_loss": pde_loss, "divergence_method": div, "pde_metric": pde_metric, "ic_metric": ic_metric}
    dims = {"xdim": 2, "ydim": 2}
    jmodel, jcfg = jtrain.get_model_from_args(config, dims)
    jloss = jmodel.make_loss_fn(jcfg, initial_condition=JLinear().score_posterior)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 2)).astype(np.float32)
    y = rng.normal(size=(B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jp = jmodel.init(jax.random.PRNGKey(3))
    (jval, jinfo), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp, key, jnp.asarray(x), jnp.asarray(y))
    # the JAX loss's own draws, rebuilt from its key schedule
    kt, keps, kprobe = jax.random.split(key, 3)
    t = np.array(jax_sample_t(jmodel.sde, kt, B))
    eps = np.array(jax.random.normal(keps, (B, 2)))
    v = np.array(jax.random.rademacher(kprobe, (B, 2), jnp.float32))

    model, cfg = train.get_model_from_args(config, dims)
    loss = model.make_loss_fn(cfg, initial_condition=LinearForwardProblem().score_posterior)
    params = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    leaves = [p.requires_grad_(True) for pair in params for p in pair]
    val, info = loss(params, None, torch.from_numpy(x), torch.from_numpy(y), t=torch.from_numpy(t),
                     eps=torch.from_numpy(eps), v=torch.from_numpy(v))
    grads = torch.autograd.grad(val, leaves)

    assert _rel(val.item(), float(jval)) < REL
    assert sorted(info) == sorted(jinfo)
    for k in info:
        assert _rel(info[k].item(), float(jinfo[k])) < REL, k
    jg = [g for pair in jgrads for g in pair]
    for g, h in zip(grads, jg):
        assert _rel(g.numpy(), h) < REL


def test_loss_fn_draws_t_then_eps_then_probe_from_the_generator():
    """The sampling form draws t (one torch.rand((B, 1)) through sample_t),
    eps and the Rademacher probe, in that order, from the generator."""
    model, cfg = train.get_model_from_args(
        {"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [8], "divergence_method": "hutchinson"},
        {"xdim": 2, "ydim": 2})
    loss = model.make_loss_fn(cfg, initial_condition=LinearForwardProblem().score_posterior)
    params = model.init(torch.Generator().manual_seed(0))
    x, y = torch.randn(B, 2), torch.randn(B, 2)
    a, info_a = loss(params, torch.Generator().manual_seed(5), x, y)
    g = torch.Generator().manual_seed(5)
    from dmip_tpu_torch.sde import sample_t

    t = sample_t(model.sde, B, g)
    eps = torch.randn(B, 2, generator=g)
    v = L.rademacher_like((B, 2), g)
    b, info_b = loss(params, None, x, y, t=t, eps=eps, v=v)
    assert a.item() == b.item() and all(info_a[k].item() == info_b[k].item() for k in info_a)
    with pytest.raises(ValueError, match="probe"):
        L.score_fpe_loss(model.apply_a, params, model.sde.base, x, eps, y, t, divergence_method="hutchinson")


def test_score_fpe_residual_on_the_stationary_gaussian_score():
    """With the stationary score s(x) = -x the spatial term
    grad_x(div s + |s|^2 + x . s) vanishes, so the ScoreFPE residual is the
    path term alone: -(alpha'(t) z0 + std'(t) eps) (tests/test_losses.py
    holds the JAX loss to the same)."""
    sde = VPSDE()

    def apply_a(params, z, cond, t):
        return sde.g(torch.as_tensor(t).reshape(-1, 1).expand(z.shape[0], 1)) * (-z)

    g = torch.Generator().manual_seed(0)
    z0, eps = torch.randn(5, 2, generator=g), torch.randn(5, 2, generator=g)
    t = torch.full((5, 1), 0.4)
    for div, v in (("exact", None), ("hutchinson", L.rademacher_like((5, 2), g))):
        vals = L.score_fpe_loss(apply_a, None, sde, z0, eps, None, t, metric="L1", divergence_method=div, v=v)
        h = 1e-3
        tt = torch.tensor([0.4 + h, 0.4 - h], dtype=torch.float64)
        alpha_p = float(VPSDE().mean_weight(tt).diff()) / (-2 * h)
        std_p = float(VPSDE().std(tt).diff()) / (-2 * h)
        res = -(alpha_p * z0 + std_p * eps)
        torch.testing.assert_close(vals, res.abs().mean(1), rtol=1e-4, atol=1e-6)


def test_divergence_helpers():
    a = torch.tensor([[2.0, 1.0], [0.5, -3.0]])
    f = lambda x: a @ x
    x = torch.tensor([0.3, -0.7])
    assert float(L.divergence_exact(f, x)) == pytest.approx(-1.0)
    v = torch.tensor([1.0, -1.0])
    assert float(L.divergence_hutchinson(f, x, v)) == pytest.approx(float(v @ (a.T @ v)))
    probes = L.rademacher_like((1000,), torch.Generator().manual_seed(0))
    assert set(probes.unique().tolist()) == {-1.0, 1.0}
