"""dmip_tpu_torch's Heun and exponential-integrator samplers and the
sampler-method grammar, held against dmip_tpu on the CPU.

The JAX samplers draw x0 from ``split(key)[0]`` and, for the SDE form of
the exponential integrator, one normal a step from ``split(kscan,
num_steps + 1)``; these draws are rebuilt here and passed to the port's
``x0=`` and ``noise=``.  Outputs match to f32 rounding of the same
arithmetic: 1e-5 absolute at unit-scale samples after 12-16 steps (the SDE
form needs 16 or more: at 8 it amplifies the score's error, in both
packages, to samples of ~100).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmip_tpu import samplers as jsamplers
from dmip_tpu import sde as jsde
from dmip_tpu.checkpoints import load_pytree
from dmip_tpu.models import CDE as JCDE
from dmip_tpu.nets import mlp_init as jmlp_init
from dmip_tpu.nets import score_mlp_apply as jscore
from dmip_tpu_torch import nets, samplers, sde
from dmip_tpu_torch.checkpoints import load_archived_params
from dmip_tpu_torch.models import CDE, AnalyticGuidanceDPS, CDiffE, PosteriorDiffusionEstimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
N = 256


def _net():
    """The committed linear net (5 -> 512^3 -> 2) in both packages, and a
    condition: a trained score keeps the samples at the posterior's scale."""
    path = os.path.join(REPO, "benchmarks", "checkpoints", "linear_refined_winner")
    jp = load_pytree(path, jmlp_init(jax.random.PRNGKey(0), 5, 2, (512, 512, 512)), "params")
    y = np.array([0.4, -0.7], np.float32)
    return jp, load_archived_params(path), y


def _drifts(jp, tp):
    return (lambda z, c, s: jscore(jp, z, c, s)), (lambda z, c, s: nets.score_mlp_apply(tp, z, c, s))


def _x0(key, mean=0.0, std=1.0):
    k0, kscan = jax.random.split(key)
    return np.array(jax.random.normal(k0, (N, 2)) * std + mean), kscan


@pytest.mark.parametrize("num_steps", [12, 32])
def test_exp_nodes_match_jax(num_steps):
    """The served grid: uniform in lambda down to t_epsilon."""
    base_j, base_t = jsde.VPSDE(), sde.VPSDE()
    want = jsamplers._exp_nodes(base_j, num_steps, base_j.t_epsilon, "lambda", jnp.float32)
    got = samplers._exp_nodes(base_t, num_steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=0)


def test_heun_ode_matches_jax():
    """The deterministic flow from the same x0, with the corrector's last
    time clamped as in JAX."""
    jp, tp, y = _net()
    dj, dt = _drifts(jp, tp)
    key = jax.random.PRNGKey(7)
    want = jsamplers.heun_ode(jsde.ReverseSDE(), dj, key, jnp.asarray(y), N, 2, 12, mean=0.1, std=0.9)
    x0, _ = _x0(key, 0.1, 0.9)
    got = samplers.heun_ode(sde.ReverseSDE(), dt, torch.as_tensor(y), N, 2, 12, x0=torch.as_tensor(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("ode,order,num_steps", [
    (True, 1, 16), (True, 2, 16), (False, 1, 16), (False, 2, 16), (False, 1, 32),
])
def test_exponential_integrator_matches_jax(ode, order, num_steps):
    """The ODE forms from the same x0 (deterministic); the SDE forms also
    with JAX's per-step normals re-derived from its key schedule.  JAX's
    defaults (grid='lambda', final_denoise=True) are the port's only
    form; 32 SDE steps of order 1 is the served expint:sde:1 row."""
    jp, tp, y = _net()
    dj, dt = _drifts(jp, tp)
    key = jax.random.PRNGKey(11)
    want = jsamplers.exponential_integrator(jsde.ReverseSDE(), dj, key, jnp.asarray(y), N, 2, num_steps,
                                            ode=ode, order=order)
    x0, kscan = _x0(key)
    noise = np.stack([np.array(jax.random.normal(k, (N, 2))) for k in jax.random.split(kscan, num_steps + 1)])
    got = samplers.exponential_integrator(sde.ReverseSDE(), dt, torch.as_tensor(y), N, 2, num_steps, ode=ode,
                                          order=order, x0=torch.as_tensor(x0), noise=torch.as_tensor(noise))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", ["heun", "expint", "expint:ode", "expint:sde:2", "expint:ode:2", "expint:2"])
def test_model_sample_methods_take_the_samplers(method):
    """CDE.sample and the Posterior model's accept the JAX grammar and call
    the sampler it names, with the same generator, on the CPU."""
    model = CDE(xdim=2, ydim=2, hidden_layers=(32,))
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.tensor([0.3, -0.2])
    drift = lambda z, c, s: model.apply_a(params, z, c, s)
    got = model.sample(params, y, 64, 6, generator=torch.Generator().manual_seed(1), device="cpu", method=method)
    if method == "heun":
        want = samplers.heun_ode(model.sde, drift, y, 64, 2, 6, generator=torch.Generator().manual_seed(1))
    else:
        parts = method.split(":")[1:]
        want = samplers.exponential_integrator(model.sde, drift, y, 64, 2, 6, ode="ode" in parts,
                                               order=2 if "2" in parts else 1,
                                               generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    post = PosteriorDiffusionEstimator(xdim=2, ydim=2, hidden_layers=(16,))
    pp = post.init(torch.Generator().manual_seed(2))
    assert post.sample(pp, y, 32, 4, method=method, device="cpu").shape == (32, 2)


@pytest.mark.parametrize("method,error", [
    ("expint:ode:3", "bad expint option"), ("expint:heun", "bad expint option"), ("expintx", "unknown sampler"),
    ("euler", "unknown sampler"),
])
def test_model_sample_method_errors_match_jax(method, error):
    jm = JCDE(xdim=2, ydim=2, hidden_layers=(8,))
    with pytest.raises(ValueError, match=error):
        jm.sample(jm.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1), jnp.zeros(2), 8, 2, method=method)
    model = CDE(xdim=2, ydim=2, hidden_layers=(8,))
    with pytest.raises(ValueError, match=error):
        model.sample(model.init(torch.Generator().manual_seed(0)), torch.zeros(2), 8, 2, method=method)


@pytest.mark.parametrize("method", ["heun", "expint:ode:2"])
def test_cdiffe_and_analytic_guidance_reject_heun_and_expint(method):
    """As in dmip_tpu: the CDiffE's re-diffusion and the clipped guidance
    are SDE-specific."""
    cd = CDiffE(xdim=2, ydim=2, hidden_layers=(8,))
    with pytest.raises(ValueError, match="unsupported"):
        cd.sample(cd.init(torch.Generator().manual_seed(0)), torch.zeros(2), 8, 2, method=method)
    post = PosteriorDiffusionEstimator(xdim=3, ydim=23, hidden_layers=(8,))
    ag = AnalyticGuidanceDPS(post, lambda x: x, {"a": 0.2, "b": 0.01})
    with pytest.raises(ValueError, match="supports method"):
        ag.sample(post.init(torch.Generator().manual_seed(0)), torch.zeros(23), 8, 2, method=method, device="cpu")


def test_batched_sampler_matches_single_calls_and_jax_vmap():
    """The port's batched_sampler over three conditions, each with its own
    injected x0 and noise: bit for bit a loop of single calls, and within
    f32 rounding JAX's batched_sampler (a vmap over keys) of its
    Euler-Maruyama, whose draws are re-derived from each key's schedule."""
    from functools import partial

    jp, tp, _ = _net()
    dj, dt = _drifts(jp, tp)
    steps = 12
    ys = np.random.default_rng(2).normal(size=(3, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = jsamplers.batched_sampler(partial(jsamplers.euler_maruyama, jsde.ReverseSDE(), dj, num_samples=N, xdim=2,
                                             num_steps=steps))(keys, jnp.asarray(ys))
    draws = []
    for key in keys:
        x0, kscan = _x0(key)
        noise = np.stack([np.array(jax.random.normal(k, (N, 2))) for k in jax.random.split(kscan, steps)])
        draws.append((torch.as_tensor(x0), torch.as_tensor(noise)))
    one = lambda d, y: samplers.euler_maruyama(sde.ReverseSDE(), dt, y, N, 2, steps, x0=d[0], noise=d[1])
    got = samplers.batched_sampler(one)(draws, torch.as_tensor(ys))
    assert got.shape == (3, N, 2)
    loop = torch.stack([one(d, y) for d, y in zip(draws, torch.as_tensor(ys))])
    torch.testing.assert_close(got, loop, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="conditions"):
        samplers.batched_sampler(one)(draws[:2], torch.as_tensor(ys))
