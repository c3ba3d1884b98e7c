"""Fused Metropolis chains (kernel B2): the port's plain version against the
JAX energy and MH sampler, and the JAX Pallas kernel's all-zero-bits
behaviour in interpret mode.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmip_tpu import mcmc as jmcmc
from dmip_tpu.ops.mh_kernel import fused_mh_scatterometry as jax_fused_mh
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import mcmc
from dmip_tpu_torch.ops.mh_kernel import fused_mh_scatterometry, mh_chains_reference
from dmip_tpu_torch.problems import scatterometry as scat

KW = dict(noise_std=0.5, a=0.2, b=0.01, lambd_bd=1000.0)


@pytest.fixture(scope="module")
def problem():
    jfwd, _ = jscat.load_forward_model()
    x_true = jnp.asarray([[0.3, -0.5, 0.1]])
    y = np.array(jscat.noisy_forward(jax.random.PRNGKey(0), jfwd, x_true, 0.2, 0.01)[0])
    return jfwd, y, scat.load_surrogate_weights()


def _jax_energy(jfwd, y, x):
    ys = jnp.broadcast_to(jnp.asarray(y), (x.shape[0], y.shape[0]))
    return np.asarray(jscat.get_log_posterior(jnp.asarray(x), jfwd, 0.2, 0.01, ys, 1000.0))


def test_one_step_matches_jax_energy_composition(problem):
    """Injected proposal noise and uniforms; uniforms kept >= 1e-3 from the
    JAX accept threshold so f32 sum order cannot flip a decision.  Same
    decisions, states exact, energy differences within rtol 2e-5."""
    jfwd, y, weights = problem
    rng = np.random.default_rng(0)
    n = 2000
    x0 = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    z = rng.normal(size=(1, n, 3)).astype(np.float32)
    u = rng.uniform(size=(1, n)).astype(np.float32)
    xp = x0 + np.float32(0.5) * z[0]
    e0, ep = _jax_energy(jfwd, y, x0), _jax_energy(jfwd, y, xp)
    thr = np.exp(np.minimum(e0 - ep, 1.0))
    near = np.abs(u[0] - thr) < 1e-3
    u[0] = np.where(near, np.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u[0])
    acc = u[0] < np.exp(e0 - ep)
    assert 0.02 < acc.mean() < 0.98
    x_ref = np.where(acc[:, None], xp, x0)
    ys = torch.from_numpy(y).reshape(1, -1)
    energy = lambda x: scat.get_log_posterior(x, lambda v: scat.surrogate_apply(weights, v), 0.2, 0.01, ys, 1000.0)
    x_t, de = mcmc.anneal_to_energy(torch.from_numpy(x0), energy, 1, 0.5,
                                    noise=torch.from_numpy(z), uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(x_t.numpy(), x_ref)
    np.testing.assert_allclose(de.numpy(), np.where(acc, ep - e0, 0.0), rtol=2e-5, atol=2e-2)
    x_w = mh_chains_reference(weights, torch.from_numpy(x0), torch.from_numpy(y), 1,
                              noise=torch.from_numpy(z), uniforms=torch.from_numpy(u), **KW)
    np.testing.assert_array_equal(x_w.numpy(), x_ref)


def test_all_zero_bits_rejects_like_the_interpreted_pallas_kernel(problem):
    """The Pallas interpreter's PRNG returns zero bits: u = 2^-24 and a
    Box-Muller normal of sqrt(-2 ln 2^-24) cos(2 pi 2^-24).  Every proposal
    lands far outside the box and is rejected, on both sides."""
    jfwd, y, weights = problem
    x0 = np.random.default_rng(1).uniform(-1, 1, size=(64, 3)).astype(np.float32)
    jw = jscat.load_surrogate_weights()
    out_j = np.asarray(jax_fused_mh(jw, jnp.asarray(x0), jnp.asarray(y), 3, block_rows=64,
                                    interpret=pltpu.InterpretParams(), **KW))
    np.testing.assert_array_equal(out_j, x0)
    u0 = np.float32(2.0**-24)
    z0 = np.sqrt(-2.0 * np.log(u0)) * np.cos(2 * np.pi * u0)
    noise = torch.full((3, 64, 3), float(z0))
    uniforms = torch.full((3, 64), float(u0))
    out_t = mh_chains_reference(weights, torch.from_numpy(x0), torch.from_numpy(y), 3,
                                noise=noise, uniforms=uniforms, **KW)
    np.testing.assert_array_equal(out_t.numpy(), x0)


def test_chains_match_jax_anneal_to_energy_in_distribution(problem):
    """3000 chains x 200 steps on each side from the same uniform starts;
    per-coordinate mean and std agree within 0.03 (standard errors
    ~0.005 at this count)."""
    jfwd, y, weights = problem
    n, steps = 3000, 200
    x0 = np.random.default_rng(2).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    ys = jnp.broadcast_to(jnp.asarray(y), (n, 23))
    energy = lambda x: jscat.get_log_posterior(x, jfwd, 0.2, 0.01, ys, 1000.0)
    xj, _ = jax.jit(lambda k, x: jmcmc.anneal_to_energy(k, x, energy, steps, noise_std=0.5))(
        jax.random.PRNGKey(3), jnp.asarray(x0))
    xj = np.asarray(xj)
    xt = fused_mh_scatterometry(weights, torch.from_numpy(x0), torch.from_numpy(y), steps, seed=4, **KW).numpy()
    np.testing.assert_allclose(xt.mean(0), xj.mean(0), atol=0.03)
    np.testing.assert_allclose(xt.std(0), xj.std(0), atol=0.03)


def test_cpu_wrapper_runs_plain_version_seeded(problem):
    _, y, weights = problem
    x0 = torch.rand(256, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    before = fused_mh_scatterometry.launches
    out = fused_mh_scatterometry(weights, x0, torch.from_numpy(y), 5, seed=9, **KW)
    ref = mh_chains_reference(weights, x0, torch.from_numpy(y), 5,
                              generator=torch.Generator().manual_seed(9), **KW)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert fused_mh_scatterometry.launches == before


def test_anneal_to_energy_targets_standard_normal():
    gen = torch.Generator().manual_seed(0)
    x0 = torch.rand(20_000, 2, generator=gen) * 6 - 3
    x, de = mcmc.anneal_to_energy(x0, lambda v: 0.5 * torch.sum(v**2, dim=1), 300, 0.5, gen)
    np.testing.assert_allclose(x.mean(0).numpy(), 0.0, atol=0.03)
    np.testing.assert_allclose(torch.cov(x.T).numpy(), np.eye(2), atol=0.05)
    assert de.shape == (20_000,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mcmc.anneal_to_energy(x0, lambda v: v.sum(1), 1, langevin_prop=True)
