"""Fused Metropolis chains (kernel B2): the port's plain version against the
JAX energy and MH sampler, and the JAX Pallas kernel's all-zero-bits
behaviour in interpret mode; the split-TF32 model of the kernel's hidden
products (``tf32_rna``, ``split_tf32_matmul``, the chains run with it) and
the kernel's weight layout.  The CUDA kernel itself is held against the
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
from dmip_tpu_torch.ops import split_tf32_study
from dmip_tpu_torch.ops.mh_kernel import (fused_mh_scatterometry, mh_chains_reference, pack_tf32_b,
                                          mh_energy, split_tf32_matmul, tf32_rna)
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
    # Langevin (MALA) proposals reach the same target
    x, _ = mcmc.anneal_to_energy(x0, lambda v: 0.5 * torch.sum(v**2, dim=1), 300, generator=gen,
                                 langevin_prop=True, lang_steps=1, stepsize=0.2)
    np.testing.assert_allclose(x.mean(0).numpy(), 0.0, atol=0.03)
    np.testing.assert_allclose(torch.cov(x.T).numpy(), np.eye(2), atol=0.05)


def _bits(v):
    return np.array(v, dtype=np.uint32).view(np.float32)


@pytest.mark.parametrize("src,want", [
    (0x3F800000, 0x3F800000),   # 1.0 is TF32 already
    (0x3F800FFF, 0x3F800000),   # below half an ulp: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0x3F801001, 0x3F802000),
    (0x3F803000, 0x3F804000),   # a tie above an odd mantissa: away, not to even
    (0xBF801000, 0xBF802000),   # negative tie: away from zero
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),   # the carry moves into the exponent
    (0x00001000, 0x00002000),   # subnormals round like normals
    (0x00000FFF, 0x00000000),
    (0x80001000, 0x80002000),
    (0x7F7FFFFF, 0x7F800000),   # the largest float rounds up to inf
    (0x7F800000, 0x7F800000),   # inf and NaN pass through, payload and all
    (0xFF800000, 0xFF800000),
    (0x7FC00001, 0x7FC00001),
    (0x7F800001, 0x7F800001),
])
def test_tf32_rna_bit_patterns(src, want):
    out = tf32_rna(torch.from_numpy(_bits([src]))).numpy().view(np.uint32)
    assert int(out[0]) == want, f"{src:#010x} -> {int(out[0]):#010x}, want {want:#010x}"


def test_split_tf32_matmul_against_float64():
    """ReLU activations times a surrogate-sized weight.  Against the float64
    product, relative to |a| @ |w|: f32, and the split product with 3 and 4
    terms, all stay within 2^-20 (f32's own max here is ~3e-7); the plain
    TF32 product (hi parts alone) is off by ~1e-4."""
    rng = np.random.default_rng(0)
    a = np.maximum(rng.normal(size=(512, 256)), 0).astype(np.float32)
    w = (rng.normal(size=(256, 256)) / 16).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    err = lambda out: float((np.abs(out.numpy().astype(np.float64) - ref) / scale).max())
    e32, e3, e4 = err(at @ wt), err(split_tf32_matmul(at, wt, 3)), err(split_tf32_matmul(at, wt, 4))
    assert max(e32, e3, e4) <= 2.0**-20, (e32, e3, e4)
    assert err(tf32_rna(at) @ tf32_rna(wt)) > 1e-5
    with pytest.raises(ValueError, match="terms"):
        split_tf32_matmul(at, wt, 2)


def test_split_tf32_chains_follow_the_f32_chains(problem):
    """4096 chains, numpy-made noise and uniforms: one step with the uniforms
    kept 2e-3 from the f32 threshold gives the f32 plain states exactly
    (chip_smoke.py's B2_STEP_TOL is 1e-5), and after 20 steps at most 0.2%
    of the chains end elsewhere (its B2_MISMATCH_SHARE is 2%), for 3 and
    4 terms."""
    _, y, weights = problem
    rng = np.random.default_rng(7)
    n, steps = 4096, 20
    x0 = torch.from_numpy(rng.uniform(-1, 1, size=(n, 3)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(steps, n, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(steps, n)).astype(np.float32))
    yt = torch.from_numpy(y)
    energy = mh_energy(weights, yt, KW["a"], KW["b"], KW["lambd_bd"])
    thr = torch.exp(energy(x0) - energy(x0 + 0.5 * z[0])).clamp(max=2.0)
    u1 = torch.where((u[0] - thr).abs() < 1e-3, torch.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u[0])[None]
    one = mh_chains_reference(weights, x0, yt, 1, noise=z[:1], uniforms=u1, **KW)
    full = mh_chains_reference(weights, x0, yt, steps, noise=z, uniforms=u, **KW)
    for terms in (3, 4):
        one_s = mh_chains_reference(weights, x0, yt, 1, noise=z[:1], uniforms=u1, terms=terms, **KW)
        assert torch.equal(one_s, one)
        full_s = mh_chains_reference(weights, x0, yt, steps, noise=z, uniforms=u, terms=terms, **KW)
        assert float(((full_s - full).abs().amax(1) > 1e-4).float().mean()) <= 2e-3


def test_plain_chains_float64_witness(problem):
    """The float64 run of the plain chains returns float32 states that
    agree with the f32 run after one step (no decision on a threshold: the
    uniforms are those of the JAX test above) and refuses split terms."""
    _, y, weights = problem
    rng = np.random.default_rng(8)
    x0 = torch.from_numpy(rng.uniform(-1, 1, size=(512, 3)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(1, 512, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(1, 512)).astype(np.float32))
    yt = torch.from_numpy(y)
    x64 = mh_chains_reference(weights, x0, yt, 1, noise=z, uniforms=u, dtype=torch.float64, **KW)
    x32 = mh_chains_reference(weights, x0, yt, 1, noise=z, uniforms=u, **KW)
    assert x64.dtype == torch.float32
    assert float(((x64 - x32).abs().amax(1) > 1e-6).float().mean()) <= 1 / 512
    with pytest.raises(ValueError, match="float32"):
        mh_chains_reference(weights, x0, yt, 1, noise=z, uniforms=u, dtype=torch.float64, terms=3, **KW)


def test_pack_tf32_b_is_the_kernels_fragment_layout():
    """A warp's fragment reads, replayed on the packed tensor, give back the
    weight: lane 4 g + t of n-tile pair np at k-step ks holds W[8 ks + t],
    W[8 ks + t + 4] at columns 16 np + g and 16 np + 8 + g.  Replaying the
    m16n8k8 products over the packed layout gives act @ W."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32))
    act = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    p = pack_tf32_b(w).reshape(16, 32, 32, 4)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    out = torch.zeros(64, 256, dtype=torch.float64)
    for np_ in range(16):
        for ks in range(32):
            frag = p[np_, ks]                       # (lane, 4)
            for nh in range(2):
                b = torch.zeros(8, 8)               # the 8 x 8 B tile rebuilt from the lanes
                b[t, g] = frag[:, 2 * nh]
                b[t + 4, g] = frag[:, 2 * nh + 1]
                n0 = 16 * np_ + 8 * nh
                torch.testing.assert_close(b, w[8 * ks:8 * ks + 8, n0:n0 + 8], rtol=0, atol=0)
                out[:, n0:n0 + 8] += act[:, 8 * ks:8 * ks + 8].double() @ b.double()
    torch.testing.assert_close(out, act.double() @ w.double())
    with pytest.raises(ValueError):
        pack_tf32_b(w[:, :96])
    with pytest.raises(ValueError):
        pack_tf32_b(w[:100])
    with pytest.raises(ValueError):
        pack_tf32_b(torch.zeros(640, 256))


def test_split_tf32_study_runs_small():
    """The numerics study behind the kernel's 3 terms, at a tiny size: every
    form reports its energy error against float64, and the split forms
    their agreement with the f32 chains."""
    out = split_tf32_study.study(chains=256, steps=4, seed=1, device="cpu")
    for form in ("f32", "split3", "split4"):
        assert 0.0 <= out[form]["energy_rel_p50"] <= out[form]["energy_rel_max"] < 1e-3
    for form in ("split3", "split4"):
        assert out[form]["step1_max_abs_vs_plain"] <= 1e-5
        assert 0.0 <= out[form]["share_vs_plain"] <= 0.02


def test_cpu_wrapper_rejects_kernel_diagnostics(problem):
    _, y, weights = problem
    x0 = torch.zeros(64, 3)
    with pytest.raises(ValueError, match="only by the CUDA kernel"):
        fused_mh_scatterometry(weights, x0, torch.from_numpy(y), 2, energy_out=torch.empty(64), **KW)
    with pytest.raises(ValueError, match="only by the CUDA kernel"):
        fused_mh_scatterometry(weights, x0, torch.from_numpy(y), 2, stamps=torch.zeros(30, dtype=torch.int64), **KW)
