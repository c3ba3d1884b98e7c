"""The analytic-guidance DPS slice: the port's guidance terms, its
``AnalyticGuidanceDPS`` and ``PosteriorDiffusionEstimator``, the guided E-M
sampler's plain version (kernel B5) and the ``dps_prior`` checkpoint against
dmip_tpu on the same inputs.  The CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmip_tpu import losses as JL
from dmip_tpu import nets as JN
from dmip_tpu import train as jtrain
from dmip_tpu.checkpoints import load_pytree as jax_load_pytree
from dmip_tpu.models import AnalyticGuidanceDPS as JAnalytic
from dmip_tpu.ops.dps_kernel import fused_guided_em_sampler as jax_fused_guided
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu.sde import VPSDE as JVPSDE
from dmip_tpu_torch import losses as L
from dmip_tpu_torch import nets, train
from dmip_tpu_torch.checkpoints import load_archived_params, params_from_numpy
from dmip_tpu_torch.models import AnalyticGuidanceDPS, PosteriorDiffusionEstimator
from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference
from dmip_tpu_torch.problems import scatterometry as scat
from dmip_tpu_torch.sde import VPSDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DPS_PRIOR = os.path.join(REPO, "benchmarks/checkpoints/dps_prior")
B = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _torch(jparams):
    return params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jparams])


def _small_nets():
    """tests/test_dps_kernel.py's nets and inputs (its PRNGKey(7) draws,
    passed to both packages as numpy arrays): prior 4 -> 32 -> 32 -> 3,
    surrogate 3 -> 16 -> 16 -> 5, 8 rows.  The guided trajectory amplifies
    f32 rounding, and the JAX package's own XLA path meets the tolerances
    below against its kernel on these inputs, not on every draw."""
    kp, ks, kx, ky = jax.random.split(jax.random.PRNGKey(7), 4)
    prior = JN.mlp_init(kp, 4, 3, (32, 32))
    surr = JN.mlp_init(ks, 3, 5, (16, 16))
    x0 = np.array(jax.random.normal(kx, (8, 3)))
    y = np.array(jax.random.normal(ky, (5,)) * 0.3)
    return prior, surr, x0, y


@pytest.mark.parametrize("guidance,clip,rows,steps,block,tol", [
    # the tolerances of tests/test_dps_kernel.py: clipped runs match tightly,
    ("dps", 10.0, 8, 8, 8, 2e-4),
    # unclipped guidance amplifies f32 rounding through the trajectory,
    ("dps", None, 8, 8, 8, 1e-2),
    # pgdm at the JAX test's own 5e-4: the Woodbury solve adds rounding,
    ("pgdm", 10.0, 8, 8, 8, 5e-4),
    # and a ragged batch: 11 rows in blocks of 4
    ("dps", 5.0, 11, 4, 4, 2e-4),
])
def test_plain_matches_pallas_kernel_interpret(guidance, clip, rows, steps, block, tol):
    prior, surr, x0, y = _small_nets()
    x0 = np.concatenate([x0, x0[:3]])[:rows]
    ref = np.asarray(jax_fused_guided(
        prior, surr, jnp.asarray(x0), jnp.asarray(y), a=0.2, b=0.1, guidance_clip=clip, num_steps=steps,
        noise_scale=0.0, block_rows=block, guidance=guidance, interpret=pltpu.InterpretParams()))
    out = guided_em_reference(_torch(prior), _torch(surr), torch.from_numpy(x0), torch.from_numpy(y), a=0.2,
                              b=0.1, guidance_clip=clip, num_steps=steps, noise_scale=0.0, guidance=guidance)
    assert out.shape == (rows, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


def _real_inputs(seed=0):
    """The dps_prior prior net and the scatterometry surrogate in both
    packages, x_t in the prior's box, y from the surrogate, t in
    [0.02, 0.5]."""
    prior = load_archived_params(DPS_PRIOR)["prior"]
    jprior = tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in prior)
    jfwd, fp = jscat.load_forward_model()
    fwd, _ = scat.load_forward_model()
    rng = np.random.default_rng(seed)
    xt = rng.uniform(-1, 1, size=(B, 3)).astype(np.float32)
    y = fwd(torch.from_numpy(rng.uniform(-0.8, 0.8, size=(B, 3)).astype(np.float32))).numpy()
    t = rng.uniform(0.02, 0.5, size=(B, 1)).astype(np.float32)
    return prior, jprior, fwd, jfwd, fp, xt, y, t


# f32 on both sides in other sum orders; 1/alpha and the b = 0.01
# precisions (up to 1e4) amplify the rounding of the VJPs
GUIDANCE_REL = 5e-5


def test_guidance_terms_match_jax():
    """likelihood_score_target (three surrogate and three prior VJPs) and
    pgdm_likelihood_score (Jacobian, Woodbury solve, gradient), the latter
    under torch.no_grad as the evaluation calls it."""
    prior, jprior, fwd, jfwd, fp, xt, y, t = _real_inputs()
    args = (VPSDE(), fwd, torch.from_numpy(xt), torch.from_numpy(y), torch.from_numpy(t))
    kw = dict(a=fp["a"], b=fp["b"])

    def jax_ref(fn):  # one jit compiles faster than eager op-by-op dispatch
        return jax.jit(lambda p, x, yy, tt: fn(JN.prior_mlp_apply, p, JVPSDE(), jfwd, x, yy, tt, **kw))(
            jprior, jnp.asarray(xt), jnp.asarray(y), jnp.asarray(t))

    want = jax_ref(JL.likelihood_score_target)
    got = L.likelihood_score_target(nets.prior_mlp_apply, prior, *args, **kw)
    assert _rel(got.numpy(), want) < GUIDANCE_REL
    want = jax_ref(JL.pgdm_likelihood_score)
    with torch.no_grad():
        got = L.pgdm_likelihood_score(nets.prior_mlp_apply, prior, *args, **kw)
    assert _rel(got.numpy(), want) < GUIDANCE_REL


@pytest.mark.parametrize("guidance,clip", [("dps", 100.0), ("dps", None), ("pgdm", 10.0)])
def test_analytic_guidance_apply_a_matches_jax(guidance, clip):
    """AnalyticGuidanceDPS.apply_a on dps_prior under torch.no_grad (the
    evaluation's score-MSE calls it so): the torch.func derivatives ignore
    the outer no_grad."""
    prior, jprior, fwd, jfwd, fp, xt, y, t = _real_inputs(seed=1)
    jmodel, _ = jtrain.get_model_from_args({"model": "Posterior"}, fp)
    model, _ = train.get_model_from_args({"model": "Posterior"}, fp)
    jag = JAnalytic(jmodel, jfwd, fp, guidance_clip=clip, guidance=guidance)
    ag = AnalyticGuidanceDPS(model, fwd, fp, guidance_clip=clip, guidance=guidance)
    want = jax.jit(jag.apply_a)({"prior": jprior}, jnp.asarray(xt), jnp.asarray(y), jnp.asarray(t))
    with torch.no_grad():
        got = ag.apply_a({"prior": prior}, torch.from_numpy(xt), torch.from_numpy(y), torch.from_numpy(t))
    assert _rel(got.numpy(), want) < GUIDANCE_REL


@pytest.mark.parametrize("guidance,clip", [("dps", 100.0), ("dps", 10.0), ("pgdm", 10.0)])
def test_plain_sampler_steps_match_jax_full_size(guidance, clip):
    """B5's plain version at the served shapes (dps_prior's 4 -> 512^3 -> 3
    prior, the 3 -> 256^3 -> 23 surrogate, b = 0.01), every step of the
    200-step grid against the JAX package's XLA E-M step through its
    AnalyticGuidanceDPS.apply_a, from the JAX trajectory's state, noise off.
    Whole trajectories are not comparable row by row: near s = T one step
    amplifies a difference in x about tenfold.  One step differs in f32
    rounding, amplified by 1/alpha and the 1/b^2 precisions, so each row's
    error is held relative to its step length: a bulk bound, and a few
    outliers where a ReLU unit or the capped direction turns."""
    prior, jprior, fwd, jfwd, fp, _, y, _ = _real_inputs()
    jmodel, _ = jtrain.get_model_from_args({"model": "Posterior"}, fp)
    jag = JAnalytic(jmodel, jfwd, fp, guidance_clip=clip, guidance=guidance)
    n, steps = B, 200
    x0 = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    cond = jnp.broadcast_to(jnp.asarray(y[0]), (n, y.shape[1]))

    @jax.jit
    def trajectory(x):  # the step of dmip_tpu.samplers.euler_maruyama, noise off
        def step(x, t_i):
            mu = jag.sde.mu(lambda xx, cc, ss: jag.apply_a({"prior": jprior}, xx, cc, ss),
                            jnp.full((n, 1), t_i, jnp.float32), x, cond, 0.0)
            x_next = x + (jag.sde.T / steps) * mu
            return x_next, (x, x_next)
        return jax.lax.scan(step, x, (jnp.arange(steps, dtype=jnp.float32) / steps) * jag.sde.T)[1]

    xs, xns = (np.asarray(v) for v in trajectory(jnp.asarray(x0)))
    rel = []
    for i in range(steps):
        got = guided_em_reference(prior, fwd.weights, torch.from_numpy(xs[i]), torch.from_numpy(y[0]), a=fp["a"],
                                  b=fp["b"], guidance_clip=clip, num_steps=steps, noise_scale=0.0,
                                  guidance=guidance, start_step=i, stop_step=i + 1).numpy()
        move = np.abs(xns[i] - xs[i]).max(1)
        rel.append(np.abs(got - xns[i]).max(1) / np.maximum(move, 1e-6))
    rel = np.concatenate(rel)
    assert np.isfinite(rel).all()
    assert np.median(rel) < 1e-4 and np.quantile(rel, 0.99) < 2e-3 and (rel > 1e-2).mean() < 5e-3


def test_plain_sampler_step_window():
    """Steps [0, 3) then [3, 8) of the grid, with the noise split to match,
    give [0, 8) exactly; a bad window raises."""
    prior, _, fwd, _, fp, _, y, _ = _real_inputs()
    gen = torch.Generator().manual_seed(5)
    x0, noise = torch.randn(32, 3, generator=gen), torch.randn(8, 32, 3, generator=gen)
    y0 = torch.from_numpy(y[0])
    kw = dict(a=fp["a"], b=fp["b"], guidance_clip=10.0, num_steps=200)
    for guidance in ("dps", "pgdm"):
        whole = guided_em_reference(prior, fwd.weights, x0, y0, stop_step=8, noise=noise, guidance=guidance, **kw)
        part = guided_em_reference(prior, fwd.weights, x0, y0, stop_step=3, noise=noise[:3], guidance=guidance, **kw)
        part = guided_em_reference(prior, fwd.weights, part, y0, start_step=3, stop_step=8, noise=noise[3:],
                                   guidance=guidance, **kw)
        torch.testing.assert_close(part, whole, rtol=0, atol=0)
    for start, stop in ((4, 4), (-1, 3), (0, 201)):
        with pytest.raises(ValueError, match="start_step"):
            guided_em_reference(prior, fwd.weights, x0, y0, start_step=start, stop_step=stop, **kw)


@pytest.mark.parametrize("guidance", ["dps", "pgdm"])
def test_plain_sampler_float64_agrees_with_float32(guidance):
    """dtype=float64 runs the same steps in double precision (the card's
    witness for f32 rounding): one step from the same f32 state and noise
    at the start, the middle and the end of the grid stays within f32
    rounding of the float32 run, relative to each row's step."""
    prior, _, fwd, _, fp, _, y, _ = _real_inputs()
    gen = torch.Generator().manual_seed(6)
    x0, noise = torch.randn(256, 3, generator=gen), torch.randn(1, 256, 3, generator=gen)
    y0 = torch.from_numpy(y[0])
    kw = dict(a=fp["a"], b=fp["b"], guidance_clip=10.0, num_steps=200, noise=noise, guidance=guidance)
    for i in (0, 100, 199):
        x32 = guided_em_reference(prior, fwd.weights, x0, y0, start_step=i, stop_step=i + 1, **kw)
        x64 = guided_em_reference(prior, fwd.weights, x0, y0, start_step=i, stop_step=i + 1,
                                  dtype=torch.float64, **kw)
        assert x32.dtype == torch.float32 and x64.dtype == torch.float64
        rel = ((x32.double() - x64).abs().amax(1) / (x64 - x0.double()).abs().amax(1).clamp(min=1e-6)).numpy()
        assert np.median(rel) < 1e-4 and np.quantile(rel, 0.99) < 2e-3


def test_dps_prior_checkpoint_leaf_order():
    """JAX flattens the {likelihood, prior} dict in sorted-key order: leaves
    0..7 are the likelihood net (27 -> 512^3 -> 3), 8..15 the prior (4 ->
    512^3 -> 3).  A swap would still run, so pin it: shapes, and the loaded
    nets give JAX's outputs on the JAX package's own restore of the file."""
    params = load_archived_params(DPS_PRIOR)
    assert sorted(params) == ["likelihood", "prior"]
    assert [w.shape for w, _ in params["prior"]] == [(4, 512), (512, 512), (512, 512), (512, 3)]
    assert [w.shape for w, _ in params["likelihood"]] == [(27, 512), (512, 512), (512, 512), (512, 3)]
    jmodel, _ = jtrain.get_model_from_args({"model": "Posterior"}, {"xdim": 3, "ydim": 23})
    jparams = jax_load_pytree(DPS_PRIOR, jmodel.init(jax.random.PRNGKey(0)), "params")
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(B, 3)).astype(np.float32)
    y = rng.normal(size=(B, 23)).astype(np.float32)
    t = rng.uniform(0.01, 1, size=(B, 1)).astype(np.float32)
    want = JN.prior_mlp_apply(jparams["prior"], jnp.asarray(x), jnp.asarray(t))
    got = nets.prior_mlp_apply(params["prior"], torch.from_numpy(x), torch.from_numpy(t))
    assert _rel(got.numpy(), want) < 1e-5
    model = PosteriorDiffusionEstimator(3, 23)
    want = jmodel.apply_a(jparams, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    got = model.apply_a(params, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t))
    assert _rel(got.numpy(), want) < 1e-5


def test_analytic_guidance_sample_paths_on_cpu():
    """On the CPU 'auto' is the plain scan; method 'kernel' runs the fused
    sampler's plain version (no launch), and without surrogate weights it
    raises; the Posterior model has no kernel; bad nets raise."""
    prior, _, fwd, _, fp, _, y, _ = _real_inputs()
    params = {"prior": prior}
    model = PosteriorDiffusionEstimator(3, 23)
    y0 = torch.from_numpy(y[0])
    ag = AnalyticGuidanceDPS(model, fwd, fp, guidance_clip=100.0, surrogate_weights=fwd.weights)
    before = fused_guided_em_sampler.launches
    a = ag.sample(params, y0, 32, 6, generator=torch.Generator().manual_seed(3))
    k = ag.sample(params, y0, 32, 6, generator=torch.Generator().manual_seed(3), method="kernel")
    assert a.shape == k.shape == (32, 3) and torch.isfinite(a).all() and torch.isfinite(k).all()
    assert fused_guided_em_sampler.launches == before
    with pytest.raises(ValueError, match="surrogate_weights"):
        AnalyticGuidanceDPS(model, fwd, fp).sample(params, y0, 8, 2, method="kernel")
    with pytest.raises(ValueError, match="no sampling kernel"):
        model.sample(load_archived_params(DPS_PRIOR), y0, 8, 2, method="kernel")
    assert model.sample(load_archived_params(DPS_PRIOR), y0, 8, 2).shape == (8, 3)
    x0 = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="xdim=3"):
        fused_guided_em_sampler(prior, fwd.weights, torch.zeros(4, 2), y0, a=0.2, b=0.01, guidance="pgdm")
    with pytest.raises(ValueError, match="xdim\\+1"):
        fused_guided_em_sampler(load_archived_params(DPS_PRIOR)["likelihood"], fwd.weights, x0, y0, a=0.2, b=0.01)
    with pytest.raises(ValueError, match="guidance"):
        fused_guided_em_sampler(prior, fwd.weights, x0, y0, a=0.2, b=0.01, guidance="analytic")


def test_cpu_wrapper_runs_plain_version_seeded():
    prior, _, fwd, _, fp, _, y, _ = _real_inputs()
    x0 = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    y0 = torch.from_numpy(y[0])
    for guidance in ("dps", "pgdm"):
        out = fused_guided_em_sampler(prior, fwd.weights, x0, y0, a=0.2, b=0.01, num_steps=5, seed=4,
                                      guidance=guidance)
        ref = guided_em_reference(prior, fwd.weights, x0, y0, a=0.2, b=0.01, num_steps=5, guidance=guidance,
                                  generator=torch.Generator().manual_seed(4))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_cpu_wrapper_rejects_stamps():
    """Clock stamps are the CUDA kernel's; the plain version on the CPU takes none."""
    prior, _, fwd, _, _, _, y, _ = _real_inputs()
    x0 = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="stamps"):
        fused_guided_em_sampler(prior, fwd.weights, x0, torch.from_numpy(y[0]), a=0.2, b=0.01, num_steps=2,
                                stamps=torch.zeros(30, dtype=torch.int64))
