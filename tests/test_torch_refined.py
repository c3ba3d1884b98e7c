"""dmip_tpu_torch's MCMC chains, energy refinement, linear energy and ELBO
tools, held against dmip_tpu on the CPU.

Every chain is fed the JAX package's own draws: its key schedule is rebuilt
here (``split(key, steps)``, then ``split(k)`` into (kn, ka), or (kl, ka)
and ``split(kl, lang_steps)`` for MALA), the same normals and uniforms are
drawn with JAX and passed to the port's ``noise=`` / ``uniforms=`` /
``eta=``.  The port then matches JAX to f32 rounding: states within 1e-5
absolute, energies within 1e-5 relative.  Each chain runs on the linear
energy and on the scatterometry energy (the surrogate posterior).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmip_tpu import mcmc as jmcmc
from dmip_tpu import sde as jsde
from dmip_tpu.models import refined as jrefined
from dmip_tpu.nets import mlp_init as jmlp_init
from dmip_tpu.nets import score_mlp_apply as jscore
from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import mcmc, nets, sde
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
from dmip_tpu_torch.mains import main_diffusion_linear, main_diffusion_scatterometry
from dmip_tpu_torch.models import refined
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_ATOL = 1e-5
E_RTOL = 1e-5
N = 400
# per problem: a random-walk std, a Langevin step size
STEP = {"linear": (0.2, 0.02), "scatterometry": (0.05, 1e-4)}


def _problem(name):
    """(jax energy, torch energy, x0, y) at N chains: x0 near the posterior
    of an observation y made from a numpy seed."""
    rng = np.random.default_rng(3)
    if name == "linear":
        jp, tp = JLinear(), LinearForwardProblem()
        x_true = np.array([0.4, -0.3], np.float32)
        y = (np.asarray(jp.forward(jnp.asarray(x_true))) + 0.5 * rng.normal(size=2)).astype(np.float32)
        x0 = (0.7 * rng.normal(size=(N, 2))).astype(np.float32)
        je = lambda x, ys: jp.log_posterior(x, ys)[:, 0]
        te = lambda x, ys: tp.log_posterior(x, ys)[:, 0]
    else:
        jf, fp = jscat.load_forward_model()
        tf, _ = scat.load_forward_model()
        a, b, lb = fp["a"], fp["b"], fp["lambd_bd"]
        x_true = np.array([0.3, -0.5, 0.1], np.float32)
        f = np.asarray(jf(jnp.asarray(x_true)))
        y = (f + b * rng.normal(size=f.shape) + a * f * rng.normal(size=f.shape)).astype(np.float32)
        x0 = (x_true + 0.1 * rng.normal(size=(N, 3))).astype(np.float32)
        je = lambda x, ys: jscat.get_log_posterior(x, jf, a, b, ys, lb)
        te = lambda x, ys: scat.get_log_posterior(x, tf, a, b, ys, lb)
    ys = np.broadcast_to(y, (N, y.shape[0])).copy()
    return (lambda x: je(x, jnp.asarray(ys))), (lambda x: te(x, torch.as_tensor(ys))), x0, y, je, te


def _t(a):
    return torch.as_tensor(np.array(a))


def _close_x(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), rtol=0, atol=X_ATOL)


def _close_e(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), rtol=E_RTOL, atol=E_RTOL)


def _rw_draws(key, steps, shape):
    """A random-walk chain's normals (steps, n, d) and uniforms (steps, n)."""
    noise, unif = [], []
    for k in jax.random.split(key, steps):
        kn, ka = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(kn, shape)))
        unif.append(np.asarray(jax.random.uniform(ka, shape[:1])))
    return _t(np.stack(noise)), _t(np.stack(unif))


def _eta(key, lang_steps, shape):
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(key, lang_steps)])


def _mala_draws(key, steps, lang_steps, shape):
    """A MALA chain's etas (steps, lang_steps, n, d) and uniforms (steps, n)."""
    eta, unif = [], []
    for k in jax.random.split(key, steps):
        kl, ka = jax.random.split(k)
        eta.append(_eta(kl, lang_steps, shape))
        unif.append(np.asarray(jax.random.uniform(ka, shape[:1])))
    return _t(np.stack(eta)), _t(np.stack(unif))


def test_linear_log_posterior_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2)).astype(np.float32)
    ys = rng.normal(size=(64, 2)).astype(np.float32)
    want = np.asarray(JLinear().log_posterior(jnp.asarray(x), jnp.asarray(ys)))
    got = LinearForwardProblem().log_posterior(_t(x), _t(ys))
    assert got.shape == (64, 1)
    _close_e(got, want)


@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_energy_grad_matches_jax(problem):
    """One forward and one backward pass, also under torch.no_grad (as the
    evaluation harnesses run); the gradient within f32 rounding of its
    largest entry."""
    je, te, x0, *_ = _problem(problem)
    gj, ej = jmcmc.energy_grad(jnp.asarray(x0), je)
    with torch.no_grad():
        gt_, et = mcmc.energy_grad(_t(x0), te)
    _close_e(et, ej)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), rtol=E_RTOL, atol=E_RTOL * scale)


@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_langevin_step_matches_jax(problem):
    je, te, x0, *_ = _problem(problem)
    key = jax.random.PRNGKey(1)
    stepsize = STEP[problem][1]
    want = jmcmc.langevin_step(key, jnp.asarray(x0), stepsize, je, 3)
    with torch.no_grad():
        got = mcmc.langevin_step(_t(x0), stepsize, te, 3, eta=_t(_eta(key, 3, x0.shape)))
    _close_x(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_e(g, w)


@pytest.mark.parametrize("kernel", ["mh", "mala"])
@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_anneal_to_energy_matches_jax(problem, kernel):
    je, te, x0, *_ = _problem(problem)
    key = jax.random.PRNGKey(2)
    noise_std, stepsize = STEP[problem]
    if kernel == "mh":
        want = jmcmc.anneal_to_energy(key, jnp.asarray(x0), je, 10, noise_std=noise_std)
        noise, unif = _rw_draws(key, 10, x0.shape)
        got = mcmc.anneal_to_energy(_t(x0), te, 10, noise_std=noise_std, noise=noise, uniforms=unif)
    else:
        want = jmcmc.anneal_to_energy(key, jnp.asarray(x0), je, 5, langevin_prop=True, lang_steps=2,
                                      stepsize=stepsize)
        noise, unif = _mala_draws(key, 5, 2, x0.shape)
        with torch.no_grad():
            got = mcmc.anneal_to_energy(_t(x0), te, 5, langevin_prop=True, lang_steps=2, stepsize=stepsize,
                                        noise=noise, uniforms=unif)
    _close_x(got[0], want[0])
    # e_final - e_initial: differences of energies, held at the energies' scale
    scale = float(np.abs(np.asarray(je(jnp.asarray(x0)))).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=E_RTOL * scale)
    assert bool((got[0] != _t(x0)).any())


ANNEAL_CASES = {
    "ramp": dict(lambda0=0.5),
    "polish": dict(lambda0=0.5, anneal_frac=0.5),
    "tempered": dict(lambda0=0.3, lambda1=0.9),
    "target_acc": dict(target_acc=0.4),
}


@pytest.mark.parametrize("case", sorted(ANNEAL_CASES))
@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_annealed_mh_matches_jax(problem, case):
    je, te, x0, *_ = _problem(problem)
    key = jax.random.PRNGKey(4)
    kw = dict(noise_std=STEP[problem][0], **ANNEAL_CASES[case])
    xj, info_j = jmcmc.annealed_mh(key, jnp.asarray(x0), je, 12, **kw)
    noise, unif = _rw_draws(key, 12, x0.shape)
    xt, info_t = mcmc.annealed_mh(_t(x0), te, 12, noise=noise, uniforms=unif, **kw)
    _close_x(xt, xj)
    np.testing.assert_allclose(info_t["acc_rate"].numpy(), np.asarray(info_j["acc_rate"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(info_t["noise_std"]), float(info_j["noise_std"]), rtol=1e-6)
    if case == "target_acc":
        assert float(info_t["noise_std"]) != kw["noise_std"]


@pytest.mark.parametrize("lambd", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_interpolated_energy_matches_jax(problem, lambd):
    *_, x0, y, je, te = _problem(problem)
    ys = np.broadcast_to(y, (N, y.shape[0])).copy()
    want = jmcmc.interpolated_energy(jnp.asarray(ys), lambd, je)(jnp.asarray(x0))
    _close_e(mcmc.interpolated_energy(_t(ys), lambd, te)(_t(x0)), want)


REFINE_SPECS = ["mh,8,{rw}", "mala,4,{lv}", "ula,4,{lv}", "mh,8,{rw},anneal=0.5,afrac=0.5,acc=0.4",
                "mh,8,{rw},0.5", "mh,8,{rw},1.0,{lv}", "none,0,0,1.0,{lv}"]


def _refine_draws(spec, key, shape):
    """The JAX refine's draws: the chain's from ``key`` after split(key, 3)
    -> (key, k_frac, k_smooth), then the mixture's and the smoothing step's."""
    refined_j, _ = jrefined.from_config(None, None, spec)
    key, k_frac, k_smooth = jax.random.split(key, 3)
    d = {}
    if refined_j.refine_steps > 0:
        if refined_j.kernel == "mala":
            d["noise"], d["uniforms"] = _mala_draws(key, refined_j.refine_steps, refined_j.lang_steps, shape)
        elif refined_j.kernel == "ula":
            d["noise"] = _t(_eta(key, refined_j.refine_steps, shape))
        else:
            d["noise"], d["uniforms"] = _rw_draws(key, refined_j.refine_steps, shape)
        if refined_j.refine_frac < 1.0:
            d["keep_u"] = _t(jax.random.uniform(k_frac, (shape[0], 1)))
    if refined_j.smooth_tau > 0.0:
        d["smooth_eta"] = _t(_eta(k_smooth, 1, shape))
    return d


@pytest.mark.parametrize("spec", REFINE_SPECS)
@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_refine_matches_jax(problem, spec):
    """EnergyRefinedModel.refine for every kernel kind, the annealed chain,
    the partial-refinement mixture and the smoothing step, on the same
    proposal x."""
    *_, x0, y, je, te = _problem(problem)
    rw, lv = STEP[problem]
    spec = spec.format(rw=rw, lv=lv)
    rj, tag_j = jrefined.from_config(None, je, spec)
    rt, tag_t = refined.from_config(None, te, spec)
    assert tag_t == tag_j
    key = jax.random.PRNGKey(5)
    want = rj.refine(key, jnp.asarray(x0), jnp.asarray(y))
    with torch.no_grad():
        got = rt.refine(_t(x0), _t(y), **_refine_draws(spec, key, x0.shape))
    _close_x(got, want)


FROM_CONFIG = ["mh,20,0.2", "mala,60,0.05", "ula,10,0.005", "mh,20,0.2,0.5", "mh,20,0.2,1.0,0.01",
               "mh,20,0.2,anneal=0.5", "mh,20,0.2,anneal=0.5,lend=0.9,afrac=0.5,acc=0.4", "none,0,0",
               "mh,0,0.2", "none,0,0,1.0,0.02"]
FROM_CONFIG_ERRORS = ["mh,20,0.2,bogus=1", "hmc,5,0.1", "mala,5,0.01,anneal=0.5", "mh,5,0.2,afrac=0", "mh5"]


@pytest.mark.parametrize("spec", FROM_CONFIG + FROM_CONFIG_ERRORS)
def test_from_config_matches_jax(spec):
    """Fields and tags letter for letter, and the same errors."""
    try:
        rj, tag_j = jrefined.from_config("base", None, spec)
    except Exception as e:  # the JAX package's error is the expectation
        with pytest.raises(type(e)):
            refined.from_config("base", None, spec)
        assert spec in FROM_CONFIG_ERRORS
        return
    rt, tag_t = refined.from_config("base", None, spec)
    assert tag_t == tag_j and spec in FROM_CONFIG
    if rj == "base":
        assert rt == "base"
        return
    fields = lambda r: {f.name: getattr(r, f.name) for f in dataclasses.fields(r) if f.name != "energy_fn"}
    assert fields(rt) == fields(rj)


def test_from_spec_takes_the_dict_form():
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry_refined.yml")))
    r, tag = refined.from_spec("base", None, cfg["refine"])
    assert tag == "mh20" and (r.kernel, r.refine_steps, r.noise_std, r.anneal_from) == ("mh", 20, 0.2, 0.5)
    assert refined.from_spec("base", None, "mh,20,0.2")[1] == "mh20_0.2"


@pytest.mark.parametrize("problem,spec,tag,suffix", [
    ("linear", "mh,20,0.2", "mh20_0.2", "_refined_mh20_0.2"),
    ("scatterometry", {"kernel": "mh", "steps": 20, "noise_std": 0.2, "anneal_from": 0.5}, "mh20", "_refined"),
])
def test_for_problem_refines_on_the_jax_drivers_energy(problem, spec, tag, suffix):
    """The drivers' refined row: the JAX drivers' tag and out-dir suffix, and
    an energy equal to the JAX package's on the same states (1e-5 rel)."""
    je, _, x0, y, _, _ = _problem(problem)
    fwd, fp = scat.load_forward_model() if problem == "scatterometry" else (None, None)
    r, got_tag, got_suffix = refined.for_problem(problem, "base", spec, fwd, fp)
    assert (r.base_model, got_tag, got_suffix) == ("base", tag, suffix)
    ys = torch.as_tensor(np.broadcast_to(y, (N, y.shape[0])).copy())
    _close_e(r.energy_fn(_t(x0), ys), je(jnp.asarray(x0)))
    with pytest.raises(ValueError, match="unknown problem"):
        refined.for_problem("heat", "base", spec)


# ELBO tools, on the inputs of tests/test_sde_extras.py
def _elbo_inputs():
    key = jax.random.PRNGKey(0)
    jp = jmlp_init(jax.random.PRNGKey(0), 5, 2, (16, 16))
    x = jax.random.normal(key, (32, 2))
    cond = jax.random.normal(jax.random.fold_in(key, 1), (32, 2))
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    return key, jp, tp, x, cond


def test_log_normal_and_sample_v_match_jax():
    rng = np.random.default_rng(0)
    x, m, lv = (rng.normal(size=10).astype(np.float32) for _ in range(3))
    _close_e(sde.log_normal(_t(x), _t(m), _t(lv)), jsde.log_normal(jnp.asarray(x), jnp.asarray(m), jnp.asarray(lv)))
    gen = torch.Generator().manual_seed(0)
    v = sde.sample_v((1000, 3), "rademacher", gen)
    assert set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(sde.sample_v((1000, 3), "gaussian", gen).mean())) < 0.1
    with pytest.raises(ValueError, match="vtype"):
        sde.sample_v((2, 2), "uniform", gen)


def test_reverse_sde_dsm_matches_jax():
    key, jp, tp, x, cond = _elbo_inputs()
    s = jsde.ReverseSDE()
    want = jsde.reverse_sde_dsm(s, lambda p, z, c, t: jscore(p, z, c, t), jp, key, x, cond)
    kt, keps = jax.random.split(key)
    t = s.base.sample_debiasing_t(kt, (32, 1))
    eps = jax.random.normal(keps, x.shape)
    got = sde.reverse_sde_dsm(sde.ReverseSDE(), nets.score_mlp_apply, tp, _t(x), _t(cond), t=_t(t), eps=_t(eps))
    assert got.shape == (32,) and bool((got >= 0).all())
    _close_e(got, want)


@pytest.mark.parametrize("vtype", ["rademacher", "gaussian"])
def test_elbo_random_t_slice_matches_jax(vtype):
    key, jp, tp, x, cond = _elbo_inputs()
    s = jsde.ReverseSDE()
    want = jsde.elbo_random_t_slice(s, lambda p, z, c, t: jscore(p, z, c, t), jp, key, x, cond, vtype)
    kt, ky, kv, kT = jax.random.split(key, 4)
    draws = dict(t=jax.random.uniform(kt, (32, 1)) * s.T, eps=jax.random.normal(ky, x.shape),
                 v=jsde.sample_v(kv, x.shape, vtype), eps_T=jax.random.normal(kT, x.shape))
    with torch.no_grad():
        got = sde.elbo_random_t_slice(sde.ReverseSDE(), nets.score_mlp_apply, tp, _t(x), _t(cond), vtype,
                                      **{k: _t(v) for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


TINY = dict(dataset_size=600, n_epochs=2, epochs_per_call=2, batch_size=50, hidden_layers=[32, 32],
            n_samples_y=2, n_samples_x=300, n_repeats=2, eval_num_steps=10, METR_STEPS=10)


@pytest.mark.parametrize("problem,config", [("linear", "config_linear_refined.yml"),
                                            ("scatterometry", "config_scatterometry_refined.yml")])
def test_training_driver_writes_the_refined_row(tmp_path, problem, config):
    """A shipped refine config through its training driver's main() on the
    CPU at a tiny size: the refined row lands in out_dir + '_refined_<tag>'
    (linear, the tag from --refine) or '_refined' (scatterometry, the dict
    form) with finite metrics."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", config)))
    cfg.update(TINY, train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"))
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    if problem == "linear":
        main_diffusion_linear.main(["--config", str(path), "--device", "cpu", "--refine", "mala,3,0.01"])
        out = tmp_path / "out_refined_mala3_0.01"
    else:
        # the GT driver's MCMC settings come from the base config (same RANDOM_STATE, same conditions)
        base = yaml.safe_load(open(os.path.join(REPO, "configs/config_scatterometry.yml")))
        base.update(TINY)
        (tmp_path / "base.yml").write_text(yaml.safe_dump(base))
        gt.main(["--config", str(tmp_path / "base.yml"), "--gt_dir", str(tmp_path / "gt"), "--device", "cpu"])
        main_diffusion_scatterometry.main(["--config", str(path), "--gt_dir", str(tmp_path / "gt"),
                                           "--device", "cpu"])
        out = tmp_path / "out_refined"
    plain = (tmp_path / "out" / "results.csv").read_text().splitlines()
    rows = (out / "results.csv").read_text().splitlines()
    assert rows[0] == plain[0] and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    assert rows[1:] != plain[1:]
