"""The guided posterior cell (``scat_dps.posterior``): its driver, autograd
reference, operation count and readers.

On the CPU, at a tiny size (32-wide prior, 512 samples, 20 steps), the cell
runs through the port's plain DPS path (``AnalyticGuidanceDPS.sample``,
``method='auto'`` off the card) against ``reference/dps.py``: correct on a
sound run, not correct with the timed path broken underneath.  On the card
(``-m cuda``; each such test skips without one): B5 against the
reference's Philox stream, and at the cell's size the program judged
correct and the control (the reference with TF32 products) not.

    python -m pytest portbench/tests/test_portbench_dps.py -q
"""

import subprocess
import sys
import types

import pytest
import torch

from portbench import common, flops, flops_guided, run, trace
from portbench.metrics import reader

CELL = "scat_dps.posterior"
SEED = 2**31 + 12345


def tiny_cell(seed: int = SEED) -> common.Cell:
    cell = common.Cell.load(CELL, seed, "cpu")
    cell.config.update({"hidden_layers": [32, 32, 32], "n_samples_x": 512, "eval_num_steps": 20})
    cell.traffic.update({"check_within": 4})
    return cell


def tiny_run(seconds: float = 0.5, seed: int = SEED) -> dict:
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=seconds, trace=0)
    return run.run(args, device="cpu", cell=tiny_cell(seed))


# --- the operation count and the readers --------------------------------------


def test_guided_sample_step_by_hand_and_against_the_kernel_table():
    prior_fwd = 4 * 512 + 2 * 512 * 512 + 512 * 3  # [x, t] 4 x 512, two 512 x 512, 512 x 3
    prior_vjp = 3 * 512 + 2 * 512 * 512 + 512 * 3  # the same back to x alone
    surrogate = 3 * 256 + 2 * 256 * 256 + 256 * 23  # forward, and its VJP again
    assert (prior_fwd, prior_vjp, surrogate) == (527_872, 527_360, 137_728)
    by_hand = 2 * (prior_fwd + prior_vjp + 2 * surrogate)
    assert by_hand == 2_661_376
    cfg = common.load_json("portbench/configs/scat_dps.json")
    assert flops_guided.guided_sample_step(3, cfg["hidden_layers"], cfg["surrogate_layers"]) == by_hand
    assert abs(by_hand / 2.66e6 - 1) < 2e-3  # the kernel table's 2.66 MFLOP a sample-step
    # its f32 bound for a 30k x 200 posterior, 238.2 ms in the kernel table
    launch = flops_guided.guided_launch(3, cfg["hidden_layers"], cfg["surrogate_layers"], 30_000, 200)
    assert launch == 30_000 * 200 * by_hand
    assert abs(launch / flops.PEAKS["f32"] * 1e3 - 238.3) < 0.1


def test_is_b5_matches_the_guided_kernel_only():
    assert flops_guided.is_b5("void guided_em_kernel<4>(GuidedArgs)")
    assert not flops_guided.is_b5("void em_sampler_kernel<false>(EmArgs)")
    assert not flops.is_b1("void guided_em_kernel<4>(GuidedArgs)")


LAUNCH = 30_000 * 200 * 2_661_376


def _summary(b5_s, launches=1):
    return {"window_s": 10.0, "busy_s": 9.9, "idle_gaps": [],
            "device_ops": {"void guided_em_kernel<4>(GuidedArgs)": (b5_s, launches),
                           "void at::native::reduce_kernel": (0.01, 20)}}


def test_b5_roofline_on_a_synthetic_reading():
    r = types.SimpleNamespace(summary=_summary(10 * 0.5535, 10), flops={"requests": LAUNCH, "b5_launch": LAUNCH})
    assert reader("b5_roofline.dps")(r) == pytest.approx(100 * LAUNCH / 67e12 / 0.5535)
    assert 43.0 < reader("b5_roofline.dps")(r) < 43.1
    # no trace, no B5 in it, or a cell that counts no B5 launch: nothing to read
    assert reader("b5_roofline.dps")(types.SimpleNamespace(summary=None, flops={})) is None
    r.summary["device_ops"].pop("void guided_em_kernel<4>(GuidedArgs)")
    assert reader("b5_roofline.dps")(r) is None
    assert reader("b5_roofline.dps")(types.SimpleNamespace(summary=_summary(1.0), flops={"b1_launch": 1})) is None


def test_mfu_dps_uses_the_f32_peak():
    r = types.SimpleNamespace(after={"requests": 70}, after_s=70 * 0.556, flops={"requests": LAUNCH},
                              kind="dps_posterior", tf32=False)
    assert reader("mfu.dps")(r) == pytest.approx(100 * LAUNCH / 0.556 / 67e12)
    assert reader("mfu.dps")(types.SimpleNamespace(after={}, after_s=0.0, flops={})) is None


def _row(name, i, t0, t1, parent=None):
    return {"name": name, "id": i, "t0_ns": t0, "t1_ns": t1, "parent": parent, "root": parent or i}


def test_host_prep_ms_dps_on_synthetic_records():
    """Two requests after the profiler's stop (t = 100): their draws, B5's
    repack and launch, 3.5 ms in all over 2 requests; B1's spans and a request
    before the stop are not counted."""
    rows = [_row("sample", 0, 10, 90), _row("b5.pack", 1, 20, 80, 0),
            _row("sample", 2, 100, 600_000_100), _row("sample.draws", 3, 110, 500_110, 2),
            _row("b5.pack", 4, 500_120, 2_000_120, 2), _row("b5.launch", 5, 2_000_130, 2_500_130, 2),
            _row("sample", 6, 700_000_000, 800_000_000), _row("b5.pack", 7, 700_000_010, 700_500_010, 6),
            _row("b5.launch", 8, 700_500_020, 701_000_020, 6), _row("b1.pack", 9, 701_000_030, 801_000_030, 6)]
    program = {"rows": rows, "device_rows": [], "spans": {}, "counters": {}, "stop_ns": 100}
    assert reader("host_prep_ms.dps")(types.SimpleNamespace(program=program)) == pytest.approx(1.75)
    assert reader("host_prep_ms.dps")(types.SimpleNamespace(program=None)) is None
    assert reader("host_prep_ms.dps")(types.SimpleNamespace(program=dict(program, stop_ns=10**12))) is None


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json; sys.path.insert(0, '.'); import portbench.reference.dps;"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('dmip_tpu_torch', 'dmip_tpu', 'jax', 'jaxlib', 'flax'))))")
    r = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


# --- the tiny cell on the CPU --------------------------------------------------


def test_tiny_cell_runs_correct_on_the_cpu():
    out = tiny_run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"near_gap", "summary_gap"}
    assert set(out["metrics"]) == {"posterior_p95_ms", "setup_s"}


def test_the_reference_is_the_plain_paths_drift():
    """One step's drift, g(s) (s_p + capped s_lik), of the port's plain DPS
    path (``AnalyticGuidanceDPS.apply_a``: the folded VJPs of
    ``losses.likelihood_score_target``) against the reference's (autograd of
    the Gaussian log-likelihood), over the grid's times, at rows of the
    prior's box and beyond it, where the cap acts."""
    from portbench.drivers import dps_posterior
    from portbench.reference import dps, mlp

    cell = tiny_cell()
    d = dps_posterior.Driver(cell, common.Spans())
    d.setup()
    x = 3.0 * torch.randn(256, 3, generator=torch.Generator().manual_seed(5))
    y = d._y(0)
    for s in (1.0, 0.5, 0.05, 0.005):
        st = torch.tensor(s)
        s_p, s_lik = dps.guided_scores(d.params["prior"], d.surrogate, x, y.reshape(1, -1), st, 0.2, 0.01, 100.0)
        ref = mlp.g(st) * (s_p + s_lik)
        prog = d.model.apply_a(d.params, x, y.expand(256, -1), st)
        assert torch.allclose(prog, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max())), s


def _altered_samples(monkeypatch):
    """Every sample moved by a quarter of the posterior's spread."""
    from dmip_tpu_torch.models.diffusion import AnalyticGuidanceDPS

    sample = AnalyticGuidanceDPS.sample
    monkeypatch.setattr(AnalyticGuidanceDPS, "sample", lambda *a, **k: (lambda x: x + 0.25 * x.std(0))(sample(*a, **k)))


def _half_samples(monkeypatch):
    """The second half of each posterior's samples a copy of the first."""
    from dmip_tpu_torch.models.diffusion import AnalyticGuidanceDPS

    sample = AnalyticGuidanceDPS.sample

    def half(*a, **k):
        x = sample(*a, **k)
        n = x.shape[0] // 2
        return torch.cat([x[:n], x[:n], x[2 * n:]])

    monkeypatch.setattr(AnalyticGuidanceDPS, "sample", half)


def _guidance_dropped(monkeypatch):
    """s_lik = 0: the prior alone."""
    from dmip_tpu_torch import losses

    monkeypatch.setattr(losses, "likelihood_score_target", lambda *a, **k: torch.zeros_like(a[4]))


def _cap_not_applied(monkeypatch):
    """The guidance served without its norm cap."""
    import dataclasses

    from dmip_tpu_torch.mains import eval_diffusion

    row = eval_diffusion.analytic_row

    def uncapped(*a, **k):
        guided, suffix = row(*a, **k)
        return dataclasses.replace(guided, guidance_clip=None), suffix

    monkeypatch.setattr(eval_diffusion, "analytic_row", uncapped)


def _old_v3(monkeypatch):
    """The thesis code's likelihood target before the v3 correction: its
    last cotangent (y - f)^2 f / P, where the exact gradient has P^2."""
    from torch.func import vjp

    from dmip_tpu_torch import losses

    def target(prior_apply, prior_params, base_sde, forward_fn, x_t, y, t, *, a, b, s_prior=None):
        t = t.reshape(x_t.shape[0], 1)
        var, alpha = base_sde.std(t) ** 2, base_sde.mean_weight(t)
        s_prior = prior_apply(prior_params, x_t, t) if s_prior is None else s_prior
        f, vjp_f = vjp(forward_fn, (x_t + var * s_prior) / alpha)
        p = (a * f) ** 2 + b**2
        (q,) = vjp_f(-(a**2) * f / p + (y - f) / p + a**2 * (y - f) ** 2 * f / p)
        _, vjp_s = vjp(lambda xt: prior_apply(prior_params, xt, t), x_t)
        return q + var * vjp_s(q)[0]

    monkeypatch.setattr(losses, "likelihood_score_target", target)


FAULTS = [_altered_samples, _half_samples, _guidance_dropped, _cap_not_applied, _old_v3]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = tiny_run()
    assert not out["correct"], out["checks"]


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the guided sampler kernel B5 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_b5_follows_the_reference_philox_stream(cuda):
    """B5 and the reference from the same x0 and Philox seed, the guidance
    capped to nothing (with it the trajectories part under any rounding, see
    ``compare``): the prior's reverse SDE alone, which contracts, so the
    samples agree row by row; the reference on the next seed's stream does
    not."""
    from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler
    from portbench.drivers.eval import gap_quantiles
    from portbench.drivers.dps_posterior import fitted_prior
    from portbench.reference import dps, scatterometry
    from portbench.reference.precision import REFERENCE

    cell = common.Cell.load(CELL, SEED, cuda)
    prior, surrogate = fitted_prior(cell), scatterometry.surrogate(common.ROOT, cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    x0, y = torch.randn(4096, 3, generator=g, device=cuda), surrogate[-1][1]
    seed, kw = 2**40 + 12345, dict(a=0.2, b=0.01)
    prog = fused_guided_em_sampler(prior, surrogate, x0, y, guidance_clip=1e-30, num_steps=200, seed=seed, **kw)
    ref = dps.sample(prior, surrogate, x0, y, 200, seed, REFERENCE, clip=1e-30, **kw)
    other = dps.sample(prior, surrogate, x0, y, 200, seed + 1, REFERENCE, clip=1e-30, **kw)
    assert gap_quantiles(prog, ref)[1] < 1e-3 < 0.1 < gap_quantiles(other, ref)[1]


@pytest.mark.cuda
def test_program_passes_and_control_fails_at_the_cells_size(cuda):
    """The reference with TF32 products in the program's place; a window of
    30 s runs the ~40 requests the checked ones are drawn from."""
    from portbench import calibrate

    rows = dict(calibrate.readings(CELL, 2**31 + 777, 30.0, control=True))
    limits = common.load_json(f"portbench/limits/{CELL}.json")
    passes = lambda vals: all(vals[k] <= limits[k] for k in limits)
    assert passes(rows["program"]), rows
    assert not passes(rows["control"]), rows
