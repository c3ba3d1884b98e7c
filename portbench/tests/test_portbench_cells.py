"""Every cell end to end on the CPU at a tiny size, through the program's
plain paths: correct on sound runs, not correct with the timed path
broken underneath (one test a fault the cell can have), and no JAX or JAX
package in a run's modules."""

import subprocess
import sys

import pytest
import torch

from portbench import common, trace
from portbench.tests.tiny import CELLS, tiny_cell, tiny_run


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    out = tiny_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and "setup_s" in out["metrics"] and len(out["metrics"]) == 2


def _altered_samples(monkeypatch):
    """A served answer altered where it is produced: every sample moved by a
    quarter of the posterior's spread."""
    from dmip_tpu_torch.models.diffusion import DiffusionModel

    sample = DiffusionModel.sample

    def moved(*a, **k):
        x = sample(*a, **k)
        return x + 0.25 * x.std(0)

    monkeypatch.setattr(DiffusionModel, "sample", moved)


def _half_samples(monkeypatch):
    """Half of the batch left out: the second half of each posterior's
    samples a copy of the first."""
    from dmip_tpu_torch.models.diffusion import DiffusionModel

    sample = DiffusionModel.sample

    def half(*a, **k):
        x = sample(*a, **k)
        n = x.shape[0] // 2
        return torch.cat([x[:n], x[:n], x[2 * n:]])

    monkeypatch.setattr(DiffusionModel, "sample", half)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from dmip_tpu_torch import train

    monkeypatch.setattr(train, "apply_updates", lambda params, updates: params)


def _half_batch(monkeypatch):
    """Half of the batch left out, the loss's means taken over the rest."""
    from dmip_tpu_torch import losses

    pinn = losses.pinn_loss

    def half(apply_a, params, base, x, y, z0, eps, t, **kw):
        n = x.shape[0] // 2
        return pinn(apply_a, params, base, x[:n], y[:n], z0[:n], eps[:n], t[:n], **kw)

    monkeypatch.setattr(losses, "pinn_loss", half)


def _later_calls(monkeypatch, change):
    """The epoch engine's calls after the first (the window's) changed by
    ``change(fn, first, params, opt_state, seed, epoch0, *rest)``, where
    ``first`` holds what the first call was handed."""
    from dmip_tpu_torch import train

    make = train.make_epoch_fn

    def wrapped(*a, **k):
        fn, first = make(*a, **k), {}

        def epochs(params, opt_state, seed, epoch0, *rest):
            if not first:
                first.update(params=params, opt_state=opt_state)
                return fn(params, opt_state, seed, epoch0, *rest)
            return change(fn, first, params, opt_state, seed, epoch0, *rest)
        return epochs

    monkeypatch.setattr(train, "make_epoch_fn", wrapped)


def _window_state_not_carried(monkeypatch):
    """A timed call that returns the state it was handed."""
    _later_calls(monkeypatch, lambda fn, first, p, s, seed, e0, *r: (p, s, *fn(p, s, seed, e0, *r)[2:]))


def _window_stale_state(monkeypatch):
    """A timed call that starts from the state of the engine's first call,
    not the one handed to it."""
    _later_calls(monkeypatch, lambda fn, first, p, s, seed, e0, *r: fn(first["params"], first["opt_state"], seed,
                                                                       e0, *r))


def _window_wrong_epoch_seed(monkeypatch):
    """A timed call whose epochs draw from the wrong generators."""
    _later_calls(monkeypatch, lambda fn, first, p, s, seed, e0, *r: fn(p, s, seed, e0 + 1, *r))


def _last_row_from_first(monkeypatch):
    """A chunk's last condition given the first one's statistics."""
    from dmip_tpu_torch import evaluate

    read = evaluate.read_stats

    def misplaced(out):
        rows = [list(r) for r in read(out)]
        rows[-1] = rows[0]
        return rows

    monkeypatch.setattr(evaluate, "read_stats", misplaced)


FAULTS = [(c, f) for c in ("linear_cde.eval", "scat_cde.posterior") for f in (_altered_samples, _half_samples)] + \
         [("linear_cde.eval", _last_row_from_first)] + \
         [(c, f) for c in ("scat_cde.train", "linear_cde.train")
          for f in (_state_unchanged, _half_batch, _window_state_not_carried, _window_stale_state,
                    _window_wrong_epoch_seed)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = tiny_run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["linear_cde.eval", "scat_cde.posterior"])
def test_the_control_in_the_programs_place_is_not_correct(name):
    """The reference with fp8 products in the sampler, in the program's place."""
    from portbench import drivers
    from portbench.reference.precision import CONTROL, REFERENCE

    cell = tiny_cell(name)
    d = drivers.load(cell.traffic["kind"])(cell, common.Spans())
    d.setup()
    d.window(0.5, trace.Tracer(False, range(0), d.spans))
    ref = d.reference(REFERENCE)
    assert all(c.ok for c in d.compare(d.outputs(), ref))
    assert not all(c.ok for c in d.compare(d.reference(CONTROL), ref))


def test_a_run_holds_no_jax_and_no_jax_package():
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from portbench.tests.tiny import tiny_run; from portbench import run;"
            "tiny_run('linear_cde.eval'); print(json.dumps(run.forbidden_modules()))")
    r = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "jaxlib_free_thing", sys)
    monkeypatch.setitem(sys.modules, "dmip_tpu.problems", sys)
    assert run.forbidden_modules() == ["dmip_tpu.problems"]


class _E:
    """A stand-in for a profiler event."""

    def __init__(self, name, start, end, device, annotation=False):
        self._n, self._s, self._e, self._d, self._a = name, start, end, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_reduction():
    ev = [_E("portbench.queue", 0, 100, False, True), _E("aten::mm", 10, 30, False),
          _E("k1", 20, 50, True), _E("k2", 40, 60, True), _E("k1", 80, 90, True),
          _E("gpu_annotation", 0, 100, True, True), _E("portbench.read", 60, 120, False, True)]
    s = trace.reduce_events(ev)
    assert s["window_s"] == pytest.approx(120e-9) and s["busy_s"] == pytest.approx(50e-9)
    assert s["device_ops"]["k1"] == (pytest.approx(40e-9), 2)
    # holes [90, 120], [0, 20], [60, 80], each labelled by the innermost span and host op over its middle
    assert s["idle_gaps"][0] == ["portbench.read / host", pytest.approx(30e-9)]
    assert [g for g, _ in s["idle_gaps"]] == ["portbench.read / host", "portbench.queue / aten::mm",
                                             "portbench.read / host"]
    assert trace.top_device_ops(s, 1) == [["k1", pytest.approx(40e-9)]]
