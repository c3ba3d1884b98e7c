"""dmip_tpu_torch.utils.profiling on the CPU: the trace, the top operations,
the timer and the recorder; a CPU trace has no device time, so its busy
share raises.
(The card's side is in tests/test_torch_cuda.py and chip_smoke.py.)"""

import json
import os
import subprocess
import sys

import pytest
import torch

from dmip_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_and_top_ops_on_the_cpu(tmp_path):
    a = torch.randn(256, 256)
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            torch.tanh(a @ a)
    assert (tmp_path / "trace.json").stat().st_size > 0
    top = profiling.top_ops(prof, "cpu", n=3)
    assert len(top) == 3 and top[0]["ms"] >= top[-1]["ms"] > 0.0
    assert {"aten::mm", "aten::tanh"} & {t["name"] for t in top}
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling.busy_share(prof)


def test_timeit_on_the_cpu_and_the_card_by_default():
    sec, out = profiling.timeit(torch.add, torch.ones(3), 1.0, reps=2, clock_device="cpu")
    assert sec > 0.0 and torch.equal(out, torch.full((3,), 2.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.timeit(torch.add, torch.ones(3), 1.0)


def test_timeit_passes_device_to_the_timed_function():
    """``device`` is the timed function's keyword, not the timer's."""
    seen = []

    def fn(n, device=None):
        seen.append(device)
        return torch.zeros(n, device=device)

    sec, out = profiling.timeit(fn, 4, reps=2, warmup=1, clock_device="cpu", device="cpu")
    assert sec > 0.0 and out.shape == (4,) and seen == ["cpu"] * 3


def test_top_ops_leave_out_record_function_spans():
    """A ``record_function`` span around the work is not an operation: the
    top operations are the ops inside it."""
    a = torch.randn(256, 256)
    with profiling.trace(device="cpu") as prof:
        with torch.profiler.record_function("train_steps"):
            for _ in range(3):
                torch.tanh(a @ a)
    assert "train_steps" in {e.name for e in prof.events()}
    names = {t["name"] for t in profiling.top_ops(prof, "cpu", n=10)}
    assert "train_steps" not in names and "aten::mm" in names


# --- the recorder -------------------------------------------------------------


@pytest.fixture
def recorder():
    """The recorder on and empty for one test; off and empty after it."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def test_off_the_recorder_records_nothing_and_annotates_nothing():
    """Off (the default), a site gets the shared no-op context: no row, no
    total, no counter of its own, and a profiled region holds no
    ``dmip.*`` annotation."""
    profiling.reset()
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.device_span("b", "cpu") is profiling._OFF
    with profiling.trace(device="cpu") as prof:
        with profiling.span("a"):
            profiling.count("host_waits")
            torch.ones(4).add_(1)
    assert not [e.name for e in prof.events() if e.name.startswith("dmip.")]
    rec = profiling.records()
    assert rec["spans"] == rec["device"] == {} and rec["rows"] == rec["device_rows"] == []
    assert "host_waits" not in profiling.counters()


def test_spans_nest_with_parents_roots_and_self_time(recorder):
    """Each row names its enclosing span and the top-level span it sits
    under; a span's self time is its time less what its children cover."""
    with recorder.span("outer"):
        with recorder.span("inner"):
            with recorder.span("leaf"):
                sum(range(1000))
        with recorder.span("inner"):
            sum(range(1000))
    with recorder.device_span("other", "cpu"):  # on the CPU a host span alone
        pass
    rec = recorder.records()
    rows = {(r["name"], r["id"]): r for r in rec["rows"]}
    by_name = {}
    for (name, _), r in rows.items():
        by_name.setdefault(name, []).append(r)
    (outer,), inners, (leaf,), (other,) = by_name["outer"], by_name["inner"], by_name["leaf"], by_name["other"]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert all(r["parent"] == outer["id"] and r["root"] == outer["id"] for r in inners)
    assert leaf["parent"] == inners[0]["id"] and leaf["root"] == outer["id"]
    assert other["parent"] is None and other["root"] == other["id"] and rec["device_rows"] == []
    took = lambda r: r["t1_ns"] - r["t0_ns"]
    spans = rec["spans"]
    assert spans["inner"]["count"] == 2 and spans["outer"]["count"] == 1
    assert spans["outer"]["self_s"] == pytest.approx((took(outer) - sum(took(r) for r in inners)) * 1e-9, abs=1e-12)
    assert spans["inner"]["self_s"] == pytest.approx((sum(took(r) for r in inners) - took(leaf)) * 1e-9, abs=1e-12)
    assert spans["leaf"]["self_s"] == spans["leaf"]["total_s"] == pytest.approx(took(leaf) * 1e-9, abs=1e-12)


def test_rows_are_bounded_and_totals_are_not(recorder, monkeypatch):
    """The rows kept are the newest ``ROWS_KEPT``; the totals count every span."""
    monkeypatch.setattr(profiling, "ROWS_KEPT", 4)
    recorder.reset()
    for i in range(10):
        with recorder.span(f"s{i % 2}"):
            pass
    rec = recorder.records()
    assert [r["id"] for r in rec["rows"]] == [6, 7, 8, 9]
    assert rec["spans"]["s0"]["count"] == rec["spans"]["s1"]["count"] == 5


def test_a_span_lies_inside_its_kineto_event_on_the_profilers_clock(recorder):
    """Under ``torch.profiler`` a span opens ``record_function('dmip.<name>')``
    around itself; its row, stamped on the profiler's clock, lies inside that
    event, its ends within 50 us of the event's.  A busy host only widens
    the gaps (``record_function``'s own Python between its stamp and the
    span's), so the closest of 50 spans tests the clock."""
    with profiling.trace(device="cpu") as prof:
        for i in range(50):
            with recorder.span(f"kineto{i}"):
                sum(range(1000))  # no aten op: its intra-op threads would spin against a loaded host
    events = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("dmip.kineto")}
    rows = [r for r in recorder.records()["rows"] if r["name"].startswith("kineto")]
    assert len(events) == len(rows) == 50
    starts, ends = [], []
    for r in rows:
        k0, k1 = events["dmip." + r["name"]]
        starts.append(r["t0_ns"] - k0)
        ends.append(k1 - r["t1_ns"])
    assert min(starts) >= 0 and min(ends) >= 0, (starts, ends)
    assert min(starts) < 50_000 and min(ends) < 50_000, (starts, ends)


def test_counters_add_up_and_include_the_kernels_launch_counts(recorder):
    from dmip_tpu_torch import ops

    recorder.count("host_waits")
    recorder.count("host_waits", 2)
    c = recorder.counters()
    assert c["host_waits"] == 3
    assert c["fused_em_sampler.launches"] == ops.fused_em_sampler.launches
    assert c["fused_em_sampler.launches_by_dtype"] == ops.fused_em_sampler.launches_by_dtype
    for fn in (ops.fused_em_sampler_cdiffe, ops.fused_mh_scatterometry, ops.fused_dsm_train_epochs,
               ops.fused_guided_em_sampler):
        assert c[f"{fn.__name__}.launches"] == fn.launches


def test_fit_records_each_call_epoch_and_step(recorder):
    """``train.fit`` of the autograd engine on the CPU, 4 epochs in calls of
    2, 3 batches an epoch, the PINN loss (its draws a batch): ``train.call``
    once a call, ``train.batches`` once an epoch, ``train.draws`` once a
    step, under their call; ``train.read`` and one host wait a call."""
    from dmip_tpu_torch import data, train
    from dmip_tpu_torch.problems import LinearForwardProblem

    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 48, torch.Generator().manual_seed(0))
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [16, 16]},
                                           {"xdim": 2, "ydim": 2})
    loss_fn = model.make_loss_fn(cfg, initial_condition=prob.score_posterior)
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(loss_fn, opt, lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 16),
                             epochs_per_call=2)
    train.fit(fn, model.init(torch.Generator().manual_seed(1)), opt, 3, num_epochs=4, epochs_per_call=2,
              log_every=0)
    rec = recorder.records()
    counts = {k: v["count"] for k, v in rec["spans"].items()}
    assert counts == {"train.call": 2, "train.batches": 4, "train.draws": 12, "train.read": 2}
    assert recorder.counters()["host_waits"] == 2
    calls = {r["id"] for r in rec["rows"] if r["name"] == "train.call"}
    assert all(r["parent"] in calls and r["root"] == r["parent"] for r in rec["rows"]
               if r["name"] in ("train.batches", "train.draws"))
    assert rec["device_rows"] == []  # the CPU has no card time


def test_read_stats_counts_one_host_wait_a_chunk(recorder):
    """Two chunks of two linear conditions through the evaluation engine on
    the CPU: a chunk span each, a condition span each under it, one read and
    one host wait a chunk."""
    from dmip_tpu_torch import evaluate
    from dmip_tpu_torch.models import CDE
    from dmip_tpu_torch.problems import LinearForwardProblem

    model, prob = CDE(2, 2, (8,)), LinearForwardProblem()
    params = model.init(torch.Generator().manual_seed(1))
    eval_many = evaluate.make_eval_many_linear(model, prob, 64, 1, 3, nbins=5)
    for k in range(2):
        evaluate.read_stats(eval_many(params, torch.Generator().manual_seed(k), torch.randn(2, 2)))
    rec = recorder.records()
    assert {k: v["count"] for k, v in rec["spans"].items()} == {"eval.chunk": 2, "eval.condition": 4,
                                                                 "eval.read": 2}
    assert recorder.counters()["host_waits"] / rec["spans"]["eval.chunk"]["count"] == 1


def test_dmip_trace_records_from_import_and_writes_jsonl_at_exit(tmp_path):
    """``DMIP_TRACE=<file>`` at the package's import turns the recorder on;
    at exit the file holds a line a row, a total a name and the counters."""
    out = tmp_path / "trace.jsonl"
    code = ("from dmip_tpu_torch.utils import profiling\n"
            "assert profiling.enabled()\n"
            "with profiling.span('outer'):\n"
            "    with profiling.span('inner'):\n"
            "        profiling.count('host_waits')\n")
    env = dict(os.environ, DMIP_TRACE=str(out), PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    kinds = [line["kind"] for line in lines]
    assert kinds == ["span", "span", "total", "total", "counters"]
    assert [line["name"] for line in lines[:2]] == ["inner", "outer"]
    assert lines[0]["parent"] == lines[1]["id"] and lines[-1]["counters"]["host_waits"] == 1
