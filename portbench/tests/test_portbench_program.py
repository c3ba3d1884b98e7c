"""The readers of the program's own records (``portbench/program.py`` and
the six readers over it) on synthetic records and on tiny CPU cells run
with the recorder on.  A run hands them ``Reading.program``: the recorder's
``records()`` after the window and the profiler's stop on its clock; a run
that hands none gives them nothing to read."""

import types

import pytest

from dmip_tpu_torch.utils import profiling
from portbench import program
from portbench.metrics import reader
from portbench.tests.tiny import tiny_run

NAMES = ("graph_kernels.train", "replay_ms.train", "card_idle_share.train", "capture_s.train",
         "host_prep_ms.posterior", "host_waits.eval")


def _row(name, i, t0, t1, parent=None):
    return {"name": name, "id": i, "t0_ns": t0, "t1_ns": t1, "parent": parent, "root": parent or i}


def _dev(name, i, a, b):
    return {"name": name, "id": i, "device": 0, "start_ms": a, "end_ms": b}


def synthetic():
    """Two calls of two steps, the profiler stopped between them (t = 100):
    a capture before, at set-up; after the stop, card spans that leave 1 ms
    of 10 idle between the leaves; two requests' host parts; two chunks."""
    rows = [_row("train.capture", 0, 10, 2_000_000_010),
            _row("train.call", 1, 20, 90), _row("train.replay", 2, 30, 40, 1),
            _row("train.call", 3, 100, 200), _row("train.draws", 4, 110, 120, 3), _row("train.replay", 5, 120, 130, 3),
            _row("train.draws", 6, 140, 150, 3), _row("train.replay", 7, 150, 160, 3),
            _row("sample", 8, 300, 400_000_300), _row("sample.draws", 9, 310, 100_000_310, 8),
            _row("b1.pack", 10, 100_000_320, 300_000_320, 8), _row("b1.launch", 11, 300_000_330, 400_000_330, 8),
            _row("sample", 12, 500, 600), _row("b1.pack", 13, 510, 200_000_510, 12)]
    device_rows = [_dev("train.replay", 2, 0.0, 3.0),
                   _dev("train.call", 3, 10.0, 20.0), _dev("train.draws", 4, 10.0, 12.0),
                   _dev("train.replay", 5, 12.0, 15.0), _dev("train.draws", 6, 16.0, 17.0),
                   _dev("train.replay", 7, 17.0, 20.0)]
    spans = {"train.capture": {"count": 2, "total_s": 2.0, "self_s": 2.0}, "eval.chunk": {"count": 4}}
    return {"rows": rows, "device_rows": device_rows, "spans": spans,
            "counters": {"graph_kernels": 2180, "host_waits": 4}, "stop_ns": 100}


@pytest.mark.parametrize("name, want", [("graph_kernels.train", 1090.0), ("replay_ms.train", 3.0),
                                        ("card_idle_share.train", 10.0), ("capture_s.train", 2.0),
                                        ("host_prep_ms.posterior", 300.0), ("host_waits.eval", 1.0)])
def test_each_reader_on_synthetic_records(name, want):
    """Each reader's number from hand-made records: the units after the stop
    for the window's readers, the whole run for the capture and the waits."""
    assert reader(name)(types.SimpleNamespace(program=synthetic())) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_no_records_no_number(name):
    """A reading without the program's records (a run that hands none, as
    every run of the harness as it stands) reads nothing."""
    assert reader(name)(types.SimpleNamespace(summary=None)) is None
    assert reader(name)(types.SimpleNamespace(program=None)) is None


def test_idle_share_counts_only_leaves_and_gaps_between_them():
    """The call around the steps is not a leaf; overlapping leaves count once."""
    rows = [_row("train.call", 0, 0, 1), _row("a", 1, 0, 1, 0), _row("b", 2, 0, 1, 0), _row("c", 3, 0, 1, 0)]
    dev = [_dev("train.call", 0, 0.0, 100.0), _dev("a", 1, 0.0, 40.0), _dev("b", 2, 30.0, 50.0),
           _dev("c", 3, 75.0, 100.0)]
    assert program.idle_share(rows, dev) == pytest.approx(25.0)
    assert program.idle_share([], []) is None


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


@pytest.mark.parametrize("cell, names", [("linear_cde.eval", {"host_waits.eval": 1.0}),
                                         ("scat_cde.train", {}), ("scat_cde.posterior", {})])
def test_readers_on_a_tiny_cpu_cell(recorder, cell, names):
    """A tiny CPU cell with the recorder on: the evaluation counts exactly one
    host wait a chunk; on the CPU nothing is captured, no card time exists
    and the posterior takes the plain sampler, so the other readers read
    nothing."""
    out = tiny_run(cell)
    assert out["correct"]
    reading = types.SimpleNamespace(program=dict(recorder.records(), stop_ns=0))
    got = {n: reader(n)(reading) for n in NAMES}
    assert {n: v for n, v in got.items() if v is not None} == names
