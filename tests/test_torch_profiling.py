"""dmip_tpu_torch.utils.profiling on the CPU: the trace, the top operations
and the timer; a CPU trace has no device time, so its busy share raises.
(The card's side is in tests/test_torch_cuda.py and chip_smoke.py.)"""

import pytest
import torch

from dmip_tpu_torch.utils import profiling


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
