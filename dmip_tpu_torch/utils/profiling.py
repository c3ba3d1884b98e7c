"""Profiling hooks: ``torch.profiler`` traces and device-synchronised timing.

Port of ``dmip_tpu/utils/profiling.py``: :func:`trace` (:17) on
``torch.profiler`` and :func:`timeit` (:26) on CUDA events.
:func:`busy_share` and :func:`top_ops` read a finished trace: the share of
the traced window in which the card ran a kernel, and the operations that
took the most time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import torch

from .. import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Profile a code block on the host and, on a CUDA device (the
    default), on the card; yields the ``torch.profiler.profile``.  With
    ``log_dir``, writes ``trace.json`` there (Chrome / Perfetto format)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeit(fn: Callable, *args, reps: int = 3, warmup: int = 1, clock_device=None, **kwargs):
    """Time ``fn(*args, **kwargs)``: seconds per call over ``reps`` calls
    after ``warmup``, by CUDA events on the current stream of a CUDA
    ``clock_device`` (the default), by the host clock for
    ``clock_device='cpu'``.  Every other keyword, ``device`` included, goes
    to ``fn``.  Returns (seconds_per_call, last_output)."""
    dev = resolve_device(clock_device)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args, **kwargs)
        return (time.perf_counter() - t0) / reps, out
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / reps, out


def _is_annotation(e) -> bool:
    """A ``record_function`` span: the profiler puts one on the host's and on
    the card's timeline, but it is neither an operation nor device work."""
    return bool(getattr(e, "is_user_annotation", False))


def busy_share(prof) -> dict:
    """The traced window (first to last event, host or device) and the
    union of the intervals in which the card ran a kernel or a copy:
    ``{'window_us', 'busy_us', 'share', 'kernels'}``.  Raises if the trace
    holds no device event."""
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e)]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    return {"window_us": hi - lo, "busy_us": busy, "share": busy / (hi - lo), "kernels": len(dev)}


def top_ops(prof, by: str = "device", n: int = 5) -> List[dict]:
    """The ``n`` operations with the most own time on the card (``by=
    'device'``) or on the host (``by='cpu'``), ``record_function`` spans
    left out: name, calls, milliseconds."""
    attr = "self_device_time_total" if by == "device" else "self_cpu_time_total"
    rows = sorted((e for e in prof.key_averages() if not _is_annotation(e)), key=lambda e: getattr(e, attr),
                  reverse=True)[:n]
    return [{"name": e.key, "calls": e.count, "ms": getattr(e, attr) / 1e3} for e in rows]
