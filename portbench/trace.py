"""The traced part of a run: ``torch.profiler`` over whole units of work,
reduced to what the per-layer readers and the result's ``device`` and
``breakdown`` need.

The device's busy time is the union of the intervals in which it ran an
operation (a kernel, a copy or a set), annotations left out; the window is
the profiler's, from the first to the last event on the host or the device.
Idle gaps are the holes in that union, each labelled by the benchmark's
host span (``portbench.<name>``) that covers its middle, or by the host
operation that does, or ``host`` where none does.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import torch


def warm_profiler() -> None:
    """Start the profiler once on a trivial op: its first start (CUPTI's set-up)
    takes seconds, which belong to set-up, not to the traced window."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """Profiles the units ``units`` of a window: the driver calls
    :meth:`start` before and :meth:`stop` after unit i, and the profiler
    runs from the first of them to the end of the last one run.  Stopping
    it (CUPTI's flush of ~1M events in a training call) takes seconds that
    are no unit's: ``paused`` sums them, and the window runs that much
    longer.  The work of the units run after the stop, untraced, is counted
    apart (``after``), from ``t_stop``, the host's clock at the stop.  The
    trace is reduced to ``summary`` by :meth:`close`, after the window."""

    def __init__(self, enabled: bool, units: range, spans):
        self.enabled, self.units, self.spans = enabled, units, spans
        self.prof = self.done = None
        self.summary: Optional[dict] = None
        self.counted: Dict[str, float] = collections.Counter()
        self.after: Dict[str, float] = collections.Counter()
        self.t_stop: Optional[float] = None
        self.paused = 0.0

    def wants(self, i: int) -> bool:
        return self.enabled and i in self.units

    def start(self, i: int) -> None:
        if self.wants(i) and self.prof is None and self.t_stop is None:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                           torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.spans.tracing = True

    def count(self, i: int, **amounts: float) -> None:
        """Work that unit i did, counted while it is traced, or apart once
        the profiler has stopped."""
        into = self.counted if self.prof is not None and self.wants(i) else \
            self.after if self.t_stop is not None else None
        if into is not None:
            for k, v in amounts.items():
                into[k] += v

    def stop(self, i: int) -> None:
        """After unit i: stop once it is the last wanted unit."""
        if self.prof is not None and (i + 1 not in self.units):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            self.spans.tracing = False
            self.prof.__exit__(None, None, None)
            self.done, self.prof = self.prof, None
            self.t_stop = time.perf_counter()
            self.paused += self.t_stop - t0

    def close(self) -> None:
        """Stop a profiler that the window's end left running, and reduce the trace."""
        if self.prof is not None:
            self.stop(self.units.stop - 1)
        if self.done is not None:
            self.summary = reduce_events(self.done.profiler.kineto_results.events())
            self.done = None


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()


def reduce_events(events) -> dict:
    """Busy time, window, per-name device time and counts, and the idle gaps
    of a finished trace (seconds)."""
    dev, host, spans = [], [], []
    lo, hi = None, None
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        lo = s if lo is None else min(lo, s)
        hi = t if hi is None else max(hi, t)
        if _is_device(e):
            dev.append((s, t, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            (spans if e.is_user_annotation() else host).append((s, t, e.name()))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    dev.sort()
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for s, t, n in dev:
        by_name[n][0] += (t - s) * 1e-9
        by_name[n][1] += 1
    busy, gaps = 0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > lo:
        gaps.append((lo, cur_s))
    for s, t, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    labelled = [[_label(spans, host, (a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:10]]
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_ops": {n: (v[0], v[1]) for n, v in by_name.items()},
        "idle_gaps": labelled,
        "device_events": len(dev),
    }


def _label(spans, host, at: int) -> str:
    """The innermost benchmark span covering ``at`` and the innermost host
    operation covering it, 'host' for either where none does."""
    parts = []
    for group in (spans, host):
        inside = [(t - s, n) for s, t, n in group if s <= at <= t]
        parts.append(min(inside)[1] if inside else "host")
    return " / ".join(parts)


def top_device_ops(summary: dict, n: int = 10) -> List[list]:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: kv[1][0], reverse=True)[:n]
    return [[name, secs] for name, (secs, _) in ops]


def device_time(summary: dict, match):
    """(seconds, launches) of the device operations whose name ``match``
    accepts, or None where there are none."""
    hits = [(s, c) for name, (s, c) in summary["device_ops"].items() if match(name)]
    if not hits:
        return None
    return sum(s for s, _ in hits), sum(c for _, c in hits)
