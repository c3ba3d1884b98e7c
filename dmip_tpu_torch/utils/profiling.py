"""Profiling hooks: ``torch.profiler`` traces and device-synchronised timing.

Port of ``dmip_tpu/utils/profiling.py``: :func:`trace` (:17) on
``torch.profiler`` and :func:`timeit` (:26) on CUDA events.
:func:`busy_share` and :func:`top_ops` read a finished trace: the share of
the traced window in which the card ran a kernel, and the operations that
took the most time.

The recorder, off by default: :func:`span` (a host interval, with its
parent span and the top-level span it sits under), :func:`device_span`
(the same, and the card's time for the work queued inside it, by a pair of
CUDA events) and :func:`count`; :func:`enable`, :func:`disable`,
:func:`reset`, :func:`records` and :func:`counters` drive and read it.  Off,
a site costs one read of the flag.  A span stamps the host clock that
``torch.profiler``'s events carry, and while a profiler runs it also opens
``record_function('dmip.<name>')``, so a trace names the program's parts.
``DMIP_TRACE=<file>`` at the package's import turns it on and writes the
records there at exit (:func:`record_to`).  No span or event may sit inside
a CUDA-graph capture: they go around replays.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import ctypes
import json
import os
import time
from typing import Callable, Dict, List, Optional

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


# --- the recorder -------------------------------------------------------------
#
# Spans, card-side spans and counters inside the program, off by default.  Each
# site reads the flag ``_on`` once: off, a site gets the shared no-op context
# and records nothing.  The program records from one thread.

ROWS_KEPT = 1 << 17  # the newest host rows and resolved device rows kept
PENDING_KEPT = 4096  # device spans the card has not passed yet; past it the oldest is dropped
ANCHOR_NS = 1_000_000_000  # a card timeline's anchor event is renewed after a second

_on = False


_OFF = contextlib.nullcontext()  # what a site gets while the recorder is off


class _Anchor:
    """An event on a card's stream that device spans are timed from: its
    offset (ms) from the device's first anchor once resolved, else the
    anchor before it."""

    __slots__ = ("event", "host_ns", "prev", "offset_ms")

    def __init__(self, event, host_ns: int, prev: Optional["_Anchor"]):
        self.event, self.host_ns, self.prev = event, host_ns, prev
        self.offset_ms = 0.0 if prev is None else None


class _Recorder:
    """What one recording holds: the open spans, per-name totals, the newest
    rows, counters and the device spans, pending and resolved."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.next_id = 0
        self.totals: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]
        self.rows = collections.deque(maxlen=ROWS_KEPT)  # (name, t0 ns, t1 ns, id, parent, root)
        self.counts: Dict[str, int] = collections.Counter()
        self.pending = collections.deque()  # (name, id, device index, start, end, anchor)
        self.dropped = 0
        self.device_totals: Dict[str, List[float]] = {}  # name -> [count, total ms]
        self.device_rows = collections.deque(maxlen=ROWS_KEPT)  # (name, id, device, start ms, end ms)
        self.anchors: Dict[int, _Anchor] = {}  # device index -> its newest anchor
        self.free: Dict[int, list] = collections.defaultdict(list)  # device index -> events to reuse

    def _event(self, index: int):
        free = self.free[index]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def device_start(self, device: torch.device):
        """The start event of a device span, recorded on ``device``'s
        current stream, and the anchor it is timed from."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device span inside a CUDA-graph capture: time the replay, not the capture")
        stream = torch.cuda.current_stream(device)
        index = stream.device_index
        now = time.time_ns()
        anchor = self.anchors.get(index)
        if anchor is None or now - anchor.host_ns > ANCHOR_NS:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            anchor = self.anchors[index] = _Anchor(ev, now, anchor)
        start = self._event(index)
        start.record(stream)
        return stream, start, anchor

    def device_end(self, name: str, span_id: int, started) -> None:
        stream, start, anchor = started
        end = self._event(stream.device_index)
        end.record(stream)
        if len(self.pending) >= PENDING_KEPT:
            self.pending.popleft()
            self.dropped += 1
        self.pending.append((name, span_id, stream.device_index, start, end, anchor))
        self.poll()

    @staticmethod
    def _offset(anchor: _Anchor) -> Optional[float]:
        """The anchor's offset from its device's first anchor (ms), resolving
        the anchors behind it, or None while the card has not passed them
        all.  Renewed anchors keep each ``elapsed_time`` (a float32 of ms)
        short, so that positions an hour in stay exact to a microsecond."""
        chain = []
        while anchor.offset_ms is None:
            chain.append(anchor)
            anchor = anchor.prev
        if not all(a.event.query() for a in chain):
            return None
        for a in reversed(chain):
            a.offset_ms = a.prev.offset_ms + a.prev.event.elapsed_time(a.event)
            a.prev = None
        return chain[0].offset_ms if chain else anchor.offset_ms

    def poll(self) -> None:
        """Resolve the device spans the card has passed, oldest first."""
        while self.pending:
            name, span_id, index, start, end, anchor = self.pending[0]
            if not end.query():
                return
            base = self._offset(anchor)
            if base is None:
                return
            self.pending.popleft()
            t0 = base + anchor.event.elapsed_time(start)
            t1 = t0 + start.elapsed_time(end)
            total = self.device_totals.setdefault(name, [0, 0.0])
            total[0] += 1
            total[1] += t1 - t0
            self.device_rows.append((name, span_id, index, t0, t1))
            self.free[index] += (start, end)


_REC = _Recorder()


class _Span:
    """A host span, and with ``device`` on a CUDA device a device span
    around the work queued inside it; while a torch profiler runs also a
    ``record_function('dmip.<name>')``, which the host span lies inside."""

    __slots__ = ("rec", "name", "device", "rf", "started", "id", "parent", "root", "child_ns", "t0")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.rec, self.name, self.device = _REC, name, device

    def __enter__(self):
        rec = self.rec
        self.started = rec.device_start(self.device) if self.device is not None else None
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("dmip." + self.name)
            self.rf.__enter__()
        up = rec.stack[-1] if rec.stack else None
        self.id, rec.next_id = rec.next_id, rec.next_id + 1
        self.parent, self.root = (None, self.id) if up is None else (up.id, up.root)
        self.child_ns = 0
        rec.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        if self.started is not None:
            rec.device_end(self.name, self.id, self.started)
        rec.stack.pop()
        took = t1 - self.t0
        if rec.stack:
            rec.stack[-1].child_ns += took
        total = rec.totals.setdefault(self.name, [0, 0, 0])
        total[0] += 1
        total[1] += took
        total[2] += took - self.child_ns
        rec.rows.append((self.name, self.t0, t1, self.id, self.parent, self.root))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A host span around the block: name, start and end on the host clock
    that ``torch.profiler``'s events use (Unix time, ns: ``time.time_ns``),
    the span enclosing it and the top-level span it sits under.  Off, the
    shared no-op context."""
    if not _on:
        return _OFF
    return _Span(name, None)


def device_span(name: str, device):
    """:func:`span`, and on a CUDA ``device`` a pair of timing events on its
    current stream around the work queued in the block: the card's time from
    reaching the first to reaching the second.  Resolved once the card has
    passed them (never waited for), the events are then reused.  Inside a
    CUDA-graph capture it raises: time replays, not captures."""
    if not _on:
        return _OFF
    dev = torch.device(device)
    return _Span(name, dev if dev.type == "cuda" else None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _on:
        _REC.counts[name] += n


def enabled() -> bool:
    """Whether the recorder is on."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop everything recorded (spans still open finish into the old records)."""
    global _REC
    _REC = _Recorder()


def counters() -> Dict[str, object]:
    """The recorder's counters, and the kernels' own launch counts where they
    live (``<wrapper>.launches``, ``<wrapper>.launches_by_dtype``,
    ``<wrapper>.launches_by_cluster``, and B1's ``<wrapper>.packs`` and
    ``<wrapper>.pack_hits``)."""
    from .. import ops

    out: Dict[str, object] = dict(_REC.counts)
    for fn in (ops.fused_em_sampler, ops.fused_em_sampler_cdiffe, ops.fused_mh_scatterometry,
               ops.fused_dsm_train_epochs, ops.fused_guided_em_sampler):
        out[f"{fn.__name__}.launches"] = fn.launches
        for by in ("launches_by_dtype", "launches_by_cluster"):
            if hasattr(fn, by):
                out[f"{fn.__name__}.{by}"] = dict(getattr(fn, by))
        for n in ("packs", "pack_hits"):
            if hasattr(fn, n):
                out[f"{fn.__name__}.{n}"] = getattr(fn, n)
    return out


def records() -> dict:
    """What the recorder holds, resolving the device spans the card has
    passed: ``spans`` (per name: count, total and self seconds, self being
    the time no child span covers), ``rows`` (the newest ``ROWS_KEPT`` host
    spans), ``device`` (per name: count, total ms of card time),
    ``device_rows`` (the newest resolved device spans: their host span's
    id, the device, start and end in ms on the card's clock from the
    device's first device span), ``counters``, and the device spans still
    ``pending`` or ``dropped`` past ``PENDING_KEPT``."""
    rec = _REC
    rec.poll()
    return {
        "spans": {n: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9} for n, (c, t, s) in rec.totals.items()},
        "rows": [{"name": n, "t0_ns": t0, "t1_ns": t1, "id": i, "parent": p, "root": r}
                 for n, t0, t1, i, p, r in rec.rows],
        "device": {n: {"count": c, "total_ms": t} for n, (c, t) in rec.device_totals.items()},
        "device_rows": [{"name": n, "id": i, "device": d, "start_ms": a, "end_ms": b}
                        for n, i, d, a, b in rec.device_rows],
        "counters": counters(),
        "pending": len(rec.pending),
        "dropped": rec.dropped,
    }


def graph_kernels(graph) -> int:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``, through the CUDA driver API (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``; the runtime's cudaGraph_t is a CUgraph)."""
    lib = ctypes.CDLL("libcuda.so.1")
    for fn in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    _check_cu(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check_cu(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[: n.value]:
        _check_cu(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def _check_cu(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def write_jsonl(path: str) -> None:
    """Write :func:`records` to ``path`` as JSON lines: one ``span`` line a
    host row, one ``device`` line a device row, one ``total`` /
    ``device_total`` line a name, one ``counters`` line; on a card after
    waiting for it, so that every device span resolves."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    recs = records()
    with open(path, "w") as f:
        for row in recs["rows"]:
            f.write(json.dumps({"kind": "span", **row}) + "\n")
        for row in recs["device_rows"]:
            f.write(json.dumps({"kind": "device", **row}) + "\n")
        for name, total in recs["spans"].items():
            f.write(json.dumps({"kind": "total", "name": name, **total}) + "\n")
        for name, total in recs["device"].items():
            f.write(json.dumps({"kind": "device_total", "name": name, **total}) + "\n")
        f.write(json.dumps({"kind": "counters", "counters": recs["counters"], "pending": recs["pending"],
                            "dropped": recs["dropped"]}) + "\n")


def record_to(path: str) -> None:
    """Turn the recorder on now and write its records to ``path`` at exit
    (:func:`write_jsonl`), from the process that writes the run's files
    (``parallel.is_writer``: the only process, or rank 0).  The package calls
    it at import when ``DMIP_TRACE`` names a file."""
    enable()

    def write():
        from ..parallel.mesh import is_writer

        if is_writer() and os.environ.get("RANK", "0") == "0":
            write_jsonl(path)

    atexit.register(write)
