"""What the program's own recorder (``dmip_tpu_torch.utils.profiling``) hands
the per-layer readers of a traced run: its ``records()`` after the window
and ``stop_ns``, the profiler's stop on the recorder's clock, as
``Reading.program``.  A run that hands no records (``program`` absent or
None) gives those readers nothing to read."""

from __future__ import annotations

from typing import List, Optional, Tuple


def records(r) -> Optional[dict]:
    return getattr(r, "program", None) or None


def after_stop(program: dict) -> Tuple[List[dict], List[dict]]:
    """The host rows that start after the profiler's stop, and the device
    rows of the spans among them (by id: a device row carries its host
    span's)."""
    stop = program.get("stop_ns")
    if stop is None:
        return [], []
    rows = [row for row in program["rows"] if row["t0_ns"] >= stop]
    if not rows:
        return [], []
    first = min(row["id"] for row in rows)
    return rows, [row for row in program["device_rows"] if row["id"] >= first]


def idle_share(rows: List[dict], device_rows: List[dict]) -> Optional[float]:
    """The share of card time, from the first leaf device span's start to the
    last one's end, that lies inside no leaf device span (%).  A leaf
    encloses no other device span, by the host rows' parents: the spans
    around a whole call are not leaves."""
    parent = {row["id"]: row["parent"] for row in rows}
    ids = {row["id"] for row in device_rows}
    outer = set()
    for i in ids:
        p = parent.get(i)
        while p is not None:
            if p in ids:
                outer.add(p)
            p = parent.get(p)
    leaves = sorted((row["start_ms"], row["end_ms"]) for row in device_rows if row["id"] not in outer)
    if not leaves:
        return None
    lo, hi = leaves[0][0], max(end for _, end in leaves)
    if hi <= lo:
        return None
    covered, (cur_s, cur_e) = 0.0, leaves[0]
    for s, e in leaves[1:]:
        if s > cur_e:
            covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    covered += cur_e - cur_s
    return 100.0 * (1.0 - covered / (hi - lo))
