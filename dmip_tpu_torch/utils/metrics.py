"""Scalar metrics writer (port of ``dmip_tpu/utils/metrics.py``).

Scalars go to a JSONL event stream and to one ``<tag>.csv`` per tag with
Step,Value columns ('/' in a tag becomes '_'), with an explicit
``step_offset``.  Off rank 0 of a multi-rank run a writer records
nothing (``parallel.is_writer``), so every rank can log the same run.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from ..parallel.mesh import is_writer


class MetricsWriter:
    def __init__(self, log_dir: str, step_offset: int = 0):
        self.log_dir = log_dir
        self.step_offset = step_offset
        self._buffers: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self._jsonl = None
        if is_writer():
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        step = step + self.step_offset
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step, "t": time.time()}) + "\n")
        self._buffers[tag].append((step, value))
        if len(self._buffers[tag]) >= 100:
            self._flush_tag(tag)

    def _flush_tag(self, tag: str) -> None:
        rows = self._buffers.pop(tag, [])
        if not rows:
            return
        path = os.path.join(self.log_dir, tag.replace("/", "_") + ".csv")
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("Step,Value\n")
            for s, v in rows:
                f.write(f"{s},{v}\n")

    def flush(self) -> None:
        if self._jsonl is None:
            return
        for tag in list(self._buffers):
            self._flush_tag(tag)
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self.flush()
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
