"""Per-layer metric readers: ``metrics/<name>.py``, or for a name with a
dot ``metrics/<part before the first dot>.py`` when the whole name has no
file of its own, defines ``read(r) -> float | None`` over a
:class:`portbench.run.Reading`.  A reader that finds nothing to read
returns None, and the run leaves the metric out of its line."""

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"portbench.metrics._{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r} under portbench/metrics/")
