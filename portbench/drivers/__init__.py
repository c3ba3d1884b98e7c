"""Traffic drivers, one a traffic ``kind``: ``drivers/<kind>.py`` defines
``Driver(cell, spans)`` with

* ``setup()``: weights and inputs from the seed, the program's objects,
  and one unit of the cell's own shapes, so nothing builds in the window;
* ``window(seconds, tracer) -> dict``: whole units until ``seconds`` have
  passed (besides ``tracer.paused``), telling ``tracer`` each unit's start, work and end; returns the
  end-to-end metric it measured, ``attempted``, ``failed`` and ``t_end``
  (the host's clock at the window's end);
* ``flops_per_unit()``: the model operations of a unit (and of a B1
  launch) for the readers;
* ``free()``: drops the program's state, keeping the outputs to judge;
* ``outputs()``: those outputs; ``reference(precision)``: the reference's
  for the same units and inputs; ``compare(outputs, reference)``: the
  checks, each number beside its limit; ``details`` (optional): what
  ``calibrate.py`` prints beside them.
"""

import importlib


def load(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver
