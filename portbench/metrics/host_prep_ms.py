"""The host's ms a request spends before B1 runs: the sampler's draws
(``sample.draws``), B1's weight packing (``b1.pack``) and its launch
(``b1.launch``), over the requests (``sample``) after the profiler's stop,
untraced."""

from portbench import program

PARTS = ("sample.draws", "b1.pack", "b1.launch")


def read(r):
    p = program.records(r)
    if p is None:
        return None
    rows, _ = program.after_stop(p)
    requests = sum(1 for row in rows if row["name"] == "sample")
    if not requests:
        return None
    ns = sum(row["t1_ns"] - row["t0_ns"] for row in rows if row["name"] in PARTS)
    return ns * 1e-6 / requests
