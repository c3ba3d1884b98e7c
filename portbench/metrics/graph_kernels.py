"""Kernels a training step: the kernel nodes of the captured step graph(s),
counted by the program at each capture (``graph_kernels``), over its
captures (host span ``train.capture``); a data-parallel step's two graphs
count as one step's."""

from portbench import program


def read(r):
    p = program.records(r)
    if p is None or "graph_kernels" not in p["counters"] or "train.capture" not in p["spans"]:
        return None
    return p["counters"]["graph_kernels"] / p["spans"]["train.capture"]["count"]
