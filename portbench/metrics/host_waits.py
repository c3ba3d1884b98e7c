"""Host waits for the card a chunk of the evaluation: the program's
``host_waits`` counter over its chunks (host span ``eval.chunk``), over the
whole run."""

from portbench import program


def read(r):
    p = program.records(r)
    if p is None or "eval.chunk" not in p["spans"]:
        return None
    return p["counters"].get("host_waits", 0) / p["spans"]["eval.chunk"]["count"]
