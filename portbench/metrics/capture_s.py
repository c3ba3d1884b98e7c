"""Seconds the engine spent capturing its step (host span ``train.capture``:
the eager warm-up runs and the capture) over the whole run, set-up
included: a recapture in the window adds to it."""

from portbench import program


def read(r):
    p = program.records(r)
    if p is None or "train.capture" not in p["spans"]:
        return None
    return p["spans"]["train.capture"]["total_s"]
