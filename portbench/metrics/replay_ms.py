"""The card's ms a training step's replay takes: the mean of the device span
``train.replay`` over the steps after the profiler's stop, untraced."""

from portbench import program


def read(r):
    p = program.records(r)
    if p is None:
        return None
    _, dev = program.after_stop(p)
    ms = [row["end_ms"] - row["start_ms"] for row in dev if row["name"] == "train.replay"]
    return sum(ms) / len(ms) if ms else None
