"""The card's idle share between the program's device spans after the
profiler's stop, untraced: card time from the first leaf span's start to
the last one's end that lies inside none (the batches, draws, input copies
and replays of every step; ``program.idle_share``)."""

from portbench import program


def read(r):
    p = program.records(r)
    if p is None:
        return None
    rows, dev = program.after_stop(p)
    return program.idle_share(rows, dev)
