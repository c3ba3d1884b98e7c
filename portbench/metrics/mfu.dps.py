"""The guided posterior's share of the card's f32 peak: the model operations
(``flops_guided.py``) of the window's requests run after the traced ones,
untraced, over their time on the host's clock (from the profiler's stop to
the window's end) and the f32 peak, the precision B5 computes in.  Untraced,
so the profiler's own cost is not in it."""

from portbench import flops


def read(r):
    if not r.after or r.after_s <= 0:
        return None
    ops = sum(n * r.flops[unit] for unit, n in r.after.items())
    return 100.0 * ops / r.after_s / flops.PEAKS["f32"]
