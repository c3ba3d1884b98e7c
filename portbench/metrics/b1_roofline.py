"""B1's share of its roofline: its launches' operations (``flops.py``, from
the net's widths) over the bf16 peak, over its device time in the traced
window.  Compute bounds it: a posterior reads ~1 MB of weights per block
and step from L2, and its device-memory bytes are a few MB."""

from portbench import flops, trace


def read(r):
    if r.summary is None:
        return None
    b1 = trace.device_time(r.summary, flops.is_b1)
    if b1 is None or b1[0] <= 0:
        return None
    seconds, launches = b1
    return 100.0 * launches * r.flops["b1_launch"] / flops.PEAKS["bf16"] / seconds
