"""B5's share of its roofline: its launches' operations (``flops_guided.py``,
from the nets' widths) over the f32 peak, over its device time in the
traced window.  Compute bounds it: B5 computes in f32 outside the tensor
cores, and a posterior's device-memory bytes are a few MB."""

from portbench import flops, flops_guided, trace


def read(r):
    if r.summary is None or "b5_launch" not in r.flops:
        return None
    b5 = trace.device_time(r.summary, flops_guided.is_b5)
    if b5 is None or b5[0] <= 0:
        return None
    seconds, launches = b5
    return 100.0 * launches * r.flops["b5_launch"] / flops.PEAKS["f32"] / seconds
