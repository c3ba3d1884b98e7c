"""The evaluation's scoring on the card: the device's busy time outside the
sampler kernel B1 (histograms, score-MSE, W2, the analytic posterior's
draws) over all its busy time in the traced window."""

from portbench import flops, trace


def read(r):
    if r.summary is None or r.summary["busy_s"] <= 0:
        return None
    b1 = trace.device_time(r.summary, flops.is_b1)
    if b1 is None:
        return None
    return 100.0 * (r.summary["busy_s"] - b1[0]) / r.summary["busy_s"]
