"""The device's idle share of the traced window: one minus the union of its
operations' intervals over the window's length."""


def read(r):
    if r.summary is None or r.summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.summary["busy_s"] / r.summary["window_s"])
