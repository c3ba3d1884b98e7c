"""The whole step's share of the card's peak: the model operations
(``flops.py``) of the window's units run after the traced ones, untraced,
over their time on the host's clock (from the profiler's stop to the
window's end) and the peak of the compute dtype: bf16 for serving, where
B1 computes in bf16; for training float32, or TF32 when the run allows
TF32 matmuls.  Untraced, so the profiler's own cost (CUPTI's buffers, its
slower graph launches) is not in it."""

from portbench import flops


def read(r):
    if not r.after or r.after_s <= 0:
        return None
    ops = sum(n * r.flops[unit] for unit, n in r.after.items())
    peak = flops.PEAKS["bf16"] if r.kind != "train" else flops.PEAKS["tf32" if r.tf32 else "f32"]
    return 100.0 * ops / r.after_s / peak
