"""fit_mfu: a fit's useful float32 operations (30 training sweeps over the
real training tokens, and every chain's prediction sweeps over every
predicted real token) over the traced fits' mean time (CUDA events around
each fit) at the H100's 67 TFLOP/s, in %."""
from statistics import fmean

from perfbench import roofline


def read(ctx):
    if not ctx["fits"] or not ctx["trace"]["device_events"]:
        return None
    ops = (roofline.train_work(ctx["work"])[0]
           + roofline.predict_work(ctx["work"])[0])
    return ops / (fmean(ctx["fit_ms"]) * 1e-3 * roofline.PEAK_FP32_S) * 100.0
