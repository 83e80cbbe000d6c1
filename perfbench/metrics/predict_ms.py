"""predict_ms: the mean of the fits' "predict" phase (`core.plan.
ExecutionPlan.predict_zbar` and ŷ), in ms, from the timer hook's CUDA
events."""
from statistics import fmean


def read(ctx):
    xs = ctx["phase_ms"]["predict"]
    return fmean(xs) if xs else None
