"""train_ms: the mean of the fits' "train" phase (`core.plan.
ExecutionPlan.train_em` and the export), in ms, from the timer hook's CUDA
events."""
from statistics import fmean


def read(ctx):
    xs = ctx["phase_ms"]["train"]
    return fmean(xs) if xs else None
