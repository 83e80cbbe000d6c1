"""b3_roofline: the least time of the traced fits' training sweeps
(`perfbench.roofline.train_work`, the larger of operations over the
float32 peak and bytes over HBM's) as a share of kernel B3's device time
(`slda::train_*`) in the window, in %."""
from perfbench import roofline

KERNEL = "slda::train_"


def read(ctx):
    dev_s = sum(s for name, s in ctx["trace"]["ops"].items()
                if KERNEL in name)
    if dev_s <= 0 or not ctx["fits"]:
        return None
    least, _ = roofline.least_s(*roofline.train_work(ctx["work"]))
    return least * ctx["fits"] / dev_s * 100.0
