"""b1_roofline: the least time of the traced fits' prediction passes
(`perfbench.roofline.predict_work`) as a share of kernel B1's device time
(`slda::predict_*`) in the window, in %."""
from perfbench import roofline

KERNEL = "slda::predict_"


def read(ctx):
    dev_s = sum(s for name, s in ctx["trace"]["ops"].items()
                if KERNEL in name)
    if dev_s <= 0 or not ctx["fits"]:
        return None
    least, _ = roofline.least_s(*roofline.predict_work(ctx["work"]))
    return least * ctx["fits"] / dev_s * 100.0
