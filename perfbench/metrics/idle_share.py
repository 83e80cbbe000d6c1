"""idle_share: the share of the traced window in which no operation ran
on the device (the union of the device operations' intervals), in %."""


def read(ctx):
    w0, w1 = ctx["trace"]["window"]
    if w1 <= w0 or not ctx["trace"]["device_events"]:
        return None
    return (1.0 - ctx["trace"]["busy_s"] / ((w1 - w0) * 1e-9)) * 100.0
