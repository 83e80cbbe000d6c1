"""What a traced window's profiler trace says: the device's busy time,
the time of each device operation, and the idle gaps named by the host
span they fell in.

The method is `repro_torch.bench_simple`'s at commit 025a0b2 (device
time read from `torch.profiler` over CUDA activity, idle = 1 − busy /
wall), with one repair: busy time is the union of the device
operations' intervals, not their sum, because the length-bucketed route
runs launches on several streams at once and a sum would count the
overlap twice.  It reads the profiler's raw events, which is much
faster than building its per-event tree.  The window and the host spans
are the harness's, on the host's wall clock in ns, the profiler's own
time base.
"""
from __future__ import annotations

from torch.autograd import DeviceType


def _union(intervals):
    """Sorted disjoint [start, end) intervals covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, window, spans) -> dict:
    """From the profiler `prof`, the window (start_ns, end_ns) and the
    host spans [(name, start_ns, end_ns)]: {"window", "busy_s", "ops":
    {name: device seconds}, "gaps": [(span, seconds)] the ten longest
    idle gaps, named by the span they fell in ("between-fits" outside
    all), "device_events": count}."""
    device, ops = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s, t = e.start_ns(), e.end_ns()
        if t > s:
            device.append((s, t))
            name = e.name()
            ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
    w0, w1 = window
    inside = [(max(s, w0), min(t, w1)) for s, t in device
              if t > w0 and s < w1]
    if device and len(inside) < len(device) // 2:
        raise RuntimeError("the device's events do not lie in the host's "
                           "window: the clocks do not agree")
    busy = _union(inside)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((a, b, n) for n, a, b in spans)
    named = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + t) / 2
        where = next((n for a, b, n in spans if a <= mid < b),
                     "between-fits")
        named.append((where, (t - s) * 1e-9))
    return {"window": window, "busy_s": sum(t - s for s, t in busy) * 1e-9,
            "ops": ops, "gaps": named, "device_events": len(device)}
