"""Phase spans for the algorithms' `timer=` hook.

Frozen copy of `repro_torch.timing.PhaseTimer` at commit 025a0b2: on a
CUDA device a phase is bracketed by CUDA events on the current stream, so
its time is the device timeline's, read after one synchronize; on the CPU
it is the host clock.  One addition: given a `spans` list, each phase
also appends (phase, start, end) on the host's wall clock in ns
(`time.time_ns`, the profiler's own time base), so that a traced run can
say what the host was doing in each idle gap.
"""
from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """`with timer("train"): ...` records a span; `ms()` sums the spans
    of each phase in milliseconds."""

    def __init__(self, device, spans: list | None = None):
        self.cuda = torch.device(device).type == "cuda"
        self.host_spans = spans
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, phase: str):
        host0 = time.time_ns()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self.spans.append((phase, start, end))
        if self.host_spans is not None:
            self.host_spans.append((phase, host0, time.time_ns()))

    def ms(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for phase, s, e in self.spans:
            t = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[phase] = out.get(phase, 0.0) + t
        return out
