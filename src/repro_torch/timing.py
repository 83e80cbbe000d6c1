"""Phase timing for the algorithms' `timer=` hook.

On a CUDA device a phase is bracketed by CUDA events on the current
stream, so its time is the device timeline's, read after one
synchronize; on the CPU it is the host clock.
"""
from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """`with timer("train"): ...` records a span; `ms()` sums the spans
    of each phase in milliseconds."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, phase: str):
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

    def ms(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for phase, s, e in self.spans:
            t = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[phase] = out.get(phase, 0.0) + t
        return out
