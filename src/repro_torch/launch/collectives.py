"""Counting the collectives a piece of code reaches.

The reference proves that its chains never communicate by scanning the
compiled HLO of the sharded program for collectives (`launch/hlo.py`'s
`collective_stats`).  Eager PyTorch has no program to scan, so the port
counts at run time instead: `count_collectives()` wraps every collective
of `torch.distributed` that the runner could reach, for the length of a
`with` block, and counts the calls and their payload bytes by kind in the
reference's fields (`count`, `bytes_total`, `by_kind`).

A payload is counted as the reference counts it from an output shape:
`all_reduce` twice its tensor (a ring moves it about twice); a gather the
gathered output; a reduce-scatter its input (the output times the group);
an all-to-all its output; `broadcast`, `reduce`, `send` / `recv` their
tensor; `barrier` nothing.  A collective that calls another one (a
deprecated alias, an object gather's size exchange) counts once, as the
one called first.  The `*_object` collectives are not wrapped: the tensor
collectives they make are counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _arg(args, kwargs, i, name):
    return args[i] if len(args) > i else kwargs.get(name)


def _group_size(args, kwargs, i) -> int:
    return dist.get_world_size(_arg(args, kwargs, i, "group"))


# kind -> payload bytes of one call, from its (args, kwargs)
_PAYLOAD = {
    "all_reduce": lambda a, k: 2 * _nbytes(_arg(a, k, 0, "tensor")),
    "all_gather": lambda a, k: _nbytes(_arg(a, k, 0, "tensor_list")),
    "all_gather_into_tensor":
        lambda a, k: _nbytes(_arg(a, k, 0, "output_tensor")),
    "all_gather_single":
        lambda a, k: _nbytes(_arg(a, k, 0, "output_tensor")),
    "reduce_scatter": lambda a, k: _nbytes(_arg(a, k, 1, "input_list")),
    "reduce_scatter_tensor": lambda a, k: _nbytes(_arg(a, k, 1, "input")),
    "reduce_scatter_single": lambda a, k: _nbytes(_arg(a, k, 1, "input")),
    "all_to_all":
        lambda a, k: _nbytes(_arg(a, k, 0, "output_tensor_list")),
    "all_to_all_single": lambda a, k: _nbytes(_arg(a, k, 0, "output")),
    "broadcast": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "reduce": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "gather": lambda a, k: _nbytes(_arg(a, k, 0, "tensor"))
    * _group_size(a, k, 3),
    "scatter": lambda a, k: _nbytes(_arg(a, k, 0, "tensor"))
    * _group_size(a, k, 3),
    "send": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "recv": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "isend": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "irecv": lambda a, k: _nbytes(_arg(a, k, 0, "tensor")),
    "barrier": lambda a, k: 0,
}


@dataclasses.dataclass
class CollectiveStats:
    """What a counted block reached: calls, payload bytes, and bytes and
    calls by kind (the reference's `launch.hlo.CollectiveStats` fields,
    with `calls_by_kind` beside its `by_kind`)."""

    bytes_total: float = 0.0
    count: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)
    calls_by_kind: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, nbytes: int):
        self.count += 1
        self.bytes_total += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes
        self.calls_by_kind[kind] = self.calls_by_kind.get(kind, 0) + 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Patch:
    """The wrappers, installed while at least one counter is open.  The
    collectives are module functions of `torch.distributed` (and of
    `distributed_c10d`, where the package's own calls look them up), so
    counting means replacing them there, for every thread of the
    process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active: list = []
        self.saved: list = []      # (module, name, original)
        self.depth = threading.local()

    def wrap(self, kind, fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            depth = getattr(self.depth, "n", 0)
            if depth == 0:
                nbytes = _PAYLOAD[kind](args, kwargs)
                with self.lock:
                    for stats in self.active:
                        stats.add(kind, nbytes)
            self.depth.n = depth + 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth.n = depth
        return counted

    def open(self, stats: CollectiveStats):
        with self.lock:
            if not self.active:
                for kind in _PAYLOAD:
                    fn = getattr(c10d, kind, None)
                    if fn is None:
                        continue
                    counted = self.wrap(kind, fn)
                    for mod in (c10d, dist):
                        if getattr(mod, kind, None) is fn:
                            self.saved.append((mod, kind, fn))
                            setattr(mod, kind, counted)
            self.active.append(stats)

    def close(self, stats: CollectiveStats):
        with self.lock:
            self.active = [s for s in self.active if s is not stats]
            if not self.active:
                for mod, kind, fn in self.saved:
                    setattr(mod, kind, fn)
                self.saved.clear()


_PATCH = _Patch()


@contextlib.contextmanager
def count_collectives():
    """`with count_collectives() as stats:` counts every collective of
    `torch.distributed` called in the block, from any thread, into
    `stats` (a `CollectiveStats`).  Counters nest: each open one counts
    every call."""
    stats = CollectiveStats()
    _PATCH.open(stats)
    try:
        yield stats
    finally:
        _PATCH.close(stats)
