"""Per-device cost of a step, counted as it runs: the port's counterpart
of the reference's `launch/hlo.py` and `launch/hlo_cost.py`.

The reference reads its costs from the optimized HLO of the partitioned
program.  A PyTorch step has no such program, so `StepCost`, a
`TorchDispatchMode`, watches the operations one device runs: under a
DTensor it lets DTensor first split an operation into local operations
and the collectives that it needs, and counts those, on the device's own
shards (a count at the DTensor level would be the global operation:
`FlopCounterMode` counts a sharded matmul whole).  With fake tensors
(`FakeTensorMode`) and a fake process group of any size, nothing is
computed and nothing is sent, and the counts are those of one device of
the full mesh.  It counts, in the reference's models:

  flops      2·M·N·K of every matmul (`mm`, `addmm`, `bmm`, `baddbmm`):
             the matmul-only model of `hlo_cost.py`, the same ops and
             formula as `torch.utils.flop_counter.FlopCounterMode`
  hbm bytes  each operation's operand and output bytes (views,
             metadata queries and collectives move none); a gather counts its output and its
             indices, not the operand it gathers from; an indexed write
             (`index_put`) its indices and values read and the values
             written, not the tensor it writes into
  collective the payload of each collective of `torch.ops.
             _c10d_functional` (and of the `c10d` ops of the eager API),
             by the reference's rules (`hlo.py`): all-reduce 2× its
             tensor, all-gather the output, reduce-scatter the output ×
             the group (its input), all-to-all and a send the output;
             split into intra-pod and cross-pod by the group's ranks
             (`pod_size` ranks a pod)
  memory     the bytes of the local storages alive at once (weak
             references to each storage the step makes); the peak is
             the most at any time, on top of the step's arguments

`roofline_terms` turns the counts into the reference's three times, with
an H100 SXM's datasheet rates in place of its TPU v5e constants.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.layout import is_dtensor

# NVIDIA H100 SXM5 datasheet: dense BF16 tensor-core rate, HBM3 bandwidth
# and NVLink 4 bandwidth each way (900 GB/s in both directions together).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
POD_SIZE = 256

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.embedding.default, _aten.index_select.default}
# an indexed write touches its indices and values, not the whole target
_SCATTERS = {_aten.index_put.default, _aten.index_put_.default,
             _aten._index_put_impl_.default}
_NO_TRAFFIC = {_aten.detach.default, _aten.lift_fresh.default,
               _aten._local_scalar_dense.default, _aten.empty.memory_format,
               _aten.empty_strided.default, _aten.empty_like.default}


# payload bytes of a collective from its output's bytes and its group
_PAYLOAD = {"all-reduce": lambda b, g: 2 * b,
            "all-gather": lambda b, g: b,
            "reduce-scatter": lambda b, g: b * g,
            "all-to-all": lambda b, g: b}
_FUNCOL = {"all_reduce": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "broadcast_": "all-gather"}


def _collective_table():
    """{op overload: kind} of every collective op that is registered."""
    table = {}
    for ns, names in ((torch.ops._c10d_functional, _FUNCOL),
                      (torch.ops._c10d_functional_autograd, _FUNCOL),
                      (torch.ops.c10d, _C10D)):
        for name, kind in names.items():
            try:
                table[getattr(ns, name).default] = kind
            except (AttributeError, RuntimeError):
                pass                     # not in this build of torch
    return table


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_ranks(args):
    """The global ranks of a collective's group: a functional collective
    names it (its last string argument), a `c10d` op passes it."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    for a in reversed(args):
        if isinstance(a, str):
            return dist.get_process_group_ranks(
                c10d._resolve_process_group(a))
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return [0]


_PROPAGATING = threading.local()      # `depth`, per thread (autograd's too)


def _mark_propagation():
    """While DTensor works out an operation's output shapes it runs the
    operation on global-shaped stand-ins (fake tensors of the step's own
    fake mode, in a dry-run): mark those calls, which no device runs.
    Returns the function that undoes the marking."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = []
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        fn = ShardingPropagator.__dict__.get(name)
        if fn is None:
            continue

        def marked(*a, _fn=fn, **k):
            _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
            try:
                return _fn(*a, **k)
            finally:
                _PROPAGATING.depth -= 1
        saved.append((name, fn))
        setattr(ShardingPropagator, name, marked)
    if not saved:
        raise RuntimeError(
            "ShardingPropagator has neither _propagate_tensor_meta nor "
            "_propagate_tensor_meta_non_cached: the counter cannot tell "
            "DTensor's shape propagation from the step's own operations")

    def undo():
        for name, fn in saved:
            setattr(ShardingPropagator, name, fn)
    return undo


def matmul_flops(func, args, out) -> int:
    """2·M·N·K of one matmul (batched: times the batch)."""
    if func in (_aten.mm.default, _aten.bmm.default):
        a = args[0]
    else:                                   # addmm / baddbmm: (bias, a, b)
        a = args[1]
    k = a.shape[-1]
    return 2 * out.numel() * k


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_cross_pod: float = 0.0
    coll_count: int = 0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0          # live local storages made by the step


class StepCost(TorchDispatchMode):
    """Counts one device's work inside the block (see the module's
    docstring).  `arguments`: tensors (DTensors, or plain ones) alive
    before the block, whose storages are not the step's to count."""

    def __init__(self, pod_size: int = POD_SIZE, arguments=()):
        super().__init__()
        self.pod_size = pod_size
        self.cost = Cost()
        self._coll = _collective_table()
        self._live = {}
        self._now = 0
        self._fake = None
        self._known = {self._key(t.to_local() if is_dtensor(t) else t)
                       for t in arguments}

    def __enter__(self):
        from torch._guards import detect_fake_mode
        self._fake = detect_fake_mode()    # the step's fake tensors, if any
        self._unpatch = _mark_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def _shadow(self, t):
        """A tensor of DTensor's sharding propagation (meta, or fake under
        a fake mode that is not the step's), not one a device holds."""
        from torch._subclasses.fake_tensor import FakeTensor
        return t.device.type == "meta" or (
            isinstance(t, FakeTensor) and t.fake_mode is not self._fake)

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def _track(self, out):
        for t in _tensors(out):
            if is_dtensor(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self._now += nbytes
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self._now -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, torch.distributed.tensor.DTensor)
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0) or any(
                self._shadow(t)
                for t in _tensors(list(args) + list(kwargs.values()))):
            return out        # DTensor's shape propagation: no device work
        c = self.cost
        if func in self._coll:
            kind = self._coll[func]
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            b = _PAYLOAD[kind](_nbytes(_tensors(out)), len(ranks))
            c.coll_bytes += b
            c.coll_count += 1
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + b
            if len({r // self.pod_size for r in ranks}) > 1:
                c.coll_cross_pod += b
            return out
        if func in _MATMULS:
            c.flops += matmul_flops(func, args, out)
        outs = _tensors(out)
        # views, allocations and queries of metadata (`prim.device`, no
        # tensor out) move no bytes
        if outs and not (func.is_view or func in _NO_TRAFFIC):
            if func in _GATHERS:
                ins = [t for t in _tensors(args[1:])
                       if not t.is_floating_point()]
            elif func in _SCATTERS:
                ins = _tensors(args[1:])
                outs = [args[2]]             # the values written
            else:
                ins = _tensors(list(args) + list(kwargs.values()))
            c.hbm_bytes += _nbytes(ins) + _nbytes(outs)
        self._track(out)
        return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (each storage once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    walk(tree)
    return total


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int, per_device: bool = True) -> dict:
    """The reference's three roofline terms in seconds (its field names),
    at `PEAK_FLOPS`, `HBM_BW` and `NVLINK_BW`.  The counts are already one
    device's (`per_device`)."""
    div = 1 if per_device else n_chips
    t_compute = flops / div / PEAK_FLOPS
    t_memory = hbm_bytes / div / HBM_BW
    t_coll = coll_bytes / div / NVLINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}


__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "POD_SIZE", "Cost",
           "StepCost", "local_bytes", "matmul_flops", "roofline_terms"]
