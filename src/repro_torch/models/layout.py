"""Where a model's tensors live: `Layout`, handed from the step builders
down to every layer.

`Layout()` (no mesh) is one device: every tensor is a plain tensor and
the layout only carries the attention switches of the plain route.  With
a `DeviceMesh`, parameters, batches and caches are DTensors placed by
the rules of `launch.sharding`, and an activation `[c, b, ...]` is
sharded over the chain axes on dim 0 and over the data-parallel axes on
dim 1, and replicated over `model` unless a layer says otherwise.

A spec is the reference's PartitionSpec as a tuple: one entry per tensor
dim, each None, an axis name or a tuple of axis names (major first).
`placements` turns one into DTensor placements.  `region` runs a
function on the local shards of its operands (as `local_map` does), after
redistributing each operand to the spec the function needs: that is how
a layer states the placement of an op that DTensor cannot propagate on
its own.  Every such place is listed in `launch.sharding`'s docstring.
"""
from __future__ import annotations

import dataclasses

import torch


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor())


def placements(spec, mesh):
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh
    dim named in entry d, `Replicate()` on the others.  A tuple entry
    shards one tensor dim over several mesh dims, the first named the
    major one (DTensor splits by mesh dim order, as the mesh's axes are
    ordered pod, data, model)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def spec_entry(axes):
    """() → None, ('data',) → 'data', a longer tuple stays a tuple."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


@dataclasses.dataclass(frozen=True)
class Layout:
    mesh: object = None          # a DeviceMesh, or None for one device
    chain: tuple = ()            # the mesh axes of the chain dim
    dp: tuple = ()               # the mesh axes of a chain's batch dim
    # the reference's §Perf switches that the layers read
    head_shard: bool = False     # kv heads repeated to shard q's heads
    moe_ep: bool = False         # MoE experts sharded over `model`
    causal_skip: bool = False    # triangular causal attention
    block_q: int = 0             # 0 → 512, the blocked attention's block
    probs_bf16: bool = False     # bf16 attention probabilities

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def msize(self) -> int:
        """The size of the `model` axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index("model"))

    def axis_size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        return n

    def act(self, ndim, model_dim=None):
        """The spec of an activation [c, b, ...] of `ndim` dims: chain axes
        on dim 0, the data-parallel axes on dim 1, `model` on `model_dim`
        if given."""
        spec = [spec_entry(self.chain), spec_entry(self.dp)]
        spec += [None] * (ndim - 2)
        if model_dim is not None:
            spec[model_dim] = "model"
        return tuple(spec[:ndim])

    def chain_only(self, ndim):
        return (spec_entry(self.chain),) + (None,) * (ndim - 1)

    def fits(self, dim, axes=("model",)) -> bool:
        """Whether `dim` splits evenly over `axes` (always on one device)."""
        return self.mesh is None or dim % self.axis_size(axes) == 0

    def put(self, t, spec):
        """t redistributed to `spec` (a plain tensor is returned as is)."""
        if not is_dtensor(t):
            return t
        want = placements(spec, self.mesh)
        if tuple(t.placements) == want:
            return t
        return t.redistribute(self.mesh, want)

    def put_like(self, t, ref):
        """t redistributed to the placements of `ref` (t itself when
        either is a plain tensor)."""
        if not (is_dtensor(t) and is_dtensor(ref)) or \
                t.placements == ref.placements:
            return t
        return t.redistribute(ref.device_mesh, ref.placements)

    def weight(self, w, dtype):
        """A weight cast to the compute dtype and gathered over the
        data-parallel axes (FSDP keeps it sharded there between uses):
        its chain and `model` placements stay."""
        w = w.to(dtype)
        if not is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate
        names = self.mesh.mesh_dim_names
        want = tuple(Replicate() if names[i] in self.dp else p
                     for i, p in enumerate(w.placements))
        if want == tuple(w.placements):
            return w
        return w.redistribute(self.mesh, want)

    def proj(self, eq, x, w, dtype):
        """torch.einsum(eq, x, w) of an activation x [c, b, ...] and a
        weight w, cast and FSDP-gathered (`weight`).  Sharded, the product
        is local: x replicated over `model`, unless w splits a contracted
        dim over `model` (then x is split the same way and the partial
        products are all-reduced over `model`), so that x @ w is column-
        or row-parallel as the weight's placement says, never what
        DTensor's cost model would pick (which can split x's sequence and
        gather the weight)."""
        w = self.weight(w, dtype)
        if not is_dtensor(w):
            return torch.einsum(eq, x, w)
        from torch.distributed.tensor import Partial, Replicate, Shard
        (lx, lw), lo = eq.split("->")[0].split(","), eq.split("->")[1]
        mi = self.mesh.mesh_dim_names.index("model")
        wm = w.placements[mi]
        row = wm.is_shard() and lw[wm.dim] in lx
        x = self.put(x, self.act(x.ndim, lx.index(lw[wm.dim]) if row
                                 else None))
        outp = []
        for xp, wp in zip(x.placements, w.placements):
            la = lx[xp.dim] if xp.is_shard() else None
            lb = lw[wp.dim] if wp.is_shard() else None
            if la is not None and lb is not None and la != lb:
                raise ValueError(f"{eq}: x split on {la}, w on {lb}")
            letter = la or lb
            if letter is None:
                outp.append(Replicate())
            elif (la is None and letter in lx) or \
                    (lb is None and letter in lw):
                raise ValueError(f"{eq}: {letter} split on one side only")
            else:
                outp.append(Shard(lo.index(letter)) if letter in lo
                            else Partial())
        DTensor = _dtensor()

        def grads(t, other):
            return [Partial() if isinstance(p, Replicate) and q.is_shard()
                    else p for p, q in zip(t.placements, other.placements)]
        out = DTensor.from_local(
            torch.einsum(eq, x.to_local(grad_placements=grads(x, w)),
                         w.to_local(grad_placements=grads(w, x))),
            self.mesh, outp, run_check=False)
        if row:
            out = self.put(out, self.act(out.ndim))
        return out

    def region(self, fn, args, in_specs, out_specs, partial=()):
        """fn(*args) on local shards: each DTensor argument redistributed
        to its spec of `in_specs` (None for a non-tensor or a plain
        tensor), the output wrapped as a DTensor of `out_specs` (a tuple
        output: a list of specs, None where fn returns None).  An
        argument whole on a mesh dim that splits another argument takes
        a partial gradient there (each device's share of the work).  The
        outputs are partial sums over the mesh axes named in `partial`.
        Without a mesh it is fn(*args)."""
        if self.mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import Partial, Replicate
        DTensor = _dtensor()
        args = [self.put(a, s) if is_dtensor(a) else a
                for a, s in zip(args, in_specs)]
        # mesh dims that split the work: an operand whole on such a dim
        # gets a partial gradient from each device's share
        split = {i for a in args if is_dtensor(a)
                 for i, p in enumerate(a.placements) if p.is_shard()}

        def grad_placements(a):
            return [Partial() if i in split and isinstance(p, Replicate)
                    else p for i, p in enumerate(a.placements)]
        loc = [a.to_local(grad_placements=grad_placements(a))
               if is_dtensor(a) else a for a in args]
        out = fn(*loc)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        specs = (out_specs,) if single else out_specs
        names = self.mesh.mesh_dim_names

        def out_placements(spec):
            return tuple(Partial() if names[i] in partial else p
                         for i, p in enumerate(placements(spec, self.mesh)))
        wrapped = tuple(
            o if o is None else DTensor.from_local(
                o, self.mesh, out_placements(s), run_check=False)
            for o, s in zip(outs, specs))
        return wrapped[0] if single else wrapped


PLAIN = Layout()


def local(t):
    """The local shard of a DTensor, or t."""
    return t.to_local() if is_dtensor(t) else t
