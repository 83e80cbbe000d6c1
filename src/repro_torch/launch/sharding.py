"""Sharding rules: how the chain / data / model axes of a device mesh map
onto every tensor, the reference's `launch.sharding`, with `DistConfig`
(`use_kernels` in place of `use_pallas`).

Chain placement: the chain axis is the paper's communication-free
boundary.  A chain count must exactly cover whole mesh axes:

  single-pod (data=16, model=16):          1 | 16
  multi-pod (pod=2, data=16, model=16):    1 | 2 | 32

`n_chains=1` on the multi-pod mesh is the standard data-parallel
baseline (the gradient all-reduce crosses the pod boundary): the dry-run
counts how many cross-pod collective bytes the chains remove.

A spec is the reference's PartitionSpec as a tuple (one entry per tensor
dim: None, an axis name, or a tuple of axis names); `placements` turns it
into DTensor placements, `_fits` replicates an entry whose axes do not
divide its dim (DTensor's uneven shards would change every per-device
byte count).  The rules key on a leaf's name: a port parameter's name is
its reference leaf's (`convert._lm_state` pairs them: the last component
of the dotted name, `embed` being the reference's `embed.table`); the
port keeps no stacked `layers_stacked` leaves, so no leaf carries the
reference's leading layer dim.

The sharded route is the plain one (`use_kernels=False`: the reference's
dry-run lowers `use_pallas=False`), and DTensor propagates the
placements of the projections, norms, residuals and the optimizer's
reductions itself.  Where it cannot, the port states the placement at
the op (`models.layout.Layout.region`, or a `redistribute`); each place
may add collectives, which the dry-run counts:

  * weights: every use casts to the compute dtype, then gathers the FSDP
    axis (`Layout.weight`);
  * the embedding lookup: the table gathered over `model` and FSDP
    (none with `opt_replicate_embed`);
  * attention: q, k, v stay head-sharded over `model` when the kv heads
    divide it; under `opt_head_shard` the kv heads are repeated to q's
    heads so that q's heads shard; otherwise q, k, v are gathered over
    `model`.  RoPE, the qk-norm, the cache write and the twins run on the
    local heads; a cache sharded on its sequence dim is gathered for the
    step and sliced back;
  * the SSD scan and the causal conv: on the local heads when they
    divide `model`, with B and C (read by every head) gathered;
  * MoE: the routing and the combine on all of a chain's tokens (x
    gathered over the data-parallel axes), the experts on the buffer's
    slots split over those axes and, under `opt_moe_ep`, its experts
    over `model` (otherwise the expert weights are gathered);
  * the cross-entropy: vocab-parallel when the vocabulary splits over
    `model` (each device's max, exp-sum and gold logit of its own
    columns, reduced over `model`), else on whole logits;
  * the training step: the per-chain loss reduced over the
    data-parallel axes, each gradient redistributed to its parameter's
    placement (all-reduce, or reduce-scatter under FSDP), the clipping
    norm reduced within a chain's devices only; a batch split into
    microbatches is gathered over the data-parallel axes and each
    microbatch split over them again.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layout import Layout, placements, spec_entry

__all__ = ["DistConfig", "axis_sizes", "chain_axes", "dp_axes", "param_specs",
           "batch_specs", "cache_specs", "opt_state_specs", "placements",
           "layout", "shard_model", "shard_tree"]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    n_chains: int = 1                    # each step checks its batch
    fsdp: bool = False
    accum_steps: int = 1
    param_dtype: str = "float32"
    opt_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # False → every kernel's plain version (the trainer's and the sharded
    # route: the kernels have no backward and take no DTensor)
    use_kernels: bool = False
    remat: bool = True
    remat_policy: str = "full"           # "full" | "dots"
    # --- §Perf switches (all off in the paper-faithful baseline) ---
    opt_causal_attention: bool = False   # triangular causal attention
    opt_replicate_embed: bool = False    # the untied table whole over
                                         # 'model' (no gather to look up)
    opt_prefill_last_only: bool = False  # prefill emits last-token logits
    opt_attn_block_q: int = 0            # 0 = 512, the blocked twin's block
    opt_head_shard: bool = False         # kv heads repeated to shard q's
    opt_probs_bf16: bool = False         # bf16 attention probabilities
    opt_moe_ep: bool = False             # MoE experts split over 'model'


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of anything with the
    reference mesh's `axis_names` / `axis_sizes`."""
    if hasattr(mesh, "mesh_dim_names"):
        names = mesh.mesh_dim_names
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _names(mesh):
    return tuple(axis_sizes(mesh))


def chain_axes(mesh, n_chains: int) -> tuple:
    """The mesh axes the chain dim is split over.  On a mesh whose
    non-`model` axes are all of size 1 (one card's host mesh) every chain
    count stays whole on the device, where the reference raises."""
    sizes = axis_sizes(mesh)
    multi = "pod" in sizes
    if n_chains == 1 or all(n == 1 for a, n in sizes.items()
                            if a != "model"):
        return ()
    if multi and n_chains == sizes["pod"]:
        return ("pod",)
    if multi and n_chains == sizes["pod"] * sizes["data"]:
        return ("pod", "data")
    if not multi and n_chains == sizes["data"]:
        return ("data",)
    raise ValueError(
        f"n_chains={n_chains} must cover whole mesh axes of {sizes}")


def dp_axes(mesh, n_chains: int) -> tuple:
    used = set(chain_axes(mesh, n_chains))
    return tuple(a for a in _names(mesh) if a != "model" and a not in used)


_maybe = spec_entry


def _fits(shape, spec, mesh) -> tuple:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        total = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            total *= sizes[a]
        out.append(entry if dim % total == 0 else None)
    return tuple(out)


def _leaf_name(name: str) -> str:
    """A port parameter's reference leaf name (`embed` is `table`)."""
    return "table" if name == "embed" else name.rsplit(".", 1)[-1]


def param_spec(name, shape, mesh, dist: DistConfig) -> tuple:
    """The spec of one parameter, by its reference leaf name."""
    c = _maybe(chain_axes(mesh, dist.n_chains))
    f = "data" if (dist.fsdp and "data" in dp_axes(mesh, dist.n_chains)) \
        else None
    m = "model"
    leaf, nd = _leaf_name(name), len(shape)
    if leaf == "table":
        spec = (c, None, None) if dist.opt_replicate_embed else (c, m, f)
    elif leaf in ("lm_head", "frontend_proj"):
        spec = (c, f, m)
    elif leaf in ("wq", "wk", "wv", "wz", "wx", "wbc", "wdt"):
        spec = (c, f, m)
    elif leaf in ("w_gate", "w_up"):
        spec = (c, m, f, None) if nd == 4 else (c, f, m)   # moe | mlp
    elif leaf == "w_down":
        spec = (c, m, None, f) if nd == 4 else (c, m, f)
    elif leaf in ("wo", "out_proj"):
        spec = (c, m, f)
    elif leaf in ("bq", "bk", "bv", "conv_b_x", "conv_b_bc", "out_norm",
                  "A_log", "dt_bias"):
        spec = (c, m)
    elif leaf in ("conv_x", "conv_bc"):
        spec = (c, None, m)
    elif leaf == "router":
        spec = (c, None, None)
    else:                       # norms, q_norm/k_norm, small leaves
        spec = (c,) + (None,) * (nd - 1)
    return _fits(shape, spec[:nd], mesh)


def param_specs(params, mesh, dist: DistConfig) -> dict:
    """{parameter name: spec} of a model (or of (name, tensor) pairs)."""
    named = params.named_parameters() if hasattr(params, "named_parameters") \
        else params
    return {n: param_spec(n, tuple(p.shape), mesh, dist) for n, p in named}


def batch_specs(batch: dict, mesh, dist: DistConfig, *,
                replicated_serve=False) -> dict:
    """Batch sharding: train batches split over chains × dp; serve
    batches (`replicated_serve`) shard over dp only and replicate across
    chains."""
    c = _maybe(chain_axes(mesh, dist.n_chains))
    d = _maybe(dp_axes(mesh, dist.n_chains))
    b_axis = None if replicated_serve and c is not None else d
    return {k: _fits(v.shape, ((c, b_axis) + (None,) * (v.ndim - 2))[:v.ndim],
                     mesh)
            for k, v in batch.items()}


def cache_leaf_spec(name, shape, mesh, dist: DistConfig) -> tuple:
    c = _maybe(chain_axes(mesh, dist.n_chains))
    d = _maybe(dp_axes(mesh, dist.n_chains))
    msize = axis_sizes(mesh)["model"]
    if name in ("len", "pos"):
        spec = (c, d)
    elif name in ("k", "v"):                 # [C, b, Hkv, S, hd]
        if shape[2] % msize == 0:
            spec = (c, d, "model", None, None)
        elif shape[3] % msize == 0:
            spec = (c, d, None, "model", None)
        else:
            spec = (c, d, None, None, None)
    elif name == "ssm":                      # [C, b, H, P, N]
        spec = (c, d, "model", None, None)
    elif name in ("conv_x", "conv_bc"):      # [C, b, K-1, ch]
        spec = (c, d, None, "model")
    else:
        spec = (c, d) + (None,) * (len(shape) - 2)
    return _fits(shape, spec[:len(shape)], mesh)


def cache_specs(cache, mesh, dist: DistConfig):
    """KV / SSM cache sharding, a tree of `Transformer.init_cache`'s
    layout: batch over dp; kv heads over `model` when divisible, else the
    cache's sequence dim over `model` (context sharding), else
    replicated.  SSM states shard heads over `model`."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return cache_leaf_spec(name, tuple(node.shape), mesh, dist)
    return walk(cache)


def opt_state_specs(pspecs, mesh=None) -> dict:
    """Optimizer state mirrors the parameters' sharding; the step counter
    replicates."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def layout(mesh, dist: DistConfig) -> Layout:
    """The `Layout` a step hands its model: the chain and data-parallel
    axes of `dist.n_chains` on `mesh` (None: one device, plain tensors)
    and the switches the layers read."""
    kw = dict(head_shard=dist.opt_head_shard, moe_ep=dist.opt_moe_ep,
              causal_skip=dist.opt_causal_attention,
              block_q=dist.opt_attn_block_q,
              probs_bf16=dist.opt_probs_bf16)
    if mesh is None:
        return Layout(**kw)
    return Layout(mesh=mesh, chain=chain_axes(mesh, dist.n_chains),
                  dp=dp_axes(mesh, dist.n_chains), **kw)


def _distribute(t, spec, mesh):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def shard_model(model, mesh, dist: DistConfig):
    """Every parameter of `model` replaced by a DTensor of its spec (each
    device keeps its own shard of the whole tensor it holds; nothing is
    communicated).  Returns the model and its specs."""
    specs = param_specs(model, mesh, dist)
    for name, p in list(model.named_parameters()):
        mod = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        setattr(mod, leaf, torch.nn.Parameter(
            _distribute(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad))
    return model, specs


def shard_tree(tree, specs, mesh):
    """A tree of tensors (dicts and lists) as DTensors of the matching
    tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return _distribute(tree, specs, mesh)
