"""The port's sharding rules (`repro_torch.launch.sharding`) against the
reference's (`repro.launch.sharding`), leaf by leaf, and its cost
counter (`repro_torch.launch.cost`).

The reference's rules read only a mesh's `axis_names` and `axis_sizes`,
so a namespace stands in for its production meshes; its parameter and
cache trees come from `jax.eval_shape` at full width (no memory), the
port's from models on the `meta` device.  A reference leaf is paired
with the port's parameter through `convert._lm_state`; a stacked
(`scan_layers`) leaf's spec loses its leading layer entry, which the
reference always leaves unsharded.
"""
import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (Replicate, Shard,
                                      distribute_tensor)

from repro.configs import ARCHS as J_ARCHS, RUNS, SHAPES as J_SHAPES
from repro.configs import SMOKES as J_SMOKES, input_specs as j_input_specs
from repro.launch import sharding as jsh
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.convert import _lm_state
from repro_torch.launch import sharding as sh
from repro_torch.launch.cost import StepCost
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.layers import Init
from repro_torch.models.transformer import Transformer

SINGLE = types.SimpleNamespace(axis_names=("data", "model"),
                               axis_sizes=(16, 16))
MULTI = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                              axis_sizes=(2, 16, 16))


@pytest.fixture(autouse=True)
def _one_thread_and_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()


def _key(p):
    return p.key if hasattr(p, "key") else p.idx


def _tree(specs, stacked_layers=0):
    """The reference's spec tree with tuples for PartitionSpecs; a
    stacked leaf's spec becomes an object array of its per-layer spec
    (what `_lm_state` indexes)."""
    def conv(path, spec):
        spec = tuple(spec)
        if any(_key(p) == "layers_stacked" for p in path):
            a = np.empty(stacked_layers, dtype=object)
            for i in range(stacked_layers):
                a[i] = spec[1:]
            return a
        return spec
    return jax.tree_util.tree_map_with_path(
        conv, specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                  .PartitionSpec))


@functools.lru_cache(maxsize=None)
def _ref_params_one(cfg):
    return jax.eval_shape(lambda k: j_init_params(k, cfg, 1),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _ref_params(cfg, chains):
    """The reference's parameter shapes at `chains` chains: traced once
    at one chain, then the chain dim (a stacked leaf's second) set, which
    is all that the chain count changes (the rules read only names and
    shapes)."""
    def lead(path, x):
        ax = 1 if any(_key(p) == "layers_stacked" for p in path) else 0
        shape = list(x.shape)
        shape[ax] = chains
        return jax.ShapeDtypeStruct(tuple(shape), x.dtype)
    return jax.tree_util.tree_map_with_path(lead, _ref_params_one(cfg))


@functools.lru_cache(maxsize=None)
def _port_model(cfg, chains):
    return Transformer(cfg, chains, torch.float32, init=Init("meta"))


def _pad(spec, n):
    """The reference's `_fits` keeps a spec's own length: pad to n."""
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_the_reference_at_full_width(name):
    """Every parameter of every arch, on both production meshes, at the
    RUN chain count and at 1 chain, FSDP on and off, with and without
    `opt_replicate_embed`."""
    cfg, run = ARCHS[name], RUNS[name]
    for mesh, chains in ((SINGLE, run["chains_single"]), (SINGLE, 1),
                         (MULTI, run["chains_multi"]), (MULTI, 1)):
        ref = _ref_params(J_ARCHS[name], chains)
        model = _port_model(cfg, chains)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        for fsdp in (False, True):
            for rep in (False, True):
                jd = jsh.DistConfig(n_chains=chains, fsdp=fsdp,
                                    opt_replicate_embed=rep)
                want = _lm_state(_tree(jsh.param_specs(ref, mesh, jd),
                                       cfg.n_layers), cfg)
                got = sh.param_specs(model, mesh, sh.DistConfig(
                    n_chains=chains, fsdp=fsdp, opt_replicate_embed=rep))
                assert set(got) == set(want), name
                for n, spec in got.items():
                    assert spec == _pad(want[n], len(shapes[n])), \
                        (name, n, mesh.axis_sizes, chains, fsdp, rep)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_and_cache_specs_equal_the_reference(name):
    """Each shape cell's batch (train split over chains, serving
    replicated) and the decode cache, on both meshes at RUN and 1
    chain."""
    cfg, run = ARCHS[name], RUNS[name]
    for mesh, chains in ((SINGLE, run["chains_single"]), (SINGLE, 1),
                         (MULTI, run["chains_multi"]), (MULTI, 1)):
        jd = jsh.DistConfig(n_chains=chains)
        d = sh.DistConfig(n_chains=chains)
        for shape in SHAPES:
            serve = SHAPES[shape].kind != "train"
            want = jsh.batch_specs(j_input_specs(J_ARCHS[name],
                                                 J_SHAPES[shape], chains),
                                   mesh, jd, replicated_serve=serve)
            got = sh.batch_specs(input_specs(cfg, SHAPES[shape], chains),
                                 mesh, d, replicated_serve=serve)
            assert got == {k: tuple(v) for k, v in want.items()}, shape
        b, s = 128, 32768
        jcache = jax.eval_shape(lambda: j_init_cache(
            J_ARCHS[name], chains, b, s, jnp.bfloat16))
        jspec = jsh.cache_specs(jcache, mesh, jd)
        model = _port_model(cfg, chains)
        got = sh.cache_specs(model.init_cache(b, s), mesh, d)
        if "layers_stacked" in jspec:
            per = {k: tuple(v)[1:] for k, v in
                   jspec["layers_stacked"].items()}
            want_layers = [per] * cfg.n_layers
        else:
            want_layers = [{k: tuple(v) for k, v in lc.items()}
                           for lc in jspec["layers"]]
        assert got["layers"] == want_layers
        assert got["pos"] == tuple(jspec["pos"])
        if "shared" in jspec:
            assert got["shared"] == [{k: tuple(v) for k, v in lc.items()}
                                     for lc in jspec["shared"]]


# ---- the five assertions of the reference's tests/test_sharding.py

def test_chain_axes_mapping():
    assert sh.chain_axes(SINGLE, 1) == ()
    assert sh.chain_axes(SINGLE, 16) == ("data",)
    assert sh.chain_axes(MULTI, 2) == ("pod",)
    assert sh.chain_axes(MULTI, 32) == ("pod", "data")
    with pytest.raises(ValueError):
        sh.chain_axes(SINGLE, 4)


def test_dp_axes_complement():
    assert sh.dp_axes(SINGLE, 1) == ("data",)
    assert sh.dp_axes(SINGLE, 16) == ()
    assert sh.dp_axes(MULTI, 2) == ("data",)
    assert sh.dp_axes(MULTI, 1) == ("pod", "data")


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_param_specs_cover_the_model_and_divide(name):
    """Every parameter gets a spec whose sharded dims divide evenly, and
    every one carries the chain axis."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 axis_sizes=(4, 4))
    model = _port_model(SMOKES[name], 4)
    specs = sh.param_specs(model, mesh, sh.DistConfig(n_chains=4))
    sizes = sh.axis_sizes(mesh)
    for n, p in model.named_parameters():
        spec = specs[n]
        assert len(spec) <= p.ndim
        for dim, entry in zip(p.shape, spec):
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                assert dim % sizes[a] == 0, (name, n, spec)
        assert spec[0] == "data", (name, n)


def test_batch_specs_train_vs_serve():
    batch = {"tokens": torch.empty((2, 128, 512), dtype=torch.int32,
                                   device="meta")}
    assert sh.batch_specs(batch, MULTI, sh.DistConfig(n_chains=2)) == \
        {"tokens": ("pod", "data", None)}
    assert sh.batch_specs(batch, MULTI, sh.DistConfig(n_chains=2),
                          replicated_serve=True) == \
        {"tokens": ("pod", None, None)}


def test_fsdp_only_when_data_free():
    """FSDP silently disables when chains occupy the data axis."""
    leaf = [("lm_head", torch.empty((16, 64, 64), device="meta"))]
    assert sh.param_specs(leaf, SINGLE, sh.DistConfig(
        n_chains=1, fsdp=True)) == {"lm_head": (None, "data", "model")}
    assert sh.param_specs(leaf, SINGLE, sh.DistConfig(
        n_chains=16, fsdp=True)) == {"lm_head": ("data", None, "model")}


def test_placements_shard_each_named_axis_major_first():
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert sh.placements((("pod", "data"), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert sh.placements((None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        t = torch.arange(32.0).reshape(32, 1)
        d = distribute_tensor(t, mesh, sh.placements((("pod", "data"),
                                                      None), mesh),
                              src_data_rank=None)
        # rank 0 holds row 0: pod major, data minor
        assert d.to_local().tolist() == [[0.0]]


# ---- the cost counter

def _fake_matmul(mesh, spec_a, spec_b, m=64, k=4096, n=4096):
    """The cost of a @ b and of gathering it whole, on fake tensors."""
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(m, k), mesh,
                              sh.placements(spec_a, mesh),
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(k, n), mesh,
                              sh.placements(spec_b, mesh),
                              src_data_rank=None)
        with StepCost() as product:
            out = a @ b
        with StepCost() as gather:
            out.full_tensor()
    return product.cost, gather.cost


def test_a_sharded_matmul_counts_its_shard_of_the_flops():
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cost, _ = _fake_matmul(mesh, ("data", None), (None, "model"))
    assert cost.flops == 2 * 64 * 4096 * 4096 / 256
    assert cost.coll_count == 0


def test_collective_payloads_and_the_pod_boundary():
    """A partial product over `model` all-reduces: 2× its output, within
    a pod; the same over `pod` crosses the pod boundary, over `data`
    not."""
    local = 64 * 4096 * 4
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        _, cost = _fake_matmul(mesh, (None, "model"), ("model", None))
        assert cost.coll_by_kind == {"all-reduce": 2 * local}
        assert cost.coll_count == 1 and cost.coll_cross_pod == 0
        _, cost = _fake_matmul(mesh, (None, "pod"), ("pod", None))
        assert cost.coll_bytes == 2 * local
        assert cost.coll_cross_pod == 2 * local
        _, cost = _fake_matmul(mesh, (None, "data"), ("data", None))
        assert cost.coll_bytes == 2 * local and cost.coll_cross_pod == 0


def test_reference_spec_trees_see_smoke_configs_too():
    """The smoke registries agree on the leaves the rules read."""
    for name in SMOKES:
        ref = _ref_params(J_SMOKES[name], 2)
        want = _lm_state(_tree(jsh.param_specs(
            ref, SINGLE, jsh.DistConfig(n_chains=1)), SMOKES[name].n_layers),
            SMOKES[name])
        model = _port_model(SMOKES[name], 2)
        assert set(dict(model.named_parameters())) == set(want), name


def test_the_counter_counts_in_another_thread():
    """The autograd engine runs a CUDA backward pass in a thread of its
    own, under the same dispatch modes: the counter works there."""
    counter, out = StepCost(), []
    args = (torch.ones(2), torch.ones(2))
    thread = threading.Thread(target=lambda: out.append(
        counter.__torch_dispatch__(torch.ops.aten.add.Tensor,
                                   (torch.Tensor,), args)))
    thread.start()
    thread.join()
    assert out and torch.equal(out[0], torch.full((2,), 2.0))
    assert counter.cost.hbm_bytes == 3 * 2 * 4

