"""The multi-device half on the CPU: sharded steps against plain ones, the
LM dry-run's cells, and `serve_ensemble` against the reference's
example.

Numerics under sharding run in `LocalTensorMode` (every rank of a fake
world simulated in this process, with real values) on two-dimensional
meshes: a 2×2 (data, model) mesh for each smoke arch, qwen3 and mamba2
with 2 chains on `data`, phi3.5-moe's train step with 1 chain, FSDP
over `data`, its experts over `model` and 2 microbatches, and a 1×4 mesh
for `opt_head_shard`.  The smoke configs are cut to one layer; loss,
AdamW update and decode logits match the unsharded ones within 1e-5 (on
the tensor's scale: atol 1e-5 · max(1, max|want|)), gradients are no
farther from the float64 ones than the unsharded float32 gradients are,
plus that 1e-5.  The 2×2×2 (pod, data, model) mesh's placements are
held by the dry-run cells below, not with values: DTensor works out an
elementwise op's placements on a three-dimensional mesh in 0.25-0.6 s
the first time it meets the op (against 0.05 s on two dimensions), so
that one simulated train step takes 11-18 s.
On a (1, 1) host mesh the sharded steps are bit-equal to the plain ones,
as `chip_smoke.py`'s `sharded` phase requires on the card.  The dry-run
cells run on fake tensors in a fake world of 256 or 512 ranks, at smoke
widths, shortened sequences and float32 compute (what the counters see
depends on the placements, not the widths or dtypes): training at the
RUN chain counts puts no collective byte across the pod boundary, the
one-chain baseline does.
"""
import dataclasses
import json
import math
import runpy
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed._local_tensor import (LocalTensor,
                                             LocalTensorMode)
from torch.distributed.device_mesh import init_device_mesh

from repro.launch import sharding as jsh
from repro.models import init_params as j_init_params
from repro_torch import serve_ensemble
from repro_torch.configs import RUNS, SMOKES
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import _lm_state, lm_params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.launch.sharding import (DistConfig, batch_specs,
                                         cache_specs, layout, shard_model,
                                         shard_tree)
from repro_torch.launch.steps import (_grad_of, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import OptConfig, adamw_update, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
DM = ("data", "model")
# arch: (mesh, chains, switches), each arch on one mesh; qwen3 with its
# untied table whole over `model` (the 1×4 case below gathers it)
CASES = {"qwen3-1.7b": ((2, 2), 2, {"opt_replicate_embed": True}),
         "mamba2-1.3b": ((2, 2), 2, {})}


@pytest.fixture(autouse=True)
def _one_thread_and_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _close(got, want, what):
    """|got - want| within TOL on want's scale, on every simulated rank."""

    def most(t):
        t = t.abs().max()
        if isinstance(t, LocalTensor):
            return max(float(x) for x in t._local_tensors.values())
        return float(t)
    d, s = most(_full(got) - want), most(want)
    assert d <= TOL * max(1.0, s), (what, d, s)


def _one_layer(cfg):
    """A smoke config cut to its first layer (the layers repeat)."""
    return dataclasses.replace(cfg, n_layers=1,
                               layer_pattern=cfg.layer_pattern[:1])


def _grads64(cfg, C, batch):
    """The unsharded gradients in float64, the truth both float32 ones
    are held to."""
    model = init_params(cfg, C, device="cpu", seed=0, trainable=True)
    model.double()
    loss = loss_fn(model, batch, compute_dtype=torch.float64,
                   use_kernels=False)
    loss.backward(torch.ones_like(loss))
    return {n: p.grad for n, p in model.named_parameters()}


def _no_farther(got, want, truth, what):
    """A sharded float32 gradient no farther from the float64 one than
    the unsharded float32 gradient is, plus TOL on its scale: sharding
    adds at most 1e-5 to float32's own error (which, for mamba2's smoke
    config, is 2.6e-5 of a gradient's largest element)."""
    got = _full(got)
    bound = (want.double() - truth).abs() + TOL * max(
        1.0, float(truth.abs().max()))
    ok = ((got.double() - truth).abs() <= bound).all()
    if isinstance(ok, LocalTensor):
        ok = all(bool(x) for x in ok._local_tensors.values())
    assert bool(ok), what


def _batch(cfg, C, b=2, s=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (C, b, s), generator=g)
    return {"tokens": tok, "targets": tok.roll(1, -1)}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_steps_match_unsharded(arch):
    """Loss and every gradient of one sharded backward pass (the train
    step's: the loss reduced over the data-parallel axes, each gradient
    in its parameter's placement), the AdamW update of the same
    gradients, and a decode step's logits."""
    shape, C, switches = CASES[arch]
    _compare(arch, shape, DM, C, switches)


def test_head_shard_and_a_context_sharded_cache_match_unsharded():
    """qwen3's 2 kv heads on a `model` axis of 4: `opt_head_shard`
    repeats them to shard q's 4 heads, and the decode cache (its
    sequence dim split over `model`) is gathered for the step."""
    _compare("qwen3-1.7b", (1, 4), DM, 1, {"opt_head_shard": True})


def test_accumulated_fsdp_train_step_matches_unsharded():
    """phi3.5-moe's `make_train_step` at its RUN kind of settings on a
    2×2 mesh: FSDP over `data`, experts over `model`, 2 microbatches
    (each regrouped over `data`, the gradients accumulated as DTensors
    and reduce-scattered to their FSDP shards).  Loss, per-chain
    gradient norm and every updated weight against the plain step's;
    then a decode step's logits."""
    cfg = _one_layer(SMOKES["phi3.5-moe-42b-a6.6b"])
    d = DistConfig(n_chains=1, compute_dtype="float32", remat=False,
                   fsdp=True, opt_moe_ep=True, accum_steps=2)
    opt = OptConfig(warmup_steps=1)
    batch = _batch(cfg, 1, b=4)
    plain, other, fresh, shard_fresh = (
        init_params(cfg, 1, device="cpu", seed=0, trainable=t)
        for t in (True, True, False, False))
    _, _, want = make_train_step(cfg, d, opt)(
        plain, init_opt_state(plain.param_tree(), opt), batch)
    tb = {"tokens": batch["tokens"][:, :, :1]}
    want_logits, _ = make_decode_step(cfg, d)(
        fresh, fresh.init_cache(4, 4, torch.float32), tb)
    with fake_world(4), LocalTensorMode(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=DM)
        model, specs = shard_model(other, mesh, d)
        assert any("data" in s for s in specs.values())      # FSDP
        _, _, got = make_train_step(cfg, d, opt, mesh)(
            model, init_opt_state(model.param_tree(), opt),
            shard_tree(batch, batch_specs(batch, mesh, d), mesh))
        _close(got["loss"], want["loss"], "loss")
        _close(got["grad_norm"], want["grad_norm"], "grad_norm")
        ref = dict(plain.named_parameters())
        for n, p in model.named_parameters():
            _close(p.detach(), ref[n].detach(), "updated " + n)
        model, _ = shard_model(shard_fresh, mesh, d)
        cache = model.init_cache(4, 4, torch.float32)
        cache = shard_tree(cache, cache_specs(cache, mesh, d), mesh)
        logits, _ = make_decode_step(cfg, d, mesh=mesh)(
            model, cache, shard_tree(tb, batch_specs(
                tb, mesh, d, replicated_serve=True), mesh))
        _close(logits, want_logits, "decode")


def _compare(arch, shape, names, C, switches):
    world = math.prod(shape)
    cfg = _one_layer(SMOKES[arch])
    d = DistConfig(n_chains=C, compute_dtype="float32", remat=False,
                   **switches)
    opt = OptConfig(warmup_steps=1)
    batch = _batch(cfg, C)
    # every model is drawn outside LocalTensorMode (inside it, each
    # simulated rank would draw its own weights)
    plain, shard_me = (init_params(cfg, C, device="cpu", seed=0,
                                   trainable=True) for _ in range(2))
    fresh, shard_fresh = (init_params(cfg, C, device="cpu", seed=0)
                          for _ in range(2))
    loss = loss_fn(plain, batch, compute_dtype=torch.float32,
                   use_kernels=False)
    loss.backward(torch.ones_like(loss))
    grads = {n: p.grad.clone() for n, p in plain.named_parameters()}
    # MoE routes in float32 whatever the model's dtype: no float64 twin
    grads64 = None if cfg.is_moe else _grads64(cfg, C, batch)
    want_p = plain.param_tree()
    adamw_update(want_p, _tree_of(plain, grads),
                 init_opt_state(want_p, opt), opt)
    tok = batch["tokens"][:, :, :1]
    want_logits, _ = make_decode_step(cfg, d)(
        fresh, fresh.init_cache(2, 4, torch.float32), {"tokens": tok})
    with fake_world(world), LocalTensorMode(world):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        L = layout(mesh, d)
        model, _ = shard_model(shard_me, mesh, d)
        sb = shard_tree(batch, batch_specs(batch, mesh, d), mesh)
        got = L.put(loss_fn(model, sb, compute_dtype=torch.float32,
                            use_kernels=False, layout=L), L.chain_only(1))
        got.backward(torch.ones_like(got))
        _close(got, loss.detach(), "loss")
        for n, p in model.named_parameters():
            if grads64 is None:
                _close(_grad_of(p), grads[n], n)
            else:
                _no_farther(_grad_of(p), grads[n], grads64[n], n)
        # AdamW on the same gradients, each placed as its parameter
        sgrads = {n: shard_tree(grads[n], _spec_of(p), mesh)
                  for n, p in model.named_parameters()}
        with torch.no_grad():
            params = model.param_tree()
            adamw_update(params, _tree_of(model, sgrads),
                         init_opt_state(params, opt), opt)
        want = dict(plain.named_parameters())
        for n, p in model.named_parameters():
            _close(p.detach(), want[n].detach(), "updated " + n)
        # a decode step of a fresh model from an empty cache
        model, _ = shard_model(shard_fresh, mesh, d)
        cache = model.init_cache(2, 4, torch.float32)
        cache = shard_tree(cache, cache_specs(cache, mesh, d), mesh)
        tb = {"tokens": tok}
        logits, _ = make_decode_step(cfg, d, mesh=mesh)(
            model, cache, shard_tree(tb, batch_specs(
                tb, mesh, d, replicated_serve=True), mesh))
        _close(logits, want_logits, "decode")


def _spec_of(p):
    """A DTensor parameter's placements as a spec."""
    names = p.device_mesh.mesh_dim_names
    spec = [None] * p.ndim
    for axis, pl in zip(names, p.placements):
        if pl.is_shard():
            e = spec[pl.dim]
            spec[pl.dim] = axis if e is None else (
                (e if isinstance(e, tuple) else (e,)) + (axis,))
    return tuple(spec)


def _tree_of(model, by_name):
    from repro_torch.models.transformer import nest
    return nest((n, by_name[n]) for n, _ in model.named_parameters())


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "mamba2-1.3b"))
def test_host_mesh_steps_are_bit_equal_to_plain(arch):
    """World 1, (1, 1): the train step's loss, gradient norm and weights,
    and the decode logits, bit for bit the plain tensors' (the card's
    `sharded` phase, on the CPU)."""
    cfg, C = SMOKES[arch], 2
    d = DistConfig(n_chains=C, compute_dtype="float32", opt_dtype="bfloat16",
                   remat=False)
    opt = OptConfig(warmup_steps=1, opt_dtype="bfloat16")
    batch = _batch(cfg, C)
    plain, other = (init_params(cfg, C, device="cpu", seed=0, trainable=True)
                    for _ in range(2))
    _, _, want = make_train_step(cfg, d, opt)(
        plain, init_opt_state(plain.param_tree(), opt), batch)
    with fake_world(1):
        mesh = make_host_mesh("cpu")
        model, _ = shard_model(other, mesh, d)
        _, _, got = make_train_step(cfg, d, opt, mesh)(
            model, init_opt_state(model.param_tree(), opt),
            shard_tree(batch, batch_specs(batch, mesh, d), mesh))
        assert torch.equal(_full(got["loss"]), want["loss"])
        assert torch.equal(_full(got["grad_norm"]), want["grad_norm"])
        ref = dict(plain.named_parameters())
        for n, p in model.named_parameters():
            assert torch.equal(p.detach().to_local(), ref[n].detach()), n
        tb = {"tokens": batch["tokens"][:, :, :1]}
        cache = plain.init_cache(2, 4, torch.float32)
        want_l, _ = make_decode_step(cfg, d)(plain, cache, tb)
        scache = model.init_cache(2, 4, torch.float32)
        scache = shard_tree(scache, cache_specs(scache, mesh, d), mesh)
        got_l, _ = make_decode_step(cfg, d, mesh=mesh)(
            model, scache, shard_tree(tb, batch_specs(tb, mesh, d), mesh))
        assert torch.equal(_full(got_l), want_l)


# ---- dry-run cells

TRAIN = ShapeSpec("train_4k", 512, 256, "train")
PREFILL = ShapeSpec("prefill_32k", 1024, 32, "prefill")
DECODE = ShapeSpec("decode_32k", 32768, 128, "decode")


def _cell(arch, shape, multi, chains=None):
    """One smoke dry-run cell in float32."""
    return dryrun.run_cell(arch, shape, multi, None, verbose=False,
                           chains_override=chains, smoke=True,
                           dist_overrides={"compute_dtype": "float32"})


def _serving(meta, shape):
    assert meta["n_chains"] == 1 and meta["kind"] == shape.kind
    assert meta["tokens_per_step"] == (
        shape.global_batch if shape.kind == "decode"
        else shape.global_batch * shape.seq_len)


def test_single_pod_cells_of_every_kind():
    """qwen3 on the 16×16 mesh: training at its RUN chains (16, one a
    `data` row), prefill and decode at one chain."""
    meta = _cell("qwen3-1.7b", TRAIN, False)
    assert meta["n_chains"] == RUNS["qwen3-1.7b"]["chains_single"]
    assert meta["n_chips"] == 256 and meta["collective_bytes_cross_pod"] == 0
    assert meta["hlo_flops"] > 0
    for shape in (PREFILL, DECODE):
        meta = _cell("qwen3-1.7b", shape, False)
        _serving(meta, shape)
        bpd = meta["bytes_per_device"]
        assert bpd["peak"] >= bpd["arguments"] > 0
        assert meta["dominant"] in ("compute", "memory", "collective")


def test_training_at_run_chains_puts_no_byte_across_pods():
    """qwen3 at its RUN chains on two pods (32, one a (pod, data) row):
    every collective stays within a chain's devices, none crosses the
    pod boundary; the step's arguments are the bytes of the reference's
    specs."""
    meta = _cell("qwen3-1.7b", TRAIN, True)
    assert meta["n_chains"] == RUNS["qwen3-1.7b"]["chains_multi"]
    assert meta["n_chips"] == 512
    assert meta["collective_bytes_cross_pod"] == 0
    assert meta["hlo_flops"] > 0 and meta["collective_count"] > 0
    assert meta["bytes_per_device"]["arguments"] == _reference_bytes()


def _reference_bytes():
    """qwen3's train cell at 32 chains on the multi-pod mesh, its
    argument bytes by the reference's own specs: each parameter's, its
    two AdamW moments' and the batch's local shard (a dim's size over
    the product of its axes), plus the step counter."""
    cfg = SMOKES["qwen3-1.7b"]
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 axis_sizes=(2, 16, 16))
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    C = RUNS["qwen3-1.7b"]["chains_multi"]
    ref = jax.eval_shape(lambda k: j_init_params(k, cfg_j(), C),
                         jax.ShapeDtypeStruct((2,), np.uint32))
    specs = _lm_state(jsh.param_specs(ref, mesh, jsh.DistConfig(
        n_chains=C)), cfg)
    shapes = _lm_state(jax.tree.map(lambda x: x.shape, ref), cfg)

    def local(shape, spec, itemsize):
        n = itemsize
        for i, dim in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(sizes[a] for a in axes)
        return n
    params = sum(local(shapes[n], tuple(s), 4) for n, s in specs.items())
    tok = jax.ShapeDtypeStruct((C, 256 // C, TRAIN.seq_len), np.int32)
    bspec = jsh.batch_specs({"tokens": tok}, mesh, jsh.DistConfig(
        n_chains=C))["tokens"]
    tokens = local(tok.shape, tuple(bspec), 4)
    return 3 * params + 2 * tokens + 4          # m and v float32; step


def test_the_one_chain_baseline_crosses_pods():
    meta = _cell("qwen3-1.7b", TRAIN, True, 1)
    assert meta["n_chains"] == 1
    assert meta["collective_bytes_cross_pod"] > 0
    assert meta["collective_by_kind"]["all-reduce"] > 0


def test_serving_cells_on_two_pods():
    for shape in (PREFILL, DECODE):
        meta = _cell("qwen3-1.7b", shape, True)
        _serving(meta, shape)
        assert meta["n_chips"] == 512
        assert meta["collective_bytes_cross_pod"] == 0


def cfg_j():
    from repro.configs import SMOKES as J_SMOKES
    return J_SMOKES["qwen3-1.7b"]


def test_cli_writes_the_reference_fields(tmp_path, monkeypatch):
    """`--arch ... --shape decode_32k --mesh host` through the CLI (the
    smoke width), and the artifact's keys; then a prefill cell whose
    `--dist` switches reach the blocked attention twin."""
    monkeypatch.setattr(dryrun, "run_cell", _smoke(dryrun.run_cell))
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                      "--mesh", "host", "--out", str(tmp_path)])
    assert rc == 0
    art = json.loads(
        (tmp_path / "qwen3-1.7b_decode_32k_single.json").read_text())
    for k in ("bytes_per_device", "hlo_flops", "hlo_bytes",
              "collective_bytes", "collective_bytes_cross_pod",
              "collective_count", "collective_by_kind", "t_compute_s",
              "t_memory_s", "t_collective_s", "dominant", "model_flops",
              "tokens_per_step", "real_token_frac", "useful_flop_ratio",
              "trace_s", "n_chips", "n_chains"):
        assert k in art, k
    assert art["n_chips"] == 1 and art["collective_bytes"] == 0
    calls = _record_twins(monkeypatch)
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "prefill_32k",
                      "--mesh", "host", "--out", str(tmp_path),
                      "--dist", "opt_attn_block_q=8192",
                      "--dist", "opt_probs_bf16=true", "--tag", "_b8k"])
    assert rc == 0 and (tmp_path / "qwen3-1.7b_prefill_32k_single_b8k.json"
                        ).exists()
    n = SMOKES["qwen3-1.7b"].n_layers
    assert calls == [("attention_blocked", 8192, True)] * n
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-1.7b", "--dist", "opt_fast=1"])


def _record_twins(monkeypatch):
    """Each attention twin's calls as (name, block_q, probs_bf16)."""
    from repro_torch.kernels import ref
    calls = []
    for name in ("ref_attention", "attention_blocked",
                 "attention_triangular"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("block_q"), k.get("probs_bf16"))),
            _f(*a, **k))[1])
    return calls


def test_the_attention_switches_reach_the_twins_through_dist_config(
        monkeypatch):
    """`DistConfig`'s causal, block and bf16-probability switches, read
    by `launch.sharding.layout` and handed down to the plain route's
    choice of twin, on plain tensors: each prefill within 2e-2 (bf16
    probabilities) of the exact route's logits."""
    cfg, C = SMOKES["qwen3-1.7b"], 2
    model = init_params(cfg, C, device="cpu", seed=0)
    batch = {"tokens": _batch(cfg, C, s=24)["tokens"]}
    calls = _record_twins(monkeypatch)
    exact = make_prefill_step(cfg, DistConfig(
        n_chains=C, compute_dtype="float32"))(model, batch)
    for switches, want in (
            ({"opt_causal_attention": True},
             ("attention_triangular", None, None)),
            ({"opt_attn_block_q": 8}, ("attention_blocked", 8, False)),
            ({"opt_attn_block_q": 16, "opt_probs_bf16": True},
             ("attention_blocked", 16, True))):
        calls.clear()
        got = make_prefill_step(cfg, DistConfig(
            n_chains=C, compute_dtype="float32", **switches))(model, batch)
        assert calls == [want] * cfg.n_layers, switches
        torch.testing.assert_close(got, exact, atol=2e-2, rtol=0)
    assert calls and exact.shape == got.shape


def test_the_optimizer_dtype_has_one_value():
    """`DistConfig.opt_dtype` and `OptConfig.opt_dtype` name one thing:
    a train step refuses two values."""
    cfg = SMOKES["qwen3-1.7b"]
    with pytest.raises(ValueError, match="opt_dtype"):
        make_train_step(cfg, DistConfig(opt_dtype="bfloat16"), OptConfig())
    make_train_step(cfg, DistConfig(opt_dtype="bfloat16"),
                    OptConfig(opt_dtype="bfloat16"))


def _smoke(fn):
    def run(*a, **k):
        return fn(*a, **{**k, "smoke": True})
    return run


# ---- serve_ensemble

def test_serve_ensemble_matches_the_reference_example():
    """The reference's example run as it is (its globals kept), its
    weights carried into the port: Simple, Weighted and the straggler
    cut's log-probabilities within 1e-5, the argmax tokens equal."""
    g = runpy.run_path(str(ROOT / "examples" / "serve_ensemble.py"))
    tree = jax.tree.map(np.asarray, g["params"])
    model = lm_params_from_numpy(tree, serve_ensemble.CFG, device="cpu")
    got = serve_ensemble.serve(model)
    for name, key in (("simple", "logits_s"), ("weighted", "logits_w"),
                      ("cut", "logits_cut")):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(g[key]),
                                   atol=TOL, rtol=TOL)
    assert got["top_full"] == int(g["top_full"])
    assert got["top_cut"] == int(g["top_cut"])
    assert serve_ensemble.main(["--device", "cpu"])["weighted_shape"] == \
        [serve_ensemble.BATCH, 1, serve_ensemble.CFG.vocab_size]
