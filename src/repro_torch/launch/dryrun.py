"""Dry-run reports of the sLDA runtime: what a run would do, before it runs.

The sLDA half of the reference's `launch/dryrun.py`:

    python -m repro_torch.launch.dryrun --slda-plan    [--device cpu] ...
    python -m repro_torch.launch.dryrun --slda-serve   [--device cpu] ...
    python -m repro_torch.launch.dryrun --slda-elastic [--device cpu] ...

print, as JSON, the execution plan of an M-chain run over a synthetic
corpus of the given shape (`slda_plan_report`: schedule, launches, count
refresh, padded against real token work, the sparse draw's expected
occupancy, the supervisor's policy), the prediction service's slot
layout and the plan its one bucket signature runs (`slda_serve_report`),
and the elastic runner's placement, rounds and checkpoint contract
(`slda_elastic_report`, bookkeeping only: nothing is trained).  In place
of the reference's Pallas backend, `backend_resolution` names the port's
route: the CUDA kernels and their variants on the card, their plain
versions on the CPU.  The corpus is drawn by the port's generator (the
reference draws its own); a plan depends only on the lengths and the
config, and a caller may hand in a corpus.

The LM half: every (arch × shape) cell on the production meshes,

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
    python -m repro_torch.launch.dryrun --arch A --shape S --multi-pod \
        --chains 1          # the standard data-parallel baseline
    python -m repro_torch.launch.dryrun --arch A --shape S \
        --dist opt_causal_attention=1 --dist opt_attn_block_q=1024

runs the cell's step once on fake tensors (`FakeTensorMode`) in a fake
world of 256 or 512 ranks (`mesh.fake_world`): parameters, AdamW state,
caches and batches are DTensors placed by `launch.sharding`'s rules at
the arch's RUN settings (serving cells one chain), and `cost.StepCost`
counts one device's matmul FLOPs, bytes, collectives and live memory as
the step runs.  A placement that does not propagate, or a host read in
the step, fails the cell.  `--mesh host` runs it on `make_host_mesh`
instead (one card: (1, 1)).  `--dist FIELD=VALUE` sets a `DistConfig`
field over the RUN settings (a §Perf switch, as the reference's
`dist_overrides`, which `benchmarks/perf_hillclimb.py` passes; the
artifact's name takes `--tag`).  The artifact has the reference's fields,
with these differences: `compile_s` is `trace_s`, the time of the fake
step; `xla_flops_raw`, `xla_bytes_raw`, `unknown_trip_loops` and
`collective_bytes_static` have no counterpart (nothing is compiled, and
loops run, so none is undercounted); `bytes_per_device.output` counts
the step's new storages only (the port updates weights, moments and KV
caches in place, where the reference's step returns them).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.device import resolve_device


def backend_resolution(cfg, dev, max_len: int) -> dict:
    """The route the plan's launches take on `dev`: each sampler kernel's
    variant on a card, the plain versions on the CPU."""
    from repro_torch.kernels import slda_gibbs, slda_predict
    if dev.type != "cuda":
        return {"device": str(dev), "route": "plain",
                "note": "the kernels' plain PyTorch versions (CPU)"}
    sparse = cfg.sampler_mode == "sparse"
    train = ({"B3": "cluster"} if cfg.sweeps_per_launch > 1
             else {"B2": slda_gibbs.variant(cfg.n_topics)})
    return {"device": str(dev), "route": "cuda",
            "kernels": {**train,
                        "B1": slda_predict.variant(cfg.n_topics, sparse,
                                                   max_len),
                        **({"B4": "inside every sparse launch"}
                           if sparse else {})}}


def _corpus(args, dev, n_docs=None):
    from repro_torch.data import make_slda_corpus
    corpus, _ = make_slda_corpus(
        0, n_docs or args.slda_docs, args.slda_vocab, args.slda_topics,
        args.slda_maxlen, phi_concentration=args.slda_phi_conc,
        doc_len_dist="lognormal" if args.slda_len_sigma > 0 else "uniform",
        len_sigma=args.slda_len_sigma or 1.0, device=dev)
    return corpus


def slda_plan_report(args, corpus=None):
    """Print (and return) the execution plans of an M-chain run over a
    corpus of the given shape (`corpus`, when given, in place of the
    synthetic one): the training schedule over the M shards, the
    prediction schedule, why, the sparse draw's expected occupancy, and
    the supervisor's policy."""
    from repro_torch.core import (HealthConfig, RecoveryPolicy, SLDAConfig,
                                  build_plan, build_schedule,
                                  counts_from_assignments, partition)
    from repro_torch.core.types import topic_occupancy

    dev = resolve_device(args.device)
    cfg = SLDAConfig(n_topics=args.slda_topics, vocab_size=args.slda_vocab,
                     length_buckets=args.slda_buckets,
                     sweeps_per_launch=args.slda_spl,
                     sampler_mode=args.slda_sampler,
                     sparse_topic_cap=args.slda_topic_cap)
    corpus = (_corpus(args, dev) if corpus is None else corpus.to(dev))
    m = args.slda_chains
    train_plan = build_plan(build_schedule(partition(corpus, m), cfg), cfg)
    predict_plan = build_plan(build_schedule(corpus, cfg), cfg)
    report = {
        "backend_resolution": backend_resolution(cfg, dev, corpus.max_len),
        "train_plan": train_plan.describe(),
        "predict_plan": predict_plan.describe(),
    }
    d = report["train_plan"]
    route = report["backend_resolution"]["route"]
    why = [f"route={route}: " + (
        "CUDA kernels, one launch a bucket (variants in "
        "backend_resolution)" if route == "cuda" else
        "the kernels' plain PyTorch versions, one call a bucket")]
    if d["buckets"] == 1:
        why.append("1 bucket (length_buckets=0 or uniform lengths) -> the "
                   "padded degenerate schedule; the blocks executor runs "
                   "the padded launches")
    elif train_plan.executor == "stair":
        why.append(f"{d['buckets']} buckets on the CPU route -> STAIR "
                   "executor (per-bucket calls would re-run the token "
                   "loop per bucket; stair keeps the step count at N_max "
                   "while slots collapse to the staircase)")
    else:
        why.append(f"{d['buckets']} buckets -> one launch a bucket "
                   "(the blocks executor; chain batches intact)")
    n_rem = d["remainder_sweeps"]
    why.append(f"spl schedule: {d['launches'] - (1 if n_rem else 0)} "
               f"launches x {d['sweeps_per_launch']} sweeps"
               + (f" + one {n_rem}-sweep remainder launch" if n_rem
                  else "")
               + f" (total sweeps stay exact); {d['count_refresh']}")
    why.append(f"predicted work per chain-sweep: "
               f"{d['slot_tokens_per_sweep']} executed slot-tokens vs "
               f"{d['real_tokens_per_sweep']} real (effective tok/s = "
               f"slot tok/s / {d['slot_vs_effective_tok_ratio']}); the "
               f"padded path would execute "
               f"{d['docs_per_chain'] * d['ctr_stride']} slots")
    # the sparse draw's support: the per-word topic occupancy at a
    # uniform random assignment, the state training starts from
    T = cfg.n_topics
    g = torch.Generator(device=dev).manual_seed(1)
    z0 = torch.randint(0, T, tuple(corpus.tokens.shape), generator=g,
                       device=dev, dtype=torch.int32)
    _, ntw0, _ = counts_from_assignments(corpus.tokens, corpus.mask, z0, T,
                                         cfg.vocab_size)
    occ = topic_occupancy(ntw0.transpose(-1, -2))
    occ_mean = float(occ.float().mean())
    cap = d["sparse_topic_cap"]
    report["estimated_word_topic_occupancy"] = {
        "mean": round(occ_mean, 2), "max": int(occ.max()), "n_topics": T,
        "note": "at uniform init; converged models on peaked corpora sit "
                "far lower"}
    if d["sampler_mode"] == "sparse":
        why.append(
            f"sampler=sparse: two-stage draw over a cap={cap} topic record "
            f"+ residual instead of the dense prefix sum — exact in "
            f"distribution for any occupancy; estimated word-topic "
            f"occupancy {occ_mean:.1f}/{T} at init "
            + ("(<= cap: stage 2 rarely fires)" if occ_mean <= cap
               else "(> cap: residual corrections more frequent until "
                    "counts concentrate)"))
    else:
        why.append(
            f"sampler=dense: exact per-token draw over the {T} topics' "
            f"prefix sum; --slda-sampler sparse pays off when T is large "
            f"and the word-topic occupancy (est. {occ_mean:.1f}/{T} at "
            f"init) stays well under T")
    health, rec = HealthConfig(), RecoveryPolicy(
        max_restarts=args.slda_restarts, min_alive_frac=args.slda_min_alive)
    n_bound = train_plan.n_boundaries()
    checks = [n for n, on in [("nan", health.check_nan),
                              ("counts", health.check_counts),
                              ("mse-z", health.check_mse)] if on]
    report["supervisor"] = {
        "health_checks": checks,
        "em_boundaries": n_bound,
        "mse_z_cut": health.mse_z_cut,
        "mse_warmup_boundaries": health.mse_warmup,
        "max_restarts_per_chain": rec.max_restarts,
        "backoff_base_s": rec.backoff_base,
        "min_alive_frac": rec.min_alive_frac,
    }
    why.append(f"supervisor: health checks [{', '.join(checks)}] at each "
               f"of the {n_bound} EM boundaries (device operations, one "
               f"host read a round); hard faults get up to "
               f"{rec.max_restarts} checkpointed restarts a chain (backoff "
               f"{rec.backoff_base}s base), then quarantine — an exact "
               f"drop; the run aborts below {rec.min_alive_frac:.0%} alive")
    report["why"] = why
    print(json.dumps(report, indent=1))
    return report


def slda_serve_report(args, corpus=None):
    """Print (and return) what the prediction service would run for
    traffic of the given shape (`corpus`, when given, is the traffic
    sample): the calibrated slot layout, its one bucket signature, and
    the plan it dispatches."""
    from repro_torch.core import SLDAConfig, partition, train_chains
    from repro_torch.serving import (STATUS_SHED_QUEUE, ServiceConfig,
                                     SLDAPredictionService)

    dev = resolve_device(args.device)
    cfg = SLDAConfig(n_topics=args.slda_topics, vocab_size=args.slda_vocab,
                     n_iters=1)
    corpus = (_corpus(args, dev) if corpus is None else corpus.to(dev))
    lens = corpus.mask.sum(-1).to("cpu", torch.int64).numpy()
    svc_cfg = ServiceConfig.calibrated(
        lens, max_doc_len=args.slda_maxlen, batch_docs=args.slda_batch_docs,
        n_buckets=args.slda_buckets, max_pending=args.slda_max_pending,
        default_deadline_s=args.slda_deadline_ms / 1e3,
        rate_limit_per_s=args.slda_rate)
    # a one-sweep ensemble is enough: the serving plan depends only on
    # the slot layout, the config and the chain count
    _, models = train_chains(1, partition(corpus, args.slda_chains), cfg,
                             device=dev)
    svc = SLDAPredictionService(models, cfg, svc_cfg, device=dev)
    report = {"backend_resolution": backend_resolution(
        cfg, dev, args.slda_maxlen), "service": svc.describe()}
    d = report["service"]
    frac = [q / args.slda_batch_docs for q in svc_cfg.slot_quota]
    why = [
        f"calibrated ladder {list(svc_cfg.width_ladder)} / quota "
        f"{list(svc_cfg.slot_quota)} from the traffic length sample "
        f"(the cost-model DP of bucket_corpus); slot shares "
        f"{[round(f, 2) for f in frac]}",
        "every micro-batch fills this ONE layout (dummies mask unused "
        "slots), so every dispatch has the single bucket signature "
        f"{d['cache_key_signature']} — one CUDA graph is captured for it "
        "on the card and steady-state traffic captures nothing more",
        f"dispatch = plan.predict over {args.slda_batch_docs} slots x "
        f"M={args.slda_chains} chains, combine={svc_cfg.combine} on the "
        "host; chain weights are host data, so drop / revive of a chain "
        "reweights the combine without a new capture",
    ]
    rb = d["robustness"]
    why.append(
        "admission: "
        + (f"pending queue capped at {rb['max_pending']} docs "
           f"(overflow -> typed '{STATUS_SHED_QUEUE}' Result)"
           if rb["max_pending"] else "pending queue UNBOUNDED "
           "(--slda-max-pending to cap; overload then grows latency, "
           "never sheds)")
        + (f"; token bucket {rb['rate_limit_per_s']}/s burst "
           f"{rb['rate_burst']}" if rb["rate_limit_per_s"] else
           "; no rate limit"))
    why.append(
        "deadlines: "
        + (f"default {1e3 * rb['default_deadline_s']:.0f}ms per request"
           if rb["default_deadline_s"] else "none by default "
           "(per-request via submit(deadline_s=...))")
        + f"; packing is {rb['scheduling']}, expired requests shed "
        "BEFORE occupying a slot")
    why.append(
        "degraded mode: model tables screened at load and reload and "
        "per-chain ŷ screened at dispatch (robust_checks="
        f"{rb['robust_checks']}); a faulty chain is quarantined by its "
        "weight — the survivors' combine is bit-identical to a service "
        "built without the chain; all-dead falls back to the unmasked "
        "combine with a RuntimeWarning")
    why.append(
        "hot reload: reload_from_checkpoint swaps models into the same "
        "buffers (validate manifest -> screen tables -> swap), bumps "
        f"model_epoch (now {rb['model_epoch']}) to invalidate the result "
        "cache by key; torn or mislabelled checkpoints are rejected with "
        "the old epoch still serving")
    report["why"] = why
    print(json.dumps(report, indent=1))
    return report


def slda_elastic_report(args):
    """Print (and return) what the elastic runner would do for an M-chain
    run over the given device pool: the initial placement, the round and
    deadline policy, and the checkpoint contract.  Bookkeeping only."""
    from repro_torch.core import SLDAConfig
    from .elastic import ElasticConfig, compute_placement

    cfg = SLDAConfig(n_topics=args.slda_topics, vocab_size=args.slda_vocab,
                     length_buckets=args.slda_buckets,
                     sweeps_per_launch=args.slda_spl)
    el = ElasticConfig(
        round_iters=args.slda_round_iters,
        async_ckpt=not args.slda_sync_ckpt,
        ckpt_every=args.slda_ckpt_every,
        deadline_s=args.slda_elastic_deadline_s or None,
        straggle_rounds=args.slda_straggle_rounds,
        speculative_replace=args.slda_speculative)
    if cfg.n_iters % el.round_iters:
        raise SystemExit(f"--slda-round-iters {el.round_iters} must "
                         f"divide n_iters {cfg.n_iters}")
    m, ndev = args.slda_chains, args.slda_devices
    n_rounds = cfg.n_iters // el.round_iters
    placement = compute_placement(range(m), range(ndev))
    report = {
        "chains": m,
        "devices": ndev,
        "backend_resolution": {"device": args.device,
                               "note": "the pool is simulated: every "
                                       "chain runs on this one device"},
        "placement": {str(d): list(cs) for d, cs in placement.items()},
        "rounds": {"n_rounds": n_rounds,
                   "round_iters": el.round_iters,
                   "deadline_s": el.deadline_s,
                   "straggle_rounds": el.straggle_rounds,
                   "speculative_replace": el.speculative_replace},
        "checkpointing": {"mode": "async" if el.async_ckpt else "sync",
                          "ckpt_every_rounds": el.ckpt_every,
                          "keep_checkpoints": el.keep_checkpoints,
                          "max_resume_rewind_rounds": el.ckpt_every,
                          "catch_up": el.catch_up},
    }
    why = [
        f"placement: {m} chains balanced over {ndev} devices "
        f"({[len(v) for v in placement.values()]} per device); chains "
        "never communicate, so placement is bookkeeping — the [M]-wide "
        "round plan is built once and a repack after device loss or "
        "join builds none",
        f"rounds: n_iters={cfg.n_iters} split into {n_rounds} EM rounds "
        f"of {el.round_iters} iterations; membership changes, deadline "
        "checks and checkpoints land on round boundaries — inside a "
        "round the schedule is the single run's, so each chain's draws "
        "are those of a fresh run on the surviving layout",
        "deadlines: "
        + (f"round deadline {el.deadline_s}s on the virtual clock; a "
           f"device that misses it has its chains flagged F_STRAGGLER "
           f"(latched in the status word), and {el.straggle_rounds} "
           "consecutive misses evict the device from the pool"
           if el.deadline_s else
           "no round deadline (--slda-elastic-deadline-s to set one; "
           "stragglers then only stretch the round)")
        + ("; speculative_replace ON — a flagged device's chains move "
           "to the least-loaded on-time device at the next boundary, "
           "state untouched" if el.speculative_replace else ""),
        f"checkpointing: {'asynchronous' if el.async_ckpt else 'synchronous'}"
        f" writer every {el.ckpt_every} round(s), keep last "
        f"{el.keep_checkpoints}; a new snapshot is not accepted until "
        "the previous one is durable, so resume after a preemption or "
        f"crash rewinds at most {el.ckpt_every} round(s); SIGTERM drains "
        "with one final synchronous save",
        "recovery: device loss restores victims from the newest durable "
        "step (the write in flight flushed first, so all victims see the "
        "same step)"
        + (" and replays them to the surviving chains' round — a chain's "
           "round draws come from (seed, chain, epoch, round), so the "
           "replay is bit for bit the original"
           if el.catch_up else "; catch_up OFF — victims ship stale "
           "state instead of replaying"),
    ]
    report["why"] = why
    print(json.dumps(report, indent=1))
    return report


# ------------------------------------------------------------- LM cells

POD_SIZE = 256


@dataclasses.dataclass
class Cell:
    """One built dry-run cell: `run()` runs its step once; `args` are the
    step's arguments (for their bytes)."""
    run: object
    args: tuple
    meta: dict


def _shape(shape):
    from repro_torch.configs.shapes import SHAPES
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_dist(arch, shape, multi_pod, chains_override=None,
              dist_overrides=None, *, mesh_kind="production"):
    """The cell's `DistConfig` at the arch's RUN settings: training
    chains per mesh, one chain to serve, unless overridden."""
    from repro_torch.configs import RUNS
    from .sharding import DistConfig
    run, shape = RUNS[arch], _shape(shape)
    if chains_override is not None:
        n_chains = chains_override
    elif shape.kind == "train" and mesh_kind == "production":
        n_chains = run["chains_multi" if multi_pod else "chains_single"]
    else:
        n_chains = 1
    fields = dict(
        n_chains=n_chains, fsdp=run["fsdp"],
        accum_steps=run["accum_steps"] if shape.kind == "train" else 1,
        param_dtype=run["param_dtype"], opt_dtype=run["opt_dtype"],
        use_kernels=False)
    return DistConfig(**{**fields, **(dist_overrides or {})})


def build_cell(arch, shape, multi_pod=False, chains_override=None,
               dist_overrides=None, *, mesh, cfg=None, device="cpu",
               seed=None) -> Cell:
    """Builds one cell on `mesh` inside a world that covers it (and, for
    a dry-run, inside `FakeTensorMode`: every tensor is then fake).
    `shape` is a name of `SHAPES` or a `ShapeSpec`; `cfg` replaces the
    arch's config (a smoke config); `seed` draws real weights and tokens
    (None leaves them empty, as a dry-run needs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import input_specs
    from repro_torch.models import init_params
    from repro_torch.models.layers import Init
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import OptConfig, init_opt_state
    from .sharding import (batch_specs, cache_specs, shard_model,
                           shard_tree)
    from .steps import (DTYPES, make_decode_step, make_prefill_step,
                        make_train_step)
    cfg = cfg or ARCHS[arch]
    shape = _shape(shape)
    dist = cell_dist(arch, shape, multi_pod, chains_override, dist_overrides,
                     mesh_kind="production" if mesh.ndim == 3 or
                     mesh.size() >= POD_SIZE else "host")
    C, dev, train = dist.n_chains, torch.device(device), shape.kind == "train"
    pdt = DTYPES[dist.param_dtype]
    if seed is None:
        model = Transformer(cfg, C, pdt, init=Init(dev, trainable=train))
    else:
        model = init_params(cfg, C, pdt, device=dev, trainable=train,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
    model, _ = shard_model(model, mesh, dist)

    def draw(t):
        if seed is None:
            return torch.empty(t.shape, dtype=t.dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                                 device=dev, generator=g)
        return torch.randn(t.shape, dtype=t.dtype, device=dev, generator=g)
    batch = {k: draw(t) for k, t in input_specs(cfg, shape, C).items()}
    batch = shard_tree(batch, batch_specs(batch, mesh, dist,
                                          replicated_serve=not train), mesh)
    if train:
        opt = OptConfig(opt_dtype=dist.opt_dtype)
        state = init_opt_state(model.param_tree(), opt)
        step = make_train_step(cfg, dist, opt, mesh)
        args = (model, state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, dist, mesh)
        args = (model, batch)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 torch.bfloat16)
        cache = shard_tree(cache, cache_specs(cache, mesh, dist), mesh)
        step = make_decode_step(cfg, dist, "none", mesh)
        args = (model, cache, batch)
    meta = dict(arch=arch, shape=shape.name, kind=shape.kind,
                multi_pod=multi_pod, n_chips=mesh.size(), n_chains=C,
                mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                fsdp=dist.fsdp, accum=dist.accum_steps,
                param_dtype=dist.param_dtype, opt_dtype=dist.opt_dtype,
                compute_dtype=dist.compute_dtype,
                seq_len=shape.seq_len, global_batch=shape.global_batch,
                params=cfg.param_count(),
                active_params=cfg.active_param_count())
    return Cell(run=lambda: step(*args), args=args, meta=meta)


def arg_tensors(args):
    """The tensors of a step's arguments (a model's parameters, the
    leaves of trees)."""
    from repro_torch.tree import leaves_with_paths
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out += list(a.parameters())
        else:
            out += [t for _, t in leaves_with_paths(a)
                    if isinstance(t, torch.Tensor)]
    return out


def analyze(cell: Cell, *, pod_size=POD_SIZE, verbose=False) -> dict:
    """Runs the cell's step once under `cost.StepCost` and returns its
    meta with the reference's artifact fields (see the module's
    docstring)."""
    from .cost import StepCost, local_bytes, roofline_terms
    meta = dict(cell.meta)
    argv = arg_tensors(cell.args)
    arguments = local_bytes(argv)
    counter = StepCost(pod_size=pod_size, arguments=argv)
    t0 = time.time()
    with counter:
        out = cell.run()
    meta["trace_s"] = round(time.time() - t0, 1)
    cost = counter.cost
    # the outputs' storages that are not the arguments' (each counted once)
    output = local_bytes(argv + arg_tensors([out])) - arguments
    meta["bytes_per_device"] = {"arguments": arguments, "output": output,
                                "temp": cost.peak_bytes,
                                "peak": arguments + cost.peak_bytes}
    meta["hlo_flops"] = cost.flops
    meta["hlo_bytes"] = cost.hbm_bytes
    meta["collective_bytes"] = cost.coll_bytes
    meta["collective_bytes_cross_pod"] = cost.coll_cross_pod
    meta["collective_count"] = cost.coll_count
    meta["collective_by_kind"] = {k: float(v)
                                  for k, v in cost.coll_by_kind.items()}
    meta.update(roofline_terms(cost.flops, cost.hbm_bytes, cost.coll_bytes,
                               meta["n_chips"]))
    seq, gb = meta["seq_len"], meta["global_batch"]
    toks = gb if meta["kind"] == "decode" else gb * seq
    mult = 6 if meta["kind"] == "train" else 2
    meta["model_flops"] = mult * meta["active_params"] * toks
    meta["tokens_per_step"] = toks
    meta["real_token_frac"] = 1.0       # LM batches here are dense
    whole = cost.flops * meta["n_chips"]
    meta["useful_flop_ratio"] = meta["model_flops"] / whole if whole else 0.0
    if verbose:
        print(json.dumps({k: v for k, v in meta.items()
                          if k != "collective_by_kind"}, indent=1))
    return meta


def run_cell(arch, shape, multi_pod, out_dir=None, verbose=True,
             chains_override=None, tag_suffix="", dist_overrides=None, *,
             mesh_kind="production", smoke=False):
    """One cell's dry-run on fake tensors in a fake world (production:
    256 or 512 ranks; host: 1), its artifact written under `out_dir`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import SMOKES
    from .mesh import fake_world, make_host_mesh, make_production_mesh
    n = 1 if mesh_kind == "host" else (512 if multi_pod else 256)
    with fake_world(n):
        mesh = (make_host_mesh("cpu") if mesh_kind == "host" else
                make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        with FakeTensorMode():
            cell = build_cell(arch, shape, multi_pod, chains_override,
                              dist_overrides, mesh=mesh,
                              cfg=SMOKES[arch] if smoke else None)
            meta = analyze(cell, verbose=verbose)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = shape if isinstance(shape, str) else shape.name
        tag = (f"{arch}_{name}_{'multi' if multi_pod else 'single'}"
               f"{tag_suffix}")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(meta, f, indent=1)
    return meta


def dist_overrides(pairs) -> dict:
    """`FIELD=VALUE` strings as `DistConfig` fields, each value read as
    its field's type (a bool from 0/1/true/false)."""
    from .sharding import DistConfig
    types = {f.name: type(f.default) for f in dataclasses.fields(DistConfig)}
    out = {}
    for pair in pairs or ():
        name, sep, value = pair.partition("=")
        if not sep or name not in types:
            raise ValueError(f"--dist {pair!r}: not FIELD=VALUE of a "
                             f"DistConfig field")
        kind = types[name]
        if kind is bool:
            if value.lower() not in ("0", "1", "true", "false"):
                raise ValueError(f"--dist {pair!r}: not a bool")
            out[name] = value.lower() in ("1", "true")
        else:
            out[name] = kind(value)
    return out


def lm_main(args, ap):
    """The LM half's CLI: each (arch × shape × mesh) cell in turn,
    reported and continued past a failure; exits 1 if any failed."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import cells_for
    if args.all:
        archs = sorted(ARCHS)
    elif args.arch:
        archs = [args.arch]
    else:
        ap.error("--arch or --all required (or an --slda-* report)")
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    if args.mesh == "host":
        meshes = [False]
    try:
        overrides = dist_overrides(args.dist)
    except ValueError as e:
        ap.error(str(e))
    failures = []
    for arch in archs:
        shapes = [args.shape] if args.shape else cells_for(ARCHS[arch])
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} × {shape} × " + (
                    "host" if args.mesh == "host" else
                    "2-pod" if mp else "1-pod")
                try:
                    t0 = time.time()
                    run_cell(arch, shape, mp, args.out, verbose=False,
                             chains_override=args.chains,
                             tag_suffix=args.tag, mesh_kind=args.mesh,
                             dist_overrides=overrides)
                    print(f"PASS {tag}  ({time.time() - t0:.0f}s)",
                          flush=True)
                except Exception as e:  # noqa: BLE001 (report, go on)
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\n{len(failures)} failures")
    for tag, err in failures:
        print(" ", tag, err)
    return 1 if failures else 0


def parser() -> argparse.ArgumentParser:
    """The reference's LM and `--slda-*` options, `--mesh` and
    `--device`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--chains", type=int, default=None,
                    help="override the chain count (1 on the multi-pod "
                         "mesh: the standard data-parallel baseline)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--dist", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="set a DistConfig field (a §Perf switch) over "
                         "the RUN settings; repeatable")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--mesh", choices=("production", "host"),
                    default="production",
                    help="host: make_host_mesh, one rank (1, 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--slda-plan", action="store_true",
                    help="print the sLDA ExecutionPlan for the given "
                         "corpus shape and exit")
    ap.add_argument("--slda-serve", action="store_true",
                    help="print the prediction service's slot layout and "
                         "dispatched plan for the given traffic shape")
    ap.add_argument("--slda-elastic", action="store_true",
                    help="print the elastic runner's chain placement, "
                         "round policy and checkpoint contract")
    ap.add_argument("--slda-devices", type=int, default=4,
                    help="--slda-elastic: size of the initial device pool")
    ap.add_argument("--slda-round-iters", type=int, default=2,
                    help="--slda-elastic: EM iterations a round (must "
                         "divide n_iters)")
    ap.add_argument("--slda-ckpt-every", type=int, default=1,
                    help="--slda-elastic: checkpoint cadence in rounds "
                         "(the resume-rewind bound)")
    ap.add_argument("--slda-sync-ckpt", action="store_true",
                    help="--slda-elastic: synchronous checkpoint writes")
    ap.add_argument("--slda-elastic-deadline-s", type=float, default=0.0,
                    help="--slda-elastic: round deadline on the virtual "
                         "clock (0 = none)")
    ap.add_argument("--slda-straggle-rounds", type=int, default=2,
                    help="--slda-elastic: consecutive deadline misses "
                         "before a device is evicted")
    ap.add_argument("--slda-speculative", action="store_true",
                    help="--slda-elastic: move a flagged device's chains "
                         "to the least-loaded on-time device")
    ap.add_argument("--slda-batch-docs", type=int, default=32,
                    help="--slda-serve: slots per micro-batch")
    ap.add_argument("--slda-max-pending", type=int, default=128,
                    help="--slda-serve: pending-queue bound (0 = "
                         "unbounded)")
    ap.add_argument("--slda-deadline-ms", type=float, default=0.0,
                    help="--slda-serve: default per-request deadline "
                         "(0 = none)")
    ap.add_argument("--slda-rate", type=float, default=0.0,
                    help="--slda-serve: token-bucket admission rate in "
                         "docs/s (0 = no limit)")
    ap.add_argument("--slda-docs", type=int, default=512)
    ap.add_argument("--slda-maxlen", type=int, default=256)
    ap.add_argument("--slda-chains", type=int, default=8)
    ap.add_argument("--slda-buckets", type=int, default=8)
    ap.add_argument("--slda-spl", type=int, default=8)
    ap.add_argument("--slda-vocab", type=int, default=1000)
    ap.add_argument("--slda-topics", type=int, default=32)
    ap.add_argument("--slda-len-sigma", type=float, default=1.0)
    ap.add_argument("--slda-sampler", choices=("dense", "sparse"),
                    default="dense",
                    help="per-token draw: dense, or the sparse two-stage "
                         "draw over the per-word topic record")
    ap.add_argument("--slda-topic-cap", type=int, default=32,
                    help="sparse-draw record capacity (clamped to T)")
    ap.add_argument("--slda-phi-conc", type=float, default=1.0,
                    help="synthetic-corpus topic concentration (<1 = "
                         "peaked φ = low word-topic occupancy)")
    ap.add_argument("--slda-restarts", type=int, default=2,
                    help="supervisor restart budget per chain")
    ap.add_argument("--slda-min-alive", type=float, default=0.25,
                    help="abort threshold on the alive chain fraction")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.slda_plan:
        return slda_plan_report(args)
    if args.slda_serve:
        return slda_serve_report(args)
    if args.slda_elastic:
        return slda_elastic_report(args)
    return lm_main(args, ap)


if __name__ == "__main__":
    rc = main()
    raise SystemExit(rc if isinstance(rc, int) else 0)
