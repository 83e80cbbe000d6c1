"""Multi-GPU sLDA chain runner: one process per GPU under torch.distributed.

The port of the reference's `launch/slda_parallel.py`.  Each rank owns
`chains_per_device` chains and their training shards, so the paper's M
is decoupled from the number of processes: M = world × chains_per_device,
and rank r runs the global chains r·cpd .. r·cpd + cpd − 1 as one chain
batch through the chain-batched entry points (`train_chains_keyed`,
`predict_chains_keyed`: on the card one B2 or B3 launch an EM boundary
and one B1 launch for all the rank's chains, B4 inside each sparse one).

Every chain draws from generators seeded by its GLOBAL id (`core.rng`),
so a chain's numbers do not depend on the rank it runs in or on how many
chains share its launches: the gathered predictions are those of one
process running all M chains with the same seed.

The training phase contains no collective: the chain batch is
rank-local.  The reference proves this on the compiled HLO; the port
counts at run time (`launch.collectives.count_collectives`, around the
training phase and around everything after it, both in the report).  The
only communication of the algorithm is one gather of each rank's
predictions and training statistics, the paper's combination stage
(Eq. 6), after which every rank combines the same [M, D_test] rows.

    torchrun --nproc-per-node=N -m repro_torch.launch.slda_parallel \
        [--chains-per-device 1] [--rule simple] [--sweeps-per-launch 1] \
        [--sampler-mode dense] [--length-buckets 0] [--seed 0]

runs the MD&A slice (`repro_torch.fig6_mdna`) with N × cpd chains, one
card a process, and prints ŷ's test MSE on rank 0 (`--device cpu` runs
the ranks on the CPU under gloo).  `run_ranks` starts the ranks on one
host from Python (spawned processes, a `file://` rendezvous), as the
tests and `chip_smoke.py` do.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import combine, rng
from repro_torch.core.parallel import (_no_timer, predict_chains_keyed,
                                       train_chains_keyed)
from repro_torch.core.plan import as_bucketed, build_schedule
from repro_torch.core.types import Corpus, SLDAConfig, partition
from repro_torch.device import resolve_device
from repro_torch.timing import PhaseTimer

from .collectives import count_collectives

#: seconds a rendezvous or a collective may wait before the group fails
GROUP_TIMEOUT_S = 300.0


# ---------------------------------------------------------------- set-up

def rank_device(device=None) -> torch.device:
    """The rank's device: `device` when given, else `cuda:{LOCAL_RANK}`
    (torchrun's variable; 0 without it).  Raises without a card."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def init_group(backend: str, rank: int, world: int, init_method: str,
               timeout_s: float = GROUP_TIMEOUT_S):
    """`torch.distributed.init_process_group` with a timeout, so that a
    rendezvous that never completes fails instead of hanging."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


# ------------------------------------------------------------ the phases

def rank_shards(train: Corpus, m: int, lo: int, hi: int, cfg: SLDAConfig,
                dev):
    """Chains lo..hi-1 of the M-shard training schedule, on `dev`.  With
    length buckets the schedule is built over ALL M shards and the
    rank's chains taken from it: the bucket cuts are shared by the
    chains, and at sweeps_per_launch > 1 a bucket is the delayed-count
    block, so a rank must cut where the whole ensemble cuts."""
    shards = partition(train.to(dev), m)
    if cfg.length_buckets > 0:
        return build_schedule(shards, cfg).chain_slice(lo, hi)
    return as_bucketed(shards.map(lambda x: x[lo:hi]))


@dataclasses.dataclass
class RankDraws:
    """The random draws of a rank's chains, by global chain id:

      train    train(ids, n_docs, max_len) → (z_init [cpd, D, max_len],
               an iterable of the EM loop's draws), as `rng.train_draws`;
      predict  predict(ids, n_docs, max_len) → (z0 [cpd, D, max_len],
               seeds [cpd, D]), as `rng.predict_draws`.

    `seeded_rank_draws` gives a seeded run's; tests hand in the
    reference's."""

    train: Callable
    predict: Callable


def seeded_rank_draws(seed: int, cfg: SLDAConfig, dev) -> RankDraws:
    """Chain c trains from generators (seed, TRAIN, c) and predicts from
    (seed, PREDICT, c): the draws `core.parallel.train_chains` and
    `predict_chains` give chain c of a run of all M chains."""
    def train(ids, n_docs, max_len):
        return rng.train_draws(
            rng.chain_generators(seed, ids, dev, rng.TRAIN), n_docs,
            max_len, cfg.n_topics, cfg.n_iters, cfg.sweeps_per_launch)

    def predict(ids, n_docs, max_len):
        return rng.predict_draws(
            rng.chain_generators(seed, ids, dev, rng.PREDICT), n_docs,
            max_len, cfg.n_topics)
    return RankDraws(train=train, predict=predict)


def gather_rows(rows: torch.Tensor) -> torch.Tensor:
    """Every rank's [cpd, K] rows → [world·cpd, K] on every rank, rank 0's
    first: one gather into one tensor (`all_gather_single`, or
    `all_gather_into_tensor` where torch has no such name).  Under gloo a
    CUDA tensor goes through the host (gloo gathers host tensors)."""
    world = dist.get_world_size()
    src = rows.contiguous()
    if dist.get_backend() == "gloo" and src.is_cuda:
        src = src.cpu()
    out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src)
    return out.to(rows.device)


def _kernel_launches() -> dict:
    """B1–B3's launch counters in this process (launches, sparse ones)."""
    from repro_torch.kernels import slda_gibbs, slda_predict, slda_train
    mods = {"B1": slda_predict, "B2": slda_gibbs, "B3": slda_train}
    return {k: (m.launches, m.sparse_launches) for k, m in mods.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------ the runner

def parallel_slda(seed, train: Corpus, test: Corpus, cfg: SLDAConfig,
                  *, rule: str = "simple", chains_per_device=None,
                  alive=None, auto_quarantine: bool = True,
                  return_report: bool = False, device=None,
                  draws: RankDraws | None = None, fault_hook=None,
                  timer=_no_timer):
    """Run M = world × chains_per_device chains, a chain batch a rank of
    the initialised (default) process group, then combine the gathered
    predictions.  Returns ŷ [D_test] on every rank.

    chains_per_device None reads `cfg.chains_per_device`.  `seed` names
    the run (`seeded_rank_draws`): chain c trains from (seed, TRAIN, c)
    and predicts from (seed, PREDICT, c), the draws
    `core.parallel.train_chains` and `predict_chains` give chain c of an
    M-chain run; or `draws` are handed in (`seed` None).  cfg.length_buckets
    > 0 runs every chain phase over the schedule built over all M shards
    (`rank_shards`) and over the bucketed test corpus.

    The gather carries each chain's test predictions and its training
    statistics (`SLDAModel.train_mse`, `train_acc`), as the reference's
    two `all_gather`s do.  Weighted Average weighs by those training-phase
    statistics, as the reference's runner does: unlike
    `core.parallel.run_weighted_average`, it does not predict the
    training set again.

    Fault tolerance: `alive` [M] masks chains out of the combine, exact
    because chains never communicate.  With `alive` None and
    `auto_quarantine`, a chain whose gathered predictions or statistics
    are not finite is quarantined.  `fault_hook(models, ids) -> models`,
    when given, is applied to the rank's trained models (global chain
    ids `ids`) before prediction: where faults are injected.  `timer`,
    when given, is entered as `timer(phase)` around "train", "predict"
    and "gather".

    `device` None is `cuda:{LOCAL_RANK}`.  Under gloo the gathered rows go
    through the host.  `return_report=True` also returns a dict: "alive",
    "n_quarantined", the gathered "yhat_chains" [M, D_test] and
    "train_stats" [M, 2], this rank's "chain_ids", "collectives"
    ("train": the training phase's `CollectiveStats`, "after_train":
    prediction, gather and combine), "ms" (CUDA events on the card, the
    host clock on the CPU: "train", "predict", "gather", and
    "gather_host", the gather alone on the host's clock between two
    synchronisations), this process's B1–B3 "launches" (launches, sparse
    launches) during the call, "backend", "world", "rank"."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cpd = cfg.chains_per_device if chains_per_device is None \
        else chains_per_device
    m = world * cpd
    lo, hi = rank * cpd, (rank + 1) * cpd
    ids = list(range(lo, hi))
    dev = rank_device(device)
    if (seed is None) == (draws is None):
        raise ValueError("pass exactly one of seed / draws")
    if draws is None:
        draws = seeded_rank_draws(seed, cfg, dev)
    phases = PhaseTimer(dev)
    launches0 = _kernel_launches()
    with count_collectives() as train_coll:
        with phases("train"), timer("train"):
            shards = rank_shards(train, m, lo, hi, cfg, dev)
            z_init, em = draws.train(ids, shards.n_docs, shards.max_len)
            _, models = train_chains_keyed(z_init, em, shards, cfg)
    if fault_hook is not None:
        models = fault_hook(models, ids)
    with count_collectives() as after_coll:
        with phases("predict"), timer("predict"):
            test_b = build_schedule(test.to(dev), cfg)
            z0, seeds = draws.predict(ids, test_b.n_docs, test_b.max_len)
            yhat = predict_chains_keyed(z0, seeds, models, test_b, cfg)
        rows = torch.cat([yhat, torch.stack(
            [models.train_mse, models.train_acc], -1)], -1)
        _sync(dev)
        t0 = time.perf_counter()
        with phases("gather"), timer("gather"):
            rows_all = gather_rows(rows)                  # [M, D_test + 2]
        _sync(dev)
        gather_host_ms = (time.perf_counter() - t0) * 1e3
        yhat_all, stats_all = rows_all[:, :-2], rows_all[:, -2:]
        if alive is None and auto_quarantine:
            alive = (torch.isfinite(yhat_all).all(-1)
                     & torch.isfinite(stats_all).all(-1)).to(torch.float32)
        if rule == "simple":
            out = combine.simple_average(yhat_all, alive=alive)
        elif rule == "weighted":
            if cfg.label_type == "binary":
                out = combine.weighted_average(
                    yhat_all, train_acc=stats_all[:, 1], alive=alive)
            else:
                out = combine.weighted_average(
                    yhat_all, train_mse=stats_all[:, 0], alive=alive)
        elif rule == "median":
            out = combine.median(yhat_all, alive=alive)
        else:
            raise ValueError(rule)
    if not return_report:
        return out
    a = None if alive is None else torch.as_tensor(alive)
    launches1 = _kernel_launches()
    report = {
        "alive": a,
        "n_quarantined": 0 if a is None else int(m - float(a.sum())),
        "yhat_chains": yhat_all, "train_stats": stats_all,
        "chain_ids": ids,
        "collectives": {"train": train_coll, "after_train": after_coll},
        "ms": {**phases.ms(), "gather_host": gather_host_ms},
        "launches": {k: (launches1[k][0] - launches0[k][0],
                         launches1[k][1] - launches0[k][1])
                     for k in launches1},
        "backend": dist.get_backend(), "world": world, "rank": rank}
    return out, report


# ------------------------------------------- ranks on one host, by spawn

def rank_runs(rank: int, world: int, *, seed: int, train: Corpus,
              test: Corpus, runs, device=None) -> list:
    """The calls of `parallel_slda` a rank makes for `run_ranks`, one a
    run, in order; each run a dict of `parallel_slda` keywords (`cfg`,
    `rule`, `chains_per_device`, ...) with, optionally, `"poison": (chain,
    kind)`, a `testing.poison_model_table` fault on that global chain's
    model after training, and `"train"` / `"test"` corpora in place of
    the shared ones.  Returns, a run, host copies of ŷ and of the report
    (its tensors as numpy arrays, its counters as dicts)."""
    from repro_torch.testing import poison_model_table
    out = []
    for run in runs:
        kw = dict(run)
        cfg = kw.pop("cfg")
        run_train, run_test = kw.pop("train", train), kw.pop("test", test)
        poisoned = kw.pop("poison", None)
        if poisoned is not None:
            chain, kind = poisoned

            def hook(models, ids, chain=chain, kind=kind):
                if chain not in ids:
                    return models
                return poison_model_table(models, ids.index(chain), kind)
            kw["fault_hook"] = hook
        yhat, rep = parallel_slda(seed, run_train, run_test, cfg,
                                  device=device, return_report=True, **kw)
        rep = dict(rep)
        for k in ("alive", "yhat_chains", "train_stats"):
            if rep[k] is not None:
                rep[k] = rep[k].cpu().numpy()
        rep["collectives"] = {k: v.as_dict()
                              for k, v in rep["collectives"].items()}
        out.append({"yhat": yhat.cpu().numpy(), "report": rep})
    return out


def _rank_main(rank, world, init_method, timeout_s, fn, kwargs, results,
               t_spawn, threads):
    """A spawned rank: join the group, run `fn(rank, world, **kwargs)`,
    put (rank, result, start-up seconds) or (rank, error) on `results`,
    leave the group.  A failure exits nonzero after reporting."""
    try:
        torch.set_num_threads(threads)
        init_group("gloo", rank, world, init_method, timeout_s)
        startup_s = time.time() - t_spawn
        try:
            res = fn(rank, world, **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", res, startup_s))
    except BaseException:
        results.put((rank, "error", traceback.format_exc(), None))
        raise


def run_ranks(world: int, fn, kwargs: dict, *,
              timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Run `fn(rank, world, **kwargs)` in `world` processes on this host,
    started by the `spawn` method (never `fork`: the parent may hold a
    CUDA context), in one gloo process group (the ranks may share a card,
    which NCCL refuses) joined by a `file://` rendezvous under a
    temporary directory.  `fn` must be a
    module-level function and `kwargs` picklable.  Each rank runs with
    this process's intra-op thread count.  Returns, rank by rank,
    (result, start-up seconds: from the spawn to the joined group).
    Raises if a rank raises, exits nonzero, or the whole takes longer
    than `timeout_s`; every process is ended before it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="rendezvous_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        t_spawn = time.time()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, init_method, timeout_s, fn, kwargs, results, t_spawn,
            torch.get_num_threads())) for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            while len(got) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {world - len(got)} of {world} ranks "
                        f"did not finish within {timeout_s} s")
                try:
                    rank, status, res, startup = results.get(
                        timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        # a rank died without reporting (killed)
                        raise RuntimeError(
                            f"run_ranks: rank process exited with "
                            f"{[p.exitcode for p in dead]}")
                    continue
                if status == "ok":
                    got[rank] = (res, startup)
                else:
                    errors.append((rank, res))
            if errors:
                raise RuntimeError("run_ranks: rank(s) failed:\n" + "\n".join(
                    f"rank {r}:\n{tb}" for r, tb in errors))
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            codes = [p.exitcode for p in procs]
            if codes != [0] * world:
                raise RuntimeError(f"run_ranks: exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------- torchrun

def main(argv=None):
    """The torchrun entry: the MD&A slice over the ranks of the job."""
    from repro_torch import fig6_mdna
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chains-per-device", type=int, default=1)
    ap.add_argument("--rule", default="simple",
                    choices=("simple", "weighted", "median"))
    ap.add_argument("--sweeps-per-launch", type=int, default=1)
    ap.add_argument("--sampler-mode", default="dense",
                    choices=("dense", "sparse"))
    ap.add_argument("--length-buckets", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu for CPU ranks under gloo; default "
                         "cuda:{LOCAL_RANK} under nccl")
    args = ap.parse_args(argv)
    dev = rank_device(args.device)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    init_group("nccl" if dev.type == "cuda" else "gloo", rank, world,
               "env://")
    try:
        cfg = dataclasses.replace(
            fig6_mdna.CFG, sweeps_per_launch=args.sweeps_per_launch,
            sampler_mode=args.sampler_mode,
            length_buckets=args.length_buckets)
        train, test = fig6_mdna.make_data(args.seed, dev)
        yhat, rep = parallel_slda(
            args.seed + 1, train, test, cfg, rule=args.rule,
            chains_per_device=args.chains_per_device, device=dev,
            return_report=True)
        if rank == 0:
            print(json.dumps({
                "world": world, "chains": world * args.chains_per_device,
                "rule": args.rule, "backend": rep["backend"],
                "test_mse": float(((yhat - test.y) ** 2).mean()),
                "var_y_test": float(test.y.var(unbiased=False)),
                "n_quarantined": rep["n_quarantined"],
                "collectives": {k: v.as_dict() for k, v
                                in rep["collectives"].items()},
                "ms": rep["ms"]}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
