"""The sLDA prediction service: a trained M-chain ensemble answering a
stream of ragged documents.

The port of the reference's `repro.serving.slda_service`, with its names
and semantics:

  * **micro-batcher** — pending documents are packed into micro-batches
    of one fixed slot layout: a width *ladder* of rungs (ascending token
    widths, the last `max_doc_len`) with a fixed slot *quota* a rung
    (`calibrate_slots` picks both from a sample of the traffic's lengths
    with the cost-model DP of `core.types.bucket_corpus`).  A document
    takes a slot of the smallest rung that fits it, or of a wider one
    when its own is full; unused slots are masked dummies.  Every
    dispatch therefore has one bucket signature.

  * **dispatch cache** — `_dispatch_fn(key)` holds one callable per key
    `(ExecutionPlan.cache_key(), device)`.  On the card the callable is a
    captured `torch.cuda.CUDAGraph` of the plan's prediction pass over
    static buffers (`_GraphDispatch`): each rung's tokens and mask, the
    draws z0 and seeds, φ̂ and η.  A flush copies its micro-batch, its
    draws and the current `models` into them and replays; steady traffic
    captures nothing more.  On the CPU the callable is the eager pass.
    `stats()["traces"]` counts captures (callable builds on the CPU), the
    counterpart of the reference's trace counter.  A failed capture or
    replay raises; nothing falls back to eager dispatch.

  * **result cache** — per-document z̄ and per-chain ŷ keyed on (content
    hash, model epoch); a repeat is served without a slot.

  * **combination on the host** — fresh batches and cache hits alike are
    combined by `_combine_yhat` (`core.combine`, whose sums over chains
    are column-independent) on the host copy of the per-chain ŷ, under
    the weights current at serve time.  The weights never enter a graph,
    so `drop_chain` / `revive_chain` capture nothing and are exact: the
    chains share nothing.

Numerical contract: a dispatch is `plan.predict_zbar` and `zb @ η` over
the micro-batch, so the replayed graph gives the eager pass's bits, and
the bucketed slot layout gives the padded (`bucketed=False`) layout's
bits per document (the PRNG counter stride is pinned to `max_doc_len`).

Robustness, as the reference's: a bounded queue (`max_pending`), a token
bucket (`rate_limit_per_s`, `rate_burst`) and per-request deadlines shed
with typed `Result` statuses, earliest deadline first; model tables are
screened at load and reload (`core.supervisor.model_status`) and each
chain's ŷ at dispatch, an unhealthy chain quarantined through its weight
(exact degraded mode); `reload_from_checkpoint` validates, loads and
screens a checkpoint before an epoch-bumping swap into the same buffers,
and rejects a torn, mislabelled or misshapen one with the old epoch
serving on.

The micro-batch's draws come from `core.rng.serve_draws`, stateless in
the batch index, or from a `draws(batch) -> (z0, seeds)` callable (the
tests hand in the reference's).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import time
import zipfile

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core import rng
from repro_torch.core.combine import median, simple_average, weighted_average
from repro_torch.core.plan import as_bucketed, build_plan
from repro_torch.core.supervisor import (MODEL_FAULTS, F_NAN_YHAT,
                                         describe_status, model_status)
from repro_torch.core.types import (BucketedCorpus, Corpus, SLDAConfig,
                                    SLDAModel, _dp_bucket_cuts)
from repro_torch.device import resolve_device

# ------------------------------------------------------- typed outcomes

#: `Result.status` values: every request id resolves to one of these
#: (an invalid document raises `InvalidDocument` and gets no id)
STATUS_OK = "ok"
STATUS_SHED_QUEUE = "shed_queue_full"    # bounded queue at capacity
STATUS_SHED_RATE = "shed_rate_limit"     # token bucket empty
STATUS_EXPIRED = "expired"               # deadline passed before dispatch
SHED_STATUSES = (STATUS_SHED_QUEUE, STATUS_SHED_RATE, STATUS_EXPIRED)


class InvalidDocument(ValueError):
    """A `submit()` rejection: the request can never be served.  `reason`
    is one of "empty_doc", "doc_too_long", "bad_token_id"."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


# ------------------------------------------------------------ calibration

def calibrate_slots(lengths, batch_docs: int, max_doc_len: int, *,
                    n_buckets: int = 4, token_block: int = 8,
                    overhead_docs: float = 0.0):
    """The service's (width ladder, slot quota) from a sample of document
    lengths: the cost-model DP of `bucket_corpus` (`_dp_bucket_cuts`)
    over the sorted length profile, the bucket counts scaled to
    `batch_docs` slots by largest remainder.  The widest rung is
    `max_doc_len` and every rung keeps at least one slot.  Returns equal-
    length tuples (widths, quota), sum(quota) == batch_docs."""
    lens = np.clip(np.asarray(lengths).ravel(), 1, max_doc_len)
    if batch_docs < 1:
        raise ValueError("batch_docs must be >= 1")
    lens_sorted = np.sort(lens)
    round_w = np.minimum(
        max_doc_len,
        np.maximum(token_block, -(-lens_sorted // token_block)
                   * token_block)).astype(int)
    segs = []
    for w in round_w:
        if segs and segs[-1][1] == int(w):
            segs[-1][0] += 1
        else:
            segs.append([1, int(w)])
    segs = [(c, w) for c, w in segs]
    ends = _dp_bucket_cuts(segs, max(1, min(n_buckets, batch_docs)),
                           float(overhead_docs))
    widths, counts, o = [], [], 0
    for e in ends:
        counts.append(sum(c for c, _ in segs[o:e]))
        widths.append(segs[e - 1][1])
        o = e
    widths[-1] = max_doc_len

    # largest-remainder scaling of counts → quota, each rung >= 1 slot
    total = float(sum(counts))
    raw = [batch_docs * c / total for c in counts]
    quota = [max(1, int(f)) for f in raw]
    while sum(quota) > batch_docs:        # too many rungs for the slots:
        widths.pop(0)                     # merge the narrowest rung up
        quota.pop(0)
        raw.pop(0)
    rema = sorted(range(len(quota)), key=lambda i: raw[i] - int(raw[i]),
                  reverse=True)
    i = 0
    while sum(quota) < batch_docs:
        quota[rema[i % len(quota)]] += 1
        i += 1
    return tuple(widths), tuple(quota)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Static configuration of the prediction service."""

    max_doc_len: int = 256        # admission limit == PRNG ctr_stride
    batch_docs: int = 32          # slots per micro-batch
    width_ladder: tuple = ()      # ascending rung widths; () = 1 rung
                                  # at max_doc_len (the padded layout)
    slot_quota: tuple = ()        # slots per rung; () = all batch_docs
                                  # on the single rung
    combine: str = "weighted"     # "simple" | "weighted" | "median"
    bucketed: bool = True         # False = dispatch the padded one-bucket
                                  # schedule (the parity twin); the ladder
                                  # still packs, the outputs are the same
    cache_results: bool = True    # z̄/ŷ result cache on content hash
    max_cached_results: int = 4096

    # ---- robustness policy
    max_pending: int = 0          # queue bound; 0 = unbounded
    default_deadline_s: float = 0.0   # deadline when the caller gives
                                  # none; 0 = no deadline
    rate_limit_per_s: float = 0.0     # token-bucket admission rate; 0 = off
    rate_burst: int = 0           # bucket capacity; 0 = batch_docs
    robust_checks: bool = True    # screen model tables at (re)load and
                                  # per-chain ŷ at dispatch
    auto_flush: bool = True       # False = the caller flushes (open-loop
                                  # serving)

    def __post_init__(self):
        ladder = self.width_ladder or (self.max_doc_len,)
        quota = self.slot_quota or (self.batch_docs,)
        if len(ladder) != len(quota):
            raise ValueError("width_ladder and slot_quota lengths differ")
        if list(ladder) != sorted(set(ladder)):
            raise ValueError("width_ladder must strictly ascend")
        if ladder[-1] != self.max_doc_len:
            raise ValueError("widest rung must equal max_doc_len")
        if sum(quota) != self.batch_docs or min(quota) < 1:
            raise ValueError("slot_quota must sum to batch_docs, each >=1")
        if self.max_pending and self.max_pending < self.batch_docs:
            raise ValueError("max_pending must be 0 (unbounded) or >= "
                             "batch_docs — a bound below one micro-batch "
                             "could never fill a dispatch")
        if self.rate_limit_per_s < 0 or self.default_deadline_s < 0 \
                or self.rate_burst < 0:
            raise ValueError("rate/deadline knobs must be >= 0")
        object.__setattr__(self, "width_ladder", tuple(ladder))
        object.__setattr__(self, "slot_quota", tuple(quota))

    @classmethod
    def calibrated(cls, lengths, *, max_doc_len: int = 256,
                   batch_docs: int = 32, n_buckets: int = 4,
                   token_block: int = 8, overhead_docs: float = 0.0,
                   **kw) -> "ServiceConfig":
        """A config whose slot layout fits a traffic sample."""
        widths, quota = calibrate_slots(
            lengths, batch_docs, max_doc_len, n_buckets=n_buckets,
            token_block=token_block, overhead_docs=overhead_docs)
        return cls(max_doc_len=max_doc_len, batch_docs=batch_docs,
                   width_ladder=widths, slot_quota=quota, **kw)


@dataclasses.dataclass
class Result:
    """One served prediction, with its per-chain values so that the
    combined scalar can be re-derived under any later alive mask.  A shed
    or expired request resolves to a Result too (`status` in
    `SHED_STATUSES`, `yhat` NaN, per-chain fields None)."""

    req_id: int
    yhat: float              # combined ŷ under the weights at serve time
    yhat_chains: np.ndarray  # [M] per-chain ŷ (None when shed)
    zbar: np.ndarray         # [M, T] per-chain posterior-mean θ (None
                             # when shed)
    latency_s: float
    from_cache: bool
    status: str = STATUS_OK


def _combine_yhat(rule: str, yhat, chain_weights, train_mse):
    """The one combine of fresh batches and cache hits: `core.combine`
    over yhat [M, D] on its device (the host, in the service), alive =
    nonzero chain weight."""
    yhat = torch.as_tensor(yhat)
    alive = (torch.as_tensor(chain_weights, device=yhat.device) > 0).to(
        yhat.dtype)
    if rule == "weighted":
        return weighted_average(
            yhat, train_mse=torch.as_tensor(train_mse, device=yhat.device),
            alive=alive)
    if rule == "median":
        return median(yhat, alive=alive)
    if rule == "simple":
        return simple_average(yhat, alive=alive)
    raise ValueError(f"unknown combine rule {rule!r}")


# ---------------------------------------------------------------- dispatch

_MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(SLDAModel))


def _predict(plan, z0, seeds, models):
    """One micro-batch's prediction pass: z̄ [M, D, T] and ŷ [M, D]."""
    zb = plan.predict_zbar(z0, seeds, models)
    return zb, (zb @ models.eta[..., None])[..., 0]


def eager_dispatch(z0, seeds, models, plan):
    """The dispatch without a graph, on the draws' device (a plan over
    host rows is moved there first): the CPU's dispatch, and the card's
    uncaptured twin."""
    if plan.device != z0.device:
        plan = build_plan(plan.corpus.to(z0.device), plan.cfg)
    return _predict(plan, z0, seeds, models)


class _GraphDispatch:
    """One captured CUDA graph of the prediction pass of one bucket
    signature and config, over static device buffers.

    Built from a first micro-batch: the buffers are allocated and loaded,
    one eager pass on a side stream builds the kernels' library and sets
    their attributes, and a fresh plan over the buffers (its cached
    lengths computed inside the capture, so that every replay recomputes
    them) is captured.  A call loads the micro-batch's rows (through
    pinned host buffers, without a sync), its draws and the models, then
    replays; it returns the graph's own output tensors, valid until the
    next call.  `rungs` is the kernel-B1 launches a replay makes and
    `replays` counts them: the kernels' launch counters run on the host
    and see the capture, never a replay."""

    def __init__(self, z0, seeds, models, plan):
        dev = z0.device
        bc = plan.corpus
        self.rungs, self.replays = len(bc.buckets), 0
        n = sum(b.tokens.numel() for b in bc.buckets)
        self._tok = torch.empty(n, dtype=torch.int32, device=dev)
        self._msk = torch.empty(n, dtype=torch.float32, device=dev)
        self._h_tok = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self._h_msk = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self._copied = torch.cuda.Event()   # the pinned rows' last copy
        buckets, o = [], 0
        for b in bc.buckets:
            k, shape = b.tokens.numel(), b.tokens.shape
            buckets.append(Corpus(
                tokens=self._tok[o:o + k].view(shape),
                mask=self._msk[o:o + k].view(shape),
                y=torch.zeros(shape[:-1], dtype=torch.float32, device=dev)))
            o += k
        static = BucketedCorpus(buckets=tuple(buckets), perm=bc.perm.to(dev),
                                inv_perm=bc.inv_perm.to(dev),
                                ctr_stride=bc.ctr_stride,
                                identity=bc.identity)
        self._z0, self._seeds = torch.empty_like(z0), torch.empty_like(seeds)
        self._models = models.map(torch.empty_like)
        self._load(z0, seeds, models, plan)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _predict(build_plan(static, plan.cfg), self._z0, self._seeds,
                     self._models)
        main.wait_stream(side)
        self.plan = build_plan(static, plan.cfg)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._out = _predict(self.plan, self._z0, self._seeds,
                                 self._models)

    def _load(self, z0, seeds, models, plan):
        self._copied.synchronize()     # the pinned rows are free again
        torch.cat([b.tokens.reshape(-1) for b in plan.corpus.buckets],
                  out=self._h_tok)
        torch.cat([b.mask.reshape(-1) for b in plan.corpus.buckets],
                  out=self._h_msk)
        self._tok.copy_(self._h_tok, non_blocking=True)
        self._msk.copy_(self._h_msk, non_blocking=True)
        self._copied.record()
        self._z0.copy_(z0)
        self._seeds.copy_(seeds)
        for f in _MODEL_FIELDS:
            getattr(self._models, f).copy_(getattr(models, f))

    def __call__(self, z0, seeds, models, plan):
        self._load(z0, seeds, models, plan)
        self.graph.replay()
        self.replays += 1
        return self._out


# ---------------------------------------------------------------- service

class SLDAPredictionService:
    """Micro-batched prediction over a trained M-chain ensemble.

      svc = SLDAPredictionService(models, cfg, ServiceConfig.calibrated(
                lengths_sample, max_doc_len=256, batch_docs=32))
      rid = svc.submit(token_ids)          # auto-flushes at batch_docs
      svc.drain()                          # force out partial batches
      svc.result(rid).yhat

    `models` is a chain-stacked `SLDAModel` ([M, ...] leaves, e.g. from
    `train_chains`), held on `device` (the card unless the caller asks
    for the CPU).  `seed` seeds the micro-batches' draws
    (`rng.serve_draws`); `draws(batch) -> (z0 [M, D, max_doc_len],
    seeds [M, D])`, when given, replaces them.  `clock` is the clock
    every deadline, rate and latency reads (`testing.VirtualClock`)."""

    def __init__(self, models: SLDAModel, cfg: SLDAConfig,
                 svc: ServiceConfig, *, seed: int = 0, chain_weights=None,
                 device="cuda", clock=None, draws=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.svc = svc
        self.models = models
        self.n_chains = int(self.models.eta.shape[0])
        self.chain_weights = (torch.ones(self.n_chains)
                              if chain_weights is None else chain_weights)
        self._draws = draws if draws is not None else (
            lambda b: rng.serve_draws(seed, b, self.n_chains, svc.batch_docs,
                                      svc.max_doc_len, self.cfg.n_topics,
                                      self.device))
        self._plan_cache = {}                   # key → dispatch callable
        self._graphs = {}                       # key → _GraphDispatch
        self._trace_counts = collections.Counter()   # key → captures
        self._results = {}                      # req_id → Result
        # (content hash, model epoch) → (zbar, yhat): the epoch in the key
        # keeps a hot reload from serving stale predictions
        self._result_cache = collections.OrderedDict()
        # (req_id, np tokens, t_submit, absolute deadline or +inf)
        self._pending = collections.deque()
        self._next_id = 0
        self._batches = 0
        self._stats = collections.Counter()
        self._clock = clock if clock is not None else time.perf_counter
        self._model_epoch = 0                   # bumps on every hot swap
        self._ckpt_step = None                  # step of the live epoch
        self._health = np.zeros(self.n_chains, np.int64)  # latched flags
        burst = svc.rate_burst or svc.batch_docs
        self._tokens = float(burst)             # token bucket, full start
        self._bucket_t = self._clock()
        if svc.robust_checks:
            self._screen_models(self.models)

    @property
    def models(self) -> SLDAModel:
        return self._models

    @models.setter
    def models(self, models: SLDAModel):
        """Hold the models on the service's device, and their train MSE
        on the host for the combine."""
        self._models = models.to(self.device)
        self._train_mse_host = self._models.train_mse.detach().to("cpu")

    @property
    def chain_weights(self) -> torch.Tensor:
        return self._chain_weights

    @chain_weights.setter
    def chain_weights(self, w):
        """Weights live on the host: the combine and the dispatch screen
        read them every flush."""
        self._chain_weights = torch.as_tensor(
            w, dtype=torch.float32).to("cpu").clone()
        self._w_host = self._chain_weights.numpy()

    def _screen_models(self, models):
        """Latch `model_status` flags and quarantine chains whose tables
        are unhealthy.  Quarantine multiplies the weight by the alive
        mask, so operator-zeroed chains stay zeroed."""
        status = model_status(models).cpu().numpy().astype(np.int64)
        self._health = status
        bad = (status & MODEL_FAULTS) != 0
        if bad.any():
            self._stats["load_quarantines"] += int(bad.sum())
            self.chain_weights = self.chain_weights \
                * torch.from_numpy((~bad).astype(np.float32))
        return status

    def _take_token(self) -> bool:
        """Token-bucket admission (always True with rate limiting off)."""
        rate = self.svc.rate_limit_per_s
        if rate <= 0:
            return True
        now = self._clock()
        burst = self.svc.rate_burst or self.svc.batch_docs
        self._tokens = min(float(burst),
                           self._tokens + (now - self._bucket_t) * rate)
        self._bucket_t = now
        if self._tokens < 1.0:
            return False
        self._tokens -= 1.0
        return True

    def _shed(self, rid: int, status: str, t0: float) -> int:
        """Resolve a request to a typed shed Result."""
        self._results[rid] = Result(
            req_id=rid, yhat=float("nan"), yhat_chains=None, zbar=None,
            latency_s=self._clock() - t0, from_cache=False, status=status)
        self._stats[status] += 1
        return rid

    def _combine(self, yhat) -> np.ndarray:
        """Per-chain ŷ [M, D] (host) → combined [D] under the current
        weights."""
        return _combine_yhat(self.svc.combine, torch.as_tensor(yhat),
                             self.chain_weights,
                             self._train_mse_host).numpy()

    # ------------------------------------------------------------ intake

    def submit(self, tokens, *, deadline_s: float | None = None) -> int:
        """Enqueue one ragged document (int token ids, 1-D); returns its
        request id and auto-flushes whenever a full micro-batch is
        pending.  A content-hash repeat is served from the result cache,
        combined under the current weights.  Admission order: validate
        (raises `InvalidDocument`), result cache, rate limit, queue
        bound.  `deadline_s` is a latency budget from now (default
        `svc.default_deadline_s`; 0/None = none): a request whose
        deadline lapses before dispatch resolves to `STATUS_EXPIRED`."""
        toks = np.asarray(tokens, np.int32).ravel()
        if toks.size < 1:
            self._stats["rejected_invalid"] += 1
            raise InvalidDocument("empty_doc", "document has no tokens")
        if toks.size > self.svc.max_doc_len:
            self._stats["rejected_invalid"] += 1
            raise InvalidDocument(
                "doc_too_long",
                f"doc length {toks.size} > max_doc_len "
                f"{self.svc.max_doc_len}")
        if toks.min() < 0 or toks.max() >= self.cfg.vocab_size:
            self._stats["rejected_invalid"] += 1
            raise InvalidDocument(
                "bad_token_id",
                f"token ids must lie in [0, {self.cfg.vocab_size}) "
                f"(got min {int(toks.min())}, max {int(toks.max())})")
        rid = self._next_id
        self._next_id += 1
        t0 = self._clock()
        if self.svc.cache_results:
            h = hashlib.blake2b(toks.tobytes(), digest_size=16).digest()
            hit = self._result_cache.get((h, self._model_epoch))
            if hit is not None:
                self._result_cache.move_to_end((h, self._model_epoch))
                zbar, yhat = hit
                comb = float(self._combine(yhat[:, None])[0])
                self._results[rid] = Result(
                    req_id=rid, yhat=comb, yhat_chains=yhat, zbar=zbar,
                    latency_s=self._clock() - t0, from_cache=True)
                self._stats["cache_hits"] += 1
                return rid
        if not self._take_token():
            return self._shed(rid, STATUS_SHED_RATE, t0)
        if self.svc.max_pending \
                and len(self._pending) >= self.svc.max_pending:
            return self._shed(rid, STATUS_SHED_QUEUE, t0)
        if deadline_s is None:
            deadline_s = self.svc.default_deadline_s
        deadline = t0 + deadline_s if deadline_s else math.inf
        self._pending.append((rid, toks, t0, deadline))
        if self.svc.auto_flush:
            while len(self._pending) >= self.svc.batch_docs:
                self.flush()
        return rid

    # ----------------------------------------------------------- packing

    def _pack(self):
        """Pack pending documents into the slot layout.  Requests whose
        deadline lapsed are shed (`STATUS_EXPIRED`) first; the rest go
        earliest deadline first (ties by request id, so deadline-free
        traffic is FIFO), each into a free slot of the smallest rung that
        fits it or of a wider one; what fits nowhere stays pending.
        Returns (per-rung lists, n_placed)."""
        ladder, quota = self.svc.width_ladder, self.svc.slot_quota
        now = self._clock()
        live = []
        while self._pending:
            item = self._pending.popleft()
            if item[3] < now:
                self._shed(item[0], STATUS_EXPIRED, item[2])
                continue
            live.append(item)
        live.sort(key=lambda it: (it[3], it[0]))    # EDF, FIFO fallback
        free = list(quota)
        placed = [[] for _ in ladder]
        leftover = collections.deque()
        n = 0
        for item in live:
            L = item[1].size
            rung = next(i for i, w in enumerate(ladder) if w >= L)
            slot = next((i for i in range(rung, len(ladder))
                         if free[i] > 0), None)
            if slot is None:
                leftover.append(item)
                continue
            free[slot] -= 1
            placed[slot].append(item)
            n += 1
        self._pending = leftover
        return placed, n

    def _build_schedule(self, placed):
        """Slot lists → (BucketedCorpus on the host, slot_meta).  The
        micro-batch's original order is the rung-major slot order (real
        documents first, dummies after, a rung at a time), so the
        permutation is the identity and the padded twin
        (`bucketed=False`) sees the same rows.  slot_meta[d] is
        (req_id, t_submit), or None for a dummy."""
        ladder, quota = self.svc.width_ladder, self.svc.slot_quota
        S = self.svc.max_doc_len
        meta, buckets = [], []
        tok_rows, mask_rows = [], []
        for w, q, docs in zip(ladder, quota, placed):
            bt = np.zeros((q, w), np.int32)
            bm = np.zeros((q, w), np.float32)
            for i, (rid, toks, t0, _deadline) in enumerate(docs):
                bt[i, :toks.size] = toks
                bm[i, :toks.size] = 1.0
                meta.append((rid, t0))
            meta.extend([None] * (q - len(docs)))
            buckets.append(Corpus(tokens=torch.from_numpy(bt),
                                  mask=torch.from_numpy(bm),
                                  y=torch.zeros((q,))))
            tok_rows.append(np.pad(bt, ((0, 0), (0, S - w))))
            mask_rows.append(np.pad(bm, ((0, 0), (0, S - w))))
        D = self.svc.batch_docs
        if self.svc.bucketed:
            perm = torch.arange(D)
            bc = BucketedCorpus(buckets=tuple(buckets), perm=perm,
                                inv_perm=perm, ctr_stride=S)
        else:
            bc = as_bucketed(Corpus(
                tokens=torch.from_numpy(np.concatenate(tok_rows)),
                mask=torch.from_numpy(np.concatenate(mask_rows)),
                y=torch.zeros((D,))))
        return bc, meta

    # ---------------------------------------------------------- dispatch

    def _dispatch_fn(self, plan_key):
        """The dispatch cache: one callable `fn(z0, seeds, models, plan)
        -> (zb [M, D, T], yhat [M, D])` per key `(plan.cache_key(),
        device)`, made once and reused by every micro-batch of that
        signature and config: on the card a captured graph
        (`_GraphDispatch`, captured at its first call), on the CPU the
        eager pass.  Each capture (each build on the CPU) counts in
        `stats()['traces']`, so steady traffic that grows it is a test
        failure."""
        fn = self._plan_cache.get(plan_key)
        if fn is not None:
            return fn
        if self.device.type != "cuda":
            self._trace_counts[plan_key] += 1
            fn = eager_dispatch
        else:
            graphs, counts = self._graphs, self._trace_counts

            def fn(z0, seeds, models, plan):
                if plan_key not in graphs:
                    graphs[plan_key] = _GraphDispatch(z0, seeds, models, plan)
                    counts[plan_key] += 1
                return graphs[plan_key](z0, seeds, models, plan)
        self._plan_cache[plan_key] = fn
        return fn

    def set_sampler_mode(self, mode: str):
        """Switch the per-token draw for later dispatches.  The cfg is in
        every key, so the next flush under the new mode captures a new
        graph; the old mode's stay cached (switching back is free)."""
        if mode not in ("dense", "sparse"):
            raise ValueError(f"unknown sampler_mode {mode!r}")
        self.cfg = dataclasses.replace(self.cfg, sampler_mode=mode)

    def _batch_draws(self, b: int):
        z0, seeds = self._draws(b)
        return (torch.as_tensor(z0).to(self.device),
                torch.as_tensor(seeds).to(self.device))

    def flush(self):
        """Dispatch one micro-batch from the pending queue (a no-op when
        it is empty).  Returns the req_ids this batch completed (shed ids
        resolve through `result()`)."""
        if not self._pending:
            return []
        placed, n = self._pack()
        if n == 0:      # every pending request expired: nothing to run
            return []
        bc, meta = self._build_schedule(placed)
        plan = build_plan(bc, self.cfg)
        fn = self._dispatch_fn((plan.cache_key(), self.device))
        z0, seeds = self._batch_draws(self._batches)
        self._batches += 1
        zb, yhat = fn(z0, seeds, self.models, plan)
        zb, yhat = zb.cpu().numpy(), yhat.cpu().numpy()
        t_done = self._clock()
        real = [d for d, slot in enumerate(meta) if slot is not None]
        comb = self._combine(yhat)
        if self.svc.robust_checks and real:
            comb = self._screen_dispatch(yhat, comb, real)
        done = []
        for d, slot in enumerate(meta):
            if slot is None:
                self._stats["dummy_slots"] += 1
                continue
            rid, t0 = slot
            self._results[rid] = Result(
                req_id=rid, yhat=float(comb[d]), yhat_chains=yhat[:, d],
                zbar=zb[:, d], latency_s=t_done - t0, from_cache=False)
            done.append(rid)
            if self.svc.cache_results:
                h = hashlib.blake2b(
                    np.ascontiguousarray(bc_tokens_row(bc, d)).tobytes(),
                    digest_size=16).digest()
                self._result_cache[(h, self._model_epoch)] = \
                    (zb[:, d], yhat[:, d])
                while len(self._result_cache) > self.svc.max_cached_results:
                    self._result_cache.popitem(last=False)
        self._stats["dispatches"] += 1
        self._stats["docs_dispatched"] += n
        return done

    def _screen_dispatch(self, yhat, comb, real):
        """Per-chain ŷ screen at dispatch: a chain with a non-finite
        prediction on a real slot is quarantined as a manual `drop_chain`
        is, and the batch recombined under the corrected mask, so the
        poison never reaches a caller."""
        bad = ~np.isfinite(yhat[:, real]).all(axis=1) & (self._w_host > 0)
        if not bad.any():
            return comb
        for c in np.flatnonzero(bad):
            self._health[c] |= F_NAN_YHAT
            self.drop_chain(int(c))
            self._stats["dispatch_quarantines"] += 1
        return self._combine(yhat)

    def drain(self, deadline_s: float | None = None):
        """Flush until nothing is pending (partial batches pad with
        dummies).  `deadline_s` bounds the time spent: on timeout the rest
        stays pending, not shed."""
        t0 = self._clock()
        done = []
        while self._pending:
            if deadline_s is not None and self._clock() - t0 > deadline_s:
                self._stats["drain_timeouts"] += 1
                break
            done.extend(self.flush())
        return done

    # ----------------------------------------------------------- results

    def result(self, req_id: int) -> Result:
        return self._results[req_id]

    def combined(self, req_id: int) -> float:
        """The combined ŷ of a served request re-derived under the current
        weights: exact under any drop/revive.  All chains dead inherits
        `core.combine`'s fallback (unmasked, with a RuntimeWarning)."""
        r = self._results[req_id]
        if r.status != STATUS_OK:
            raise ValueError(
                f"request {req_id} was not served (status {r.status!r})"
                " — no per-chain values to combine")
        return float(self._combine(r.yhat_chains[:, None])[0])

    # ---------------------------------------------- ensemble maintenance

    def drop_chain(self, idx: int):
        """Zero a chain's weight: exact (the chains share nothing), and
        no graph sees the weights."""
        w = self.chain_weights.clone()
        w[idx] = 0.0
        self.chain_weights = w

    def revive_chain(self, idx: int, weight: float = 1.0):
        """Undo a drop, and clear the chain's latched health flags."""
        w = self.chain_weights.clone()
        w[idx] = weight
        self.chain_weights = w
        self._health[idx] = 0

    def reload_from_checkpoint(self, ckpt_dir: str,
                               step: int | None = None) -> dict:
        """Hot model swap, epoch-versioned and atomic from the caller's
        view: validate the manifest, load every chain, check the shapes
        against the live models (the graphs' buffers), screen, then swap.
        Any failure before the swap (missing, torn or mislabelled
        checkpoint, another chain count or table shape, no healthy chain)
        rejects the reload and the old epoch serves on.  A swap bumps the
        epoch, which retires every cached result by key, and captures
        nothing: the models are copied into the same buffers."""
        t0 = self._clock()

        def _reject(reason: str) -> dict:
            self._stats["reloads_rejected"] += 1
            return {"ok": False, "reason": reason,
                    "epoch": self._model_epoch,
                    "ckpt_step": self._ckpt_step,
                    "wall_s": self._clock() - t0}

        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                return _reject(f"no checkpoint under {ckpt_dir!r}")
        try:
            models, manifest = restore_checkpoint(
                ckpt_dir, step, self.models)
        except (FileNotFoundError, KeyError, ValueError, OSError, EOFError,
                zipfile.BadZipFile) as e:   # truncated .npz = torn write
            return _reject(f"{type(e).__name__}: {e}")
        for f in _MODEL_FIELDS:
            got, want = getattr(models, f).shape, getattr(self.models,
                                                         f).shape
            if got != want:
                return _reject(f"shape mismatch: {f} {tuple(got)}, serving "
                               f"{tuple(want)}")
        quarantined = []
        if self.svc.robust_checks:
            status = model_status(models).cpu().numpy().astype(np.int64)
            bad = (status & MODEL_FAULTS) != 0
            if bad.all():
                return _reject("all_chains_unhealthy")
            quarantined = [int(c) for c in np.flatnonzero(bad)]
            self._health = status
            alive = (~bad).astype(np.float32)
        else:
            alive = np.ones(self.n_chains, np.float32)
        # point of no return: everything below is assignment
        self.models = models
        self._model_epoch += 1
        self._ckpt_step = int(manifest["step"])
        self.chain_weights = alive
        self._stats["reloads_ok"] += 1
        if quarantined:
            self._stats["load_quarantines"] += len(quarantined)
        return {"ok": True, "epoch": self._model_epoch,
                "ckpt_step": self._ckpt_step,
                "quarantined_chains": quarantined,
                "wall_s": self._clock() - t0}

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """The counters the tests and `chip_smoke.py` read; `traces` (the
        captures) must not grow under steady traffic."""
        sig_traces = collections.Counter()
        for k, v in self._trace_counts.items():
            sig_traces[str(k[0][0])] += v
        slot_total = max(self._stats["dispatches"], 1) \
            * self.svc.batch_docs
        alive = self._w_host > 0
        return {
            "traces": int(sum(self._trace_counts.values())),
            "compiled_plans": len(self._plan_cache),
            "plan_cache_keys": len(self._plan_cache),
            "sampler_mode": self.cfg.sampler_mode,
            "traces_by_signature": dict(sig_traces),
            "dispatches": int(self._stats["dispatches"]),
            "docs_dispatched": int(self._stats["docs_dispatched"]),
            "dummy_slots": int(self._stats["dummy_slots"]),
            "dummy_slot_frac": round(
                self._stats["dummy_slots"]
                / (slot_total if self._stats["dispatches"] else 1), 4),
            "result_cache_hits": int(self._stats["cache_hits"]),
            "result_cache_size": len(self._result_cache),
            "pending": len(self._pending),
            "width_ladder": list(self.svc.width_ladder),
            "slot_quota": list(self.svc.slot_quota),
            "bucketed": self.svc.bucketed,
            "device": str(self.device),
            "dispatch": ("cuda_graph" if self.device.type == "cuda"
                         else "eager"),
            "queue_depth": len(self._pending),
            "shed_queue_full": int(self._stats[STATUS_SHED_QUEUE]),
            "shed_rate_limit": int(self._stats[STATUS_SHED_RATE]),
            "expired": int(self._stats[STATUS_EXPIRED]),
            "rejected_invalid": int(self._stats["rejected_invalid"]),
            "drain_timeouts": int(self._stats["drain_timeouts"]),
            "dispatch_quarantines": int(
                self._stats["dispatch_quarantines"]),
            "load_quarantines": int(self._stats["load_quarantines"]),
            "reloads_ok": int(self._stats["reloads_ok"]),
            "reloads_rejected": int(self._stats["reloads_rejected"]),
            "model_epoch": self._model_epoch,
            "ckpt_step": self._ckpt_step,
            "alive_chains": int(alive.sum()),
            "chain_health": [describe_status(int(s))
                             for s in self._health],
        }

    def describe(self) -> dict:
        """The serving plan, readable: slot layout, signature, and the
        plan a dispatch runs."""
        dummy = [(0, np.zeros(1, np.int32), 0.0, math.inf)]
        placed = [[] for _ in self.svc.width_ladder]
        placed[0] = dummy
        bc, _ = self._build_schedule(placed)
        plan = build_plan(bc.to(self.device), self.cfg)
        d = plan.describe()
        d["cache_key_signature"] = str(plan.cache_key()[0])
        d["width_ladder"] = list(self.svc.width_ladder)
        d["slot_quota"] = list(self.svc.slot_quota)
        d["combine"] = self.svc.combine
        d["chains"] = self.n_chains
        d["dispatch"] = self.stats()["dispatch"]
        d["robustness"] = {
            "max_pending": self.svc.max_pending,
            "default_deadline_s": self.svc.default_deadline_s,
            "rate_limit_per_s": self.svc.rate_limit_per_s,
            "rate_burst": self.svc.rate_burst or self.svc.batch_docs,
            "robust_checks": self.svc.robust_checks,
            "auto_flush": self.svc.auto_flush,
            "scheduling": "earliest-deadline-first (FIFO when no "
                          "deadlines)",
            "shed_statuses": list(SHED_STATUSES),
            "model_epoch": self._model_epoch,
        }
        return d


def bc_tokens_row(bc: BucketedCorpus, d: int) -> np.ndarray:
    """Original-order row d of a schedule whose permutation is the
    identity, cut to its true length: the service's content-hash source
    (it reads the host rows the service packed)."""
    o = 0
    for b in bc.buckets:
        q = b.tokens.shape[0]
        if d < o + q:
            row = b.tokens[d - o].cpu().numpy()
            n = int(b.mask[d - o].cpu().numpy().astype(bool).sum())
            return row[:n]
        o += q
    raise IndexError(d)
