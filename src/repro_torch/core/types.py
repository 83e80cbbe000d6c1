"""Core datatypes for sLDA and its embarrassingly parallel runner.

Small dataclasses of tensors, in the reference's layouts: counts are kept
in float32 (small integers, exact below 2^24), topic-word tables are
`[T, W]` with a leading chain dim `[M, T, W]` where chains are batched.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SLDAConfig:
    """Hyperparameters of supervised LDA (McAuliffe & Blei 2008 notation).

    Same fields and defaults as the reference's `SLDAConfig`.  A run
    takes one sweep per launch (`sweeps_per_launch=1`, kernel B2) or
    several (kernel B3), with the dense draw or the sparse two-stage draw
    (`sampler_mode="sparse"`, over each word's top `sparse_topic_cap`
    topics, clamped to T), over the padded corpus (`length_buckets=0`)
    or over at most `length_buckets` length buckets (`bucket_corpus`,
    each bucket one launch of the kernel).  `use_pallas` is accepted and
    ignored: the tensors' device decides between the CUDA kernels and
    their plain versions.
    """

    n_topics: int = 32
    vocab_size: int = 1024
    alpha: float = 0.1       # Dir prior on doc-topic θ_d
    beta: float = 0.01       # Dir prior on topic-word φ_t
    rho: float = 0.5         # response noise  y_d ~ N(ηᵀ z̄_d, ρ)
    mu: float = 0.0          # prior mean of η_t
    sigma: float = 10.0      # prior variance of η_t
    label_type: str = "continuous"   # "continuous" | "binary"
    n_iters: int = 60        # stochastic-EM iterations (Gibbs sweep + η solve)
    n_pred_burnin: int = 15  # test-time Gibbs burn-in sweeps
    n_pred_samples: int = 10 # test-time sweeps averaged for z̄
    use_pallas: bool = False # accepted for parity; the device decides
    pred_doc_block: int = 8  # reference kernel tiling; unused here
    count_rebuild_every: int = 16  # exact ntw/nt rebuild cadence; the
                             # iterations in between apply exact ±1 deltas
    sweeps_per_launch: int = 1
    train_doc_block: int = 128
    product_form_sweeps: bool = True
    fuse_weighted_predict: bool = True  # Weighted Average predicts test
                             # and train in ONE chain-batched pass
    length_buckets: int = 0
    bucket_token_block: int = 8
    bucket_overhead_docs: float = 0.0
    chains_per_device: int = 1
    sampler_mode: str = "dense"
    sparse_topic_cap: int = 32

    def __post_init__(self):
        if self.sampler_mode not in ("dense", "sparse"):
            raise ValueError(f"sampler_mode={self.sampler_mode!r}: expected "
                             "'dense' or 'sparse'")


class _Tensors:
    """Field-wise helpers for the tensor dataclasses below."""

    def map(self, fn):
        return type(self)(*(fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)))

    def to(self, device):
        return self.map(lambda t: t.to(device))


@dataclasses.dataclass
class Corpus(_Tensors):
    """A padded bag of documents.

    tokens  : int32[D, N]  word ids, padding value arbitrary where mask==0
    mask    : float32[D, N] 1.0 on real tokens
    y       : float32[D]   document labels (binary labels stored as 0/1)
    A chain-sharded corpus carries a leading chain dim: [M, D, N].
    """

    tokens: Tensor
    mask: Tensor
    y: Tensor

    @property
    def n_docs(self) -> int:
        return self.tokens.shape[-2]

    @property
    def max_len(self) -> int:
        return self.tokens.shape[-1]

    def lengths(self) -> Tensor:
        return self.mask.sum(-1)


@dataclasses.dataclass
class GibbsState(_Tensors):
    """State of collapsed-Gibbs sLDA chains (leading chain dim optional)."""

    z: Tensor      # int32[D, N]   token-topic assignments
    ndt: Tensor    # float32[D, T] doc-topic counts
    ntw: Tensor    # float32[T, W] topic-word counts
    nt: Tensor     # float32[T]    topic totals
    eta: Tensor    # float32[T]    regression weights


@dataclasses.dataclass
class SLDAModel(_Tensors):
    """What a trained chain exports: enough to predict, nothing more —
    the only thing that crosses a chain boundary."""

    phi: Tensor        # float32[T, W] topic-word distributions  φ̂
    eta: Tensor        # float32[T]    regression weights        η̂
    train_mse: Tensor  # float32[] training-set MSE (Weighted Average weight)
    train_acc: Tensor  # float32[] training-set accuracy (binary labels)


# ------------------------------------------------- ragged execution layer

def _take_docs(arr: Tensor, idx: Tensor, d_axis: int) -> Tensor:
    """Gather document rows: idx [D'] (any d_axis) or [M, D'] (then the
    doc axis is 1 and arr carries the matching leading chain dim)."""
    if idx.dim() == 1:
        return arr.index_select(d_axis, idx)
    if d_axis != 1:
        raise ValueError(f"per-chain rows want d_axis 1, got {d_axis}")
    return arr[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


@dataclasses.dataclass
class BucketedCorpus:
    """A corpus reorganized for length-bucketed (ragged) execution.

    Documents are sorted by true length and grouped into buckets; bucket
    b holds a contiguous run of the sorted order, padded to its own token
    width `widths[b]` (a token_block multiple of its longest document)
    instead of the source's max_len.  Each sweep runs one kernel launch a
    bucket, so the token slots it walks scale with Σ_b D_b·N_b rather
    than D·N_max.

    buckets   : per-bucket `Corpus` (tokens [.., D_b, N_b]), rows in
                sorted order; a leading chain dim M rides along when the
                source was a chain-sharded corpus [M, D, N].
    perm      : int64 [D] (or [M, D]): sorted position i holds original
                document perm[i].
    inv_perm  : int64 [D] (or [M, D]): original document d sits at sorted
                position inv_perm[d].
    ctr_stride: the source corpus's max_len, pinned as every bucketed
                launch's PRNG counter stride, so that each (document,
                sweep, token) draws the uniform it draws in the padded
                launch: a bucketed run is bit for bit the padded one per
                document at sweeps_per_launch=1 (`merge_docs` restores
                original order).
    identity  : the degenerate one-bucket schedule with the identity
                permutation (`core.plan.as_bucketed`, the padded path):
                its row plumbing gathers nothing.
    """

    buckets: tuple
    perm: Tensor
    inv_perm: Tensor
    ctr_stride: int
    identity: bool = False

    @property
    def _trivial(self) -> bool:
        return self.identity and len(self.buckets) == 1

    # ---- the schedule's shapes

    @property
    def widths(self) -> tuple:
        return tuple(b.tokens.shape[-1] for b in self.buckets)

    @property
    def counts(self) -> tuple:
        return tuple(b.tokens.shape[-2] for b in self.buckets)

    @property
    def n_docs(self) -> int:
        return sum(self.counts)

    @property
    def n_chains(self):
        """Leading chain dim of a chain-sharded schedule (None if flat)."""
        t = self.buckets[0].tokens
        return t.shape[0] if t.dim() == 3 else None

    @property
    def max_len(self) -> int:
        return self.ctr_stride

    def padded_tokens(self) -> int:
        """Token slots the bucketed schedule walks a sweep (per chain)."""
        return sum(d * w for d, w in zip(self.counts, self.widths))

    def real_tokens(self) -> Tensor:
        return sum(b.mask.sum() for b in self.buckets)

    def lengths(self) -> Tensor:
        """True document lengths in original order, [D] (or [M, D])."""
        return self.merge_docs([b.mask.sum(-1) for b in self.buckets])

    @property
    def y(self) -> Tensor:
        """Labels in original order (the buckets hold them sorted)."""
        return self.merge_docs([b.y for b in self.buckets])

    def to(self, device):
        return BucketedCorpus(
            buckets=tuple(b.to(device) for b in self.buckets),
            perm=self.perm.to(device), inv_perm=self.inv_perm.to(device),
            ctr_stride=self.ctr_stride, identity=self.identity)

    # ---- row plumbing between original order and the bucketed layout

    def _bucket_perms(self) -> list:
        """Each bucket's slice of `perm`: its documents, original ids."""
        out, o = [], 0
        for c in self.counts:
            out.append(self.perm[..., o:o + c])
            o += c
        return out

    def split_docs(self, arr: Tensor, d_axis=None) -> list:
        """Original-order document rows [.., D, ...] → per-bucket pieces
        (one gather a bucket, each piece contiguous)."""
        if self._trivial:
            return [arr]
        if d_axis is None:
            d_axis = self.perm.dim() - 1
        return [_take_docs(arr, p, d_axis) for p in self._bucket_perms()]

    def merge_docs(self, pieces, d_axis=None) -> Tensor:
        """Per-bucket document rows → one tensor in original order."""
        pieces = list(pieces)
        if self._trivial:
            return pieces[0]
        if d_axis is None:
            d_axis = self.perm.dim() - 1
        return _take_docs(torch.cat(pieces, d_axis), self.inv_perm, d_axis)

    def split_padded(self, arr: Tensor, d_axis=None) -> list:
        """[.., D, ctr_stride] in original order → per-bucket
        [.., D_b, N_b]: rows gathered, the token tail cut to the bucket's
        width (one gather a bucket, each piece contiguous)."""
        if self._trivial and self.widths[0] == self.ctr_stride:
            return [arr]
        if d_axis is None:
            d_axis = self.perm.dim() - 1
        return [_take_docs(arr[..., :w], p, d_axis)
                for p, w in zip(self._bucket_perms(), self.widths)]

    def merge_padded(self, pieces, fill: Tensor, d_axis=None) -> Tensor:
        """Per-bucket [.., D_b, N_b] → [.., D, ctr_stride] in original
        order; the token columns past each bucket's width come from `fill`
        (original order): they are all padding, which the padded launch
        leaves at their input values."""
        pieces = list(pieces)
        if self._trivial and pieces[0].shape[-1] == self.ctr_stride:
            return pieces[0]
        fills = self.split_docs(fill, d_axis)
        return self.merge_docs(
            [torch.cat([p, f[..., p.shape[-1]:]], -1)
             for p, f in zip(pieces, fills)], d_axis)


def bucket_signature(bc: BucketedCorpus) -> tuple:
    """The static shape signature of a bucketed schedule: one (width,
    count) pair a bucket, the PRNG counter stride, the chain layout and
    the identity flag.  Two schedules with equal signatures launch the
    same kernels at the same shapes."""
    return (tuple(zip(bc.widths, bc.counts)), bc.ctr_stride,
            bc.n_chains, bc.identity)


def _dp_bucket_cuts(segs, max_buckets: int, overhead: float):
    """Optimal contiguous grouping of width segments into at most
    max_buckets buckets, minimizing the modeled sweep cost
    Σ_b (D_b + overhead)·N_b.

    segs: [(count, width), ...] with strictly increasing widths (documents
    sorted by length, compressed to runs of equal rounded width: a cut
    inside a run never pays, so these are the only candidate cuts).
    `overhead` is the fixed cost of a bucket in document rows (each extra
    bucket is one more launch); 0 minimizes padded slots alone.  Returns
    the segment end index of each bucket."""
    S = len(segs)
    max_b = max(1, min(max_buckets, S))
    pref = [0]
    for c, _ in segs:
        pref.append(pref[-1] + c)
    INF = float("inf")
    # dp[b][j]: the least cost of covering the first j segments by b buckets
    dp = [[INF] * (S + 1) for _ in range(max_b + 1)]
    cut = [[0] * (S + 1) for _ in range(max_b + 1)]
    dp[0][0] = 0.0
    for b in range(1, max_b + 1):
        for j in range(1, S + 1):
            w = segs[j - 1][1]
            for i in range(j):
                if dp[b - 1][i] == INF:
                    continue
                c = dp[b - 1][i] + (pref[j] - pref[i] + overhead) * w
                if c < dp[b][j]:
                    dp[b][j] = c
                    cut[b][j] = i
    b_best = min(range(1, max_b + 1), key=lambda b: dp[b][S])
    bounds, j = [], S
    for b in range(b_best, 0, -1):
        bounds.append(j)
        j = cut[b][j]
    return list(reversed(bounds))


def bucket_corpus(corpus: Corpus, n_buckets: int = 8, *,
                  token_block: int = 8,
                  overhead_docs: float = 96.0) -> BucketedCorpus:
    """The length-bucketed schedule of `corpus`, the reference's.

    Documents are stably sorted by true length (per chain for a
    chain-sharded [M, D, N] corpus: every chain shares the bucket sizes,
    so that each launch stays rectangular, and has its own permutation)
    and cut into at most `n_buckets` contiguous groups by
    `_dp_bucket_cuts`: each group is padded to its token_block-rounded
    longest document (longest across chains), and the cuts minimize
    Σ_b (D_b + overhead_docs)·N_b.  A corpus of documents of one length
    collapses to one bucket.  The lengths are read to the host (the
    schedule's shapes depend on them); the rows are gathered on the
    corpus's device."""
    lens = corpus.mask.sum(-1).to("cpu", torch.int64).numpy()  # [D]/[M, D]
    chain = lens.ndim == 2
    D = lens.shape[-1]
    src_n = corpus.tokens.shape[-1]
    nb = max(1, min(int(n_buckets), D))

    perm = np.argsort(lens, axis=-1, kind="stable")
    lens_sorted = np.take_along_axis(lens, perm, axis=-1)
    # the rounded width each sorted position needs (max across chains:
    # each chain's sorted lengths ascend, so the column max ascends)
    colmax = lens_sorted.max(axis=0) if chain else lens_sorted
    round_w = np.minimum(
        src_n, np.maximum(token_block,
                          -(-colmax // token_block) * token_block))
    segs = []                                      # runs of equal width
    for w in round_w.tolist():
        if segs and segs[-1][1] == w:
            segs[-1][0] += 1
        else:
            segs.append([1, w])
    ends = _dp_bucket_cuts([tuple(sg) for sg in segs], nb,
                           float(overhead_docs))
    widths, counts, o = [], [], 0
    for e in ends:
        counts.append(sum(c for c, _ in segs[o:e]))
        widths.append(segs[e - 1][1])
        o = e

    dev = corpus.tokens.device
    perm_t = torch.from_numpy(perm).to(dev)
    inv_perm = torch.from_numpy(
        np.argsort(perm, axis=-1, kind="stable")).to(dev)
    d_axis = 1 if chain else 0
    buckets, o = [], 0
    for c, w in zip(counts, widths):
        rows = perm_t[..., o:o + c]
        buckets.append(Corpus(
            tokens=_take_docs(corpus.tokens[..., :w], rows, d_axis),
            mask=_take_docs(corpus.mask[..., :w], rows, d_axis),
            y=_take_docs(corpus.y, rows, d_axis)))
        o += c
    return BucketedCorpus(buckets=tuple(buckets), perm=perm_t,
                          inv_perm=inv_perm, ctr_stride=src_n)


def partition(corpus: Corpus, m: int) -> Corpus:
    """Split a corpus into M equal shards: [D, ...] → [M, D/M, ...].

    The paper partitions uniformly at random; callers should pre-shuffle.
    D must be divisible by M (pad the corpus if not).
    """
    if corpus.n_docs % m:
        raise ValueError(f"{corpus.n_docs} docs not divisible by {m} shards")
    return corpus.map(
        lambda x: x.reshape((m, corpus.n_docs // m) + tuple(x.shape[1:])))


def _concat_corpora(a: Corpus, b: Corpus) -> Corpus:
    """Stack two corpora along the doc axis (padding to a common max_len)
    so one fused prediction pass covers both."""
    n = max(a.max_len, b.max_len)
    padn = lambda x: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return Corpus(tokens=torch.cat([padn(a.tokens), padn(b.tokens)]),
                  mask=torch.cat([padn(a.mask), padn(b.mask)]),
                  y=torch.cat([a.y, b.y]))


def counts_from_assignments(tokens: Tensor, mask: Tensor, z: Tensor,
                            n_topics: int, vocab_size: int):
    """Exact (ndt, ntw, nt) from the current assignments.

    tokens/mask/z are [..., D, N]; leading dims are independent chains.
    Returns ndt [..., D, T], ntw [..., T, W], nt [..., T].  The scatters
    add 0/1 values, so any order of accumulation is exact."""
    lead, (D, N) = tokens.shape[:-2], tokens.shape[-2:]
    B = math.prod(lead)
    dev = tokens.device
    b = torch.arange(B, device=dev)[:, None, None].expand(B, D, N)
    d = torch.arange(D, device=dev)[None, :, None].expand(B, D, N)
    zz = z.reshape(B, D, N).long()
    m = mask.reshape(B, D, N)
    ndt = torch.zeros((B, D, n_topics), dtype=torch.float32, device=dev)
    ndt.index_put_((b, d, zz), m, accumulate=True)
    ntw = torch.zeros((B, n_topics, vocab_size), dtype=torch.float32,
                      device=dev)
    ntw.index_put_((b, zz, tokens.reshape(B, D, N).long()), m,
                   accumulate=True)
    ndt = ndt.reshape(lead + (D, n_topics))
    ntw = ntw.reshape(lead + (n_topics, vocab_size))
    return ndt, ntw, ntw.sum(-1)


def apply_count_deltas(ntw: Tensor, nt: Tensor, tokens: Tensor,
                       mask: Tensor, z_old: Tensor, z_new: Tensor,
                       cap: int | None = None):
    """Exact incremental (ntw, nt) refresh from one sweep's reassignments:
    −1 at (z_old, w) and +1 at (z_new, w) for every real token whose topic
    changed.  ±1 float32 updates are lossless below 2^24, so both forms
    below give the same bits.  Shapes as `counts_from_assignments`, with
    ntw [..., T, W] and nt [..., T]; returns new tensors.

    The reference's two forms: the dense scatter over all D·N positions
    (`cap` None or 0, the default on both devices: on the H100 it beat
    the compaction, see PERF.md), and the changed-token compaction, which
    gathers the changed positions of each chain into `cap` slots and
    scatters only those.  If a chain changed more than `cap` tokens the
    dense form runs: deciding that reads one count back to the host.  The
    scatters are `index_add_` (atomic adds on CUDA), exact in any order."""
    lead, (D, N) = tokens.shape[:-2], tokens.shape[-2:]
    T, W = ntw.shape[-2:]
    B, total = math.prod(lead), D * N
    dev = tokens.device
    changed = (mask * (z_new != z_old).to(mask.dtype)).reshape(B, total)
    cap = min(cap or 0, total)
    if 0 < cap < total and int((changed > 0).sum(-1).max()) <= cap:
        # the changed positions of all chains in B·cap slots; the empty
        # slots carry weight 0 at distinct positions, so that no cell
        # collects a pile of zero updates
        idx = torch.nonzero_static(changed > 0, size=B * cap, fill_value=-1)
        valid = idx[:, 0] >= 0
        slot = torch.arange(B * cap, device=dev)
        at = torch.where(valid, idx[:, 0] * total + idx[:, 1],
                         slot // cap * total + slot % cap)
        wt = valid.to(ntw.dtype)
    else:
        at = torch.arange(B * total, device=dev)
        wt = changed.reshape(-1)
    b = at // total
    w = tokens.reshape(-1)[at].long()
    zo = z_old.reshape(-1)[at].long()
    zn = z_new.reshape(-1)[at].long()
    ntw2 = ntw.reshape(B * T * W).clone()
    ntw2.index_add_(0, (b * T + zo) * W + w, -wt)
    ntw2.index_add_(0, (b * T + zn) * W + w, wt)
    nt2 = nt.reshape(B * T).clone()
    nt2.index_add_(0, b * T + zn, wt)
    nt2.index_add_(0, b * T + zo, -wt)
    return ntw2.reshape(ntw.shape), nt2.reshape(nt.shape)


def topic_occupancy_index(table_t: Tensor, cap: int):
    """Per-word top-`cap` occupied-topic index for the sparse sampler.

    `table_t` is any `[..., W, T]` word-major table (`ntw` transposed for
    training, `phi_t` for prediction).  Returns `(idx, vmask, occm)`:

      * ``idx``   int32 `[..., W, cap]`: the word's top-`cap` topics by
        mass, distinct entries;
      * ``vmask`` f32 `[..., W, cap]`: 1 where the indexed entry carries
        positive mass, 0 for slots past the word's true occupancy;
      * ``occm``  f32 `[..., W, T]`: the 0/1 membership mask of the valid
        indexed topics.

    `cap` is clamped to T.  The sort is stable, as `jnp.argsort` is:
    count tables are full of ties (zeros above all), and an unstable
    sort orders them differently from the reference."""
    *lead, w_dim, t_dim = table_t.shape
    cap = int(min(cap, t_dim))
    idx = torch.argsort(-table_t, dim=-1, stable=True)[..., :cap] \
        .to(torch.int32)
    vals = table_t.gather(-1, idx.long())
    vmask = (vals > 0).to(torch.float32)
    # idx entries are distinct per word, so a scatter equals an add
    occm = torch.zeros(table_t.shape, dtype=torch.float32,
                       device=table_t.device).scatter_(-1, idx.long(), vmask)
    return idx, vmask, occm


def topic_occupancy(table_t: Tensor) -> Tensor:
    """Number of positive-mass topics per word (`[..., W]`)."""
    return (table_t > 0).to(torch.int32).sum(-1, dtype=torch.int32)
