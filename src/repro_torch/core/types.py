"""Core datatypes for sLDA and its embarrassingly parallel runner.

Small dataclasses of tensors, in the reference's layouts: counts are kept
in float32 (small integers, exact below 2^24), topic-word tables are
`[T, W]` with a leading chain dim `[M, T, W]` where chains are batched.
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SLDAConfig:
    """Hyperparameters of supervised LDA (McAuliffe & Blei 2008 notation).

    Same fields and defaults as the reference's `SLDAConfig`.  This port
    runs the padded path, one sweep per launch (`sweeps_per_launch=1`,
    kernel B2) or several (kernel B3), with the dense draw or the sparse
    two-stage draw (`sampler_mode="sparse"`, over each word's top
    `sparse_topic_cap` topics, clamped to T); ragged buckets raise until
    the ROADMAP item that brings them lands.  `use_pallas` is accepted
    and ignored: the tensors' device decides between the CUDA kernels and
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
        if self.length_buckets > 0:
            raise NotImplementedError(
                "length_buckets > 0 (ragged execution) comes with ROADMAP "
                "queue A item 8")
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
