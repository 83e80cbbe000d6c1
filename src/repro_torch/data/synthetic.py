"""Synthetic corpora drawn from the sLDA generative process itself.

The paper's two datasets (SEC 10-K MD&A and Kaggle IMDB reviews) are
regenerated synthetically at the paper's published dimensions (Section
IV-A): since its claims are about the sampler, sampling the data from the
model the sampler assumes is the right oracle.

The draws come from a CPU `torch.Generator` seeded with `seed`, so one
seed names the same corpus on every device; the result is then moved to
`device`.  The generator is not the reference's (`jax.random`), so the
corpora differ from the reference's draw for draw and agree in
distribution.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import Corpus
from repro_torch.device import resolve_device


def _log_gamma(g: torch.Generator, a: float, size) -> torch.Tensor:
    """log of Gamma(a, 1) draws, float64 (Marsaglia–Tsang; shapes a < 1
    are boosted by U^(1/a) in log space so tiny draws do not underflow)."""
    boost = a < 1.0
    b = a + 1.0 if boost else a
    d = b - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(size)
    out = torch.empty(n, dtype=torch.float64)
    pending = torch.arange(n)
    while pending.numel():
        k = pending.numel()
        x = torch.randn(k, generator=g, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        u = torch.rand(k, generator=g, dtype=torch.float64)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v))
        out[pending[ok]] = math.log(d) + torch.log(v[ok])
        pending = pending[~ok]
    if boost:
        out += torch.log(torch.rand(n, generator=g, dtype=torch.float64)) / a
    return out.reshape(size)


def _dirichlet(g: torch.Generator, conc: float, rows: int, k: int):
    """`rows` draws of a symmetric Dirichlet(conc) over k categories,
    float64, normalized in log space."""
    return torch.softmax(_log_gamma(g, conc, (rows, k)), dim=-1)


def make_slda_corpus(seed: int, n_docs: int, vocab_size: int,
                     n_topics: int, doc_len: int, *,
                     alpha: float = 0.1, beta: float = 0.01,
                     phi_concentration: float = 1.0,
                     rho: float = 0.25, eta_scale: float = 2.0,
                     label_type: str = "continuous",
                     var_len: bool = True,
                     doc_len_dist: str = "uniform",
                     len_sigma: float = 0.75,
                     len_skew: float = 4.0,
                     device="cuda") -> tuple[Corpus, torch.Tensor]:
    """Sample a corpus from the sLDA generative process (Section III-B).

    Returns (corpus, true_eta).  Same parameters as the reference:
    φ_t ~ Dir(β·phi_concentration), θ_d ~ Dir(α), z ~ θ_d, w ~ φ_z,
    y_d = ηᵀz̄_d + √ρ·ε; binary labels threshold y at its median.
    doc_len_dist "uniform" draws lengths in [doc_len//2, doc_len] when
    var_len (else all doc_len); "lognormal" draws
    LogNormal(log(doc_len/len_skew), len_sigma) clipped to [4, doc_len].
    """
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    phi = _dirichlet(g, beta * phi_concentration, n_topics,
                     vocab_size).to(torch.float32)               # [T, V]
    eta = torch.randn(n_topics, generator=g) * eta_scale
    theta = _dirichlet(g, alpha, n_docs, n_topics)               # [D, T]
    z = torch.multinomial(theta, doc_len, replacement=True,
                          generator=g)                           # [D, N]
    # per-topic inverse CDF with one shared uniform per token: [T, D·N]
    # ints, never a [D, N, V] tensor
    cdf = torch.cumsum(phi, dim=-1)
    u = torch.rand(n_docs * doc_len, generator=g)
    by_topic = torch.searchsorted(cdf, u.expand(n_topics, -1).contiguous())
    tokens = by_topic.gather(0, z.reshape(1, -1)).reshape(n_docs, doc_len)
    tokens = tokens.clamp(max=vocab_size - 1).to(torch.int32)

    pos = torch.arange(doc_len)[None, :]
    if doc_len_dist == "lognormal":
        gl = torch.randn(n_docs, generator=g)
        lens = torch.exp(math.log(doc_len / len_skew) + len_sigma * gl)
        lens = torch.round(lens).clamp(min(4, doc_len), doc_len)
        mask = (pos < lens[:, None]).to(torch.float32)
    elif var_len:
        lens = torch.randint(doc_len // 2, doc_len + 1, (n_docs,),
                             generator=g)
        mask = (pos < lens[:, None]).to(torch.float32)
    else:
        mask = torch.ones((n_docs, doc_len), dtype=torch.float32)

    nd = mask.sum(-1).clamp(min=1.0)
    counts = torch.zeros((n_docs, n_topics)).scatter_add_(1, z, mask)
    noise = torch.randn(n_docs, generator=g)
    y = (counts / nd[:, None]) @ eta + math.sqrt(rho) * noise
    if label_type == "binary":
        y = (y > torch.quantile(y, 0.5)).to(torch.float32)
    corpus = Corpus(tokens=tokens, mask=mask, y=y.to(torch.float32))
    return corpus.to(dev), eta.to(dev)


def shuffle_corpus(seed: int, corpus: Corpus) -> Corpus:
    """The corpus with its documents in a random order drawn from `seed`."""
    perm = torch.randperm(corpus.n_docs,
                          generator=torch.Generator().manual_seed(seed))
    return corpus.map(lambda x: x[perm.to(x.device)])


def train_test_split(corpus: Corpus, n_train: int) -> tuple[Corpus, Corpus]:
    return (corpus.map(lambda x: x[:n_train]),
            corpus.map(lambda x: x[n_train:]))
