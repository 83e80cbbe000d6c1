"""The benchmark's corpora: drawn from the sLDA generative process on the
device, from the run's seed.

Frozen copy of `repro_torch.data.synthetic.make_slda_corpus` and
`train_test_split` at commit 025a0b2, with one change: the draws come
from a generator on the corpus's device (Philox on the card) and are made
there, in a few large calls, so that set-up stays short.  The same seed
gives the same corpus on the same device; the program and the plain
reference are handed that one corpus.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _generator(seed: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, 0x636F7270]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def _log_gamma(g, a: float, size, device) -> torch.Tensor:
    """log of Gamma(a, 1) draws, float64 (Marsaglia–Tsang; shapes a < 1
    boosted by U^(1/a) in log space)."""
    boost = a < 1.0
    b = a + 1.0 if boost else a
    d = b - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(size)
    out = torch.empty(n, dtype=torch.float64, device=device)
    pending = torch.arange(n, device=device)
    while pending.numel():
        k = pending.numel()
        x = torch.randn(k, generator=g, dtype=torch.float64, device=device)
        v = (1.0 + c * x) ** 3
        u = torch.rand(k, generator=g, dtype=torch.float64, device=device)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v))
        out[pending[ok]] = math.log(d) + torch.log(v[ok])
        pending = pending[~ok]
    if boost:
        out += torch.log(torch.rand(n, generator=g, dtype=torch.float64,
                                    device=device)) / a
    return out.reshape(size)


def _dirichlet(g, conc: float, rows: int, k: int, device):
    return torch.softmax(_log_gamma(g, conc, (rows, k), device), dim=-1)


def make_corpus(seed: int, c: dict, device):
    """(tokens int32 [D, N], mask float32 [D, N], y float32 [D]) of the
    configuration `c` (its keys n_docs, vocab_size, n_topics, doc_len,
    alpha, beta, rho, label_type and the generator's phi_concentration,
    eta_scale, doc_len_dist, len_sigma, len_skew)."""
    g = _generator(seed, device)
    D, W, T, N = c["n_docs"], c["vocab_size"], c["n_topics"], c["doc_len"]
    phi = _dirichlet(g, c["beta"] * c["phi_concentration"], T, W,
                     device).to(torch.float32)
    eta = torch.randn(T, generator=g, device=device) * c["eta_scale"]
    theta = _dirichlet(g, c["alpha"], D, T, device)
    z = torch.multinomial(theta, N, replacement=True, generator=g)
    cdf = torch.cumsum(phi, dim=-1)
    u = torch.rand(D * N, generator=g, device=device)
    by_topic = torch.searchsorted(cdf, u.expand(T, -1).contiguous())
    tokens = by_topic.gather(0, z.reshape(1, -1)).reshape(D, N)
    tokens = tokens.clamp(max=W - 1).to(torch.int32)
    pos = torch.arange(N, device=device)[None, :]
    if c["doc_len_dist"] == "lognormal":
        gl = torch.randn(D, generator=g, device=device)
        lens = torch.exp(math.log(N / c["len_skew"]) + c["len_sigma"] * gl)
        lens = torch.round(lens).clamp(min(4, N), N)
    elif c["doc_len_dist"] == "uniform":
        lens = torch.randint(N // 2, N + 1, (D,), generator=g,
                             device=device)
    else:
        raise ValueError(f"doc_len_dist {c['doc_len_dist']!r}")
    mask = (pos < lens[:, None]).to(torch.float32)
    nd = mask.sum(-1).clamp(min=1.0)
    cnt = torch.zeros((D, T), device=device).scatter_add_(1, z, mask)
    noise = torch.randn(D, generator=g, device=device)
    y = (cnt / nd[:, None]) @ eta + math.sqrt(c["rho"]) * noise
    if c["label_type"] == "binary":
        y = (y > torch.quantile(y, 0.5)).to(torch.float32)
    return tokens, mask, y.to(torch.float32)


def split(corpus, n_train: int):
    """(train, test): the first n_train documents and the rest."""
    return (tuple(a[:n_train] for a in corpus),
            tuple(a[n_train:] for a in corpus))
