"""The random draws of a run, as explicit tensors.

The plan functions take their random numbers as arguments — the initial
topics, the per-sweep uniforms or per-launch document seeds of training,
the initial topics and per-document seeds of prediction — so that tests
can hand in the reference's own draws.  For a standalone run every chain
gets its own `torch.Generator` on the run's device (Philox on a CUDA
device), seeded from (seed, stream, chain): a chain's draws do not
depend on how many chains run beside it.  A length-bucketed run takes
the padded run's draws, at the source corpus's max_len (`ctr_stride`),
and its plan carves them along the schedule: nothing draws at a bucket's
width, so bucketed and padded runs draw the same numbers per document.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1

# the streams a run draws from (one generator per chain in each); a
# supervised run's EM rounds and its fresh re-inits draw from streams of
# their own (`core.supervisor`)
TRAIN, PREDICT, PREDICT_TRAIN, SUPERVISED_ROUND, FRESH_INIT = 0, 1, 2, 3, 4


def generator(device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from the integers `words`."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def chain_generators(seed: int, m: int, device, stream: int = TRAIN):
    """One generator per chain, seeded from (seed, stream, chain)."""
    return [generator(device, seed, stream, c) for c in range(m)]


def _stack(gens, draw):
    return torch.stack([draw(g) for g in gens])


def train_draws(gens, n_docs: int, max_len: int, n_topics: int,
                n_iters: int, sweeps_per_launch: int = 1):
    """(z_init int32 [M, D, N], draws): the initial topics and an iterator
    over the draws of the EM loop, made lazily.  At sweeps_per_launch=1
    that is one uniform tensor f32 [M, D, N] per sweep (n_iters of them);
    above, one seed tensor int32 [M, D] in [0, 2^31 - 1) per fused launch
    (⌈n_iters / sweeps_per_launch⌉ of them, the remainder launch
    included), as the reference draws them."""
    z_init = init_topics(gens, n_docs, max_len, n_topics)
    return z_init, em_draws(gens, n_docs, max_len, n_iters,
                            sweeps_per_launch)


def init_topics(gens, n_docs: int, max_len: int, n_topics: int):
    """The initial topics int32 [M, D, N], uniform over the topics."""
    dev = gens[0].device
    return _stack(gens, lambda g: torch.randint(
        0, n_topics, (n_docs, max_len), generator=g, device=dev,
        dtype=torch.int32))


def em_draws(gens, n_docs: int, max_len: int, n_iters: int,
             sweeps_per_launch: int = 1):
    """An iterator over the draws of `n_iters` EM iterations, made lazily
    (`train_draws`)."""
    dev = gens[0].device
    if sweeps_per_launch > 1:
        return (_stack(gens, lambda g: torch.randint(
            0, INT32_MAX, (n_docs,), generator=g, device=dev,
            dtype=torch.int32))
            for _ in range(-(-n_iters // sweeps_per_launch)))
    return (_stack(gens, lambda g: torch.rand((n_docs, max_len), generator=g,
                                              device=dev))
            for _ in range(n_iters))


def predict_draws(gens, n_docs: int, max_len: int, n_topics: int):
    """(z0 int32 [M, D, N], seeds int32 [M, D]) of one prediction pass:
    the seeds lie in [0, 2^31 - 1), as the reference draws them."""
    dev = gens[0].device
    z0 = _stack(gens, lambda g: torch.randint(
        0, n_topics, (n_docs, max_len), generator=g, device=dev,
        dtype=torch.int32))
    seeds = _stack(gens, lambda g: torch.randint(
        0, INT32_MAX, (n_docs,), generator=g, device=dev, dtype=torch.int32))
    return z0, seeds
