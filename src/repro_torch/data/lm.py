"""LM-side data: a deterministic synthetic token stream, the reference's
`data.lm`.

Real deployments plug a tokenized dataset in here; the interface is a
plain iterator of {tokens, targets} dicts, so the training loop does not
care where tokens come from.  The stream is drawn by numpy from a
generator keyed by (seed, step), so it restarts at any step, and its
tokens are bit for bit the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def synthetic_lm_batch(seed: int, step: int, batch: int, seq_len: int,
                       vocab_size: int) -> dict:
    """One LM batch keyed by (seed, step): int32 tokens and targets
    [batch, seq_len] (the targets the tokens shifted by one), on the
    CPU."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    toks = rng.integers(0, vocab_size, (batch, seq_len + 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "targets": torch.from_numpy(toks[:, 1:].copy())}


def lm_batch_iterator(seed: int, batch: int, seq_len: int, vocab_size: int,
                      start_step: int = 0):
    """Infinite (step, batch) iterator; `start_step` resumes mid-stream."""
    step = start_step
    while True:
        yield step, synthetic_lm_batch(seed, step, batch, seq_len, vocab_size)
        step += 1
