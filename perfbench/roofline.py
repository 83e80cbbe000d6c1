"""The yardstick of the rooflines and of `fit_mfu`: the card's peaks and
the work a fit needs, counted from shapes and real tokens.

The peaks and the operations per topic are frozen from `chip_smoke.py`
at commit 025a0b2 (`PEAK_FP32_S`, `PEAK_BYTES_S`, `OPS_PER_TOPIC`,
`bound_ms`).  The counts are of what the algorithm needs, not of the
variant that ran: one training sweep costs `OPS_TRAIN` float32
operations per topic per real token (the product form's), one prediction
sweep `OPS_PREDICT`; each input byte is counted once and each output
byte once, with token arrays at their real tokens.  A kernel that does
the same work another way is read against the same work.
"""
from __future__ import annotations

# published peaks of one H100 SXM (dense): non-tensor float32, HBM3
PEAK_FP32_S = 67e12
PEAK_BYTES_S = 3.35e12
# float32 operations per topic per real token per sweep.  Training (B3's
# product form): remove, +α, −old, +β, ×, −old, +Wβ, ÷, the Gaussian
# term's six operations, max, −max, exp, ×, scan add, compare, add back.
# Prediction (B1): remove, +α, ×φ, scan add, compare, add back, select.
OPS_TRAIN = 21
OPS_PREDICT = 7
F32 = I32 = 4


def least_s(n_ops: float, n_bytes: float) -> tuple:
    """(seconds, "operations" or "bytes"): the least time the card could
    take, the larger of the two bounds, and which bounds it."""
    by_ops, by_bytes = n_ops / PEAK_FP32_S, n_bytes / PEAK_BYTES_S
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def train_work(w: dict) -> tuple:
    """(operations, bytes) of a fit's training sweeps: `w` holds T, W,
    chains, train_docs, train_real_tokens, n_iters, launches.  A launch
    reads the tokens, topics, per-document seeds, labels, 1/lengths and
    doc-topic counts and each chain's table, nt and η, and writes the
    topics and the doc-topic counts."""
    T, W, M = w["T"], w["W"], w["chains"]
    ops = OPS_TRAIN * T * w["train_real_tokens"] * w["n_iters"]
    per_launch = (w["train_real_tokens"] * (I32 + I32 + I32)
                  + w["train_docs"] * (I32 + F32 + F32 + 2 * T * F32)
                  + M * (W * T + 2 * T) * F32)
    return ops, per_launch * w["launches"]


def predict_work(w: dict) -> tuple:
    """(operations, bytes) of a fit's prediction pass: every chain
    predicts the shared corpus of predict_docs documents and
    predict_real_tokens real tokens over pred_sweeps sweeps.  It reads
    the tokens once, each chain's initial topics, seeds, doc-topic counts
    and φ̂, and writes each chain's topics and mean doc-topic counts."""
    T, W, M = w["T"], w["W"], w["chains"]
    ops = (OPS_PREDICT * T * w["predict_real_tokens"] * M
           * w["pred_sweeps"])
    n_bytes = (w["predict_real_tokens"] * I32
               + M * w["predict_real_tokens"] * (I32 + I32)
               + M * w["predict_docs"] * (I32 + 2 * T * F32)
               + M * W * T * F32)
    return ops, n_bytes
