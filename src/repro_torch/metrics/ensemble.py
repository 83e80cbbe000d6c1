"""Chain-ensemble health.

Communication-free chains never synchronize, so operators need a cheap
signal for (a) a diverging or NaN chain that should be dropped from the
combine, and (b) ensemble collapse (chains too similar to gain from
ensembling).  Both come from per-chain numbers on a small probe batch,
evaluated out of band.  `robust_z` is also the supervisor's in-loop
train-MSE probe (`core.supervisor.chain_status`), so it runs on the
tensors' device with no host synchronization.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _as_f32(values, device) -> torch.Tensor:
    """`values` as float32: a tensor stays on its device, anything else
    goes to `device` (the card unless the caller asks for the CPU)."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.float32)
    return torch.as_tensor(values, dtype=torch.float32,
                           device=resolve_device(device))


_MEDIAN_TABLES: dict = {}


def _median_tables(m: int, device):
    """(idx int64 [m + 1, 2], w float32 [m + 1, 2]): for n non-NaN values
    sorted first, the positions lo, hi and weights 1 − h, h with which
    the linear-interpolation quantile forms their median, lo·(1 − h) +
    hi·h at q = (n − 1)/2, h = q − ⌊q⌋, in float32, the positions
    clamped to [0, n − 1] (to 0 at n = 0, where the value read is NaN)."""
    key = (m, str(device))
    if key not in _MEDIAN_TABLES:
        idx = np.zeros((m + 1, 2), np.int64)
        w = np.zeros((m + 1, 2), np.float32)
        for n in range(m + 1):
            q = np.float32(0.5) * np.float32(n - 1)
            lo, hi = np.floor(q), np.ceil(q)
            hw = np.float32(q - lo)
            top = max(n - 1, 0)
            idx[n] = [min(max(int(lo), 0), top), min(max(int(hi), 0), top)]
            w[n] = [np.float32(1.0) - hw, hw]
        _MEDIAN_TABLES[key] = (torch.from_numpy(idx).to(device),
                               torch.from_numpy(w).to(device))
    return _MEDIAN_TABLES[key]


def nanmedian(v: torch.Tensor) -> torch.Tensor:
    """The median of the non-NaN entries of a 1-D tensor of finite values
    and NaN, as a 0-d tensor: the mean of the two middle values at an
    even count, NaN when every entry is NaN.  `torch.nanmedian` returns
    the lower middle value, so this follows the linear-interpolation
    quantile instead, with its float32 rounding (`_median_tables`).  A
    few device operations and no host read: the supervisor's probe runs
    it at every EM boundary."""
    v = v.reshape(-1)
    s = torch.sort(v).values                       # NaN sorts last
    n = (v == v).sum().reshape(1)
    idx, w = _median_tables(v.numel(), v.device)
    return (s[idx.index_select(0, n)[0]] * w.index_select(0, n)[0]).sum()


def chain_divergence(logits) -> torch.Tensor:
    """Mean pairwise symmetric KL between chains' token distributions:
    logits [C, ..., V] → [C, C]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    p = torch.exp(logp)
    c, v = p.shape[0], p.shape[-1]
    pf, lf = p.reshape(c, -1), logp.reshape(c, -1)
    kl = -(pf @ lf.T) + (pf * lf).sum(-1)[:, None]
    kl = kl / (p.numel() // (c * v))
    return 0.5 * (kl + kl.T)


def robust_z(values, valid=None, *, rel_floor: float = 0.0,
             device="cuda") -> torch.Tensor:
    """Robust z-scores (median / MAD) of a 1-D statistic.

    Non-finite entries, and entries masked out by the optional `valid`
    (> 0 keeps), are excluded from the location and scale (`nanmedian`
    over the valid subset) and come back as +inf, so downstream
    `z < cut` tests treat them as maximal outliers.  `rel_floor` clamps
    the scale to at least `rel_floor · |median|`: with a handful of
    near-identical values the MAD degenerates to about 0 and rounding
    jitter would become an outlier.  A tensor `values` keeps its device;
    other input goes to `device`."""
    v = _as_f32(values, device)
    ok = torch.isfinite(v)
    if valid is not None:
        ok = ok & (torch.as_tensor(valid, device=v.device) > 0)
    vals = torch.where(ok, v, float("nan"))
    med = nanmedian(vals)
    mad = nanmedian((vals - med).abs())
    scale = torch.maximum(mad * 1.4826, med.abs() * rel_floor) + 1e-9
    z = (v - med) / scale
    return torch.where(ok & torch.isfinite(z), z, float("inf"))


def ensemble_health(per_chain_loss, logits=None, *, loss_z_cut: float = 4.0,
                    collapse_kl: float = 1e-3, device="cuda"):
    """Returns (alive [C] float mask, report dict).

    A chain is dead if its probe loss is non-finite or further than
    `loss_z_cut` robust z-scores above the chain median (diverged).
    `collapsed` flags an ensemble whose surviving chains are nearly
    identical (median pairwise KL below `collapse_kl`); it reads the
    alive count and the KL back to the host."""
    loss = _as_f32(per_chain_loss, device)
    z = robust_z(loss)
    alive = (torch.isfinite(loss) & (z < loss_z_cut)).to(torch.float32)
    report = {"loss": loss, "z": z, "alive": alive, "collapsed": False}
    if logits is not None and int(alive.sum()) >= 2:
        kl = chain_divergence(logits.to(loss.device))
        c = kl.shape[0]
        mask = (alive[:, None] * alive[None, :]
                * (1 - torch.eye(c, device=kl.device)))
        med_kl = nanmedian(torch.where(mask > 0, kl,
                                       torch.full_like(kl, float("nan"))))
        report["median_pairwise_kl"] = med_kl
        report["collapsed"] = bool(med_kl < collapse_kl)
    return alive, report
