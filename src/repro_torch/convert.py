"""Carries the reference's arrays across into the port's objects.

Each function takes the fields of the reference's `Corpus`, `SLDAModel`
or `GibbsState` as numpy arrays (or anything `np.asarray` accepts) in the
reference's layouts and returns the port's object on `device`, so that
both packages can compute on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Corpus, GibbsState, SLDAModel
from repro_torch.device import resolve_device


def _t(a, dtype, dev):
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def corpus_from_numpy(tokens, mask, y, *, device="cuda") -> Corpus:
    dev = resolve_device(device)
    return Corpus(tokens=_t(tokens, torch.int32, dev),
                  mask=_t(mask, torch.float32, dev),
                  y=_t(y, torch.float32, dev))


def model_from_numpy(phi, eta, train_mse, train_acc, *,
                     device="cuda") -> SLDAModel:
    dev = resolve_device(device)
    return SLDAModel(*(_t(a, torch.float32, dev)
                       for a in (phi, eta, train_mse, train_acc)))


def state_from_numpy(z, ndt, ntw, nt, eta, *, device="cuda") -> GibbsState:
    dev = resolve_device(device)
    return GibbsState(z=_t(z, torch.int32, dev),
                      **{k: _t(a, torch.float32, dev) for k, a in
                         (("ndt", ndt), ("ntw", ntw), ("nt", nt),
                          ("eta", eta))})
