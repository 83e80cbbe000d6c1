"""Carries the reference's arrays across into the port's objects.

Each function takes the fields of the reference's `Corpus`, `SLDAModel`
or `GibbsState`, or its LM parameter tree or AdamW state, as numpy arrays (or anything
`np.asarray` accepts) in the reference's layouts and returns the port's
object on `device`, so that both packages can compute on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Corpus, GibbsState, SLDAModel
from repro_torch.device import resolve_device
from repro_torch.models.layers import Init
from repro_torch.models.transformer import Transformer, nest


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


def _np_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix, out):
    for key, val in tree.items():
        name = f"{prefix}.{key}"
        if isinstance(val, dict):
            _flatten(val, name, out)
        else:
            out[name] = val


def _lm_state(tree, cfg) -> dict:
    """The reference's LM parameter tree (or a tree of its layout, such as
    the optimizer's m and v) as {the port's parameter name: array}."""
    if "layers_stacked" in tree:
        stacked = {}
        _flatten(tree["layers_stacked"], "", stacked)
        layers = [{k[1:]: np.asarray(a)[i] for k, a in stacked.items()}
                  for i in range(cfg.n_layers)]
    else:
        layers = []
        for lp in tree["layers"]:
            flat = {}
            _flatten(lp, "", flat)
            layers.append({k[1:]: a for k, a in flat.items()})
    state = {"embed": tree["embed"]["table"],
             "final_norm": tree["final_norm"]}
    for top in ("lm_head", "frontend_proj"):
        if top in tree:
            state[top] = tree[top]
    for i, lp in enumerate(layers):
        state.update({f"layers.{i}.{k}": a for k, a in lp.items()})
    if "shared" in tree:                      # the hybrid's shared block
        _flatten(tree["shared"], "shared", state)
    return state


def lm_params_from_numpy(tree, cfg, *, device="cuda",
                         trainable=False) -> Transformer:
    """The port's model from the reference's `init_params` tree (numpy
    leaves, chain axis leading), in the list layout (`layers`: attention
    layers with an MLP or an MoE (`moe.router`, `moe.w_gate` / `w_up` /
    `w_down`, Arctic's `moe.dense.*`), Mamba-2 layers, and the hybrid's
    `shared` block; `frontend_proj`) or the stacked one of `scan_layers`
    (`layers_stacked`, leaves [L, C, ...]), which is unstacked.  The
    weights keep the tree's dtype (the router stays float32);
    `trainable` turns their gradients on."""
    dev = resolve_device(device)
    state = _lm_state(tree, cfg)
    table = _np_tensor(state["embed"])
    model = Transformer(cfg, table.shape[0], table.dtype,
                        init=Init(dev, trainable=trainable))
    model.load_state_dict({k: _np_tensor(a) for k, a in state.items()})
    return model


def opt_state_from_numpy(tree, model: Transformer) -> dict:
    """The reference's AdamW state {"m", "v": trees of its parameter
    tree's layout, "step": int} as the port's (`optim.init_opt_state`'s
    layout: `model.param_tree()`'s, each leaf in the reference's dtype,
    on the model's device)."""
    dev = model.final_norm.device
    names = [name for name, _ in model.named_parameters()]

    def moments(t):
        state = _lm_state(t, model.cfg)
        return nest((n, _np_tensor(state[n]).to(dev)) for n in names)
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": torch.as_tensor(np.array(tree["step"]),
                                    dtype=torch.int32, device=dev)}
