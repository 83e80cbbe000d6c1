"""Serve a model with the paper's prediction-combination rules at the
token level, the port of the reference's `examples/serve_ensemble.py`:
the chains' next-token distributions are combined by Simple Average
(Eq. 7) or Weighted Average (Eq. 9, weights the inverse of each chain's
validation loss), and a chain that misses its deadline is dropped from
the combine by a zero weight, with no pause in the service.

    PYTHONPATH=src python -m repro_torch.serve_ensemble [--device cpu]
        [--seed 0]

prints, as JSON, the shapes of both combined next-token log-probability
tensors and the first slot's argmax token with every chain and with
chain 2 dropped.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import DistConfig
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import ModelConfig, init_params

CFG = ModelConfig(name="serve-demo", n_layers=2, d_model=128, n_heads=4,
                  n_kv_heads=2, d_ff=256, vocab_size=512, rope_theta=1e4)
CHAINS, BATCH, MAX_LEN = 4, 2, 16
# the reference's stand-in validation losses, one a chain
VAL_LOSS = (2.31, 2.27, 2.40, 2.29)
DROPPED = 2


def serve(model, val_loss=VAL_LOSS, dropped=DROPPED) -> dict:
    """One decode step of token 1 in every slot from an empty cache,
    combined three ways: {"simple", "weighted", "cut"} → log-probabilities
    [BATCH, 1, V] (each from a fresh cache: the port writes its caches in
    place), and the first slot's argmax with every chain ("top_full") and
    with chain `dropped` weighted 0 ("top_cut")."""
    dev = model.final_norm.device
    dist = DistConfig(n_chains=CHAINS, compute_dtype="float32")
    weights = 1.0 / torch.tensor(val_loss, dtype=torch.float32, device=dev)
    cut = weights.clone()
    cut[dropped] = 0.0
    toks = torch.ones((CHAINS, BATCH, 1), dtype=torch.int32, device=dev)
    out = {}
    for name, combine, w in (("simple", "simple", None),
                             ("weighted", "weighted", weights),
                             ("cut", "weighted", cut)):
        batch = {"tokens": toks}
        if w is not None:
            batch["chain_weights"] = w
        cache = model.init_cache(BATCH, MAX_LEN, torch.float32)
        out[name], _ = make_decode_step(CFG, dist, combine)(model, cache,
                                                             batch)
    out["top_full"] = int(out["weighted"][0, 0].argmax())
    out["top_cut"] = int(out["cut"][0, 0].argmax())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = init_params(CFG, CHAINS, device=dev, seed=args.seed)
    res = serve(model)
    report = {"simple_shape": list(res["simple"].shape),
              "weighted_shape": list(res["weighted"].shape),
              "top_full": res["top_full"], "top_cut": res["top_cut"]}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
