"""Train a ~100M-parameter LM with communication-free chain parallelism
and checkpoints, then serve it with the paper's prediction combination
(Simple Average, Eq. 7): the counterpart of the reference's
`examples/train_lm_100m.py`.

    PYTHONPATH=src python -m repro_torch.train_lm_100m [--steps 300]
        [--tiny] [--chains 2] [--batch 4] [--seq 128] [--ckpt-dir DIR]
        [--device cuda|cpu]

Training runs the plain route under autograd (`DistConfig(use_kernels=
False)`), as the reference trains; the served decode steps run the
kernels on the card.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import DistConfig
from repro_torch.launch.steps import make_decode_step, make_train_step
from repro_torch.launch.train import make_lm_batch
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import OptConfig, init_opt_state

LM_100M = ModelConfig(
    name="lm-100m", n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=2048, vocab_size=32000, rope_theta=1e4,
)   # ≈ 107M params

TINY = dataclasses.replace(LM_100M, name="lm-tiny", n_layers=2, d_model=128,
                           n_heads=4, n_kv_heads=2, d_ff=256,
                           vocab_size=1024)


def run(cfg, *, steps, chains, batch, seq, device, ckpt_dir=None,
        decode_tokens=8):
    """Train `chains` chains of `cfg` for `steps` steps, then decode
    `decode_tokens` greedy tokens from token 0 with the chains' Simple
    Average.  Returns (the per-chain loss history [steps, chains], the
    decoded tokens of slot 0)."""
    dev = resolve_device(device)
    train_dist = DistConfig(n_chains=chains, compute_dtype="float32",
                            use_kernels=False, remat=False)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=max(5, steps // 20),
                        total_steps=steps)
    model = init_params(cfg, chains, device=dev, trainable=True,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt_state = init_opt_state(model.param_tree(), opt_cfg)
    step_fn = make_train_step(cfg, train_dist, opt_cfg)
    manager = CheckpointManager(ckpt_dir, interval=50) if ckpt_dir else None
    history = []
    for step in range(steps):
        b = make_lm_batch(0, step, cfg, chains, batch, seq, dev)
        model, opt_state, metrics = step_fn(model, opt_state, b)
        history.append(metrics["loss"].cpu().numpy())
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:4d}  loss/chain {np.round(history[-1], 3)}")
        if manager:
            manager.maybe_save(step + 1, {"params": model.param_tree(),
                                          "opt": opt_state})

    # ---- serving with the paper's ensemble combine (Eq. 7)
    model.requires_grad_(False)
    decode = make_decode_step(cfg, dataclasses.replace(
        train_dist, use_kernels=True), combine="simple")
    cache = model.init_cache(batch, max_len=32, dtype=torch.float32)
    toks = torch.zeros((chains, batch, 1), dtype=torch.int32, device=dev)
    out = []
    for _ in range(decode_tokens):
        logits, cache = decode(model, cache, {"tokens": toks})
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)          # [b, 1]
        toks = nxt[None].expand(chains, batch, 1).contiguous()
        out.append(int(nxt[0, 0]))
    return np.stack(history), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = TINY if args.tiny else LM_100M
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.chains} communication-free chains")
    _, out = run(cfg, steps=args.steps, chains=args.chains, batch=args.batch,
                 seq=args.seq, device=args.device, ckpt_dir=args.ckpt_dir)
    print("ensemble-decoded tokens (batch 0):", out)


if __name__ == "__main__":
    main()
