"""The LM trainer with communication-free chain parallelism,
checkpoint/restart and per-chain metrics, the reference's
`launch.train`.

Training runs every kernel's plain version under autograd
(`DistConfig(use_kernels=False)`, as the reference trains with
`use_pallas=False`): the CUDA kernels have no backward.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        [--full] [--steps 50] [--batch 8] [--seq 64] [--chains 2] \\
        [--ckpt-dir DIR] [--resume] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_elastic)
from repro_torch.configs import get_arch
from repro_torch.data import synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.metrics import MetricLogger, ensemble_health
from repro_torch.models import init_params
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.tree import leaves_with_paths, map_with_paths
from .sharding import DistConfig
from .steps import make_train_step


def make_lm_batch(seed, step, cfg, n_chains, batch, seq, device="cpu"):
    """Per-chain disjoint data shards (the paper's partition step): chain
    c draws from the stream at seed + 7919·c, so no two chains see the
    same batch.  A frontend's embeddings (vision [C, b, n_patches, D],
    audio [C, b, seq, D], standard normal) come from a torch generator
    keyed by (seed, step)."""
    parts = [synthetic_lm_batch(seed + 7919 * c, step, batch, seq,
                                cfg.vocab_size) for c in range(n_chains)]
    out = {k: torch.stack([p[k] for p in parts]).to(device)
           for k in ("tokens", "targets")}
    if cfg.frontend != "none":
        n = cfg.n_patches if cfg.frontend == "vision" else seq
        g = torch.Generator().manual_seed(seed * 1_000_003 + step)
        out["embeds"] = torch.randn((n_chains, batch, n, cfg.d_model),
                                    generator=g).to(device)
    return out


def _state(model, opt_state):
    return {"params": model.param_tree(), "opt": opt_state}


def train(arch: str, *, smoke=True, steps=50, batch=8, seq=64, chains=2,
          lr=3e-4, seed=0, ckpt_dir=None, save_interval=20, resume=False,
          accum=1, compute_dtype="float32", log_every=10,
          schedule_steps=None, metrics_path=None, device="cuda",
          model=None):
    """Train `chains` independent chains of `arch` for `steps` steps.
    Returns (the model, the optimizer state, the per-chain loss history
    [steps run, chains]).

    `model` is a trainable model to start from (by default one drawn on a
    generator on `device` seeded with `seed`).  With `resume` and a
    checkpoint under `ckpt_dir`, the run continues from its newest step
    (a checkpoint of either package): chains it lacks start fresh, and
    the step counter is a scalar again.  `schedule_steps` keeps the
    learning-rate schedule fixed across restarts."""
    cfg = get_arch(arch, smoke=smoke)
    dev = resolve_device(device)
    dist = DistConfig(n_chains=chains, accum_steps=accum,
                      compute_dtype=compute_dtype, use_kernels=False,
                      remat=False)
    sched = schedule_steps or steps
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, sched // 10),
                        total_steps=sched)

    def fresh(n, s):
        return init_params(cfg, n, seed=s, device=dev, trainable=True,
                           generator=torch.Generator(device=dev)
                           .manual_seed(s))

    if model is None:
        model = fresh(chains, seed)
    opt_state = init_opt_state(model.param_tree(), opt_cfg)
    start = 0

    manager = CheckpointManager(ckpt_dir, save_interval) if ckpt_dir \
        else None
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        step0 = latest_step(ckpt_dir)

        def init_chain(i):
            """A chain the checkpoint lacks: fresh, its own seed."""
            one = fresh(1, seed * 1_000_003 + i + 1)
            return map_with_paths(
                lambda _, x: x[0] if x.ndim else x,
                _state(one, init_opt_state(one.param_tree(), opt_cfg)))

        state, info = restore_elastic(ckpt_dir, step0,
                                      _state(model, opt_state), init_chain)
        with torch.no_grad():
            for (_, p), (_, q) in zip(leaves_with_paths(model.param_tree()),
                                      leaves_with_paths(state["params"])):
                p.copy_(q)
        opt_state = state["opt"]
        # the step counter must be a scalar again after chain stacking
        opt_state["step"] = opt_state["step"].max()
        start = step0
        print(f"resumed at step {step0}, chains restored: "
              f"{info['restored_chains']}")

    step_fn = make_train_step(cfg, dist, opt_cfg)
    logger = MetricLogger(metrics_path)
    history = []
    for step in range(start, steps):
        batch_tree = make_lm_batch(seed, step, cfg, chains, batch, seq, dev)
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch_tree)
        loss = metrics["loss"].cpu().numpy()
        step_s = time.perf_counter() - t0
        history.append(loss)
        alive, _ = ensemble_health(metrics["loss"])
        alive = alive.cpu().numpy()
        logger.log(step, loss=loss,
                   grad_norm=metrics["grad_norm"].cpu().numpy(),
                   alive=alive, step_s=step_s)
        if step % log_every == 0 or step == steps - 1:
            note = "" if float(alive.sum()) == chains else \
                f"  [!] dead chains: {np.where(alive == 0)[0]}"
            print(f"step {step:5d}  loss/chain "
                  f"{np.array2string(loss, precision=3)}  "
                  f"({step_s:.2f}s){note}")
        if manager:
            manager.maybe_save(step + 1, _state(model, opt_state))
    return model, opt_state, np.stack(history) if history else \
        np.zeros((0, chains), np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-interval", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, chains=args.chains, lr=args.lr, seed=args.seed,
          ckpt_dir=args.ckpt_dir, save_interval=args.save_interval,
          resume=args.resume, accum=args.accum, device=args.device)


if __name__ == "__main__":
    main()
