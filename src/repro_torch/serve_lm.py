"""Serve an LM ensemble with the paper's combination rules at the token
level, the counterpart of the reference's `examples/serve_ensemble.py`.

n_chains replicas of one architecture of the port's registry (dense,
MoE such as phi3.5-moe-42b-a6.6b, Mamba-2 such as mamba2-1.3b, the
zamba2-2.7b hybrid, or a stub frontend's internvl2-2b or musicgen-medium;
random weights from --seed) decode a batch of random prompts greedily; at
every step the
chains' next-token distributions are combined by Simple Average (Eq. 7),
Weighted Average (Eq. 9, weights the inverse of each chain's mean
next-token loss on the prompts, from one full forward pass over them) or
not at all (the first chain).

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch qwen3-1.7b]
        [--smoke] [--chains 4] [--slots 8] [--prompt-len 200]
        [--new-tokens 32] [--combine simple|weighted|none]
        [--dtype bf16|f32] [--device cuda|cpu] [--seed 0]

Prints one JSON object: the generated tokens, the prefill time by decode
steps (as the engine primes its cache) and by one fused forward pass over
the prompts (`last_token_only`), the time per decode step and the
generated tokens per second; for MoE, the share of (token, choice) slots
the fused prefill drops at the experts' capacity.  On the card the times
come from CUDA events, on the CPU from the host clock.

A frontend architecture's fused prefill (and the chain weights' forward
pass) takes random embeddings drawn from --seed (vision: [C, b,
n_patches, D] patches prepended; audio: [C, b, s, D] frames added); its
decode steps get tokens only, as the reference's engine's do.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.nn import functional as F

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.moe import moe_drops
from repro_torch.serving import GenerationConfig, ServingEngine
from repro_torch.timing import PhaseTimer

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_model(arch, *, smoke, chains, dtype, device, seed):
    """The model of `arch` for `chains` chains, drawn on a generator on
    `device` seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(get_arch(arch, smoke=smoke), chains, dtype,
                       device=dev, generator=gen)


def make_prompts(vocab_size, slots, prompt_len, seed, device):
    """int32 [slots, prompt_len] random prompts (a CPU generator)."""
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, vocab_size, (slots, prompt_len), generator=g,
                         dtype=torch.int32).to(device)


def make_embeds(cfg, chains, slots, prompt_len, seed, device):
    """A frontend's random precomputed embeddings (a CPU generator seeded
    from `seed`), standard normal: vision [chains, slots, n_patches, D],
    audio [chains, slots, prompt_len, D]; None without a frontend."""
    if cfg.frontend == "none":
        return None
    n = cfg.n_patches if cfg.frontend == "vision" else prompt_len
    g = torch.Generator().manual_seed(seed + 2)
    return torch.randn((chains, slots, n, cfg.d_model), generator=g).to(
        device)


def inverse_loss_weights(model, prompts, dtype, embeds=None):
    """Eq. 9's chain weights: the inverse of each chain's mean next-token
    cross-entropy on the prompts."""
    toks = prompts[None].expand((model.n_chains,) + tuple(prompts.shape))
    logits = model(toks, embeds, compute_dtype=dtype)[:, :, :-1]
    target = toks[:, :, 1:].long()
    loss = torch.stack([
        F.cross_entropy(logits[c].reshape(-1, logits.shape[-1]).float(),
                        target[c].reshape(-1))
        for c in range(model.n_chains)])
    return 1.0 / loss


def serve(args) -> dict:
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    model = build_model(args.arch, smoke=args.smoke, chains=args.chains,
                        dtype=dtype, device=dev, seed=args.seed)
    prompts = make_prompts(model.cfg.vocab_size, args.slots,
                           args.prompt_len, args.seed, dev)
    embeds = make_embeds(model.cfg, args.chains, args.slots,
                         args.prompt_len, args.seed, dev)
    weights = (inverse_loss_weights(model, prompts, dtype, embeds)
               if args.combine == "weighted" else None)
    engine = ServingEngine(
        model, batch_slots=args.slots,
        max_len=args.prompt_len + args.new_tokens,
        gen=GenerationConfig(max_new_tokens=args.new_tokens,
                             combine=args.combine),
        chain_weights=weights, compute_dtype=dtype)
    toks = prompts[None].expand((args.chains,) + tuple(prompts.shape))

    def fused_prefill():
        return model(toks, embeds, compute_dtype=dtype, last_token_only=True)

    with moe_drops(model) as drops:
        fused_prefill()                  # warm-up: builds the kernels
    timer = PhaseTimer(dev)
    out = engine.generate(prompts, timer=timer)
    with timer("fused_prefill"):
        fused_prefill()
    ms = timer.ms()
    steps = sum(1 for phase, _, _ in timer.spans if phase == "decode")
    return {"arch": model.cfg.name, "device": str(dev),
            "chains": args.chains, "slots": args.slots,
            "prompt_len": args.prompt_len, "new_tokens": steps,
            "combine": args.combine, "dtype": args.dtype,
            "tokens": out.tolist(), "prefill_ms": ms["prefill"],
            "fused_prefill_ms": ms["fused_prefill"],
            "decode_ms_per_step": ms["decode"] / steps,
            "tokens_per_s": args.slots * steps / (ms["decode"] / 1e3),
            "moe_drop_share": sum(drops) / len(drops) if drops else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small smoke configuration")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=200)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--combine", default="simple",
                    choices=("simple", "weighted", "none"))
    ap.add_argument("--dtype", default="bf16", choices=tuple(DTYPES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    res = serve(ap.parse_args(argv))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
