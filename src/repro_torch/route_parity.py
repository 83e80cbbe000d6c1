"""The LM kernels' route against their plain versions, in float32.

`plain_route(*kernels)` swaps the named wrappers (B5 `flash_attention`,
B6 `ssd_scan`, B7 `rmsnorm`; all three by default) for their plain
versions on the card.  `route_gaps` builds one model from a seed and
holds the kernel route against the plain route over 200-token prompts:
forward, 8 decode steps, and the fused prefill's last logits against
prefill by decode steps (both on the kernel route).  Each gap is read
against the rule of the CPU tests' `_close_logits`, elementwise

    |got - want| <= tol * max(1, rms(want)) + tol * |want|,

and reported as `need`, the least tol for which it holds.

    PYTHONPATH=src python -m repro_torch.route_parity [--seeds 0 1 2 3]

runs qwen3-1.7b cut to 2 layers, mamba2-1.3b cut to 2 and zamba2-2.7b cut
to 12 (two applications of the shared block), at full width, 4 chains and
8 slots, for each seed: with every kernel, and with B6 alone and B7 alone
on the kernel route (the others plain), and the plain route's own move
under NOISE on its embeddings.  Prints one JSON line a model and
seed, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess

import torch

KERNELS = ("B5", "B6", "B7")
# the relative noise of `main`'s sensitivity reading: about one float32
# rounding (2^-24 to 2^-23 relative)
NOISE = 1e-7


def kernel_modules():
    """The LM kernels' wrapper modules, by kernel."""
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    return {"B5": flash_attention, "B6": ssd_scan, "B7": rmsnorm}


@contextlib.contextmanager
def plain_route(*kernels):
    """Inside the block the named kernels' `*_cuda` wrappers (all three
    when none is named) run their plain versions, so they launch
    nothing."""
    from repro_torch.kernels import ref
    plain = {
        "B5": ("flash_attention_cuda",
               lambda q, k, v, *, causal=True, kv_len=None:
               ref.ref_attention(q, k, v, causal=causal, kv_len=kv_len)),
        "B6": ("ssd_scan_cuda",
               lambda x, dt, A, B, C, *, chunk=64:
               ref.ref_ssd_chunked(x, dt, A, B, C, chunk=chunk)),
        "B7": ("rmsnorm_cuda",
               lambda x, w, *, eps=1e-6: ref.ref_rmsnorm(x, w, eps)),
    }
    mods = kernel_modules()
    saved = {}
    for k in kernels or KERNELS:
        name, fn = plain[k]
        saved[k] = getattr(mods[k], name)
        setattr(mods[k], name, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(mods[k], plain[k][0], fn)


def need(got, want):
    """(the least tol for which every element of `got` lies within
    tol·max(1, rms(want)) + tol·|want| of `want`, max |got - want|, the
    position (axis 2) of the element that sets the first)."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.square().mean().sqrt()))
    diff = (got - want).abs()
    ratio = diff / (scale + want.abs())
    at = int(ratio.argmax())
    pos = (at // (ratio.shape[3] if ratio.dim() > 3 else 1)) % ratio.shape[2]
    return float(ratio.max()), float(diff.max()), pos


def route_gaps(cfg, seed, dev, *, kernels=KERNELS, full=True, noise=None):
    """`cfg` with random weights from `seed`, float32, 4 chains, 8 slots,
    200-token prompts.  The kernel route runs the named kernels (the
    others plain) against the plain route; `full` adds the 8 decode steps
    and the fused prefill against prefill by decode steps; `noise` adds
    how far the plain route's forward moves when the embedding table is
    scaled by 1 + noise·N(0, 1) elementwise.  Returns a dict of each
    comparison's `need` reading, the plain forward logits' rms, the
    kernel route's launches in its forward, and the plain route's
    launches in all."""
    from repro_torch import serve_lm
    from repro_torch.models import init_params

    f32, C, S, P = torch.float32, 4, 8, 200
    mods = kernel_modules()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, C, f32, device=dev, generator=gen)
    toks = serve_lm.make_prompts(cfg.vocab_size, S, P, seed, dev)[None] \
        .expand(C, S, P)
    others = tuple(k for k in KERNELS if k not in kernels)

    def count(fn, route):
        for m in mods.values():
            m.launches = 0
        with route:
            out = fn()
        return out, {k: m.launches for k, m in mods.items()}

    def forward():
        return model(toks, compute_dtype=f32)

    def decode(n):
        cache = model.init_cache(S, 256, f32)
        outs = []
        for t in range(n):
            lg, cache = model.decode_step(cache, toks[:, :, t:t + 1],
                                          compute_dtype=f32)
            outs.append(lg)
        return torch.cat(outs, 2)

    kernel_route = (lambda: plain_route(*others)) if others else \
        contextlib.nullcontext
    fwd, fwd_launches = count(forward, kernel_route())
    want, plain_launches = count(forward, plain_route())
    out = {"arch": cfg.name, "layers": cfg.n_layers, "seed": seed,
           "kernels": list(kernels),
           "plain_logit_rms": float(want.square().mean().sqrt()),
           "forward": need(fwd, want), "forward_launches": fwd_launches}
    del fwd
    if noise:
        saved = model.embed.clone()
        model.embed.mul_(1 + noise * torch.randn(
            saved.shape, device=dev, generator=gen))
        moved, _ = count(forward, plain_route())
        model.embed.copy_(saved)
        out["plain_under_noise"] = need(moved, want)
        del saved, moved
    del want
    if full:
        dec, _ = count(lambda: decode(8), kernel_route())
        dec_plain, more = count(lambda: decode(8), plain_route())
        out["decode8"] = need(dec, dec_plain)
        del dec, dec_plain
        plain_launches = {k: v + more[k] for k, v in plain_launches.items()}
        with kernel_route():
            fused = model(toks, compute_dtype=f32, last_token_only=True)
            out["fused_vs_decode_prefill"] = need(fused, decode(P)[:, :, -1:])
    out["plain_route_launches"] = sum(plain_launches.values())
    return out


def main() -> None:
    from repro_torch.configs import mamba2_1_3b, qwen3_1_7b, zamba2_2_7b
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    a = ap.parse_args()
    dev = resolve_device("cuda")
    models = [dataclasses.replace(qwen3_1_7b.CONFIG, n_layers=2)]
    models += [dataclasses.replace(cfg, n_layers=n, layer_pattern="M" * n)
               for cfg, n in ((mamba2_1_3b.CONFIG, 2),
                              (zamba2_2_7b.CONFIG, 12))]
    for cfg in models:
        for seed in a.seeds:
            row = route_gaps(cfg, seed, dev, noise=NOISE)
            for alone in ("B6", "B7"):
                if row["forward_launches"][alone]:
                    row[f"forward_{alone}_alone"] = route_gaps(
                        cfg, seed, dev, kernels=(alone,),
                        full=False)["forward"]
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
