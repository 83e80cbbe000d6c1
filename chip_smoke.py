#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA card and holds its kernels
against their plain versions.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; needs one CUDA card, builds the kernels
from the sources in the checkout, and exits non-zero if any phase fails
(or if there is no card, or no `src/repro_torch` beside this file).
Phases, one JSON line each:

  env            card, power limit, torch and CUDA versions; TF32 off
  build          nvcc build of every kernel source, its time and ptxas use
  counter_hash   the kernels' counter hash bit-equal to the torch version
  B1 / B2 / B3   each kernel against its plain version at the slice's
                 shapes and at T = 128 (B3 also in log form): draw
                 mismatch over real tokens, exact counts, times, bound
  end_to_end     the paper's four algorithms at the slice's configuration
                 (`repro_torch.fig6_mdna`) through their entry points,
                 with the kernels' launch counts over that run
  end_to_end_fused  the same at sweeps_per_launch = 8 (kernel B3)
  profile        one Simple Average run under torch.profiler, at each of
                 the two settings: device busy time, idle share and the
                 kernels that take it

then the kernels line, the card line from nvidia-smi, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

# published peaks of one H100 SXM (dense): HBM3 bytes/s, non-tensor fp32
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# float32 operations per topic per real token per sweep: B1 (remove, +α,
# ×φ, scan add, compare, add back, masked select); B2 and B3's log form
# (the same plus three logs, one exp, the Gaussian response term and the
# max); B3's product form (remove, +α, −old, +β, ×, −old, +Wβ, ÷, the
# Gaussian term's six operations, max, −max, exp, ×, scan add, compare,
# add back)
OPS_PER_TOPIC = {"B1": 7, "B2": 25, "B3_log": 25, "B3_product": 21}
MISMATCH_MAX = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description="port smoke test on one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import fig6_mdna
    from repro_torch.core import (ALGORITHMS, apply_count_deltas,
                                  counts_from_assignments, partition)
    from repro_torch.device import resolve_device
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import (build, ref, slda_gibbs, slda_predict,
                                     slda_train)
    from repro_torch.kernels.prng import counter_uniform

    dev = resolve_device("cuda")       # raises if TF32 were on
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "matmul_precision": torch.get_float32_matmul_precision()})

    # ---- build
    build.load("slda_predict")
    ptxas = [ln.strip() for ln in build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build.build_info["seconds"],
          "directory": build.build_info["directory"], "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    int32 = dict(dtype=torch.int32, device=dev, generator=gen)

    # ---- counter hash, bit for bit
    n = 1 << 20
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), **int32)
    ctrs = torch.cat([
        torch.arange(n // 4, dtype=torch.int32, device=dev),
        torch.randint(-2 ** 31, 2 ** 31 - 1, (n // 4,), **int32),
        torch.randint(int(2 ** 31 / 1.618033988749895), 2 ** 31 - 1,
                      (n - n // 2,), **int32)])
    got = slda_predict.counter_uniform_cuda(seeds, ctrs)
    want = counter_uniform(seeds, ctrs)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    emit({"phase": "counter_hash", "pairs": n, "mismatches": bad})
    check(bad == 0, "counter hash differs from the torch version")

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def bound_ms(tensors, n_ops, extra_bytes=0):
        nbytes = extra_bytes + sum(t.numel() * t.element_size()
                                   for t in tensors)
        by_bytes, by_ops = nbytes / PEAK_BYTES_S, n_ops / PEAK_FP32_S
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    train, test = fig6_mdna.make_data(args.seed, dev)
    T0, W = fig6_mdna.N_TOPICS, fig6_mdna.VOCAB
    M, cfg = fig6_mdna.M, fig6_mdna.CFG
    rows = {}

    def rand_table(m, t):
        """A peaked random topic-word table [m, t, W], rows summing to 1."""
        p = torch.rand((m, t, W), device=dev, generator=gen) ** 8 + 1e-6
        return p / p.sum(-1, keepdim=True)

    # ---- B1: prediction, shared corpus (the weighted pass: test + train)
    both = torch.cat([test.tokens, train.tokens]), \
        torch.cat([test.mask, train.mask])
    for label, t, d in (("slice", T0, both[0].shape[0]), ("T128", 128, 256)):
        tokens, mask = both[0][:d].contiguous(), both[1][:d].contiguous()
        phi_t = rand_table(M, t).transpose(1, 2).contiguous()
        z0 = torch.randint(0, t, (M,) + tuple(tokens.shape), **int32)
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **int32)
        ndt0, _, _ = counts_from_assignments(
            tokens.expand(M, -1, -1), mask.expand(M, -1, -1), z0, t, W)
        real = float(mask.sum()) * M
        one = dict(alpha=cfg.alpha, n_burnin=0, n_samples=1)
        avg_k, z_k = slda_predict.slda_predict_sweeps_cuda(
            tokens, mask, sd, z0, ndt0, phi_t, **one)
        avg_p, z_p = ref.slda_predict_sweeps_chains(
            tokens, mask, sd, z0, ndt0, phi_t, **one)
        mis = float(((z_k != z_p) & (mask > 0)).sum()) / real
        err = float((avg_k - avg_p).abs().max())
        recount, _, _ = counts_from_assignments(
            tokens.expand(M, -1, -1), mask.expand(M, -1, -1), z_k, t, W)
        exact = bool(torch.equal(recount, avg_k))
        full = dict(alpha=cfg.alpha, n_burnin=cfg.n_pred_burnin,
                    n_samples=cfg.n_pred_samples)
        avg_f, _ = slda_predict.slda_predict_sweeps_cuda(
            tokens, mask, sd, z0, ndt0, phi_t, **full)
        lens = mask.sum(-1).expand(M, -1)
        row_err = float(((avg_f.sum(-1) - lens).abs()
                         / lens.clamp(min=1)).max())
        ms = event_ms(lambda: slda_predict.slda_predict_sweeps_cuda(
            tokens, mask, sd, z0, ndt0, phi_t, **full), 5)
        plain = event_ms(lambda: ref.slda_predict_sweeps_chains(
            tokens, mask, sd, z0, ndt0, phi_t, **full), 1)
        steps = real * (cfg.n_pred_burnin + cfg.n_pred_samples)
        b_ms, b_by = bound_ms([tokens, mask, sd, z0, ndt0, phi_t, avg_f,
                               z_k], OPS_PER_TOPIC["B1"] * t * steps)
        row = {"phase": "B1", "shape": label, "M": M, "D": d,
               "N": tokens.shape[1], "T": t, "W": W,
               "real_tokens": real, "draw_mismatch": mis,
               "one_sweep_max_abs_err": err, "counts_exact": exact,
               "row_sum_rel_err": row_err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.setdefault("B1", row)
        check(mis <= MISMATCH_MAX, f"B1 {label}: draw mismatch {mis}")
        check(exact, f"B1 {label}: ndt differs from counts of z")
        check(row_err <= 1e-4, f"B1 {label}: ndt_avg rows off by {row_err}")

    # ---- B2: one training sweep, chain-sharded corpus
    for label, t, docs in (("slice", T0, train.n_docs), ("T128", 128, 1024)):
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        z = torch.randint(0, t, tuple(sh.tokens.shape), **int32)
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=gen) * 2.0
        u = torch.rand(tuple(sh.tokens.shape), device=dev, generator=gen)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        a = (sh.tokens, sh.mask, u, z, ndt, sh.y, inv_len, ntw_t, nt, eta)
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                  supervised=True)
        z_k, ndt_k = slda_gibbs.slda_gibbs_sweep_cuda(*a, **kw)
        z_p, ndt_p = ref.ref_slda_gibbs_sweep_chains(*a, **kw)
        real = float(sh.mask.sum())
        mis = float(((z_k != z_p) & (sh.mask > 0)).sum()) / real
        err = float((ndt_k - ndt_p).abs().max())
        recount, _, _ = counts_from_assignments(sh.tokens, sh.mask, z_k, t,
                                                W)
        exact = bool(torch.equal(recount, ndt_k))
        ms = event_ms(lambda: slda_gibbs.slda_gibbs_sweep_cuda(*a, **kw), 20)
        plain = event_ms(lambda: ref.ref_slda_gibbs_sweep_chains(*a, **kw),
                         2)
        b_ms, b_by = bound_ms(list(a) + [z_k, ndt_k],
                              OPS_PER_TOPIC["B2"] * t * real)
        row = {"phase": "B2", "shape": label, "M": M, "D": d,
               "N": sh.max_len, "T": t, "W": W, "real_tokens": real,
               "draw_mismatch": mis, "max_abs_err": err,
               "counts_exact": exact, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.setdefault("B2", row)
        check(mis <= MISMATCH_MAX, f"B2 {label}: draw mismatch {mis}")
        check(exact, f"B2 {label}: ndt differs from counts of z")

    # ---- B3: fused training launches, chain-sharded corpus
    for label, t, docs, sweeps, product in (
            ("slice", T0, train.n_docs, 8, True),
            ("T128", 128, 1024, 8, True),
            ("slice_log", T0, train.n_docs, 2, False)):
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        z = torch.randint(0, t, tuple(sh.tokens.shape), **int32)
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=gen) * 2.0
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **int32)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        db = build_plan(sh, cfg).train_doc_block(d)
        a = (sh.tokens, sh.mask, sd, z, ndt, sh.y, inv_len, ntw_t, nt, eta)
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                  n_sweeps=sweeps, doc_block=db, supervised=True,
                  product_form=product)
        z_k, ndt_k = slda_train.slda_train_sweeps_cuda(*a, **kw)
        z_p, ndt_p = ref.slda_train_sweeps_chains(*a, **kw)
        real = float(sh.mask.sum())
        mis = float(((z_k != z_p) & (sh.mask > 0)).sum()) / real
        err = float((ndt_k - ndt_p).abs().max())
        recount, ntw_k, nt_k = counts_from_assignments(sh.tokens, sh.mask,
                                                       z_k, t, W)
        exact = bool(torch.equal(recount, ndt_k))
        # the EM boundary's refresh from (z, z_k), dense and compacted
        # (nonzero_static on the card), against the counts of z_k
        refresh_exact = all(
            torch.equal(got, want) for cap in (0, d * sh.max_len - 1)
            for got, want in zip(apply_count_deltas(
                ntw, nt, sh.tokens, sh.mask, z, z_k, cap=cap),
                (ntw_k, nt_k)))
        ms = event_ms(lambda: slda_train.slda_train_sweeps_cuda(*a, **kw),
                      10)
        plain = event_ms(lambda: ref.slda_train_sweeps_chains(*a, **kw), 1)
        copies = M * -(-d // db)            # one private table per block
        form = "B3_product" if product else "B3_log"
        b_ms, b_by = bound_ms(list(a) + [z_k, ndt_k],
                              OPS_PER_TOPIC[form] * t * real * sweeps,
                              extra_bytes=copies * W * t * 4)
        row = {"phase": "B3", "shape": label, "M": M, "D": d,
               "N": sh.max_len, "T": t, "W": W, "doc_block": db,
               "sweeps": sweeps, "product_form": product,
               "real_tokens": real, "draw_mismatch": mis,
               "max_abs_err": err, "counts_exact": exact,
               "refresh_exact": refresh_exact, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.setdefault("B3", row)
        check(mis <= MISMATCH_MAX, f"B3 {label}: draw mismatch {mis}")
        check(exact, f"B3 {label}: ndt differs from counts of z")
        check(refresh_exact, f"B3 {label}: count refresh differs")

    # ---- end to end: the four algorithms through their entry points, at
    # one sweep per launch (B2) and at eight (B3); each run's launch
    # counts are zeroed just before it and read just after
    fused = dataclasses.replace(cfg, sweeps_per_launch=8)
    counted = {}
    for phase, run_cfg, want in (
            ("end_to_end", cfg, {"B1": 4, "B2": 4 * cfg.n_iters, "B3": 0}),
            ("end_to_end_fused", fused, {"B1": 4, "B2": 0, "B3": 16})):
        fig6_mdna.run(args.seed, dev, data=(train, test),
                      cfg=run_cfg)                           # warm-up
        slda_gibbs.launches = slda_predict.launches = 0
        slda_train.launches = 0
        res = fig6_mdna.run(args.seed, dev, data=(train, test), cfg=run_cfg)
        torch.cuda.synchronize()
        launches = {"B1": slda_predict.launches, "B2": slda_gibbs.launches,
                    "B3": slda_train.launches}
        counted[phase] = launches
        emit({"phase": phase, "card": smi,
              "sweeps_per_launch": run_cfg.sweeps_per_launch,
              "launches": launches, **res})
        mse = {k: v["test_mse"] for k, v in res["algorithms"].items()}
        var_y = res["var_y_test"]
        check(launches == want, f"{phase}: launch counts {launches}")
        check(all(v == v and abs(v) != float("inf") for v in mse.values()),
              f"{phase}: non-finite test MSE {mse}")
        for name in ("nonparallel", "simple", "weighted"):
            check(mse[name] < 0.6 * var_y,
                  f"{phase}: {name} MSE {mse[name]} >= 0.6 var(y) "
                  f"{0.6 * var_y}")
        check(mse["naive"] > mse["simple"],
              f"{phase}: naive not worse than simple {mse}")

    # ---- where the time goes: one simple-average run under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # device kernels only: an operator's row repeats its kernels' time
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    for run_cfg in (cfg, fused):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ALGORITHMS["simple"](args.seed + 1, train, test, run_cfg, M,
                                 device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
        busy_ms = sum(dev_us(e) for e in ops) / 1e3
        emit({"phase": "profile", "algorithm": "simple",
              "sweeps_per_launch": run_cfg.sweeps_per_launch,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_idle_share": 1.0 - busy_ms / wall_ms if ops else None,
              "top_kernels": [{"name": e.key[:70], "calls": e.count,
                               "ms": dev_us(e) / 1e3} for e in ops[:8]]})

    # each kernel's launches in the run of the path it carries
    sources = {"B1": ("slda_predict_sweeps", "slda_predict.cu",
                      "src/repro/kernels/slda_predict.py:119", "end_to_end"),
               "B2": ("slda_gibbs_sweep", "slda_gibbs.cu",
                      "src/repro/kernels/slda_gibbs.py:31", "end_to_end"),
               "B3": ("slda_train_sweeps", "slda_train.cu",
                      "src/repro/kernels/slda_train.py:99",
                      "end_to_end_fused")}
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": rep,
        "launches": counted[path][k],
        "max_abs_err": rows[k].get("max_abs_err",
                                   rows[k].get("one_sweep_max_abs_err")),
        "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
        "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
        "library_ms": None}
        for k, (name, src, rep, path) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
