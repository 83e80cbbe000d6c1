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
                 (B1's and B2's kernels' registers and spills apart;
                 every sampler kernel's spills, none allowed in the
                 kernels of SPILL_FREE_KERNELS), and the count of
                 HGMMA (wgmma) instructions in B5's machine code and of
                 HMMA or HGMMA in B6's (there must be some)
  counter_hash   the kernels' counter hash bit-equal to the torch version
  B1 / B2 / B3   each kernel against its plain version at the slice's
                 shapes and at T = 128 and 512 (B3 also in log form): draw
                 mismatch over real tokens, exact counts, times, bound;
                 each row names the variant the main path runs (B1 lane
                 or warp, B2 half_warp or warp, B3 cluster) and runs, on
                 the same inputs, the variant it replaced (B1 and B2
                 warp, B3 block: `replaced_ms`; their draws and counts
                 must be equal), with the critical path (real tokens of
                 the longest walk × sweeps, and ns a step) of both, B1
                 the lane layout's time, B3 the cluster size; B1 and B2
                 also with the profiler's device time of both variants
                 (`device_us`, `replaced_device_us`) and at the slice's
                 chain 0 alone (`slice_one_chain`: a quarter of the
                 warps, so its step against the slice's tells latency
                 from issue); B1 also at one chain over the test
                 documents (`test_one_chain`, Nonparallel's and Naive's
                 predict launch); B3 held sweep by sweep: sweep k of the
                 kernel (its launch of k sweeps) against the plain version
                 handed the kernel's own state after k − 1 sweeps (z,
                 ndt, the launch-start and block-local tables) and sweep
                 k's uniforms, k = 1..8, each within the bound
                 (`sweep_mismatch`; the 8-sweep comparison from the start,
                 where one draw at a rounding edge spreads through its doc
                 block, is reported as `fused_mismatch`); the T = 512 rows
                 in both forms, also against a plain version whose
                 Σ_t η_t·N_dt is one torch reduction
                 (`torch_sum_sweep_mismatch`, ROADMAP C5)
  B3_parting     B3 against its plain version after 1, 2, .. 8 sweeps at
                 T = 128 on four fresh inputs: mismatched tokens after
                 each (one draw at a rounding edge spreads through its doc
                 block in later sweeps); one sweep within the bound
  B1_sparse / B2_sparse / B3_sparse
                 each kernel's sparse-draw instantiation (kernel B4
                 inside it) against its plain version, at the slice's
                 shape with the default cap (clamped to T) and with cap 4,
                 and at T = 128 and 512 with cap 32: draw mismatch, exact
                 counts, the share of real tokens that took stage 2 (from
                 the plain version), the sparse and the dense kernel's
                 times on the same inputs, plain time, bound, and as the
                 dense rows the main path's variant (B1 lane, B2
                 half_warp, B3 cluster with two groups a warp at T <= 16),
                 the replaced kernel (B1 and B2 warp, B3 block; draws and
                 counts equal) and the critical path; B3_sparse held
                 sweep by sweep as B3
  B4             the sparse draw alone against its plain version, on the
                 rows of one training sweep (T = 16, cap 4) and at T = 128
                 and 512 (cap 32): each form's mismatch, time by events
                 and device time by the profiler (lane, half_warp and
                 warp at T <= 16), the records packed on the card equal
                 to the plain packing, the packing's times
  small_shapes   B1, B2 and B3, dense and sparse, against their plain
                 versions at small shapes over T = 3, 16, 40, 128, 256 and
                 512 (T off the 16- and 32-topic grids, K = 1, 2, 4, 8,
                 16); where B1's or B2's main-path variant is not the warp
                 one, its draws and counts against the warp variant's
  prefix_order   at each shape [R, T] the plain draws' prefix sums took in
                 the rows above (the dense draw's and the sparse draw's
                 three), the rows of random weights that
                 `mathutil.prefix_sum` sums out of left-to-right order (the
                 kernels' order; a gate: none), and beside them, reported,
                 those that one GEMM p @ triu(T) does
  end_to_end     the paper's four algorithms at the slice's configuration
                 (`repro_torch.fig6_mdna`) through their entry points,
                 with the kernels' launch counts over that run, B1's and
                 B2's by variant (every dense launch lane / half_warp)
  end_to_end_fused  the same at sweeps_per_launch = 8 (kernel B3, every
                 launch on its cluster variant, counted by variant)
  end_to_end_sparse  the same with sampler_mode="sparse", at
                 sweeps_per_launch 1 and 8: every launch a sparse one, on
                 the main path's variant
  sparse_T512    one Simple Average run at sweeps_per_launch 8 on the
                 slice's corpus with T = 512, dense and sparse (cap 32):
                 train and predict ms, test MSE (finite), launch counts
  end_to_end_binary  the four algorithms at Figure 7's configuration
                 (`repro_torch.fig7_imdb`: 25,000 documents, binary labels)
                 at sweeps_per_launch 1 and 8, dense, and sparse at 8: test
                 accuracy beside the majority class's rate, phase times,
                 launch counts by variant; Nonparallel, Simple and Weighted
                 at or above BINARY_ACC_MIN, Naive below Simple
  end_to_end_ragged  the four algorithms over the padded corpus against
                 8 length buckets (`length_buckets`), at the slice at spl
                 1 (dense and sparse) and 8 and at Figure 7 at spl 8; the
                 bucketed run with the plan's choice of streams
                 (`plan._streams_for`) and with the other choice for every
                 launch: each schedule's widths, counts and padding,
                 train / predict ms of every form and which launches went
                 on streams, launches by variant (a launch a bucket: per
                 sweep for B2, per launch for B3, per pass for B1, all on
                 the main path's variants); at spl 1 every algorithm's ŷ
                 bit for bit the padded run's, at spl 8 the padded
                 phases' MSE or accuracy gates, and the swapped streams'
                 ŷ the plan's
  ragged_small_buckets  B1, B2 and B3 (sweep by sweep, at the plan's doc
                 block) against their plain versions over 1 to 8 documents
                 a chain, the tail bucket's shape, dense and sparse
  supervised     training under `core.supervisor` at the slice's full
                 scale, spl 1 and 8 dense and 8 sparse, rounds of 5 EM
                 iterations, a checkpoint at each round's start
                 (`supervised_phase`): the health probe leaves z, ndt and
                 η bit for bit and adds no host sync to a round; chain 1
                 with NaN η is restarted twice, then quarantined, the
                 survivors' ŷ bit-equal to a clean run's; chain 2 killed
                 comes back from the round's checkpoint, every chain alive
                 and the MSE gate met; corrupt counts flagged; every B1–B3
                 launch on the main path's variant; train ms with the
                 probe on and off, the store's save, async accept and
                 restore ms reported
  slda_serving   the sLDA prediction service (`repro_torch.serving`:
                 fixed-slot micro-batches, one captured CUDA graph a
                 bucket signature and sampler mode) on two rows, `mdna`
                 (the slice's Weighted Average ensemble, its test
                 documents as traffic) and `bench_shape` (the reference's
                 serving benchmark: T 32, M 8, lengths to 256), each a
                 closed-loop trace of 512 requests with 25% verbatim
                 repeats (`serving_phase`): every request served ok; one
                 capture after the first flush and none after; results
                 bit-equal to an eager twin's and the padded layout's;
                 `mdna`'s served MSE under 0.6·var(y_test); the sparse
                 mode one more capture (finite, the MSE gate), back to
                 dense none; drop / revive, hot reload, a torn checkpoint
                 and NaN η at dispatch exact and capturing nothing;
                 reported: a flush's replay, in-turn replay and eager ms
                 by CUDA events, host ms a flush, latencies, docs/s,
                 dummy share, layout, B1 and B4 launches
  parallel       the multi-process runner (`repro_torch.launch.
                 slda_parallel`) at the slice's full scale, spl 1 and 8
                 dense and 8 sparse, M = 4 (`parallel_phase`): (a) world
                 size 1 under NCCL in this process, 4 chains a rank; (b)
                 4 ranks of one chain sharing the card under gloo,
                 spawned, `file://` rendezvous; gates: every rank's
                 gathered predictions bit-equal to one process's chain
                 batch with the same seed and ŷ to its combine (Simple,
                 Weighted), no collective counted in training and one
                 gather after it, no NCCL kernel in a profile of (a)'s
                 training, a NaN chain in one rank auto-quarantined and
                 ŷ the survivors' combine bit for bit, 8 length buckets
                 at spl 1 bit-equal to padded, each rank's B1–B3
                 launches (counted in the rank); reported: each rank's
                 train / predict / gather ms and start-up seconds
  elastic        the elastic runner (`repro_torch.launch.elastic`) at the
                 slice, spl 1 dense and 8 sparse, rounds of 5 EM
                 iterations, a simulated pool of 2 devices, asynchronous
                 checkpoints (`elastic_phase`): undisturbed runs equal
                 over pools of 1, 2 and 4; a device loss restored and
                 caught up bit for bit; without checkpoints quarantined
                 with the survivors lane-equal; preempt then resume
                 equal; a straggler flagged then evicted; asynchronous
                 and synchronous checkpoints the same bits; one round
                 plan a run; `elastic_run_average`'s MSE gate; reported:
                 each wall round's ms and its checkpoint's, launches
  profile       one Simple Average run under torch.profiler, at each of
                 the two settings and sparse at 8, then over 8 length
                 buckets at the slice at spl 1 and 8 and Figure 7 at 8
                 beside Figure 7 padded: device busy time, idle share,
                 B3's share of the busy time, the B1–B3 kernels' time and
                 the kernels that take it (for sparse, also where the
                 topic-index build's kernels rank)
  B5             the attention kernel against its plain version, bf16 and
                 f32 (`B5_SHAPES`): qwen3-1.7b's prefill (B 32, Hq 16 /
                 Hkv 8, Dh 128, Sq = Sk = 200 and 512) and decode (Sq 1,
                 Sk 256, kv_len over 1–256 per row, the tail poisoned),
                 zamba2-2.7b's shared block (Hq = Hkv = 32, Dh 80; prefill
                 200 and decode 256), a GQA 4:1 prefill at Dh 64, and
                 small shapes (MQA, Sq < Sk, non-causal, and a decode whose
                 kv_len includes 0: that row is NaN in both, and NaN
                 equals NaN): the variant that ran, error, times (CUDA
                 events back to back; `device_us` by the profiler, with
                 `device_us_kept` the calls its trace kept of 10;
                 `host_us` on the host's clock) beside the replaced
                 kernel's (the cuda_cores variant on the same inputs) and
                 SDPA's (the yardstick), bound
  B7             the RMSNorm kernel against its plain version at the
                 decode step's shapes ([4, 8, 2048], [4, 8·16, 128],
                 [4, 8·8, 128], mamba2's [4, 8, 4096]) and the prefill's
                 ([4, 8·200, 2048], [4, 8·200·16, 128], [4, 8·200,
                 4096]), bf16 and f32 (`B7_SHAPES`): variant, error,
                 `err_f64` and `plain_err_f64` (the kernel's and the plain
                 version's max error against a float64 RMSNorm of the same
                 inputs), times as B5's beside the two_pass variant's and
                 F.rms_norm's, bound
  lm_parity      qwen3-1.7b at full width cut to 2 layers, f32, 4 chains,
                 8 slots: the kernel route against the plain route for
                 forward over a 200-token prompt and for 8 decode steps,
                 and the fused prefill's last logits against prefill by
                 decode steps, within 2e-3 on the logits' scale (atol
                 2e-3·max(1, their rms), rtol 2e-3, as the CPU tests)
  lm_serve       qwen3-1.7b at full width and depth, bf16, 4 chains, 8
                 slots, 200-token prompts, 32 greedy tokens, Simple
                 Average, through `ServingEngine.generate`: prefill and
                 decode times, tokens/s, peak memory, the kernels' launch
                 counts (B5's by variant: decode in every step, the
                 tensor cores in the fused prefill), and on the first
                 decode step the kernel route's logits against the plain
                 route's
  lm_profile     three of lm_serve's decode steps under torch.profiler:
                 device busy time, the idle share against lm_serve's
                 unprofiled step, the kernels that take it
  B6             the SSD scan kernel against its plain version, bf16 and
                 f32 (`B6_SHAPES`), at mamba2-1.3b's fused prefill (C 4,
                 b 8, s 200 and 512, H 64, P 64, N 128), zamba2-2.7b's (H
                 80, N 64), the reference's small grid, one step, chunks
                 that do not divide s, against the sequential oracle, and
                 where the masked exponent overflows: the variant that ran
                 (`ssd_scan.variant`: tensor_cores for bf16), error,
                 `err_f64` and `plain_err_f64` (against a float64 scan of
                 the same inputs), finiteness, times beside the replaced
                 kernel's (the cuda_cores variant on the same inputs), the
                 CUDA cores' bound (`f32_bound_ms`) and the tensor
                 cores' (`tc_bound_ms`), `bound_ms` the one of the
                 variant that ran; no PyTorch call computes it
  ssm_parity     mamba2-1.3b at full width cut to 2 layers, and
  hybrid_parity  zamba2-2.7b at full width cut to 12 layers (two
                 applications of the shared block), as lm_parity, with
                 each forward's launch counts; zamba2's kernel route
                 within 0.05 of its plain route (HYBRID_ROUTE_TOL)
  ssm_serve      mamba2-1.3b at full width and depth as lm_serve, with
                 Weighted Average: its chain weights from one full forward
                 over the prompts (48 B6 launches), then generate (none),
                 then the fused prefill (48, every one on the tensor
                 cores)
  ssm_profile    three of ssm_serve's decode steps, as lm_profile
  moe_serve      phi3.5-moe-42b-a6.6b at full width cut to 4 of 32
                 layers, bf16, 4 chains, as lm_serve (`zoo_phases`): B5 at
                 its GQA group of 4 and B7 at D 4096 against their plain
                 versions, then the served run with the fused prefill's
                 MoE drop share, then `zoo_parity` (float32, 1 layer, 2
                 chains): the first decode step's logits, kernel route
                 against plain route, within LM_PARITY_TOL
  arctic_serve   arctic-480b at full width cut to 1 of 35 layers, 2
                 chains: B5 at its group of 7 and B7 at D 7168, the served
                 run, then `zoo_parity` (float32, 1 chain)
  frontend_serve internvl2-2b and musicgen-medium at full width and depth,
                 bf16, 4 chains: B5 at the vision prefill's S = 456 and at
                 musicgen's Dh 64 with a group of 1, B7 at their widths;
                 internvl2 served as lm_serve, its fused prefill with 256
                 patches prepended; musicgen's prefill and 32 tokens
                 through `launch.steps.make_decode_step` (Simple
                 Average), each step with its frame's embedding; each
                 model's `zoo_parity` (float32, 2 chains: the forward with
                 its embeddings and the first decode step)
  lm_train       qwen3-1.7b at full width and depth trained on the plain
                 route (`launch.steps.make_train_step`): 2 chains, float32
                 parameters and compute, bf16 AdamW state, 2 × 128 tokens
                 a chain, 4 steps; gates: finite per-chain loss and
                 gradient norm, no kernel launched; reported: step ms,
                 tokens/s, peak memory, 6·N·tokens a step against the
                 float32 peak; then at the smoke config
                 (`launch.train.train`) 10 steps straight bit-equal, loss
                 by loss, to 6, a restart from the checkpoint and 4 more,
                 and accum_steps=2 within 1e-4 of one batch
  (each of the last four frees the one before it and reports its seconds
  and peak memory)
  sharded        the multi-device half on this card, under a world-1 NCCL
                 group and `launch.mesh.make_host_mesh` (1 × 1): (a)
                 qwen3-1.7b at full width and depth, bf16, lm_serve's
                 traffic (4 chains, 8 slots, a 200-token prompt primed on
                 plain tensors by the kernels), then 8 decode steps on
                 the plain route with weights and cache as DTensors placed by
                 `launch.sharding`'s rules, logits bit-equal to the same
                 steps on plain tensors, 0 collectives, ms a step of both;
                 (b) one training step at TRAIN_SHAPE on DTensors: loss,
                 per-chain gradient norm and every updated weight
                 bit-equal to the plain step, 0 collectives; (c) the
                 dry-run (`launch.dryrun`, fake tensors) of (b)'s cell and
                 of decode_32k cut to 1 chain and 8 slots (a 32,768-token
                 cache), each held to one real step: FLOPs equal to
                 `FlopCounterMode`'s, argument bytes equal to the real
                 tensors', the predicted peak within SHARDED_PEAK_TOL of
                 `max_memory_allocated`, the roofline terms beside the
                 measured ms; no kernel launched (SHARDED_BUDGET_S)

then the kernels line, the card line from nvidia-smi, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
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
# the dense draw's share of those: the scan add and the compare
DENSE_DRAW_OPS = 2
# the kernels (fragments of their mangled names) that the build phase
# requires without spills: every B1 and B2 kernel (each variant, dense and
# sparse, K = 1 to 16 slots), B4 alone in each form, the record packing,
# B3's half-warp cluster kernels, and B3's kernels at K = 12 and 16 (T up
# to 512, 8-warp CTAs).  B3's 16- and 32-warp kernels at K <= 8 have 128
# or 64 registers a thread by their CTA size; their spills are reported.
SPILL_FREE_KERNELS = (
    "predict_", "gibbs_", "sparse_draw_", "pack_topic_index_kernel",
    "train_cluster_kernelILi1ELi16ELb0ELi16E",
    "train_cluster_kernelILi1ELi16ELb1ELi16E",
    *(f"{k}ILi{K}E" for K in (12, 16)
      for k in ("train_sweeps_kernel", "train_cluster_kernel")))
MISMATCH_MAX = 1e-3
# EM iterations a supervised round (the `supervised` phase)
SUPERVISED_ROUND = 5
# Figure 7's accuracy gate for Nonparallel, Simple and Weighted Average:
# the reference's own run at scale 0.04 on the CPU gave 0.78, 0.86, 0.86
# (Naive 0.71), so a port that learns the labels stays above 0.70
BINARY_ACC_MIN = 0.70
# the LM kernels' bf16 operations run at most at the dense bf16
# tensor-core rate; float32 ones on the CUDA cores (TF32 stays off)
PEAK_BF16_S = 989e12
# each element within tol + tol·|plain| (numpy's allclose, atol = rtol):
# float32 differs by summation order only; bf16 by one rounding of the
# output (an ulp is 2^-7 relative)
B5_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B7_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# B6: float32 the reference's own tolerance for its scan
# (tests/test_kernels.py); bf16 one rounding of the output
B6_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# float32 logits in parity_phase, held as the CPU tests hold them: atol
# tol·max(1, rms of the plain logits), rtol tol.  LM_PARITY_TOL for each
# comparison but zamba2's kernel route against its plain route: cut to 12
# layers with random weights, its first positions move by up to 0.083
# under one float32 rounding of noise on the embeddings, and the route's
# gap (B7's rounding at each norm; B6 adds none) needs up to 0.021
# (`python -m repro_torch.route_parity`, seeds 0-7, on the H100)
LM_PARITY_TOL = 2e-3
HYBRID_ROUTE_TOL = 0.05
# B5's rows (label, B, Hq, Hkv, Sq, Sk, Dh, causal, kv_len): kv_len None,
# "ragged" (1..Sk over the batch rows, the tail poisoned) or "with_zero"
# (0..Sk, so one row has no valid key and is NaN, the tail poisoned).
# Dh 128 is qwen3-1.7b's, Dh 80 zamba2-2.7b's shared block's
B5_SHAPES = (
    ("prefill_200", 32, 16, 8, 200, 200, 128, True, None),
    ("prefill_512", 32, 16, 8, 512, 512, 128, True, None),
    ("decode_256", 32, 16, 8, 1, 256, 128, True, "ragged"),
    ("prefill_200_dh80", 32, 32, 32, 200, 200, 80, True, None),
    ("decode_256_dh80", 32, 32, 32, 1, 256, 80, True, "ragged"),
    ("prefill_200_gqa4_dh64", 8, 16, 4, 200, 200, 64, True, None),
    ("small_mqa", 2, 8, 1, 96, 96, 32, True, None),
    ("small_sq_lt_sk", 1, 4, 2, 16, 80, 32, True, None),
    ("small_noncausal", 1, 2, 2, 32, 64, 16, False, None),
    ("small_decode_kv0", 3, 4, 2, 1, 64, 64, True, "with_zero"))
# B7 at the decode step's norm shapes, those of the main paths' launches
# (norm1, norm2 and final_norm [c, b, D]; q_norm and k_norm [c, b·H,
# Dh]; mamba2-1.3b's gated out_norm [c, b, d_inner]), and at the
# prefill's
B7_SHAPES = (
    ("decode_hidden", (4, 8, 2048)),
    ("decode_q_norm", (4, 8 * 16, 128)),
    ("decode_k_norm", (4, 8 * 8, 128)),
    ("decode_inner", (4, 8, 4096)),
    ("prefill_hidden", (4, 8 * 200, 2048)),
    ("prefill_q_norm", (4, 8 * 200 * 16, 128)),
    ("prefill_inner", (4, 8 * 200, 4096)))

# the rest of the LM zoo's B5 rows (as B5_SHAPES) and B7 rows (as
# B7_SHAPES), by phase: phi3.5-moe's GQA group of 4 and arctic's of 7
# (Dh 128; 4 and 2 chains × 8 slots), internvl2's vision prefill (256
# patches + 200 tokens) and musicgen's Dh 64 with one query head a KV
# head; the norms at D 4096, 7168, 2048 and 1536
ZOO_B5 = {
    "moe_serve": (
        ("phi_prefill_200_gqa4", 32, 32, 8, 200, 200, 128, True, None),
        ("phi_decode_256_gqa4", 32, 32, 8, 1, 256, 128, True, "ragged")),
    "arctic_serve": (
        ("arctic_prefill_200_gqa7", 16, 56, 8, 200, 200, 128, True, None),
        ("arctic_decode_256_gqa7", 16, 56, 8, 1, 256, 128, True,
         "ragged")),
    "frontend_serve": (
        ("internvl2_prefill_456", 32, 16, 8, 456, 456, 128, True, None),
        ("musicgen_prefill_200_dh64", 32, 24, 24, 200, 200, 64, True, None),
        ("musicgen_decode_256_dh64", 32, 24, 24, 1, 256, 64, True,
         "ragged"))}
ZOO_B7 = {
    "moe_serve": (("phi_decode_hidden", (4, 8, 4096)),
                  ("phi_prefill_hidden", (4, 8 * 200, 4096))),
    "arctic_serve": (("arctic_decode_hidden", (2, 8, 7168)),
                     ("arctic_prefill_hidden", (2, 8 * 200, 7168))),
    "frontend_serve": (("internvl2_prefill_hidden", (4, 8 * 456, 2048)),
                       ("musicgen_decode_hidden", (4, 8, 1536)))}
# the zoo's serving configurations: (phase, arch, layers kept, chains;
# the float32 parity's layers and chains)
ZOO_SERVE = (("moe_serve", "phi3.5-moe-42b-a6.6b", 4, 4, 1, 2),
             ("arctic_serve", "arctic-480b", 1, 2, 1, 1))
# lm_train at full width and depth: chains, batch rows and tokens a row
# per chain, steps (the first a warm-up)
TRAIN_SHAPE = (2, 2, 128, 4)
# the sharded phase: serving (chains, slots, prompt, decode steps), the
# decode_32k cell cut to one card (chains, slots, cache), the dry-run's
# peak against the card's, and the phase's budget in seconds
SHARDED_SERVE = (4, 8, 200, 8)
SHARDED_DECODE = (1, 8, 32768)
SHARDED_PEAK_TOL = 0.10
SHARDED_BUDGET_S = 90.0

# B6's rows (label, C, b, s, H, P, N, chunk, against the oracle too, A·dt
# scale): mamba2-1.3b's fused prefill (4 chains × 8 slots, 200 and 512
# steps, 64 heads of 64, N 128) and zamba2-2.7b's (80 heads, N 64); the
# reference's small grid, chunks that do not divide s, one step; the
# sequential oracle; A·dt of about -250 a step, where the masked exponent
# overflows
B6_SHAPES = (
    ("mamba2_prefill_200", 4, 8, 200, 64, 64, 128, 64, False, 1.0),
    ("mamba2_prefill_512", 4, 8, 512, 64, 64, 128, 64, False, 1.0),
    ("zamba2_prefill_200", 4, 8, 200, 80, 64, 64, 64, False, 1.0),
    ("small_64_c16", 2, 1, 64, 2, 8, 8, 16, False, 1.0),
    ("small_128_c32", 2, 2, 128, 4, 16, 8, 32, False, 1.0),
    ("small_96_c32", 2, 1, 96, 1, 32, 16, 32, False, 1.0),
    ("small_50_c16", 2, 1, 50, 2, 8, 8, 16, False, 1.0),
    ("small_200_c48", 2, 2, 200, 3, 64, 128, 48, False, 1.0),
    ("one_step", 2, 2, 1, 4, 64, 128, 64, False, 1.0),
    ("oracle_80", 2, 2, 80, 3, 16, 8, 64, True, 1.0),
    ("overflow_128", 1, 2, 128, 2, 8, 8, 64, True, 200.0))

def sparse_draw_ops(t: int, cap: int, stage2_share: float) -> float:
    """float32 operations of one sparse two-stage draw: the gather-scale,
    prefix and compare of the cap-long bucket (3·cap), the residual's
    1 − occm, product and in-block prefix (3·T), the block totals' prefix
    and compare (2·nb), and for the share of tokens that take stage 2 the
    compares inside the picked block and two subtractions."""
    blk = min(16, t)
    nb = -(-t // blk)
    return 3 * cap + 3 * t + 2 * nb + stage2_share * (blk + 2)


def longest_walk(real_per_doc, walks) -> float:
    """Real tokens of the longest walk, over the chains: the dependent
    token steps of one sweep on a kernel's critical path.  real_per_doc
    [M, D] (or [1, D] for a corpus the chains share); walks [n, per], the
    documents each group of lanes draws in turn, -1 where none."""
    import torch
    idx = walks.clamp(min=0).to(real_per_doc.device)
    tok = real_per_doc[:, idx] * (walks >= 0).to(real_per_doc.device)
    return float(tok.sum(-1).max())


def own_walks(D):
    """B1's and B2's walks in either variant: each document alone (a lane,
    a half-warp or a warp draws it and no other)."""
    import torch
    return torch.arange(D)[:, None]


def variant_of(counts, call):
    """What `call` returns, and the one variant whose count in `counts` (a
    wrapper's `variant_launches`) its launch raised."""
    before = dict(counts)
    out = call()
    ran = [v for v in counts if counts[v] != before[v]]
    check(len(ran) == 1, f"variants launched: {ran}")
    return out, ran[0]


def replaced_agrees(got, replaced, mask) -> bool:
    """A redesigned variant drew what the variant it replaced draws on the
    same inputs: every real token's topic and every count equal (got and
    replaced (z, ndt); mask broadcasts against z)."""
    import torch
    (z, ndt), (z_r, ndt_r) = got, replaced
    return bool(((z == z_r) | (mask <= 0)).all() and torch.equal(ndt, ndt_r))


def critical_path(real_per_doc, sweeps, timed):
    """The critical path on these inputs of each variant in `timed`, a
    list of (key prefix, walks, ms): the dependent token steps of its
    longest walk times the sweeps, and the launch's time a step in ns."""
    out = {}
    for key, walks, t_ms in timed:
        steps = longest_walk(real_per_doc, walks) * sweeps
        out[f"{key}critical_path_steps"] = steps
        out[f"{key}ns_per_step"] = t_ms * 1e6 / steps
    return out


def b3_critical_path(mask, D, doc_block, T, sweeps, ms, replaced_ms):
    """B3's cluster size and critical path on these inputs (mask [M, D,
    N]), for the cluster variant and the block variant it replaced."""
    from repro_torch.kernels import slda_train
    return {"cluster": slda_train.slot_plan(D, doc_block, T)[0],
            **critical_path(mask.sum(-1), sweeps, [
                (key, slda_train.walks(D, doc_block, T, variant), t_ms)
                for key, variant, t_ms in (("", "cluster", ms),
                                           ("replaced_", "block",
                                            replaced_ms))])}


def ptxas_use(log, kernels):
    """Registers and spill bytes of each entry function whose (mangled)
    name holds one of `kernels`, read from nvcc's -Xptxas -v log:
    {name: {"registers", "spill_stores", "spill_loads"}}."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m[1] if any(k in m[1] for k in kernels) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m[1]),
                                            spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def close_err(got, want, tol):
    """max |got - want|, and whether every element lies within tol +
    tol·|want|; NaN where both are NaN counts as equal."""
    got, want = got.float(), want.float()
    both = got.isnan() & want.isnan()
    diff = (got - want).abs().masked_fill(both, 0.0)
    scale = want.abs().masked_fill(both, 0.0)
    return (float(diff.max()) if diff.numel() else 0.0,
            bool((diff <= tol + tol * scale).all()))


def device_us(fn, n=10, tries=3):
    """Device time a call of `fn`, in µs, and the calls of the trace it
    comes from ("kept/n"): every kernel it launches, summed by
    torch.profiler over n calls.  A trace that lost launches (the
    profiler now and then returns none, or some: a kernel seen a number
    of times that n does not divide) is taken again, up to `tries`
    times.  If none is whole, the last trace is read as k calls, k the
    fewest launches of any of its kernels, when k is at least n/2: each
    kernel's mean a launch times its launches a call (its launches over
    k, rounded) (B6's traces keep 8 of 10 at times, and B2's one of its
    two kernels 9); else (None, None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0)))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        kernels = [(c, t) for c, t in kernels if t > 0]
        if kernels and all(c % n == 0 for c, _ in kernels):
            return sum(t for _, t in kernels) / n, f"{n}/{n}"
    k = min((c for c, _ in kernels), default=0)
    if k and 2 * k >= n:
        return (sum(t / c * max(1, round(c / k)) for c, t in kernels),
                f"{k}/{n}")
    return None, None


def device_fields(key, fn):
    """{key: device_us(fn), key_kept: the calls its trace kept}."""
    us, kept = device_us(fn)
    return {key: us, f"{key}_kept": kept}


def host_us(fn, n=50):
    """Wall time a call of `fn` on the host, in µs, launches included and
    no synchronisation between calls: what a host-bound step pays."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def reset_launches():
    from repro_torch.kernels import (flash_attention, slda_gibbs,
                                     slda_predict, slda_train, ssd_scan)
    from repro_torch.route_parity import kernel_modules
    for mod in kernel_modules().values():
        mod.launches = 0
    for counts in (flash_attention.variant_launches,
                   ssd_scan.variant_launches, slda_train.variant_launches,
                   slda_predict.variant_launches,
                   slda_gibbs.variant_launches):
        for v in counts:
            counts[v] = 0


def read_b5_variants():
    from repro_torch.kernels import flash_attention
    return dict(flash_attention.variant_launches)


def read_b6_variants():
    from repro_torch.kernels import ssd_scan
    return dict(ssd_scan.variant_launches)


def read_launches():
    from repro_torch.route_parity import kernel_modules
    return {k: mod.launches for k, mod in kernel_modules().items()}


def launches_per_pass(cfg):
    """The LM kernels' launches in one forward pass and in one decode step
    of `cfg`: B5 once per attention (an 'A' layer or an application of the
    shared block), B6 once per 'M' layer in a forward pass and never in a
    decode step (the recurrence), B7 once per norm (two a layer or shared
    block, two more for qk-norm, and the final norm)."""
    shared = (cfg.n_layers // cfg.shared_attn_every
              if cfg.shared_attn_every else 0)
    attn = cfg.pattern.count("A") + shared
    mamba = cfg.pattern.count("M")
    norms = attn * (4 if cfg.qk_norm else 2) + 2 * mamba + 1
    return ({"B5": attn, "B6": mamba, "B7": norms},
            {"B5": attn, "B6": 0, "B7": norms})


def cache_tensors(tree):
    """Every tensor of a decode cache, in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from cache_tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from cache_tensors(v)
    else:
        yield tree


def parity_phase(phase, cfg, seed, dev, route_tol=LM_PARITY_TOL):
    """`cfg` in float32, 4 chains, 8 slots, 200-token prompts, random
    weights from `seed` (`route_parity.route_gaps`): the kernel route
    against the plain route for forward over the prompts and for 8 decode
    steps, each within `route_tol`, and the fused prefill's last logits
    against prefill by decode steps within LM_PARITY_TOL, on the logits'
    scale (atol tol·max(1, rms of the plain logits), rtol tol, as the CPU
    tests).  The plain route launches nothing; the kernel route's forward
    launches what `launches_per_pass` says."""
    import torch
    from repro_torch.route_parity import route_gaps

    row = {"phase": phase, "dtype": "float32", **route_gaps(cfg, seed, dev),
           "route_tol": route_tol, "tol": LM_PARITY_TOL}
    emit(row)
    per_forward, _ = launches_per_pass(cfg)
    check(row["plain_route_launches"] == 0, f"{phase}: the plain route "
          f"launched")
    check(row["forward_launches"] == per_forward,
          f"{phase}: forward launches {row['forward_launches']}, not "
          f"{per_forward}")
    check(max(row["forward"][0], row["decode8"][0]) <= route_tol
          and row["fused_vs_decode_prefill"][0] <= LM_PARITY_TOL,
          f"{phase}: {row}")
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(phase, arch, combine, seed, dev, smi, event_ms, *,
                cfg=None, chains=4):
    """`arch` at full width and depth (or `cfg`, the arch cut in depth;
    random weights from `seed`), bf16, `chains` chains, 8 slots,
    200-token prompts, 32 greedy tokens through `ServingEngine.generate`
    under `combine`; with "weighted" the chain weights come from
    `serve_lm.inverse_loss_weights` (one full forward pass), timed and
    counted as part of the served run.  Then the fused prefill, timed
    (a frontend's embeddings from `serve_lm.make_embeds` in it and in
    the weights' pass; an MoE's drop share read), and on the first
    decode step after the prefill the kernel route's logits against the
    plain route's.  Checks finite logits, tokens in the vocabulary and
    every kernel's launches.
    Returns (the engine after its prefill, the token it feeds next, the
    unprofiled ms per decode step, the served run's launches with
    "B5_prefill": the fused prefill's tensor-core B5 launches)."""
    import torch
    from repro_torch import serve_lm
    from repro_torch.route_parity import plain_route
    from repro_torch.serving import GenerationConfig, ServingEngine
    from repro_torch.timing import PhaseTimer

    from repro_torch.models import init_params

    bf16, C, S, P, NEW, MAX_LEN = torch.bfloat16, chains, 8, 200, 32, 256
    if cfg is None:
        model = serve_lm.build_model(arch, smoke=False, chains=C,
                                     dtype=bf16, device=dev, seed=seed)
    else:
        model = init_params(cfg, C, bf16, device=dev, generator=torch
                            .Generator(device=dev).manual_seed(seed))
    cfg = model.cfg
    prompts = serve_lm.make_prompts(cfg.vocab_size, S, P, seed, dev)
    embeds = serve_lm.make_embeds(cfg, C, S, P, seed, dev)
    toks = prompts[None].expand(C, S, P)
    gen_cfg = GenerationConfig(max_new_tokens=NEW, combine=combine)
    model(toks[:, :, :8], compute_dtype=bf16, last_token_only=True)  # warm
    ServingEngine(model, batch_slots=S, max_len=MAX_LEN, gen=gen_cfg,
                  compute_dtype=bf16).prefill(prompts[:, :4])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    timer = PhaseTimer(dev)
    t0 = time.perf_counter()
    weights = None
    if combine == "weighted":
        with timer("weights"):
            weights = serve_lm.inverse_loss_weights(model, prompts, bf16,
                                                    embeds)
    weight_launches = read_launches()
    weight_variants = read_b5_variants()
    engine = ServingEngine(model, batch_slots=S, max_len=MAX_LEN,
                           gen=gen_cfg, chain_weights=weights,
                           compute_dtype=bf16)
    out = engine.generate(prompts, timer=timer)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    gen_variants = {k: v - weight_variants[k]
                    for k, v in read_b5_variants().items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    ms = timer.ms()
    n_dec = sum(1 for name, _, _ in timer.spans if name == "decode")
    steps = P + n_dec
    per_forward, per_step = launches_per_pass(cfg)
    gen_launches = {k: v - weight_launches[k] for k, v in launches.items()}

    reset_launches()
    fused = model(toks, embeds, compute_dtype=bf16, last_token_only=True)
    torch.cuda.synchronize()
    fused_launches = read_launches()
    fused_variants = read_b5_variants()
    fused_b6_variants = read_b6_variants()
    fused_ms = event_ms(lambda: model(toks, embeds, compute_dtype=bf16,
                                      last_token_only=True), 3)
    with serve_lm.moe_drops(model) as drops:
        model(toks, embeds, compute_dtype=bf16, last_token_only=True)

    # the first decode step after the prefill, by each route, from one
    # cache state (what the step writes in place is put back in between)
    engine.reset()
    last = engine.prefill(prompts)
    saved = [t.clone() for t in cache_tensors(engine.cache)]
    logits_k, _ = model.decode_step(engine.cache, last, compute_dtype=bf16)
    for t, s in zip(cache_tensors(engine.cache), saved):
        t.copy_(s)
    del saved
    with plain_route():
        logits_p, _ = model.decode_step(engine.cache, last,
                                        compute_dtype=bf16)
    step_err = float((logits_k.float() - logits_p.float()).abs().max())
    agree = logits_k.argmax(-1) == logits_p.argmax(-1)
    agree_rows = float(agree.float().mean())
    # where the routes' argmax differ, the plain route's lead of its top
    # logit over the kernel route's pick (a near-tie at bf16 resolution
    # when it is below the logits' difference)
    pick = logits_k.argmax(-1, keepdim=True)
    lead = (logits_p.float().amax(-1) - logits_p.float().gather(
        -1, pick).squeeze(-1))[~agree]
    mixed = [engine._combine(lg, engine.chain_weights).argmax(-1)
             for lg in (logits_k, logits_p)]
    agree_slots = float((mixed[0] == mixed[1]).float().mean())
    finite = bool(logits_k.isfinite().all() and fused.isfinite().all())
    in_vocab = bool(((out >= 0) & (out < cfg.vocab_size)).all())
    step_ms = ms["decode"] / n_dec
    row = {"phase": phase, "card": smi, "arch": cfg.name,
           "layers": cfg.n_layers, "dtype": "bfloat16", "chains": C,
           "slots": S, "prompt_len": P, "max_len": MAX_LEN,
           "new_tokens": n_dec, "combine": combine,
           "chain_weights": None if weights is None else weights.tolist(),
           "weights_ms": ms.get("weights"),
           "prefill_by_decode_ms": ms["prefill"],
           "fused_prefill_ms": fused_ms,
           "decode_ms_per_step": step_ms,
           "tokens_per_s": S * n_dec / (ms["decode"] / 1e3),
           "generate_wall_s": wall_s,
           "max_memory_allocated": peak_bytes,
           "launches": launches, "weights_launches": weight_launches,
           "launches_per_step": {k: v / steps
                                 for k, v in gen_launches.items()},
           "fused_prefill_launches": fused_launches,
           "b5_variant_launches": gen_variants,
           "fused_prefill_b5_variant_launches": fused_variants,
           "fused_prefill_b6_variant_launches": fused_b6_variants,
           "first_step_max_abs_logit_diff": step_err,
           "first_step_argmax_agreement_rows": agree_rows,
           "first_step_disagreeing_rows_max_lead":
               float(lead.max()) if lead.numel() else None,
           "first_step_greedy_agreement_slots": agree_slots,
           "fused_prefill_positions": P + (cfg.n_patches
                                           if cfg.frontend == "vision"
                                           else 0),
           "fused_prefill_moe_drop_share":
               sum(drops) / len(drops) if drops else None,
           "finite_logits": finite, "tokens_in_vocab": in_vocab,
           "tokens_slot0": out[0].tolist()}
    emit(row)
    check(finite, f"{phase}: non-finite logits")
    check(in_vocab, f"{phase}: tokens outside the vocabulary")
    check(gen_launches == {k: v * steps for k, v in per_step.items()},
          f"{phase}: launches {gen_launches} over {steps} steps")
    check(weight_launches == (per_forward if weights is not None else
                              {k: 0 for k in per_forward}),
          f"{phase}: chain weights' launches {weight_launches}")
    check(fused_launches == per_forward,
          f"{phase}: fused prefill launches {fused_launches}")
    # bf16: every decode step's attention on the decode variant, every
    # fused prefill's on the tensor cores
    check(gen_variants["decode"] == gen_launches["B5"]
          and fused_variants["prefill_wgmma"] == fused_launches["B5"],
          f"{phase}: B5 variants {gen_variants}, fused {fused_variants}")
    # and every bf16 fused prefill's scan on the tensor cores
    check(fused_b6_variants["tensor_cores"] == fused_launches["B6"],
          f"{phase}: B6 variants {fused_b6_variants}")
    return engine, last, step_ms, {
        **launches, "B5_prefill": fused_variants["prefill_wgmma"]}


def profile_phase(phase, engine, tok, step_ms):
    """Three of the engine's decode steps under torch.profiler: device busy
    time, its idle share against the unprofiled step `step_ms` (the
    profiler slows the host) and against the profiled wall, and the
    kernels that take the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    engine._decode(tok, None)                             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tok, _ = engine._decode(tok, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in ops) / 1e3
    emit({"phase": phase, "steps": 3, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "unprofiled_step_ms": step_ms,
          "device_idle_share": 1.0 - busy_ms / (3 * step_ms) if ops
          else None,
          "device_idle_share_profiled_wall": 1.0 - busy_ms / wall_ms
          if ops else None,
          "device_kernels": sum(e.count for e in ops),
          "top_kernels": [{"name": e.key[:70], "calls": e.count,
                           "ms": dev_us(e) / 1e3} for e in ops[:10]]})


def b5_row(label, shape, dtype, dev, randn, event_ms, bound_ms,
           phase="B5"):
    """Kernel B5 at one shape (B, Hq, Hkv, Sq, Sk, Dh, causal, kv_len) and
    dtype: its variant against the plain version on identical inputs; its
    time beside the kernel it replaced (the cuda_cores variant, as every
    call ran before) and SDPA's, by CUDA events (back to back: at decode
    sizes the host's issue rate), by the profiler (device time a launch)
    and on the host's clock (a call's wall time).  Emits the row, fails
    the run if the kernel disagrees, and returns the row."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels import flash_attention, ref
    B, hq, hkv, sq, sk, dh, causal, lens = shape
    q, k, v = (randn(dims, dtype) for dims in (
        (B, hq, sq, dh), (B, hkv, sk, dh), (B, hkv, sk, dh)))
    kv_len = None
    lim = torch.full((B, sq), sk, device=dev)
    if lens:        # kv_len over 1..Sk (or 0..Sk), the tail poisoned
        kv_len = torch.linspace(0 if lens == "with_zero" else 1, sk,
                                B, device=dev).round().int()
        tail = (torch.arange(sk, device=dev)[None, :]
                >= kv_len[:, None])[:, None, :, None]
        k = k.masked_fill(tail, 1e4)
        v = v.masked_fill(tail, 1e4)
        lim = kv_len[:, None].expand(B, sq)
    if causal:
        lim = torch.minimum(lim, torch.arange(sq, device=dev)
                            + sk - sq + 1).clamp(min=0)
    kind = flash_attention.variant(dtype, sq, dh)

    def kernel(name=None):
        return flash_attention.flash_attention_cuda(
            q, k, v, causal=causal, kv_len=kv_len,
            kernel_variant=name)
    out = kernel()
    want = ref.ref_attention(q, k, v, causal=causal, kv_len=kv_len)
    err, ok = close_err(out, want, B5_TOL[str(dtype)[6:]])
    if kv_len is None and causal and sq == sk:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    else:           # every row's valid keys are a prefix
        mask = (torch.arange(sk, device=dev)
                < lim[..., None])[:, None]         # [B, 1, Sq, Sk]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    lib_err, _ = close_err(lib(), want, 1.0)
    reps = 5 if sq >= 512 else 20
    ms = event_ms(kernel, reps)
    dev_us = device_fields("device_us", kernel)
    replaced = lambda: kernel("cuda_cores")  # noqa: E731
    replaced_ms, replaced_dev_us = (
        (event_ms(replaced, reps),
         device_fields("replaced_device_us", replaced))
        if kind != "cuda_cores" else
        (ms, {f"replaced_{k}": v for k, v in dev_us.items()}))
    plain_ms = event_ms(lambda: ref.ref_attention(
        q, k, v, causal=causal, kv_len=kv_len), reps)
    library_ms = event_ms(lib, reps)
    pairs = float(lim.sum()) * hq
    elt = q.element_size()
    valid_kv = float(lim.amax(1).sum()) * hkv * dh * 2 * elt
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_FP32_S
    b_ms, b_by = bound_ms([q, out], 4 * dh * pairs,
                          extra_bytes=valid_kv, peak_ops=peak)
    row = {"phase": phase, "shape": label, "dtype": str(dtype)[6:],
           "variant": kind, "B": B, "Hq": hq, "Hkv": hkv, "Sq": sq,
           "Sk": sk, "Dh": dh, "causal": causal,
           "kv_len": None if kv_len is None else
           [int(kv_len.min()), int(kv_len.max())],
           "max_abs_err": err, "tol": B5_TOL[str(dtype)[6:]],
           "sdpa_max_abs_err": lib_err, "ms": ms,
           "replaced_ms": replaced_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **dev_us, **replaced_dev_us,
           **device_fields("library_device_us", lib),
           "host_us": host_us(kernel), "library_host_us": host_us(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    check(ok, f"{phase} {label} {dtype}: error {err}")
    return row


def b7_row(label, shape, dtype, eps, dev, randn, event_ms, bound_ms,
           phase="B7"):
    """Kernel B7 at one norm shape [C, rows, D] and dtype: error against
    the plain version, and each one's against float64 (C1); times beside
    the two-pass form of the kernel it replaced and F.rms_norm's, as
    `b5_row`'s.  Emits the row, fails the run if the kernel disagrees,
    and returns the row."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels import ref, rmsnorm
    x = randn(shape, dtype)
    w = 1.0 + 0.1 * randn((shape[0], shape[2]), torch.float32)
    kind = rmsnorm.variant(dtype, shape[2])

    def kernel(name=None):
        return rmsnorm.rmsnorm_cuda(x, w, eps=eps,
                                    kernel_variant=name)
    out = kernel()
    want = ref.ref_rmsnorm(x, w, eps)
    err, ok = close_err(out, want, B7_TOL[str(dtype)[6:]])
    xd = x.double()
    exact = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True)
                             + eps) * w.double()[:, None]
    # the library call scales every chain by chain 0's weight: the
    # same work, a weight row per chain aside
    w0 = w[0].to(dtype)
    lib = lambda: F.rms_norm(x, (shape[2],), w0, eps)  # noqa: E731
    ms = event_ms(kernel, 50)
    b_ms, b_by = bound_ms([x, w, out], 4 * x.numel())
    row = {"phase": phase, "label": label, "shape": list(shape),
           "dtype": str(dtype)[6:], "variant": kind,
           "max_abs_err": err, "tol": B7_TOL[str(dtype)[6:]],
           "err_f64": float((out.double() - exact).abs().max()),
           "plain_err_f64": float((want.double() - exact)
                                  .abs().max()),
           "ms": ms,
           "replaced_ms": event_ms(lambda: kernel("two_pass"), 50),
           **device_fields("replaced_device_us",
                           lambda: kernel("two_pass")),
           "plain_ms": event_ms(lambda: ref.ref_rmsnorm(x, w, eps),
                                20),
           "library_ms": event_ms(lib, 50),
           **device_fields("device_us", kernel),
           **device_fields("library_device_us", lib),
           "host_us": host_us(kernel), "library_host_us": host_us(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    check(ok, f"{phase} {shape} {dtype}: error {err}")
    return row


def lm_phases(seed, dev, smi, event_ms, bound_ms):
    """The phases of the dense LM serving slice (B5, B7, lm_parity,
    lm_serve, lm_profile).  Returns their kernels-line rows and the
    kernels' launches in the lm_serve run."""
    import torch
    from repro_torch.configs import qwen3_1_7b

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}

    def randn(shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    # ---- B5 and B7 at the slice's shapes (`b5_row`, `b7_row`)
    for label, *shape in B5_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            row = b5_row(label, shape, dtype, dev, randn, event_ms, bound_ms)
            if dtype == torch.bfloat16 and label == "decode_256":
                rows["B5"] = row
            if dtype == torch.bfloat16 and label == "prefill_200":
                rows["B5_prefill"] = row

    eps = qwen3_1_7b.CONFIG.norm_eps
    for label, shape in B7_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            row = b7_row(label, shape, dtype, eps, dev, randn, event_ms,
                         bound_ms)
            if label == "decode_hidden" and dtype == torch.bfloat16:
                rows["B7"] = row

    # ---- lm_parity: full width, 2 layers, f32; kernel against plain route
    parity_phase("lm_parity", dataclasses.replace(qwen3_1_7b.CONFIG,
                                                  n_layers=2),
                 seed, dev)

    # ---- lm_serve: the slice's main path at full width and depth, and
    # where a decode step's time goes
    engine, last, step_ms, launches = serve_phase(
        "lm_serve", "qwen3-1.7b", "simple", seed, dev, smi, event_ms)
    profile_phase("lm_profile", engine, last, step_ms)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rows, {k: launches[k] for k in ("B5", "B5_prefill", "B7")}


def ssd_flops(s, chunk, rows, h, p, n):
    """float32 operations of the chunk algebra for `rows` (chain, batch
    row) sequences of s steps and h heads, counting what the data needs.
    Per chunk of Lc steps and row, the scores C·Bᵀ over the Lc(Lc+1)/2
    pairs s <= t (2n each; B and C are shared by the heads); per chunk
    and head, each pair's decay and scale and its product with x over p,
    the carried state's term Lc·p·(2n + 2) after the first chunk, the
    state update Lc·p·2n + p·n and the cumulative sum, decays and weights
    (4·Lc)."""
    per_row = per_head = 0
    for k, t0 in enumerate(range(0, s, chunk)):
        lc = min(chunk, s - t0)
        pairs = lc * (lc + 1) // 2
        per_row += pairs * 2 * n
        per_head += (pairs * (2 * p + 3) + (k > 0) * lc * p * (2 * n + 2)
                     + lc * p * 2 * n + p * n + 4 * lc)
    return float(per_row + h * per_head) * rows


def b6_phase(dev, gen, event_ms, bound_ms):
    """Kernel B6 against its plain version (`ref.ref_ssd_chunked`) on
    identical inputs at `B6_SHAPES`, x in bf16 and float32: error, and the
    kernel's and the plain version's errors against a float64 scan of the
    same inputs; the variant that ran; times (CUDA events, and
    `device_us` by the profiler) beside the replaced kernel's (the
    cuda_cores variant on the same inputs); the CUDA cores' bound
    (`f32_bound_ms`) and the tensor cores' (`tc_bound_ms`), and as
    `bound_ms` the one of the variant that ran.  Returns the kernels-line row."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels import ref, ssd_scan

    def inputs(c, b, s, h, p, n, dtype, a_scale=1.0):
        def rn(*shape):
            return torch.randn(shape, device=dev, generator=gen)
        return ((0.5 * rn(c, b, s, h, p)).to(dtype),
                F.softplus(rn(c, b, s, h)),
                -a_scale * torch.exp(0.3 * rn(c, h)), 0.5 * rn(c, b, s, n),
                0.5 * rn(c, b, s, n))

    kernel_row = None
    for label, c, b, s, h, p, n, chunk, oracle, a_scale in B6_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, B, C = inputs(c, b, s, h, p, n, dtype, a_scale)
            ch = min(chunk, s)
            kind = ssd_scan.variant(dtype, p, n)

            def kernel(name=None):
                return ssd_scan.ssd_scan_cuda(x, dt, A, B, C, chunk=ch,
                                              kernel_variant=name)
            out = kernel()
            want = ref.ref_ssd_chunked(x, dt, A, B, C, chunk=ch)
            tol = B6_TOL[str(dtype)[6:]]
            err, ok = close_err(out, want, tol)
            exact = ref.ref_ssd_chunked(
                *(t.double() for t in (x, dt, A, B, C)), chunk=ch,
                compute_dtype=torch.float64)
            row = {"phase": "B6", "shape": label, "dtype": str(dtype)[6:],
                   "variant": kind, "C": c, "b": b, "s": s, "H": h, "P": p,
                   "N": n, "chunk": ch, "max_abs_err": err, "tol": tol,
                   "err_f64": float((out.double() - exact).abs().max()),
                   "plain_err_f64": float((want.double() - exact)
                                          .abs().max()),
                   "finite": bool(out.isfinite().all())}
            del exact
            if oracle:
                row["oracle_max_abs_err"], ok_o = close_err(
                    out, ref.ref_ssd(x, dt, A, B, C), tol)
                ok = ok and ok_o
            reps = 5 if s >= 200 else 20
            row["ms"] = event_ms(kernel, reps)
            row.update(device_fields("device_us", kernel))
            replaced = lambda: kernel("cuda_cores")  # noqa: E731
            if kind != "cuda_cores":
                row["replaced_ms"] = event_ms(replaced, reps)
                row.update(device_fields("replaced_device_us", replaced))
            else:
                row["replaced_ms"] = row["ms"]
                row.update({f"replaced_{k}": row[k]
                            for k in ("device_us", "device_us_kept")})
            row["plain_ms"] = event_ms(lambda: ref.ref_ssd_chunked(
                x, dt, A, B, C, chunk=ch), reps)
            flops = ssd_flops(s, ch, c * b, h, p, n)
            # the least time on the CUDA cores (the operations at the
            # float32 rate, or the bytes) and on the tensor cores (at the
            # dense bf16 rate); `bound_ms` is that of the variant that ran
            row["f32_bound_ms"], row["f32_bound_by"] = bound_ms(
                [x, dt, A, B, C, out], flops)
            row["tc_bound_ms"], row["tc_bound_by"] = bound_ms(
                [x, dt, A, B, C, out], flops, peak_ops=PEAK_BF16_S)
            on_tc = kind == "tensor_cores"
            row["bound_ms"], row["bound_by"] = (
                row["tc_bound_ms" if on_tc else "f32_bound_ms"],
                row["tc_bound_by" if on_tc else "f32_bound_by"])
            # no single PyTorch call computes the SSD scan
            row["library_ms"] = None
            emit(row)
            if label == "mamba2_prefill_200" and dtype == torch.bfloat16:
                kernel_row = row
            check(ok and row["finite"], f"B6 {label} {dtype}: {row}")
    return kernel_row


def ssm_phases(seed, dev, smi, event_ms, bound_ms):
    """The phases of the Mamba-2 serving slice (B6, ssm_parity,
    hybrid_parity, ssm_serve, ssm_profile).  Returns the B6 row of the
    kernels line and B6's launches in the ssm_serve run."""
    import torch
    from repro_torch.configs import mamba2_1_3b, zamba2_2_7b

    gen = torch.Generator(device=dev).manual_seed(seed)
    row = b6_phase(dev, gen, event_ms, bound_ms)

    # ---- full width cut in depth, f32; kernel against plain route: two
    # 'M' layers, and twelve with two applications of the shared block
    for phase, cfg, layers, tol in (
            ("ssm_parity", mamba2_1_3b.CONFIG, 2, LM_PARITY_TOL),
            ("hybrid_parity", zamba2_2_7b.CONFIG, 12, HYBRID_ROUTE_TOL)):
        parity_phase(phase, dataclasses.replace(
            cfg, n_layers=layers, layer_pattern="M" * layers), seed, dev,
            tol)

    # ---- ssm_serve: the slice's main path at full width and depth, with
    # Weighted Average (its chain weights run B6), and where a decode
    # step's time goes
    engine, last, step_ms, launches = serve_phase(
        "ssm_serve", "mamba2-1.3b", "weighted", seed, dev, smi, event_ms)
    profile_phase("ssm_profile", engine, last, step_ms)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"B6": row}, {"B6": launches["B6"]}


def zoo_parity(phase, cfg, chains, seed, dev, *, prompt_len=32):
    """`cfg` in float32, `chains` chains, 8 slots, random weights from
    `seed` (a frontend's embeddings from `serve_lm.make_embeds`): the
    kernel route against the plain route (`route_parity.plain_route`)
    for the forward pass over `prompt_len`-token prompts, with the
    embeddings, and for the first decode step after the prompts are
    primed by decode steps (audio: each step with its frame), both routes
    from one cache state.  Each read as `route_parity.need` (the CPU
    tests' rule).  The decode step is gated within LM_PARITY_TOL, and so
    is the forward pass but for MoE: there 1,600 router choices a layer
    see the two routes' rounding, and one within it of a tie sends a
    token to another expert (the decode step's 16 choices are gated)."""
    import torch
    from repro_torch import serve_lm
    from repro_torch.models import init_params
    from repro_torch.route_parity import need, plain_route

    f32, S, P = torch.float32, 8, prompt_len
    model = init_params(cfg, chains, f32, device=dev, generator=torch
                        .Generator(device=dev).manual_seed(seed))
    toks = serve_lm.make_prompts(cfg.vocab_size, S, P + 1, seed, dev)[
        None].expand(chains, S, P + 1)
    emb = serve_lm.make_embeds(cfg, chains, S, P + 1, seed, dev)
    audio = cfg.frontend == "audio"

    def frames(t0, t1):
        return emb[:, :, t0:t1] if audio else None

    fwd_emb = frames(0, P) if audio else emb
    fwd = model(toks[:, :, :P], fwd_emb, compute_dtype=f32)
    reset_launches()
    with plain_route():
        fwd_plain = model(toks[:, :, :P], fwd_emb, compute_dtype=f32)
    plain_launches = sum(read_launches().values())
    cache = model.init_cache(S, P + 1, f32)
    for t in range(P):
        _, cache = model.decode_step(cache, toks[:, :, t:t + 1],
                                     frames(t, t + 1), compute_dtype=f32)
    saved = [t.clone() for t in cache_tensors(cache)]
    last = toks[:, :, P:P + 1]
    step, _ = model.decode_step(cache, last, frames(P, P + 1),
                                compute_dtype=f32)
    for t, s in zip(cache_tensors(cache), saved):
        t.copy_(s)
    with plain_route():
        step_plain, _ = model.decode_step(cache, last, frames(P, P + 1),
                                          compute_dtype=f32)
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
           "chains": chains, "dtype": "float32", "prompt_len": P,
           "forward": need(fwd, fwd_plain),
           "decode_step": need(step, step_plain),
           "plain_route_launches": plain_launches, "tol": LM_PARITY_TOL,
           "forward_gated": not cfg.is_moe}
    emit(row)
    check(plain_launches == 0, f"{phase}: the plain route launched")
    check(row["decode_step"][0] <= LM_PARITY_TOL
          and (cfg.is_moe or row["forward"][0] <= LM_PARITY_TOL),
          f"{phase}: route parity {row}")
    del model, cache, saved
    gc.collect()
    torch.cuda.empty_cache()


def musicgen_serve(seed, dev, event_ms):
    """musicgen-medium at full width and depth, bf16, 4 chains, 8 slots:
    200 prompt steps and 32 greedy tokens through
    `launch.steps.make_decode_step(combine="simple")`, every step with
    its frame's embedding (`serve_lm.make_embeds`).  Checks finite logits,
    tokens in the vocabulary and each step's B5 and B7 launches.
    Returns the served run's launches."""
    import torch
    from repro_torch import serve_lm
    from repro_torch.launch.sharding import DistConfig
    from repro_torch.launch.steps import make_decode_step

    bf16, C, S, P, NEW = torch.bfloat16, 4, 8, 200, 32
    model = serve_lm.build_model("musicgen-medium", smoke=False, chains=C,
                                 dtype=bf16, device=dev, seed=seed)
    cfg = model.cfg
    prompts = serve_lm.make_prompts(cfg.vocab_size, S, P, seed, dev)
    frames = serve_lm.make_embeds(cfg, C, S, P + NEW, seed, dev)
    step = make_decode_step(cfg, DistConfig(
        n_chains=C, compute_dtype="bfloat16", use_kernels=True), "simple")
    toks = prompts[None].expand(C, S, P)
    cache = model.init_cache(S, P + NEW, bf16)
    step(model, model.init_cache(S, 4, bf16),
         {"tokens": toks[:, :, :1], "embeds": frames[:, :, :1]})  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for t in range(P):
        _, cache = step(model, cache, {"tokens": toks[:, :, t:t + 1],
                                       "embeds": frames[:, :, t:t + 1]})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok, out = toks[:, :, -1:], []
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    for t in range(P, P + NEW):
        mix, cache = step(model, cache, {"tokens": tok,
                                         "embeds": frames[:, :, t:t + 1]})
        nxt = mix[:, -1].argmax(-1).to(torch.int32)              # [S]
        tok = nxt[None, :, None].expand(C, S, 1).contiguous()
        out.append(nxt)
    s1.record()
    torch.cuda.synchronize()
    launches = read_launches()
    out = torch.stack(out, 1)
    _, per_step = launches_per_pass(cfg)
    finite = bool(mix.isfinite().all())
    in_vocab = bool(((out >= 0) & (out < cfg.vocab_size)).all())
    step_ms = s0.elapsed_time(s1) / NEW
    row = {"phase": "frontend_serve", "arch": cfg.name, "chains": C,
           "slots": S, "prompt_len": P, "new_tokens": NEW,
           "combine": "simple", "frames_per_step": 1,
           "prefill_by_decode_s": prefill_s, "decode_ms_per_step": step_ms,
           "tokens_per_s": S * NEW / (step_ms * NEW / 1e3),
           "launches": launches, "finite_logits": finite,
           "tokens_in_vocab": in_vocab, "tokens_slot0": out[0].tolist()}
    emit(row)
    check(finite and in_vocab, f"musicgen_serve: {row}")
    check(launches == {k: v * (P + NEW) for k, v in per_step.items()},
          f"musicgen_serve: launches {launches}")
    del model, cache
    return launches


def zoo_phases(seed, dev, smi, event_ms, bound_ms):
    """The rest of the LM zoo (moe_serve, arctic_serve, frontend_serve)
    and single-card training (lm_train).  Each phase frees the one
    before it and reports its seconds and peak memory.  Returns each
    serving phase's B5 (decode), B5_prefill and B7 launches."""
    import torch
    from repro_torch.configs import get_arch

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    launches = {}

    def randn(shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def done(phase, t0, **more):
        emit({"phase": phase, "done": True,
              "seconds": time.perf_counter() - t0,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "card": smi, **more})

    def kernel_rows(phase, eps):
        for label, *shape in ZOO_B5[phase]:
            for dtype in (torch.bfloat16, torch.float32):
                b5_row(label, shape, dtype, dev, randn, event_ms, bound_ms)
        for label, shape in ZOO_B7[phase]:
            for dtype in (torch.bfloat16, torch.float32):
                b7_row(label, shape, dtype, eps, dev, randn, event_ms,
                       bound_ms)

    def counts(got):
        return {k: got[k] for k in ("B5", "B5_prefill", "B7")}

    for phase, arch, layers, chains, p_layers, p_chains in ZOO_SERVE:
        t0 = start()
        full = get_arch(arch)
        assert full.moe_top_k == 2       # the combine's exact sum
        kernel_rows(phase, full.norm_eps)
        cut = dataclasses.replace(full, n_layers=layers)
        engine, _, _, got = serve_phase(phase, arch, "simple", seed, dev,
                                        smi, event_ms, cfg=cut,
                                        chains=chains)
        launches[phase] = counts(got)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        zoo_parity(phase, dataclasses.replace(full, n_layers=p_layers),
                   p_chains, seed, dev)
        done(phase, t0, layers=f"{layers} of {full.n_layers}",
             chains=chains)

    t0 = start()
    kernel_rows("frontend_serve", get_arch("internvl2-2b").norm_eps)
    engine, _, _, got = serve_phase("frontend_serve", "internvl2-2b",
                                    "simple", seed, dev, smi, event_ms)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    audio = musicgen_serve(seed, dev, event_ms)
    gc.collect()
    torch.cuda.empty_cache()
    launches["frontend_serve"] = {
        "B5": got["B5"] + audio["B5"], "B5_prefill": got["B5_prefill"],
        "B7": got["B7"] + audio["B7"]}
    for arch in ("internvl2-2b", "musicgen-medium"):
        zoo_parity("frontend_serve", get_arch(arch), 2, seed, dev)
    done("frontend_serve", t0)

    t0 = start()
    lm_train_phase(seed, dev, smi, event_ms)
    done("lm_train", t0)
    return launches


def lm_train_phase(seed, dev, smi, event_ms):
    """qwen3-1.7b at full width and depth trained on the plain route
    (TRAIN_SHAPE), then the smoke config's restart and accumulation
    checks (see the module's docstring)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.sharding import DistConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_lm_batch, train
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, init_opt_state

    C, B, T, steps = TRAIN_SHAPE
    cfg = get_arch("qwen3-1.7b")
    model = init_params(cfg, C, torch.float32, device=dev, trainable=True,
                        generator=torch.Generator(device=dev)
                        .manual_seed(seed))
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps,
                    opt_dtype="bfloat16")
    state = init_opt_state(model.param_tree(), opt)
    step_fn = make_train_step(cfg, DistConfig(
        n_chains=C, compute_dtype="float32", use_kernels=False,
        remat=False, opt_dtype="bfloat16"), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, norms, ms = [], [], []
    for i in range(steps):
        batch = make_lm_batch(seed, i, cfg, C, B, T, dev)
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        model, state, m = step_fn(model, state, batch)
        s1.record()
        torch.cuda.synchronize()
        ms.append(s0.elapsed_time(s1))
        losses.append(m["loss"].tolist())
        norms.append(m["grad_norm"].tolist())
    launched = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.mean(ms[1:]))
    tokens = C * B * T
    n = cfg.param_count()
    row = {"phase": "lm_train", "card": smi, "arch": cfg.name,
           "layers": cfg.n_layers, "chains": C, "batch": B, "seq": T,
           "param_dtype": "float32", "compute_dtype": "float32",
           "opt_dtype": opt.opt_dtype, "steps": steps,
           "step_ms": ms, "step_ms_after_first": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "max_memory_allocated": peak, "loss": losses,
           "grad_norm": norms, "launches": launched,
           "params_per_chain": n,
           "flops_per_step_6nt": 6.0 * n * tokens,
           "fp32_peak_share": 6.0 * n * tokens / (step_ms / 1e3)
           / PEAK_FP32_S}
    emit(row)
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"lm_train: non-finite loss or norm {row}")
    check(sum(launched.values()) == 0,
          f"lm_train: a kernel launched on the plain route {launched}")
    del model, state, step_fn, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # the smoke config: restart bit for bit, accumulation within 1e-4
    kw = dict(smoke=True, batch=2, seq=16, chains=2, lr=1e-3,
              log_every=100, schedule_steps=10, device=dev)
    with tempfile.TemporaryDirectory(prefix="lm_train_") as tmp:
        _, _, full = train("qwen3-1.7b", steps=10, **kw)
        train("qwen3-1.7b", steps=6, ckpt_dir=tmp, save_interval=6, **kw)
        _, _, tail = train("qwen3-1.7b", steps=10, ckpt_dir=tmp,
                           resume=True, save_interval=100, **kw)
    smoke = get_arch("qwen3-1.7b", smoke=True)
    acc_opt = OptConfig(lr=1e-3, warmup_steps=0, clip_norm=1e9)
    batch = make_lm_batch(seed, 0, smoke, 2, 8, 16, dev)
    after = {}
    for a in (1, 2):
        m = init_params(smoke, 2, device=dev, trainable=True, seed=seed)
        st = init_opt_state(m.param_tree(), acc_opt)
        m, _, met = make_train_step(smoke, DistConfig(
            n_chains=2, accum_steps=a, compute_dtype="float32",
            remat=False), acc_opt)(m, st, batch)
        after[a] = (met["loss"], [p.detach() for p in m.parameters()])
    acc_err = max(float((x - y).abs().max())
                  for x, y in zip(after[1][1], after[2][1]))
    loss_err = float((after[1][0] - after[2][0]).abs().max())
    row = {"phase": "lm_train", "smoke_restart_equal": bool(
        np.array_equal(full[6:], tail)),
        "smoke_losses_straight": full[6:].tolist(),
        "smoke_losses_restarted": tail.tolist(),
        "accum2_max_param_diff": acc_err, "accum2_max_loss_diff": loss_err}
    emit(row)
    check(row["smoke_restart_equal"], f"lm_train: restart differs {row}")
    check(acc_err <= 1e-4 and loss_err <= 1e-4,
          f"lm_train: accumulation differs {row}")


def sharded_serve(cfg, seed, dev, mesh, event_ms):
    """(a): the plain decode step against the sharded one, step by step
    from the same primed cache."""
    import torch
    from repro_torch.launch.collectives import count_collectives
    from repro_torch.launch.sharding import (DistConfig, batch_specs,
                                             cache_specs, shard_model,
                                             shard_tree)
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_params

    C, slots, P, steps = SHARDED_SERVE
    dist = DistConfig(n_chains=C, compute_dtype="bfloat16")

    def model():
        return init_params(cfg, C, torch.bfloat16, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
    plain = model()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = P + steps + 2                  # room for the timed steps
    tok = torch.randint(0, cfg.vocab_size, (1, slots, n),
                        dtype=torch.int32, device=dev, generator=g)
    tok = tok.expand(C, -1, -1).contiguous()     # every chain, every slot
    plain_step = make_decode_step(cfg, dist)
    # the prompt primes the cache on the kernel route (the steps compared
    # start from one primed cache, so its route does not matter)
    prime = make_decode_step(cfg, DistConfig(n_chains=C,
                                             compute_dtype="bfloat16",
                                             use_kernels=True))
    t0 = time.perf_counter()
    cache = plain.init_cache(slots, n, torch.bfloat16)
    for t in range(P):
        _, cache = prime(plain, cache, {"tokens": tok[:, :, t:t + 1]})
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    reset_launches()
    sharded, _ = shard_model(model(), mesh, dist)
    scache = shard_tree({k: ([{n: t.clone() for n, t in lc.items()}
                              for lc in v] if isinstance(v, list)
                             else v.clone()) for k, v in cache.items()},
                        cache_specs(cache, mesh, dist), mesh)
    sharded_step = make_decode_step(cfg, dist, mesh=mesh)
    state = {"cache": cache, "scache": scache}

    def step(t, sharded_too=True):
        tb = {"tokens": tok[:, :, t:t + 1]}
        plain_logits, state["cache"] = plain_step(plain, state["cache"], tb)
        if not sharded_too:
            return plain_logits, None
        stb = shard_tree(tb, batch_specs(tb, mesh, dist,
                                         replicated_serve=True), mesh)
        logits, state["scache"] = sharded_step(sharded, state["scache"], stb)
        return plain_logits, logits

    equal = []
    with count_collectives(functional=True) as stats:  # compared, counted
        for t in range(P, P + steps):
            plain_logits, logits = step(t)
            equal.append(bool(torch.equal(plain_logits,
                                          logits.full_tensor())))
    # two more steps of each, timed with the counter off
    t = P + steps
    plain_ms = event_ms(lambda: step(t, False), 1, warm=False)
    tb = {"tokens": tok[:, :, t:t + 1]}
    stb = shard_tree(tb, batch_specs(tb, mesh, dist, replicated_serve=True),
                     mesh)
    sharded_ms = event_ms(lambda: sharded_step(sharded, state["scache"],
                                               stb), 1, warm=False)
    return {"chains": C, "slots": slots, "prompt": P, "steps": steps,
            "prime_s": prime_s, "logits_bit_equal": equal,
            "collectives": stats.count, "plain_ms": plain_ms,
            "sharded_ms": sharded_ms}


def sharded_train(cfg, seed, dev, mesh, dist, event_ms):
    """(b): one training step of the same weights and batch on plain
    tensors, then on DTensors; the plain step's updated weights wait on
    the host (two models and their state do not fit the card)."""
    import torch
    from repro_torch.launch.collectives import count_collectives
    from repro_torch.launch.sharding import (batch_specs, shard_model,
                                             shard_tree)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_lm_batch
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, init_opt_state

    C, B, T, _ = TRAIN_SHAPE
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=4,
                    opt_dtype=dist.opt_dtype)
    batch = make_lm_batch(seed, 0, cfg, C, B, T, dev)
    res = {}
    for name in ("plain", "sharded"):
        model = init_params(cfg, C, torch.float32, device=dev,
                            trainable=True,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
        b, m = batch, None
        if name == "sharded":
            model, _ = shard_model(model, mesh, dist)
            b = shard_tree(batch, batch_specs(batch, mesh, dist), mesh)
            m = mesh
        state = init_opt_state(model.param_tree(), opt)
        step = make_train_step(cfg, dist, opt, m)
        out = {}

        def run():
            out["r"] = step(model, state, b)
        with count_collectives(functional=True) as stats:
            ms = event_ms(run, 1, warm=False)
        metrics = out["r"][2]
        full = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                for k, v in metrics.items()}
        res[name] = {"ms": ms, "collectives": stats.count,
                     "loss": full["loss"], "grad_norm": full["grad_norm"]}
        if name == "plain":
            weights = {n: p.detach().cpu() for n, p in
                       model.named_parameters()}
        else:
            res["weights_equal"] = all(
                torch.equal(p.detach().to_local(),
                            weights[n].to(dev, non_blocking=True))
                for n, p in model.named_parameters())
        del model, state, out, metrics, b
        gc.collect()
        torch.cuda.empty_cache()
    return {"chains": C, "batch": B, "seq": T,
            "loss_bit_equal": bool(torch.equal(res["plain"]["loss"],
                                               res["sharded"]["loss"])),
            "grad_norm_bit_equal": bool(torch.equal(
                res["plain"]["grad_norm"], res["sharded"]["grad_norm"])),
            "weights_bit_equal": res["weights_equal"],
            "loss": res["plain"]["loss"].tolist(),
            "collectives": res["sharded"]["collectives"],
            "plain_ms_counted": res["plain"]["ms"],
            "sharded_ms_counted": res["sharded"]["ms"]}


def dryrun_against_card(label, shape, chains, overrides, seed, dev, mesh,
                        event_ms):
    """(c): one cell's dry-run on fake tensors at the host mesh, then the
    same cell built with real weights and one real step."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import local_bytes

    arch = "qwen3-1.7b"
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = dryrun.build_cell(arch, shape, False, chains, overrides,
                                 mesh=mesh, device=dev)
        meta = dryrun.analyze(fake)
    del fake
    dry_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(arch, shape, False, chains, overrides,
                             mesh=mesh, device=dev, seed=seed)
    arguments = local_bytes(dryrun.arg_tensors(cell.args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        out = cell.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    ms = event_ms(cell.run, 1, warm=False)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    want = meta["bytes_per_device"]
    return {"cell": label, "shape": [shape.seq_len, shape.global_batch],
            "chains": meta["n_chains"], "dryrun_s": dry_s,
            "flops": meta["hlo_flops"],
            "flop_counter_flops": counter.get_total_flops(),
            "arguments": want["arguments"], "card_arguments": arguments,
            "peak": want["peak"], "card_peak": peak,
            "peak_err": (want["peak"] - peak) / peak,
            "hbm_bytes": meta["hlo_bytes"],
            "collective_bytes": meta["collective_bytes"],
            "t_compute_s": meta["t_compute_s"],
            "t_memory_s": meta["t_memory_s"],
            "t_collective_s": meta["t_collective_s"],
            "dominant": meta["dominant"], "measured_ms": ms}


def sharded_phase(seed, dev, smi, event_ms):
    """The `sharded` phase (see the module's docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import DistConfig
    from repro_torch.launch.slda_parallel import init_group

    t_phase = time.perf_counter()
    cfg = get_arch("qwen3-1.7b")
    C, B, T, _ = TRAIN_SHAPE
    train_over = dict(compute_dtype="float32", opt_dtype="bfloat16",
                      remat=False)
    train_dist = DistConfig(n_chains=C, use_kernels=False, **train_over)
    chains, slots, cache_len = SHARDED_DECODE
    cells = (("train", ShapeSpec("train_smoke", T, C * B, "train"), C,
              train_over),
             ("decode_32k", ShapeSpec("decode_32k", cache_len, slots,
                                      "decode"), chains, None))
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="rendezvous_") as tmp:
        init_group("nccl", 0, 1, f"file://{tmp}/store", RANKS_TIMEOUT_S)
        try:
            mesh = make_host_mesh("cuda")
            t0 = time.perf_counter()
            serve = sharded_serve(cfg, seed, dev, mesh, event_ms)
            serve["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            train = sharded_train(cfg, seed, dev, mesh, train_dist, event_ms)
            train["seconds"] = time.perf_counter() - t0
            held = []
            for label, shape, n, over in cells:
                t0 = time.perf_counter()
                held.append(dryrun_against_card(label, shape, n, over, seed,
                                                dev, mesh, event_ms))
                held[-1]["seconds"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    launched = read_launches()
    seconds = time.perf_counter() - t_phase
    row = {"phase": "sharded", "card": smi, "arch": cfg.name,
           "mesh": [1, 1], "serve": serve, "train": train, "dryrun": held,
           "launches": launched, "seconds": seconds}
    emit(row)
    check(all(serve["logits_bit_equal"]) and serve["collectives"] == 0,
          "sharded: serving not bit-equal to plain tensors, or collectives")
    check(train["loss_bit_equal"] and train["grad_norm_bit_equal"]
          and train["weights_bit_equal"] and train["collectives"] == 0,
          "sharded: the training step not bit-equal, or collectives")
    for h in held:
        check(h["flops"] == h["flop_counter_flops"],
              f"sharded: {h['cell']} dry-run FLOPs differ from the card's")
        check(h["arguments"] == h["card_arguments"],
              f"sharded: {h['cell']} argument bytes differ")
        check(abs(h["peak_err"]) <= SHARDED_PEAK_TOL,
              f"sharded: {h['cell']} predicted peak off by "
              f"{h['peak_err']:.3f}")
    check(not any(launched.values()), "sharded: a kernel was launched")
    check(seconds <= SHARDED_BUDGET_S, f"sharded: took {seconds:.1f} s")
    return row


def supervised_phase(seed, dev, smi, train, test, runs, zero_counts,
                     read_counts, main_variant):
    """The supervised, checkpointed training path (`core.supervisor`) at
    the slice's full scale, for each (label, config) of `runs`, in rounds
    of SUPERVISED_ROUND EM iterations with a checkpoint at each round's
    start; every B1–B3 launch of a config's runs counted, and each on the
    main path's variant.  Gates: the probe is transparent (the same z,
    ndt and η as no hook, status 0); it adds no host synchronization to a
    round; a clean run keeps every chain; chain 1 poisoned with NaN η at
    EM iteration 7's boundary is flagged, restarted twice, then
    quarantined, the survivors' ŷ bit-equal to the clean run's and the
    combined ŷ the clean chains' under the faulty mask; chain 2 killed at
    iteration 12's boundary restarts from the round's checkpoint and every
    chain ends alive within the accuracy gate; corrupt counts raise
    F_NDT_SUM and F_NTW_NEG.  Reported: train ms with the probe on and
    off, and save / restore ms (sync and async).  Returns each config's
    launches, {label: (launches, sparse_launches)}."""
    import tempfile
    import warnings

    import numpy as np
    import torch
    from repro_torch.checkpoint import (AsyncCheckpointManager,
                                        restore_chain, save_checkpoint)
    from repro_torch.core import rng, supervised_run_average
    from repro_torch.core.parallel import _combine_weighted, _shards
    from repro_torch.core.supervisor import (F_KILLED, F_NAN_ETA, F_NDT_SUM,
                                             F_NTW_NEG, ChainSupervisor,
                                             _chain_of, seeded_draws)
    from repro_torch.testing import poison

    M, R = 4, SUPERVISED_ROUND
    var_y = float(test.y.var(unbiased=False))
    out = {}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, res

    def syncs(fn):
        """Host synchronizations in fn(), as the sync debug mode warns."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("synchroniz" in str(w.message).lower() for w in caught)

    def actions(rep, c):
        return [e["action"] for h in rep.history for e in h["events"]
                if e["chain"] == c]

    for n_run, (label, cfg) in enumerate(runs):
        spl, T = cfg.sweeps_per_launch, cfg.n_topics
        per_round = -(-R // spl)

        def boundary(i):
            """The EM boundary that follows EM iteration i."""
            return (i // R) * per_round + (i % R) // spl

        shards = _shards(train, M, cfg, dev)
        sup = ChainSupervisor(shards, cfg)
        plan = sup.plan
        bc = plan.corpus
        z0, draws = rng.train_draws(rng.chain_generators(seed, M, dev),
                                    bc.n_docs, bc.max_len, T, cfg.n_iters,
                                    spl)
        draws = list(draws)
        ones = torch.ones(M, device=dev)

        def status0():
            return torch.zeros(M, dtype=torch.int32, device=dev)

        def plain():
            return plan.train_em(plan.init_states(z0), draws)

        def probed():
            return plan.train_em(plan.init_states(z0), draws,
                                 em_hook=sup.hook(plan, ones),
                                 status0=status0())
        plain(), probed()                                    # warm-up
        off_ms, on_ms = [], []
        for _ in range(3):
            off_ms.append(wall_ms(plain)[0])
            on_ms.append(wall_ms(probed)[0])
        a, (b, st) = plain(), probed()
        transparent = (all(torch.equal(x, y) for x, y in zip(a.z, b.z))
                       and all(torch.equal(getattr(a, f), getattr(b, f))
                               for f in ("ndt", "ntw", "nt", "eta"))
                       and int((st != 0).sum()) == 0)

        # host synchronizations in one round, the probe off and on, each
        # counted twice in turn after a warm-up call (the first count of
        # a setting has held one sync more than the others)
        rp = sup.make_round_plan(R)
        rd = list(seeded_draws(seed, plan).round(0, np.zeros(M, np.int32),
                                                 R))
        count = {
            "off": lambda: rp.train_em(rp.init_states(z0), rd),
            "on": lambda: rp.train_em(
                rp.init_states(z0), rd, em_hook=sup.hook(rp, ones),
                status0=status0()),
            "supervised": lambda: sup.run_round(
                rp, iter(rd), rp.init_states(z0), np.ones(M, bool), 0)}
        for fn in count.values():
            fn()
        s_off, s_on, s_round = [], [], []
        for _ in range(2):
            for got, fn in zip((s_off, s_on, s_round), count.values()):
                got.append(syncs(fn))

        zero_counts()
        with tempfile.TemporaryDirectory() as tmp:
            def run(name, fault=None):
                t0 = time.perf_counter()
                y, rep = supervised_run_average(
                    seed, train, test, cfg, M, rule="weighted",
                    ckpt_dir=f"{tmp}/{name}", round_iters=R,
                    fault_hook=None if fault is None else
                    poison(M, *fault, device=dev).hook(), device=dev)
                torch.cuda.synchronize()
                return y, rep, (time.perf_counter() - t0) * 1e3
            y_c, rep_c, clean_ms = run("clean")
            y_n, rep_n, nan_ms = run("nan", (1, boundary(7), "nan"))
            y_k, rep_k, kill_ms = run("kill", (2, boundary(12), "kill"))
            y_x, rep_x, _ = run("corrupt", (3, boundary(3), "corrupt"))
        launches, sparse_launches, variants = read_counts()
        out[label] = (launches, sparse_launches)

        alive_n = rep_n.alive_mask(dev)
        want_n = _combine_weighted(
            torch.from_numpy(rep_c.yhat_chains).to(dev),
            torch.from_numpy(rep_c.yhat_train_chains).to(dev), train.y, cfg,
            alive_n)
        survivors_equal = all(np.array_equal(rep_n.yhat_chains[c],
                                             rep_c.yhat_chains[c])
                              for c in (0, 2, 3))
        mse_k = float(((y_k - test.y) ** 2).mean())
        kill_step = R * (12 // R)
        row = {"phase": "supervised", "card": smi, "config": label,
               "sweeps_per_launch": spl, "sampler_mode": cfg.sampler_mode,
               "M": M, "n_iters": cfg.n_iters, "round_iters": R,
               "boundaries_per_round": per_round,
               "hook_transparent": transparent,
               "train_ms_probe_off": off_ms, "train_ms_probe_on": on_ms,
               "syncs_a_round_probe_off": s_off,
               "syncs_a_round_probe_on": s_on,
               "syncs_a_round_supervised": s_round,
               "clean": {"alive": rep_c.alive.tolist(),
                         "status": rep_c.status.tolist(),
                         "test_mse": float(((y_c - test.y) ** 2).mean()),
                         "run_ms": clean_ms},
               "nan_eta": {"boundary": boundary(7),
                           "alive": rep_n.alive.tolist(),
                           "status": rep_n.status.tolist(),
                           "restarts": rep_n.restarts.tolist(),
                           "chain_1_actions": actions(rep_n, 1),
                           "survivors_equal": survivors_equal,
                           "combined_equal": bool(torch.equal(y_n,
                                                              want_n)),
                           "run_ms": nan_ms},
               "kill": {"boundary": boundary(12),
                        "alive": rep_k.alive.tolist(),
                        "status": rep_k.status.tolist(),
                        "restarts": rep_k.restarts.tolist(),
                        "chain_2_actions": actions(rep_k, 2),
                        "test_mse": mse_k, "var_y_test": var_y,
                        "run_ms": kill_ms},
               "corrupt": {"boundary": boundary(3),
                           "status": rep_x.status.tolist(),
                           "alive": rep_x.alive.tolist(),
                           "finite": bool(torch.isfinite(y_x).all())},
               "launches": launches, "sparse_launches": sparse_launches,
               "variant_launches": variants}
        if n_run == 0:
            # the checkpoint store on the trained state (one save: every
            # chain's file, the manifest, the fsyncs and the publish)
            state = a
            with tempfile.TemporaryDirectory() as tmp:
                save_ms = [wall_ms(lambda i=i: save_checkpoint(
                    f"{tmp}", i, state))[0] for i in range(5)]
                tmpl = _chain_of(state, 0)
                restore_ms = [wall_ms(lambda: restore_chain(
                    tmp, 4, 1, tmpl))[0] for _ in range(5)]
                mgr = AsyncCheckpointManager(f"{tmp}/async", interval=1,
                                             keep=2)
                accept_ms = [wall_ms(lambda i=i: mgr.maybe_save(
                    i, state))[0] for i in range(5)]
                flush_ms = wall_ms(mgr.flush)[0]
                mgr.close()
                back = restore_chain(tmp, 4, 1, tmpl)
            row["checkpoint"] = {
                "bytes": sum(t.numel() * t.element_size() for t in
                             (*state.z, state.ndt, state.ntw, state.nt,
                              state.eta)),
                "save_ms": save_ms, "async_accept_ms": accept_ms,
                "async_writes": mgr.stats["writes"],
                "async_waits": mgr.stats["waits"],
                "async_last_flush_ms": flush_ms, "restore_chain_ms":
                    restore_ms,
                "restored_equal": bool(torch.equal(back.ndt, state.ndt[1])
                                       and torch.equal(back.eta,
                                                       state.eta[1]))}
        emit(row)
        where = f"supervised {label}"
        check(transparent, f"{where}: the probe changed the run")
        check(max(s_on) <= min(s_off), f"{where}: the probe adds host "
              f"syncs ({s_on} against {s_off})")
        check(rep_c.alive.all() and not rep_c.status.any(),
              f"{where}: a clean run flagged {rep_c.status.tolist()}")
        check(bool(rep_n.status[1] & F_NAN_ETA)
              and rep_n.restarts[1] == 2
              and rep_n.alive.tolist() == [True, False, True, True]
              and actions(rep_n, 1)[-1] == "quarantine",
              f"{where}: NaN η not restarted twice then quarantined "
              f"{row['nan_eta']}")
        check(survivors_equal and row["nan_eta"]["combined_equal"],
              f"{where}: the quarantine is not exact")
        check(bool(rep_k.status[2] & F_KILLED) and rep_k.alive.all()
              and f"restart_from_step_{kill_step}" in actions(rep_k, 2)
              and mse_k < 0.6 * var_y,
              f"{where}: the killed chain {row['kill']}")
        check(bool(rep_x.status[3] & F_NDT_SUM)
              and bool(rep_x.status[3] & F_NTW_NEG) and row["corrupt"][
                  "finite"], f"{where}: corrupt counts {row['corrupt']}")
        check(all(variants[k][v] == launches[k]
                  for k, v in main_variant(cfg).items()),
              f"{where}: launches by variant {variants}")
        if "checkpoint" in row:
            check(row["checkpoint"]["restored_equal"],
                  f"{where}: a restored chain differs")
    return out


# the slda_serving phase: requests a row's closed-loop trace, the share
# of them that re-submit an earlier one verbatim (the reference's
# `benchmarks/bench_slda_serving.py` `make_trace`), the served MSE gate
# as a share of var(y_test), and the CUDA-event timings' repetitions
SERVE_REQUESTS = 512
SERVE_REPEAT_FRAC = 0.25
SERVE_MSE_FRAC = 0.6
SERVE_TIMING_REPS = 30


def serve_trace(seed, n_req, fresh, repeat_frac=SERVE_REPEAT_FRAC):
    """A request trace, the reference's `make_trace` recipe: each request
    re-submits an earlier one verbatim with probability `repeat_frac`,
    else it is `fresh(rng)`, which returns (tokens, id).  Returns (docs,
    ids), a repeat carrying its original's id."""
    import numpy as np
    rng = np.random.default_rng(seed)
    docs, ids = [], []
    for _ in range(n_req):
        if docs and rng.random() < repeat_frac:
            j = int(rng.integers(len(docs)))
            docs.append(docs[j])
            ids.append(ids[j])
            continue
        doc, i = fresh(rng)
        docs.append(doc)
        ids.append(i)
    return docs, ids


def lognormal_doc(vocab, max_len, len_sigma=1.0):
    """`fresh` for `serve_trace`: the reference's `make_trace` document
    (log-normal length clipped to [1, max_len], uniform tokens), id -1."""
    import numpy as np
    mu = np.log(max(2.0, max_len / 6.0))

    def fresh(rng):
        n = int(np.clip(np.rint(rng.lognormal(mu, len_sigma)), 1, max_len))
        return rng.integers(0, vocab, size=n).astype(np.int32), -1
    return fresh


def serving_rows(seed, dev, train, test):
    """`serving_phase`'s two rows.  `mdna`: the slice at full width, the
    Weighted Average ensemble of MD&A (`train_chains` over the 3000
    training documents in 4 shards, spl 1), its 1216 test documents in
    order as the trace's fresh requests; the slots calibrated on the
    training lengths (32 slots, 4 rungs, max_doc_len 120).
    `bench_shape`: the reference's own serving configuration
    (benchmarks/bench_slda_serving.py: 512 training documents, W 1000,
    T 32, log-normal lengths to 256, 60 EM iterations, M = 8, 32 slots,
    4 rungs) with its `make_trace(123, ...)` recipe."""
    import numpy as np
    import torch
    from repro_torch import fig6_mdna
    from repro_torch.core import SLDAConfig, partition, train_chains
    from repro_torch.core.parallel import _shards
    from repro_torch.data import make_slda_corpus
    from repro_torch.kernels import slda_predict
    from repro_torch.serving import ServiceConfig

    def lengths(corpus):
        return corpus.mask.sum(-1).to(torch.int64).cpu().numpy()

    cfg, M = fig6_mdna.CFG, fig6_mdna.M
    mdna_models, mdna_models_b = (train_chains(
        seed + k, _shards(train, M, cfg, dev), cfg, device=dev)[1]
        for k in (1, 2))
    test_len, test_tok = lengths(test), test.tokens.cpu().numpy()
    test_docs = [test_tok[d, :test_len[d]] for d in range(test.n_docs)]
    next_test = iter(range(test.n_docs))

    def mdna_next(rng):
        i = next(next_test)
        return test_docs[i], i

    def mdna_fresh(n):
        idx = [next(next_test) for _ in range(n)]
        return [test_docs[i] for i in idx], idx

    cfg_b = SLDAConfig(n_topics=32, vocab_size=1000, rho=0.25, n_iters=60)
    corpus_b, _ = make_slda_corpus(seed, 512, 1000, 32, 256, rho=0.25,
                                   doc_len_dist="lognormal", len_sigma=1.0,
                                   len_skew=6.0, device=dev)
    bench_models, bench_models_b = (train_chains(
        seed + k, partition(corpus_b, 8), cfg_b, device=dev)[1]
        for k in (1, 2))
    bench_doc = lognormal_doc(1000, 256)
    bench_rng = np.random.default_rng(124)

    def bench_fresh(n):
        return [bench_doc(bench_rng)[0] for _ in range(n)], [-1] * n

    return (
        ("mdna", cfg, mdna_models, mdna_models_b, ServiceConfig.calibrated(
            lengths(train), max_doc_len=fig6_mdna.DOC_LEN, batch_docs=32,
            n_buckets=4, combine="weighted"),
         *serve_trace(seed, SERVE_REQUESTS, mdna_next), mdna_fresh,
         test.y.cpu().numpy(), float(test.y.var(unbiased=False)),
         slda_predict.variant(cfg.n_topics, False, fig6_mdna.DOC_LEN)),
        ("bench_shape", cfg_b, bench_models, bench_models_b,
         ServiceConfig.calibrated(lengths(corpus_b), max_doc_len=256,
                                  batch_docs=32, n_buckets=4),
         *serve_trace(123, SERVE_REQUESTS, bench_doc), bench_fresh, None,
         None, slda_predict.variant(32, False, 256)))


def serving_phase(seed, dev, smi, rows, zero_counts, read_counts):
    """The sLDA prediction service (`repro_torch.serving`) on the card,
    for each row of `rows`: (label, cfg, models, models_b, svc_cfg, trace
    docs, trace ids, fresh(n) -> n unseen documents, y of the ids or
    None, var_y, B1's main variant).  Gates: every request of the
    closed-loop trace is served `ok`; one capture after the first flush
    and none in steady traffic; each fresh result bit-equal to an eager
    (uncaptured) twin's and to the padded layout's at the same batch
    indices; the served MSE under SERVE_MSE_FRAC·var(y) where the row has
    labels; `set_sampler_mode("sparse")` one more capture, finite ŷ (and
    the MSE gate), switching back none; a mid-stream drop and revive
    capturing nothing, the dropped combine the survivors' and the revive
    the first outputs, bit for bit; a hot reload bumping the epoch,
    capturing nothing and equal to a fresh service on the new models at
    the aligned batch index, a torn checkpoint rejected with the old epoch
    serving on; NaN η after load quarantined at dispatch, every ŷ a clean
    service's with that chain dropped.  Reported: one flush's dispatch by
    CUDA events (replay with the plan's side streams captured, replay of
    a graph captured with the rungs in turn, and eager), host ms a flush,
    latencies, docs/s, the dummy share, the layout, and B1's and B4's
    launches (the kernels' counters see a capture, never a replay: real
    launches = counted − captured calls + replays × rungs).  Returns
    {label: {"B1": n, "B4": n}}."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import slda_predict
    from repro_torch.serving import SLDAPredictionService
    from repro_torch.serving.slda_service import (_GraphDispatch,
                                                  _combine_yhat,
                                                  eager_dispatch)
    from repro_torch.testing import poison_model_table, truncate_chain_file

    class EagerService(SLDAPredictionService):
        """The uncaptured twin: every flush dispatches eagerly."""

        def _dispatch_fn(self, plan_key):
            return eager_dispatch

    def serve(svc, docs):
        rids = [svc.submit(d) for d in docs]
        svc.drain()
        torch.cuda.synchronize()
        return [svc.result(r) for r in rids]

    def same(a, b):
        return (a.status == b.status and a.from_cache == b.from_cache
                and (a.from_cache or (
                    a.yhat == b.yhat
                    and np.array_equal(a.yhat_chains, b.yhat_chains)
                    and np.array_equal(a.zbar, b.zbar))))

    def median_ms(fn, reps=SERVE_TIMING_REPS):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return float(np.median(out))

    def graph_launches(services):
        """Real B1 and B4 launches of the services' graphs beyond what
        the counters saw: − captured calls + replays × rungs."""
        b1 = b4 = 0
        for svc in services:
            for key, g in svc._graphs.items():
                n = (g.replays - 1) * g.rungs
                b1 += n
                b4 += n if key[0][1].sampler_mode == "sparse" else 0
        return b1, b4

    out = {}
    for (label, cfg, models, models_b, svc_cfg, trace, ids, fresh, y,
         var_y, b1_variant) in rows:
        t_row = time.perf_counter()
        where = f"slda_serving {label}"
        B, M = svc_cfg.batch_docs, int(models.eta.shape[0])
        mk = lambda m=models, **kw: SLDAPredictionService(
            m, cfg, dataclasses.replace(svc_cfg, **kw), seed=seed,
            device=dev)
        zero_counts()

        # ---- the closed-loop trace: the first micro-batch captures, the
        # rest is steady traffic (each flush timed on the host's clock)
        svc = mk()
        warm = serve(svc, trace[:B])
        captures_warm = svc.stats()["traces"]
        flush_ms, flush = [], svc.flush

        def timed_flush():
            t = time.perf_counter()
            done = flush()
            flush_ms.append((time.perf_counter() - t) * 1e3)
            return done
        svc.flush = timed_flush
        t0 = time.perf_counter()
        steady = serve(svc, trace[B:])
        wall_s = time.perf_counter() - t0
        del svc.flush
        served = warm + steady
        st0 = svc.stats()
        all_ok = all(r.status == "ok" for r in served)
        fresh_lat = [r.latency_s * 1e3 for r in steady if not r.from_cache]
        hit_lat = [r.latency_s * 1e3 for r in steady if r.from_cache]

        # ---- the eager twin and the padded layout, the same trace
        twins = {}
        for name, twin in (("eager", EagerService(
                models, cfg, svc_cfg, seed=seed, device=dev)),
                ("padded", mk(bucketed=False))):
            got = serve(twin, trace[:B]) + serve(twin, trace[B:])
            twins[name] = (twin, all(same(a, b)
                                     for a, b in zip(served, got)))
        mse = None
        if y is not None:
            idx = [i for r, i in zip(served, ids) if not r.from_cache]
            yh = np.array([r.yhat for r in served if not r.from_cache])
            mse = float(np.mean((yh - y[idx]) ** 2))

        # ---- sparse mode: one more capture; back to dense: none
        svc.set_sampler_mode("sparse")
        sp_docs, sp_ids = fresh(4 * B)
        sp = serve(svc, sp_docs)
        captures_sparse = svc.stats()["traces"]
        sparse_finite = all(np.isfinite(r.yhat) and r.status == "ok"
                            for r in sp)
        sparse_mse = None
        if y is not None:
            sparse_mse = float(np.mean((np.array([r.yhat for r in sp])
                                        - y[sp_ids]) ** 2))
        svc.set_sampler_mode("dense")
        back_docs, _ = fresh(B)
        back = serve(svc, back_docs)
        captures_back = svc.stats()["traces"]

        # ---- drop and revive mid-stream, each pass at the same draws
        dr = mk(cache_results=False)
        docs_d = list({d.tobytes(): d for d in trace}.values())[:2 * B]
        passes = []
        for action in (None, "drop", "revive"):
            if action == "drop":
                dr.drop_chain(1)
            elif action == "revive":
                dr.revive_chain(1)
            dr._batches = 0
            passes.append(serve(dr, docs_d))
        surv = [c for c in range(M) if c != 1]
        mse_host = models.train_mse.cpu()
        drop_exact = all(
            np.array_equal(b.yhat_chains, a.yhat_chains)
            and b.yhat == float(_combine_yhat(
                svc_cfg.combine,
                torch.from_numpy(a.yhat_chains[surv].copy())[:, None],
                torch.ones(M - 1), mse_host[surv])[0])
            for a, b in zip(passes[0], passes[1]))
        revive_exact = all(same(a, c) for a, c in zip(passes[0], passes[2]))
        captures_dr = dr.stats()["traces"]

        # ---- hot reload from the port's checkpoint, then a torn one
        caps = svc.stats()["traces"]
        with tempfile.TemporaryDirectory() as good, \
                tempfile.TemporaryDirectory() as torn_dir:
            save_checkpoint(good, 5, models_b)
            rep = svc.reload_from_checkpoint(good)
            b0 = svc._batches
            rel = serve(svc, docs_d[:B])
            ref_svc = mk(models_b)
            ref_svc._batches = b0
            reload_equal = all(same(a, b) and not a.from_cache for a, b in
                               zip(rel, serve(ref_svc, docs_d[:B])))
            save_checkpoint(torn_dir, 3, models_b)
            truncate_chain_file(torn_dir, 3, 1)
            torn = svc.reload_from_checkpoint(torn_dir)
            again = serve(svc, docs_d[:4])
        torn_keeps = (not torn["ok"] and torn["epoch"] == rep["epoch"]
                      and all(a.from_cache and a.yhat == b.yhat
                              for a, b in zip(again, rel)))
        reload_ok = (rep["ok"] and rep["epoch"] == 1
                     and svc.stats()["traces"] == caps and reload_equal)

        # ---- NaN η after load: quarantined at dispatch, exact
        q, clean = mk(cache_results=False), mk(cache_results=False)
        q.models = poison_model_table(models, 3, "nan_eta")
        clean.drop_chain(3)
        quarantine_exact = all(
            a.yhat == b.yhat and np.isfinite(a.yhat)
            for a, b in zip(serve(q, docs_d), serve(clean, docs_d)))
        quarantines = q.stats()["dispatch_quarantines"]

        # ---- the launches of everything served above
        torch.cuda.synchronize()
        launches, sparse_launches, variants = read_counts()
        services = [svc, twins["padded"][0], dr, ref_svc, q, clean]
        g1, g4 = graph_launches(services)
        b1_launches = launches["B1"] + g1
        b4_launches = sparse_launches["B1"] + g4

        # ---- one flush's dispatch: replay, replay of a graph captured
        # with the rungs in turn, eager (the same micro-batch and draws)
        svc._pending.extend((i, d, 0.0, float("inf"))
                            for i, d in enumerate(docs_d[:B]))
        placed, _ = svc._pack()
        svc._pending.clear()
        bc, _ = svc._build_schedule(placed)
        plan = build_plan(bc, svc.cfg)
        fn = svc._dispatch_fn((plan.cache_key(), dev))
        z0, seeds = svc._batch_draws(0)
        replay = lambda: fn(z0, seeds, svc.models, plan)
        eager = lambda: eager_dispatch(z0, seeds, svc.models, plan)
        streams_used = plan_mod._streams_for(
            svc.cfg.n_pred_burnin + svc.cfg.n_pred_samples,
            len(bc.buckets), dev)
        orig = plan_mod._streams_for
        plan_mod._streams_for = lambda *a: False
        try:
            in_turn = _GraphDispatch(z0, seeds, svc.models, plan)
        finally:
            plan_mod._streams_for = orig
        want = [t.clone() for t in replay()]
        got = in_turn(z0, seeds, svc.models, plan)
        in_turn_equal = all(torch.equal(a, b) for a, b in zip(want, got))
        eager_equal = all(torch.equal(a, b) for a, b in zip(want, eager()))
        replay_ms = median_ms(replay)
        in_turn_ms = median_ms(lambda: in_turn(z0, seeds, svc.models,
                                               plan))
        eager_ms = median_ms(eager)
        flush_p50 = float(np.median(flush_ms))
        steady_caps = svc.stats()["traces"]

        row = {"phase": "slda_serving", "row": label, "card": smi,
               "M": M, "T": cfg.n_topics, "W": cfg.vocab_size,
               "max_doc_len": svc_cfg.max_doc_len, "batch_docs": B,
               "combine": svc_cfg.combine,
               "width_ladder": list(svc_cfg.width_ladder),
               "slot_quota": list(svc_cfg.slot_quota),
               "requests": len(trace), "all_ok": all_ok,
               "cache_hits": st0["result_cache_hits"],
               "dispatches": st0["dispatches"],
               "dummy_slot_frac": st0["dummy_slot_frac"],
               "captures_after_first_flush": captures_warm,
               "captures_after_trace": st0["traces"],
               "captures_sparse": captures_sparse,
               "captures_back_to_dense": captures_back,
               "eager_equal": twins["eager"][1],
               "padded_equal": twins["padded"][1],
               "test_mse": mse, "sparse_test_mse": sparse_mse,
               "var_y_test": var_y, "sparse_finite": sparse_finite,
               "drop_exact": drop_exact, "revive_exact": revive_exact,
               "drop_revive_captures": captures_dr,
               "reload": {k: rep[k] for k in ("ok", "epoch", "ckpt_step")},
               "reload_equal": reload_equal,
               "torn_rejected": {k: torn[k] for k in ("ok", "epoch",
                                                      "reason")},
               "torn_old_epoch_serves": torn_keeps,
               "dispatch_quarantines": quarantines,
               "quarantine_exact": quarantine_exact,
               "graph_streams": streams_used,
               "replay_ms": replay_ms, "replay_in_turn_ms": in_turn_ms,
               "eager_ms": eager_ms,
               "replay_in_turn_equal": in_turn_equal,
               "replay_eager_equal": eager_equal,
               "flush_wall_ms_p50": flush_p50,
               "host_ms_per_flush": flush_p50 - replay_ms,
               "fresh_latency_ms_p50": float(np.percentile(fresh_lat, 50)),
               "fresh_latency_ms_p99": float(np.percentile(fresh_lat, 99)),
               "cache_hit_latency_ms_p50": (
                   float(np.percentile(hit_lat, 50)) if hit_lat else None),
               "docs_per_s": len(steady) / wall_s,
               "fresh_docs_per_s": len(fresh_lat) / wall_s,
               "launches": {"B1": b1_launches, "B4": b4_launches},
               "b1_variant": b1_variant,
               "b1_variant_launches": variants["B1"],
               "seconds": time.perf_counter() - t_row}
        emit(row)
        check(all_ok, f"{where}: a request was not served ok")
        check(captures_warm == 1 and st0["traces"] == 1,
              f"{where}: captures {captures_warm} after the first flush, "
              f"{st0['traces']} after the trace")
        check(twins["eager"][1] and eager_equal,
              f"{where}: the replay differs from eager dispatch")
        check(twins["padded"][1], f"{where}: the padded layout differs")
        if mse is not None:
            check(mse < SERVE_MSE_FRAC * var_y
                  and sparse_mse < SERVE_MSE_FRAC * var_y,
                  f"{where}: MSE {mse}, sparse {sparse_mse} against "
                  f"var(y_test) {var_y}")
        check(captures_sparse == 2 and captures_back == 2 and sparse_finite
              and steady_caps == 2,
              f"{where}: sampler mode captures {captures_sparse}, "
              f"{captures_back}, finite {sparse_finite}")
        check(drop_exact and revive_exact and captures_dr == 1,
              f"{where}: drop/revive not exact or captured anew")
        check(reload_ok, f"{where}: the reload {rep}, equal {reload_equal}")
        check(torn_keeps, f"{where}: the torn checkpoint {torn}")
        check(quarantines == 1 and quarantine_exact,
              f"{where}: quarantine at dispatch {quarantines}, exact "
              f"{quarantine_exact}")
        check(in_turn_equal, f"{where}: the in-turn graph differs")
        check(b1_launches > 0 and b4_launches > 0
              and variants["B1"][b1_variant] == launches["B1"],
              f"{where}: launches B1 {b1_launches}, B4 {b4_launches}, "
              f"by variant {variants['B1']}")
        out[label] = {"B1": b1_launches, "B4": b4_launches}
    return out


# EM iterations an elastic round (the `elastic` phase): R = 30 / 5 = 6
ELASTIC_ROUND = 5
# seconds the spawned ranks of the `parallel` phase may take in all
RANKS_TIMEOUT_S = 300.0


class PhaseProfile:
    """A `timer=` for `parallel_slda`: torch.profiler over the "train"
    and the "gather" phases (CUDA activity), the device kernels' names of
    each kept in `kernels[phase]`."""

    def __init__(self):
        self.kernels = {}

    def __call__(self, phase):
        import contextlib

        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        if phase not in ("train", "gather"):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def traced():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                yield
                torch.cuda.synchronize()
            self.kernels[phase] = sorted(
                {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA})
        return traced()


def batched_forms(dev, seed):
    """The batched forms that ROADMAP C7 replaced (the η solve's Gram
    product, its right-hand side and solve, `zb @ η`, the train MSE's
    mean), each on four chains at once against the same operation chain
    by chain, on random inputs at the slice's shapes (a shard's 750
    documents, the 1,216 test documents; T = 16 and 512): the largest
    difference of each, a report (0.0 where the card's batched call does
    not depend on the batch)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for d, t in ((750, 16), (1216, 16), (750, 512)):
        z = torch.rand((4, d, t), generator=g, device=dev)
        z = z / z.sum(-1, keepdim=True)
        y = torch.randn((4, d), generator=g, device=dev)
        eta = torch.randn((4, t), generator=g, device=dev)

        def forms(z, y, eta):
            zt = z.transpose(-1, -2)
            gram = zt @ z
            rhs = (zt @ y[..., None])[..., 0]
            sol = torch.linalg.solve_ex(
                gram / 0.25 + torch.eye(t, device=dev) / 10.0,
                rhs / 0.25).result
            yhat = (z @ eta[..., None])[..., 0]
            return {"gram": gram, "rhs": rhs, "eta": sol, "zb_eta": yhat,
                    "mse": ((yhat - y) ** 2).mean(-1)}
        whole = forms(z, y, eta)
        alone = [forms(z[c:c + 1], y[c:c + 1], eta[c:c + 1])
                 for c in range(4)]
        out[f"D{d}_T{t}"] = {
            k: float((v - torch.cat([a[k] for a in alone])).abs().max())
            for k, v in whole.items()}
    return out


def parallel_phase(seed, dev, smi, train, test, runs, zero_counts,
                   read_counts, main_variant):
    """The multi-process runner (`repro_torch.launch.slda_parallel`) at the
    slice's full scale for each (label, config) of `runs` (the first spl 1
    dense), M = 4: (a) world size 1 under NCCL in this process, 4 chains
    a rank; (b) 4 spawned ranks of 1 chain sharing the card under gloo.
    Gates: every rank's gathered [M, D_test] predictions bit-equal to one
    process's chain batch with the same seed (`train_chains` on the 4
    shards, `predict_chains`) and ŷ to its combine, Simple and Weighted;
    no collective counted in training, one gather after it; in (a), no
    NCCL kernel in a profile of the training phase; a chain poisoned to
    NaN in one rank quarantined, ŷ the survivors' combine bit for bit; 8
    length buckets at spl 1 bit-equal to padded; every rank's B1–B3
    launches (the children count their own).  Reported: each rank's
    train / predict / gather ms (CUDA events; the gather also on the
    host's clock) and its start-up seconds; apart, (a)'s first gather
    (NCCL builds its communicator) and each (b) rank's warm-up run; the
    batched forms ROADMAP C7 replaced against chain by chain
    (`batched_forms`).  Returns the phase's launches, {"B1", "B2", "B3",
    "B4"}."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import combine, predict_chains, train_chains
    from repro_torch.core.parallel import _shards
    from repro_torch.launch.slda_parallel import (gather_rows, init_group,
                                                  parallel_slda, rank_runs,
                                                  run_ranks)
    from repro_torch.testing import poison_model_table

    M = 4
    total = {"B1": 0, "B2": 0, "B3": 0, "B4": 0}
    spl1 = runs[0][1]
    bucketed = dataclasses.replace(spl1, length_buckets=8)
    dead = torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)  # chain 2 poisoned

    # one process, all four chains: what every rank must reproduce
    single = {}
    for label, cfg in runs:
        _, models = train_chains(seed, _shards(train, M, cfg, dev), cfg,
                                 device=dev)
        y = predict_chains(seed, models, test, cfg, device=dev)
        single[label] = (y, {
            "simple": combine.simple_average(y),
            "weighted": combine.weighted_average(
                y, train_mse=models.train_mse)})
    y1 = single[runs[0][0]][0]
    survivors = combine.simple_average(y1, alive=dead)

    def want_launches(cfg, chains):
        spl = cfg.sweeps_per_launch
        n = cfg.n_iters if spl == 1 else -(-cfg.n_iters // spl)
        return {"B1": 1, "B2": n if spl == 1 else 0,
                "B3": 0 if spl == 1 else n}

    def gates(where, label, cfg, rule, yhat, rep, launches):
        y, want = single[label]
        coll = rep["collectives"]
        after = coll["after_train"]
        check(np.array_equal(np.asarray(rep["yhat_chains"]), y.cpu().numpy()),
              f"{where}: gathered predictions differ from the chain batch")
        check(np.array_equal(np.asarray(yhat), want[rule].cpu().numpy()),
              f"{where}: ŷ differs from the chain batch's combine")
        check(coll["train"]["count"] == 0,
              f"{where}: collectives in training {coll['train']}")
        check(after["count"] == 1 and set(after["calls_by_kind"]) <= {
            "all_gather_single", "all_gather_into_tensor"},
              f"{where}: collectives after training {after}")
        check(launches == want_launches(cfg, 1),
              f"{where}: launches {launches}")

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else v

    def coll_dict(rep):
        return {k: (v if isinstance(v, dict) else v.as_dict())
                for k, v in rep["collectives"].items()}

    t_phase = time.perf_counter()
    # ---- (a) world size 1 under NCCL, in this process
    rows_a = []
    with tempfile.TemporaryDirectory(prefix="rendezvous_") as tmp:
        t0 = time.perf_counter()
        init_group("nccl", 0, 1, f"file://{tmp}/store", RANKS_TIMEOUT_S)
        group_s = time.perf_counter() - t0
        try:
            # NCCL builds its communicator at the first collective: one
            # gather of one value first, timed apart
            t0 = time.perf_counter()
            gather_rows(torch.zeros((1, 1), device=dev))
            torch.cuda.synchronize()
            communicator_ms = (time.perf_counter() - t0) * 1e3
            for label, cfg in runs:
                for rule in ("simple", "weighted"):
                    zero_counts()
                    yhat, rep = parallel_slda(
                        seed, train, test, cfg, rule=rule,
                        chains_per_device=M, device=dev, return_report=True)
                    torch.cuda.synchronize()
                    launches, sparse_launches, variants = read_counts()
                    is_sparse = cfg.sampler_mode == "sparse"
                    check(all(variants[k][v] == launches[k] for k, v
                              in main_variant(cfg).items()),
                          f"parallel (a) {label}: variants {variants}")
                    check(sum(sparse_launches.values())
                          == (sum(launches.values()) if is_sparse else 0),
                          f"parallel (a) {label}: sparse launches "
                          f"{sparse_launches}")
                    gates(f"parallel (a) {label} {rule}", label, cfg, rule,
                          host(yhat), {**rep, "yhat_chains":
                                       host(rep["yhat_chains"]),
                                       "collectives": coll_dict(rep)},
                          launches)
                    for k in ("B1", "B2", "B3"):
                        total[k] += launches[k]
                    total["B4"] += sum(sparse_launches.values())
                    rows_a.append({"config": label, "rule": rule,
                                   "ms": rep["ms"], "launches": launches,
                                   "sparse_launches": sparse_launches,
                                   "collectives": coll_dict(rep)})
            # the training phase under the profiler: no NCCL kernel
            prof = PhaseProfile()
            parallel_slda(seed, train, test, spl1, chains_per_device=M,
                          device=dev, timer=prof)
            nccl_train = [k for k in prof.kernels["train"]
                          if "nccl" in k.lower()]
            nccl_gather = [k for k in prof.kernels["gather"]
                           if "nccl" in k.lower()]
            # a NaN chain, auto-quarantined; 8 length buckets at spl 1
            zero_counts()
            y_bad, rep_bad = parallel_slda(
                seed, train, test, spl1, chains_per_device=M, device=dev,
                return_report=True, fault_hook=lambda models, ids:
                poison_model_table(models, ids.index(2), "nan_eta"))
            y_bkt = parallel_slda(seed, train, test, bucketed,
                                  chains_per_device=M, device=dev)
            torch.cuda.synchronize()
            launches, sparse_launches, _ = read_counts()
            for k in ("B1", "B2", "B3"):
                total[k] += launches[k]
        finally:
            dist.destroy_process_group()
    quarantine_a = (rep_bad["n_quarantined"] == 1
                    and torch.equal(rep_bad["alive"].to(dev), dead)
                    and torch.equal(y_bad, survivors))
    buckets_a = torch.equal(y_bkt, single[runs[0][0]][1]["simple"])
    emit({"phase": "parallel", "form": "world1_nccl", "card": smi,
          "backend": "nccl", "chains_per_device": M,
          "group_init_s": group_s, "first_gather_ms": communicator_ms,
          "batched_forms_max_abs_diff": batched_forms(dev, seed),
          "runs": rows_a,
          "nccl_kernels_in_train": nccl_train,
          "nccl_kernels_in_gather": nccl_gather,
          "train_kernels": len(prof.kernels["train"]),
          "quarantine_exact": quarantine_a,
          "buckets_equal_padded": buckets_a,
          "extra_launches": launches})
    check(prof.kernels["train"] and not nccl_train,
          f"parallel (a): NCCL kernels in training {nccl_train}")
    check(quarantine_a, "parallel (a): the NaN chain's quarantine is not "
          f"exact ({rep_bad['n_quarantined']} quarantined)")
    check(buckets_a, "parallel (a): 8 length buckets differ from padded")

    # ---- (b) 4 ranks of one chain under gloo, sharing the card; each
    # rank's first run (its CUDA libraries' first calls) is a warm-up
    runs_b, names = [dict(cfg=spl1, chains_per_device=1)], []
    for label, cfg in runs:
        for rule in ("simple", "weighted"):
            runs_b.append(dict(cfg=cfg, rule=rule, chains_per_device=1))
            names.append((label, rule))
    runs_b.append(dict(cfg=spl1, chains_per_device=1, poison=(2, "nan_eta")))
    runs_b.append(dict(cfg=bucketed, chains_per_device=1))
    t0 = time.perf_counter()
    res = run_ranks(4, rank_runs, dict(seed=seed, train=train.to("cpu"),
                                       test=test.to("cpu"), runs=runs_b,
                                       device=str(dev)),
                    timeout_s=RANKS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    rows_b = []
    for rank, (results, startup_s) in enumerate(res):
        warm, results = results[0], results[1:]
        for k, v in warm["report"]["launches"].items():
            total[k] += v[0]
        per_run = []
        for (label, rule), r in zip(names, results):
            cfg = dict(runs)[label]
            rep = r["report"]
            launches = {k: v[0] for k, v in rep["launches"].items()}
            gates(f"parallel (b) rank {rank} {label} {rule}", label, cfg,
                  rule, r["yhat"], rep, launches)
            check(rep["backend"] == "gloo" and rep["chain_ids"] == [rank],
                  f"parallel (b) rank {rank}: {rep['backend']}, "
                  f"{rep['chain_ids']}")
            for k in ("B1", "B2", "B3"):
                total[k] += launches[k]
            total["B4"] += sum(v[1] for v in rep["launches"].values())
            per_run.append({"config": label, "rule": rule, "ms": rep["ms"],
                            "launches": rep["launches"]})
        bad, bkt = results[-2], results[-1]
        for r in (bad, bkt):
            for k, v in r["report"]["launches"].items():
                total[k] += v[0]
        quarantine_b = (bad["report"]["n_quarantined"] == 1
                        and np.array_equal(bad["yhat"],
                                           survivors.cpu().numpy()))
        buckets_b = np.array_equal(bkt["yhat"], results[0]["yhat"])
        rows_b.append({"rank": rank, "startup_s": startup_s,
                       "warm_up_ms": warm["report"]["ms"],
                       "runs": per_run, "quarantine_exact": quarantine_b,
                       "buckets_equal_padded": buckets_b})
        check(quarantine_b, f"parallel (b) rank {rank}: the NaN chain's "
              "quarantine is not exact")
        check(buckets_b, f"parallel (b) rank {rank}: 8 length buckets "
              "differ from padded")
    emit({"phase": "parallel", "form": "world4_gloo_one_card", "card": smi,
          "backend": "gloo", "chains_per_device": 1, "ranks_s": ranks_s,
          "ranks": rows_b,
          "phase_s": time.perf_counter() - t_phase})
    return total


def elastic_phase(seed, dev, smi, train, test, runs, zero_counts,
                  read_counts, main_variant):
    """The elastic runner (`repro_torch.launch.elastic`) at the slice's
    full scale for each (label, config) of `runs`: M = 4, rounds of
    ELASTIC_ROUND EM iterations (R = 6), a simulated pool of 2 devices,
    asynchronous checkpoints under a temporary directory.  Gates, the
    reference's elastic tests on the card: an undisturbed run equals
    itself and runs over pools of 1 and 4; a device loss at wall round 3
    with checkpoints every 2 rounds restores from step 2 and catches up
    to the undisturbed state bit for bit; without a checkpoint directory
    its chains are quarantined and the survivors lane-equal; a preemption
    at round 2 then `resume` equals the undisturbed run; a straggler is
    flagged, then evicted; asynchronous and synchronous checkpoints give
    the same bits; no run builds more than its one round plan;
    `elastic_run_average`'s MSE under 0.6·var(y_test); every B1–B3
    launch on the main path's variant.  Reported: each wall round's ms
    and its checkpoint's (asynchronous and synchronous), the launches.
    Returns the phase's launches, {"B1", "B2", "B3", "B4"}."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import read_manifest
    from repro_torch.core.parallel import _shards
    from repro_torch.core.supervisor import F_KILLED, F_STRAGGLER
    from repro_torch.launch.elastic import (ElasticConfig, ElasticRunner,
                                            elastic_run_average)
    from repro_torch.testing import ElasticEvent, VirtualClock

    M = 4
    var_y = float(test.y.var(unbiased=False))
    total = {"B1": 0, "B2": 0, "B3": 0, "B4": 0}

    def same(a, b, idx=None):
        pick = (lambda x: x) if idx is None else (lambda x: x[idx])
        return all(torch.equal(pick(getattr(a, f)), pick(getattr(b, f)))
                   for f in ("z", "ndt", "ntw", "nt", "eta"))

    for label, cfg in runs:
        t_row = time.perf_counter()
        el = ElasticConfig(round_iters=ELASTIC_ROUND)
        R = cfg.n_iters // ELASTIC_ROUND
        shards = _shards(train, M, cfg, dev)
        plans = []

        def run(*, devices=2, elastic=el, resume=False, **kw):
            runner = ElasticRunner(shards, cfg, devices=devices,
                                   elastic=elastic, **kw)
            state, _, rep = runner.train(seed, resume=resume)
            plans.append(rep.round_plans)
            return state, rep, runner

        zero_counts()
        with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
            s0, r0, _ = run()
            s_again, _, _ = run()
            s_pool1, _, _ = run(devices=1)
            s_pool4, _, _ = run(devices=4)
            loss = [ElasticEvent("device_loss", at_round=3, device=1)]
            s_loss, r_loss, _ = run(
                events=loss, ckpt_dir=f"{tmp}/loss",
                elastic=ElasticConfig(round_iters=ELASTIC_ROUND,
                                      ckpt_every=2))
            s_q, r_q, _ = run(events=loss)
            _, r_p1, _ = run(events=[ElasticEvent("preempt", at_round=2)],
                             ckpt_dir=f"{tmp}/preempt")
            s_p2, r_p2, _ = run(ckpt_dir=f"{tmp}/preempt", resume=True)
            s_s, r_s, runner_s = run(
                events=[ElasticEvent("straggle", at_round=1, device=1,
                                     delay_s=5.0, rounds=3)],
                clock=VirtualClock(),
                elastic=ElasticConfig(round_iters=ELASTIC_ROUND,
                                      deadline_s=2.0, straggle_rounds=2))
            s_sync, r_sync, _ = run(
                ckpt_dir=f"{tmp}/sync",
                elastic=ElasticConfig(round_iters=ELASTIC_ROUND,
                                      async_ckpt=False))
            s_async, r_async, _ = run(ckpt_dir=f"{tmp}/async")
            files_equal = read_manifest(f"{tmp}/sync", R) == \
                read_manifest(f"{tmp}/async", R)
            for c in range(M):
                name = f"step_{R:08d}/chain_{c:03d}.npz"
                with np.load(f"{tmp}/sync/{name}") as a, \
                        np.load(f"{tmp}/async/{name}") as b:
                    files_equal &= sorted(a.files) == sorted(b.files) and \
                        all(np.array_equal(a[k], b[k]) for k in a.files)
            yhat, rep_avg = elastic_run_average(
                seed, train, test, cfg, M, devices=2, elastic=el,
                events=loss, ckpt_dir=f"{tmp}/average", device=dev)
        torch.cuda.synchronize()
        launches, sparse_launches, variants = read_counts()
        mse = float(((yhat - test.y) ** 2).mean())
        acts = [e["action"] for h in r_s.history for e in h["events"]]
        survivors = np.nonzero(r_q.alive)[0]
        gates = {
            "deterministic": same(s_again, s0),
            "pool_1_and_4_equal": same(s_pool1, s0) and same(s_pool4, s0),
            "loss_caught_up_equal": (r_loss.alive.all()
                                     and (r_loss.progress == R).all()
                                     and r_loss.wall_rounds == R + 1
                                     and same(s_loss, s0)),
            "loss_quarantine_exact": (
                list(np.nonzero(~r_q.alive)[0]) == [2, 3]
                and all(r_q.status[c] & F_KILLED for c in (2, 3))
                and same(s_q, s0, idx=torch.as_tensor(survivors))),
            "preempt_resume_equal": (r_p1.preempted
                                     and r_p2.resume_round
                                     == r_p1.wall_rounds
                                     and same(s_p2, s0)),
            "straggler_flagged_evicted": (
                [bool(s & F_STRAGGLER) for s in r_s.status]
                == [False, False, True, True]
                and runner_s.pool.ids == (0,)
                and "straggler_evicted" in acts and same(s_s, s0)),
            "async_sync_equal": same(s_async, s_sync) and same(s_sync, s0)
            and files_equal,
            "one_round_plan_a_run": set(plans) == {1},
            "average_all_alive": bool(rep_avg.alive.all()),
        }
        emit({"phase": "elastic", "config": label, "card": smi,
              "sweeps_per_launch": cfg.sweeps_per_launch,
              "sampler_mode": cfg.sampler_mode, "chains": M,
              "round_iters": ELASTIC_ROUND, "rounds": R, "pool": 2,
              "gates": gates, "test_mse": mse, "var_y_test": var_y,
              "round_ms_async": [h["round_ms"] for h in r_async.history],
              "ckpt_ms_async": [h["ckpt_ms"] for h in r_async.history],
              "round_ms_sync": [h["round_ms"] for h in r_sync.history],
              "ckpt_ms_sync": [h["ckpt_ms"] for h in r_sync.history],
              "round_ms_undisturbed": [h["round_ms"] for h in r0.history],
              "loss_wall_rounds": r_loss.wall_rounds,
              "restores": [e["action"] for h in r_loss.history
                           for e in h["events"] if "chain" in e],
              "round_plans": plans, "launches": launches,
              "sparse_launches": sparse_launches,
              "variant_launches": variants,
              "seconds": time.perf_counter() - t_row})
        for name, ok in gates.items():
            check(ok, f"elastic {label}: {name}")
        check(mse < 0.6 * var_y,
              f"elastic {label}: MSE {mse} against var(y_test) {var_y}")
        check(all(variants[k][v] == launches[k] for k, v
                  in main_variant(cfg).items())
              and launches["B1"] > 0
              and launches["B2" if cfg.sweeps_per_launch == 1 else "B3"] > 0,
              f"elastic {label}: launches {launches}, {variants}")
        for k in ("B1", "B2", "B3"):
            total[k] += launches[k]
        total["B4"] += sum(sparse_launches.values())
    return total


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
                                     slda_train, sparse)
    from repro_torch.kernels.prng import counter_uniform
    from repro_torch.mathutil import upper_tri_ones

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
    # B5's bf16 prefill runs on wgmma: HGMMA in its machine code
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "--dump-sass",
         str(Path(build.build_info["directory"]) / "libflash_attention.so")],
        capture_output=True, text=True, check=True).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    # B6's bf16 route runs on the tensor cores (wgmma, and mma.sync for
    # G): HGMMA or HMMA in its machine code
    sass6 = subprocess.run(
        [cuobjdump, "--dump-sass",
         str(Path(build.build_info["directory"]) / "libssd_scan.so")],
        capture_output=True, text=True, check=True).stdout
    tc6 = sum("HMMA" in ln or "HGMMA" in ln for ln in sass6.splitlines())
    gated_ptxas = ptxas_use(build.build_info["log"], SPILL_FREE_KERNELS)
    # every sampler kernel's spills (the warp layout's at K up to 16)
    spills = {k: v for k, v in ptxas_use(
        build.build_info["log"],
        ("predict_", "gibbs_", "train_", "sparse_draw")).items()
              if v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "build", "seconds": build.build_info["seconds"],
          "directory": build.build_info["directory"], "ptxas": ptxas,
          "gated_ptxas": gated_ptxas,
          "sampler_kernels_with_spills": spills,
          # B1's and B2's variants (the warp ones at K = 1, T <= 32)
          "b1_b2_ptxas": ptxas_use(
              build.build_info["log"],
              ("predict_lane", "gibbs_half", "gibbs_log_table",
               "predict_sweeps_kernelILi1E", "gibbs_sweep_kernelILi1E")),
          "b5_hgmma_instructions": hgmma,
          "b6_tensor_core_instructions": tc6})
    check(all(any(f in k for k in gated_ptxas) for f in SPILL_FREE_KERNELS)
          and not any(v.get("spill_stores") or v.get("spill_loads")
                      for v in gated_ptxas.values()),
          f"a kernel missing or spilling {gated_ptxas}")
    check(hgmma > 0, "B5: no HGMMA instruction in its machine code")
    check(tc6 > 0, "B6: no HMMA or HGMMA instruction in its machine code")

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

    def event_ms(fn, reps, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def bound_ms(tensors, n_ops, extra_bytes=0, peak_ops=PEAK_FP32_S):
        nbytes = extra_bytes + sum(t.numel() * t.element_size()
                                   for t in tensors)
        by_bytes, by_ops = nbytes / PEAK_BYTES_S, n_ops / peak_ops
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    train, test = fig6_mdna.make_data(args.seed, dev)
    T0, W = fig6_mdna.N_TOPICS, fig6_mdna.VOCAB
    M, cfg = fig6_mdna.M, fig6_mdna.CFG
    rows = {}

    def rand_table(m, t, g=gen):
        """A peaked random topic-word table [m, t, W], rows summing to 1."""
        p = torch.rand((m, t, W), device=dev, generator=g) ** 8 + 1e-6
        return p / p.sum(-1, keepdim=True)

    # the one-chain rows draw from a generator of their own, so that every
    # other row keeps the inputs it had before they were added
    gen1 = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def against_warp(kind, run, got, mask, reps, ms):
        """B1's or B2's replaced (warp) kernel on the row's inputs:
        `run(variant)` returns (z, ndt) as `got` holds them.  Its time and
        whether its draws and counts equal `got`; a row whose main-path
        variant is the warp one is its own replaced kernel."""
        if kind == "warp":
            return {"replaced_ms": ms, "replaced_draws_equal": True}
        same = replaced_agrees(got, run("warp"), mask)
        return {"replaced_ms": event_ms(lambda: run("warp"), reps),
                "replaced_draws_equal": same}

    def sweep_by_sweep(a, kw, real, index=None, torch_sum=False):
        """B3 held sweep by sweep from identical states (ROADMAP C2): for
        k = 1 .. n_sweeps, the kernel's launch of k sweeps against the
        plain version's sweep k alone, handed the kernel's own z and ndt
        after k − 1 sweeps (its launch of k − 1 sweeps from the same
        start), the launch-start tables and the block-local tables they
        imply, and sweep k's uniforms.  The mismatch of each sweep over
        real tokens; with `torch_sum`, also that of a plain version whose
        running Σ_t η_t·N_dt starts from one torch reduction in place of
        the kernels' lane order (`ref.lane_eta_dot`, ROADMAP C5)."""
        tokens, msk, sd, z0, ndt0, y, il, ntw_t, nt, eta = a
        one = {k: v for k, v in kw.items() if k != "n_sweeps"}
        z, ndt, out, out_torch = z0, ndt0, [], []
        lane_order = ref.lane_eta_dot
        orders = [(out, lane_order)]
        if torch_sum:
            orders.append((out_torch, lambda n_, e_: (n_ * e_).sum(-1)))
        for k in range(1, kw["n_sweeps"] + 1):
            z_k, ndt_k = slda_train.slda_train_sweeps_cuda(
                *a, n_sweeps=k, topic_index=index, **one)
            for rates, eta_dot in orders:
                ref.lane_eta_dot = eta_dot
                try:
                    z_p, _ = ref.slda_train_sweep_from(
                        tokens, msk, sd, z0, z, ndt, y, il, ntw_t, nt, eta,
                        sweep=k - 1, topic_index=index, **one)
                finally:
                    ref.lane_eta_dot = lane_order
                rates.append(float(((z_k != z_p) & (msk > 0)).sum()) / real)
            z, ndt = z_k, ndt_k
        return (out, out_torch) if torch_sum else out

    # the shapes [R, T] of the prefix sums the plain samplers take in the
    # rows below, the dense draw's and the sparse draw's three (read by the
    # prefix_order phase after them)
    prefix_shapes = set()
    plain_prefix_sum = ref.prefix_sum

    def recorded_prefix_sum(p):
        prefix_shapes.add((p.numel() // max(p.shape[-1], 1), p.shape[-1]))
        return plain_prefix_sum(p)

    ref.prefix_sum = sparse.prefix_sum = recorded_prefix_sum

    # ---- B1: prediction, shared corpus (the weighted pass: test + train)
    both = torch.cat([test.tokens, train.tokens]), \
        torch.cat([test.mask, train.mask])
    full = dict(alpha=cfg.alpha, n_burnin=cfg.n_pred_burnin,
                n_samples=cfg.n_pred_samples)
    sweeps_b1 = cfg.n_pred_burnin + cfg.n_pred_samples
    # slice_one_chain: the slice's chain 0 alone, a quarter of the warps,
    # so a step's time with (slice) and without (one chain) other warps on
    # its scheduler tells issue from latency; test_one_chain: one chain
    # over the test documents, the launch of Nonparallel's and Naive's
    # predict, where the warp variant has few warps
    for label, t, d, chains in (("slice", T0, both[0].shape[0], M),
                                ("slice_one_chain", T0, both[0].shape[0], 1),
                                ("test_one_chain", T0, test.n_docs, 1),
                                ("T128", 128, 256, M),
                                ("T512", 512, 256, M)):
        tokens, mask = both[0][:d].contiguous(), both[1][:d].contiguous()
        rg = gen if chains == M else gen1
        ri = dict(int32, generator=rg)
        phi_t = rand_table(M, t, rg).transpose(1, 2).contiguous()
        z0 = torch.randint(0, t, (M,) + tuple(tokens.shape), **ri)
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **ri)
        ndt0, _, _ = counts_from_assignments(
            tokens.expand(M, -1, -1), mask.expand(M, -1, -1), z0, t, W)
        phi_t, z0, sd, ndt0 = (x[:chains].contiguous()
                               for x in (phi_t, z0, sd, ndt0))
        real = float(mask.sum()) * chains
        a = (tokens, mask, sd, z0, ndt0, phi_t)
        one = dict(alpha=cfg.alpha, n_burnin=0, n_samples=1)

        def b1_run(v, kw):
            avg, z = slda_predict.slda_predict_sweeps_cuda(
                *a, kernel_variant=v, **kw)
            return z, avg
        (avg_k, z_k), kind = variant_of(
            slda_predict.variant_launches,
            lambda: slda_predict.slda_predict_sweeps_cuda(*a, **one))
        avg_p, z_p = ref.slda_predict_sweeps_chains(*a, **one)
        mis = float(((z_k != z_p) & (mask > 0)).sum()) / real
        err = float((avg_k - avg_p).abs().max())
        recount, _, _ = counts_from_assignments(
            tokens.expand(chains, -1, -1), mask.expand(chains, -1, -1), z_k,
            t, W)
        exact = bool(torch.equal(recount, avg_k))
        avg_f, z_f = slda_predict.slda_predict_sweeps_cuda(*a, **full)
        lens = mask.sum(-1).expand(chains, -1)
        row_err = float(((avg_f.sum(-1) - lens).abs()
                         / lens.clamp(min=1)).max())
        ms = event_ms(lambda: slda_predict.slda_predict_sweeps_cuda(
            *a, **full), 5)
        plain = event_ms(lambda: ref.slda_predict_sweeps_chains(
            *a, **full), 1)
        # the replaced kernel: one sweep and all of them, draws and counts
        replaced = against_warp(kind, lambda v: b1_run(v, full),
                                (z_f, avg_f), mask, 5, ms)
        if kind != "warp":
            replaced["replaced_draws_equal"] &= replaced_agrees(
                (z_k, avg_k), b1_run("warp", one), mask)
        steps = real * sweeps_b1
        b_ms, b_by = bound_ms([tokens, mask, sd, z0, ndt0, phi_t, avg_f,
                               z_k], OPS_PER_TOPIC["B1"] * t * steps)
        row = {"phase": "B1", "shape": label, "M": chains, "D": d,
               "N": tokens.shape[1], "T": t, "W": W, "variant": kind,
               "real_tokens": real, "draw_mismatch": mis,
               "one_sweep_max_abs_err": err, "counts_exact": exact,
               "row_sum_rel_err": row_err, "ms": ms, **replaced,
               **device_fields("device_us", lambda: b1_run(None, full)),
               **device_fields("replaced_device_us",
                               lambda: b1_run("warp", full)),
               "layout_ms": event_ms(lambda: slda_predict.lane_layout(
                   tokens, mask), 20) if kind == "lane" else None,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               **critical_path(mask.sum(-1)[None], sweeps_b1, [
                   ("", own_walks(d), ms),
                   ("replaced_", own_walks(d), replaced["replaced_ms"])])}
        emit(row)
        rows.setdefault("B1", row)
        check(row["replaced_draws_equal"],
              f"B1 {label}: draws differ from the replaced kernel's")
        check(mis <= MISMATCH_MAX, f"B1 {label}: draw mismatch {mis}")
        check(exact, f"B1 {label}: ndt differs from counts of z")
        check(row_err <= 1e-4, f"B1 {label}: ndt_avg rows off by {row_err}")

    # ---- B2: one training sweep, chain-sharded corpus
    for label, t, docs, chains in (("slice", T0, train.n_docs, M),
                                   ("slice_one_chain", T0, train.n_docs, 1),
                                   ("T128", 128, 1024, M),
                                   ("T512", 512, 1024, M)):
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        rg = gen if chains == M else gen1
        z = torch.randint(0, t, tuple(sh.tokens.shape),
                          **dict(int32, generator=rg))
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=rg) * 2.0
        u = torch.rand(tuple(sh.tokens.shape), device=dev, generator=rg)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        a = tuple(x[:chains].contiguous() for x in (
            sh.tokens, sh.mask, u, z, ndt, sh.y, inv_len, ntw_t, nt, eta))
        tok_c, mask_c = a[0], a[1]
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                  supervised=True)
        (z_k, ndt_k), kind = variant_of(
            slda_gibbs.variant_launches,
            lambda: slda_gibbs.slda_gibbs_sweep_cuda(*a, **kw))
        z_p, ndt_p = ref.ref_slda_gibbs_sweep_chains(*a, **kw)
        real = float(mask_c.sum())
        mis = float(((z_k != z_p) & (mask_c > 0)).sum()) / real
        err = float((ndt_k - ndt_p).abs().max())
        recount, _, _ = counts_from_assignments(tok_c, mask_c, z_k, t, W)
        exact = bool(torch.equal(recount, ndt_k))
        ms = event_ms(lambda: slda_gibbs.slda_gibbs_sweep_cuda(*a, **kw), 20)
        plain = event_ms(lambda: ref.ref_slda_gibbs_sweep_chains(*a, **kw),
                         2)
        run = lambda v=None: slda_gibbs.slda_gibbs_sweep_cuda(  # noqa: E731
            *a, kernel_variant=v, **kw)
        replaced = against_warp(kind, run, (z_k, ndt_k), mask_c, 20, ms)
        b_ms, b_by = bound_ms(list(a) + [z_k, ndt_k],
                              OPS_PER_TOPIC["B2"] * t * real)
        row = {"phase": "B2", "shape": label, "M": chains, "D": d,
               "N": sh.max_len, "T": t, "W": W, "variant": kind,
               "real_tokens": real, "draw_mismatch": mis,
               "max_abs_err": err, "counts_exact": exact, "ms": ms,
               **replaced, **device_fields("device_us", run),
               **device_fields("replaced_device_us", lambda: run("warp")),
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               **critical_path(mask_c.sum(-1), 1, [
                   ("", own_walks(d), ms),
                   ("replaced_", own_walks(d), replaced["replaced_ms"])])}
        emit(row)
        rows.setdefault("B2", row)
        check(row["replaced_draws_equal"],
              f"B2 {label}: draws differ from the replaced kernel's")
        check(mis <= MISMATCH_MAX, f"B2 {label}: draw mismatch {mis}")
        check(exact, f"B2 {label}: ndt differs from counts of z")

    # ---- B3: fused training launches, chain-sharded corpus; the T = 512
    # rows in both forms (the log form's inputs from a generator of their
    # own, so that every other row keeps the inputs it had), each held
    # against the torch-sum order of Σ_t η_t·N_dt as well (ROADMAP C5)
    gen_c5 = torch.Generator(device=dev).manual_seed(args.seed + 3)
    for label, t, docs, sweeps, product, g3 in (
            ("slice", T0, train.n_docs, 8, True, gen),
            ("T128", 128, 1024, 8, True, gen),
            ("slice_log", T0, train.n_docs, 2, False, gen),
            ("T512", 512, 1024, 8, True, gen),
            ("T512_log", 512, 1024, 8, False, gen_c5)):
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        i3 = dict(int32, generator=g3)
        z = torch.randint(0, t, tuple(sh.tokens.shape), **i3)
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=g3) * 2.0
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **i3)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        db = build_plan(sh, cfg).train_doc_block(d)
        a = (sh.tokens, sh.mask, sd, z, ndt, sh.y, inv_len, ntw_t, nt, eta)
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                  n_sweeps=sweeps, doc_block=db, supervised=True,
                  product_form=product)
        (z_k, ndt_k), kind = variant_of(
            slda_train.variant_launches,
            lambda: slda_train.slda_train_sweeps_cuda(*a, **kw))
        z_p, ndt_p = ref.slda_train_sweeps_chains(*a, **kw)
        real = float(sh.mask.sum())
        fused_mis = float(((z_k != z_p) & (sh.mask > 0)).sum()) / real
        c5 = {}
        if t == 512:
            sweep_mis, c5["torch_sum_sweep_mismatch"] = sweep_by_sweep(
                a, kw, real, torch_sum=True)
        else:
            sweep_mis = sweep_by_sweep(a, kw, real)
        mis = max(sweep_mis)
        # the replaced kernel's draws, which the cluster variant repeats
        same = replaced_agrees(
            (z_k, ndt_k), slda_train.slda_train_sweeps_cuda(
                *a, kernel_variant="block", **kw), sh.mask)
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
        replaced_ms = event_ms(lambda: slda_train.slda_train_sweeps_cuda(
            *a, kernel_variant="block", **kw), 10)
        plain = event_ms(lambda: ref.slda_train_sweeps_chains(*a, **kw), 1)
        copies = M * -(-d // db)            # one private table per block
        form = "B3_product" if product else "B3_log"
        b_ms, b_by = bound_ms(list(a) + [z_k, ndt_k],
                              OPS_PER_TOPIC[form] * t * real * sweeps,
                              extra_bytes=copies * W * t * 4)
        row = {"phase": "B3", "shape": label, "M": M, "D": d,
               "N": sh.max_len, "T": t, "W": W, "doc_block": db,
               "sweeps": sweeps, "product_form": product,
               "variant": kind, "real_tokens": real,
               "draw_mismatch": mis, "sweep_mismatch": sweep_mis, **c5,
               "fused_mismatch": fused_mis, "max_abs_err": err,
               "counts_exact": exact, "refresh_exact": refresh_exact,
               "ms": ms, "replaced_ms": replaced_ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by,
               "replaced_draws_equal": same,
               **b3_critical_path(sh.mask, d, db, t, sweeps, ms,
                                    replaced_ms)}
        emit(row)
        rows.setdefault("B3", row)
        check(same, f"B3 {label}: draws differ from the replaced kernel's")
        check(mis <= MISMATCH_MAX,
              f"B3 {label}: a sweep's draw mismatch {sweep_mis}")
        check(exact, f"B3 {label}: ndt differs from counts of z")
        check(refresh_exact, f"B3 {label}: count refresh differs")

    # ---- B3_parting: B3 against its plain version after 1 to 8 sweeps,
    # at T = 128 on fresh inputs (a generator of their own).  A draw may
    # differ where a uniform lies within rounding of a CDF boundary; in a
    # fused launch that token's document, and through the doc block's
    # shared table its block, then walk on from other states, so one such
    # draw shows as a share of the tokens some sweeps later.  Gated as the
    # rule for one sweep on identical inputs reads: after one sweep the
    # mismatch stays within MISMATCH_MAX.
    gp = torch.Generator(device=dev).manual_seed(args.seed + 2)
    sh = partition(train.map(lambda x: x[:1024]), M)
    db = build_plan(sh, cfg).train_doc_block(sh.n_docs)
    inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
    real = float(sh.mask.sum())
    parting = []
    for _ in range(4):
        z = torch.randint(0, 128, tuple(sh.tokens.shape),
                          **dict(int32, generator=gp))
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, 128, W)
        eta = torch.randn((M, 128), device=dev, generator=gp) * 2.0
        sd = torch.randint(0, 2 ** 31 - 1, (M, sh.n_docs),
                           **dict(int32, generator=gp))
        a = (sh.tokens, sh.mask, sd, z, ndt, sh.y, inv_len,
             ntw.transpose(1, 2).contiguous(), nt, eta)
        parted = []
        for k in range(1, 9):
            kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                      n_sweeps=k, doc_block=db, supervised=True,
                      product_form=True)
            z_k, _ = slda_train.slda_train_sweeps_cuda(*a, **kw)
            z_p, _ = ref.slda_train_sweeps_chains(*a, **kw)
            parted.append(int(((z_k != z_p) & (sh.mask > 0)).sum()))
        parting.append(parted)
    emit({"phase": "B3_parting", "T": 128, "M": M, "D": sh.n_docs,
          "doc_block": db, "real_tokens": real,
          "mismatched_tokens_after_1_to_8_sweeps": parting})
    check(all(r[0] / real <= MISMATCH_MAX for r in parting),
          f"B3_parting: one sweep parts beyond the bound {parting}")

    # ---- the sparse draw (kernel B4) inside B1 / B2 / B3.  Each row runs
    # the kernel's sparse instantiation and its plain version on identical
    # inputs and the topic index the ops would build from the same table;
    # the dense instantiation is timed on the same inputs.  The plain
    # version tallies the real tokens that took stage 2.
    sparse_shapes = (("slice", T0, cfg.sparse_topic_cap),
                     ("slice_cap4", T0, 4), ("T128", 128, 32),
                     ("T512", 512, 32))

    def index_of(table_t, cap):
        return tuple(a.contiguous()
                     for a in sparse.build_topic_index(table_t, cap))

    def tallied(fn):
        """fn() and the share of its plain sparse draws that took stage 2."""
        ref.sparse_tally.update(tokens=0, stage2=0)
        out = fn()
        tokens = float(ref.sparse_tally["tokens"])
        return out, float(ref.sparse_tally["stage2"]) / max(tokens, 1.0)

    for label, t, cap in sparse_shapes:
        d = both[0].shape[0] if t == T0 else 256
        tokens, mask = both[0][:d].contiguous(), both[1][:d].contiguous()
        phi_t = rand_table(M, t).transpose(1, 2).contiguous()
        index = index_of(phi_t, cap)
        z0 = torch.randint(0, t, (M,) + tuple(tokens.shape), **int32)
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **int32)
        ndt0, _, _ = counts_from_assignments(
            tokens.expand(M, -1, -1), mask.expand(M, -1, -1), z0, t, W)
        real = float(mask.sum()) * M
        a = (tokens, mask, sd, z0, ndt0, phi_t)
        one = dict(alpha=cfg.alpha, n_burnin=0, n_samples=1)

        def b1s_run(v, kw):
            avg, z = slda_predict.slda_predict_sweeps_cuda(
                *a, topic_index=index, kernel_variant=v, **kw)
            return z, avg
        (avg_k, z_k), kind = variant_of(
            slda_predict.variant_launches,
            lambda: slda_predict.slda_predict_sweeps_cuda(
                *a, topic_index=index, **one))
        (avg_p, z_p), share = tallied(lambda: ref.slda_predict_sweeps_chains(
            *a, topic_index=index, **one))
        mis = float(((z_k != z_p) & (mask > 0)).sum()) / real
        err = float((avg_k - avg_p).abs().max())
        recount, _, _ = counts_from_assignments(
            tokens.expand(M, -1, -1), mask.expand(M, -1, -1), z_k, t, W)
        exact = bool(torch.equal(recount, avg_k))
        full = dict(alpha=cfg.alpha, n_burnin=cfg.n_pred_burnin,
                    n_samples=cfg.n_pred_samples)
        ms = event_ms(lambda: slda_predict.slda_predict_sweeps_cuda(
            *a, topic_index=index, **full), 5)
        dense_ms = event_ms(lambda: slda_predict.slda_predict_sweeps_cuda(
            *a, **full), 5)
        plain = event_ms(lambda: ref.slda_predict_sweeps_chains(
            *a, topic_index=index, **full), 1, warm=False)
        steps = real * (cfg.n_pred_burnin + cfg.n_pred_samples)
        k_cap = index[0].shape[-1]
        b_ms, b_by = bound_ms(
            list(a) + list(index) + [avg_k, z_k],
            ((OPS_PER_TOPIC["B1"] - DENSE_DRAW_OPS) * t
             + sparse_draw_ops(t, k_cap, share)) * steps)
        replaced = against_warp(kind, lambda v: b1s_run(v, full),
                                b1s_run(None, full), mask, 5, ms)
        if kind != "warp":
            replaced["replaced_draws_equal"] &= replaced_agrees(
                (z_k, avg_k), b1s_run("warp", one), mask)
        row = {"phase": "B1_sparse", "shape": label, "M": M, "D": d,
               "N": tokens.shape[1], "T": t, "W": W, "cap": k_cap,
               "variant": kind, "real_tokens": real, "draw_mismatch": mis,
               "one_sweep_max_abs_err": err, "counts_exact": exact,
               "stage2_share": share, "ms": ms, **replaced,
               "dense_ms": dense_ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by,
               **critical_path(mask.sum(-1)[None], sweeps_b1, [
                   ("", own_walks(d), ms),
                   ("replaced_", own_walks(d), replaced["replaced_ms"])])}
        emit(row)
        check(kind == slda_predict.variant(t, True, tokens.shape[1]),
              f"B1_sparse {label}: ran {kind}")
        check(row["replaced_draws_equal"],
              f"B1_sparse {label}: draws differ from the replaced kernel's")
        check(mis <= MISMATCH_MAX, f"B1_sparse {label}: draw mismatch {mis}")
        check(exact, f"B1_sparse {label}: ndt differs from counts of z")

    for label, t, cap in sparse_shapes:
        docs = train.n_docs if t == T0 else 1024
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        z = torch.randint(0, t, tuple(sh.tokens.shape), **int32)
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        index = index_of(ntw_t, cap)
        eta = torch.randn((M, t), device=dev, generator=gen) * 2.0
        u = torch.rand(tuple(sh.tokens.shape), device=dev, generator=gen)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        a = (sh.tokens, sh.mask, u, z, ndt, sh.y, inv_len, ntw_t, nt, eta)
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                  supervised=True)
        (z_k, ndt_k), kind = variant_of(
            slda_gibbs.variant_launches,
            lambda: slda_gibbs.slda_gibbs_sweep_cuda(
                *a, topic_index=index, **kw))
        (z_p, ndt_p), share = tallied(lambda: ref.ref_slda_gibbs_sweep_chains(
            *a, topic_index=index, **kw))
        real = float(sh.mask.sum())
        mis = float(((z_k != z_p) & (sh.mask > 0)).sum()) / real
        err = float((ndt_k - ndt_p).abs().max())
        recount, _, _ = counts_from_assignments(sh.tokens, sh.mask, z_k, t,
                                                W)
        exact = bool(torch.equal(recount, ndt_k))
        ms = event_ms(lambda: slda_gibbs.slda_gibbs_sweep_cuda(
            *a, topic_index=index, **kw), 20)
        dense_ms = event_ms(lambda: slda_gibbs.slda_gibbs_sweep_cuda(
            *a, **kw), 20)
        plain = event_ms(lambda: ref.ref_slda_gibbs_sweep_chains(
            *a, topic_index=index, **kw), 1, warm=False)
        k_cap = index[0].shape[-1]
        b_ms, b_by = bound_ms(
            list(a) + list(index) + [z_k, ndt_k],
            ((OPS_PER_TOPIC["B2"] - DENSE_DRAW_OPS) * t
             + sparse_draw_ops(t, k_cap, share)) * real)
        run = lambda v=None: slda_gibbs.slda_gibbs_sweep_cuda(  # noqa: E731
            *a, topic_index=index, kernel_variant=v, **kw)
        replaced = against_warp(kind, run, (z_k, ndt_k), sh.mask, 20, ms)
        row = {"phase": "B2_sparse", "shape": label, "M": M, "D": d,
               "N": sh.max_len, "T": t, "W": W, "cap": k_cap,
               "variant": kind, "real_tokens": real, "draw_mismatch": mis,
               "max_abs_err": err, "counts_exact": exact,
               "stage2_share": share, "ms": ms, **replaced,
               "dense_ms": dense_ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by,
               **critical_path(sh.mask.sum(-1), 1, [
                   ("", own_walks(d), ms),
                   ("replaced_", own_walks(d), replaced["replaced_ms"])])}
        emit(row)
        check(kind == slda_gibbs.variant(t),
              f"B2_sparse {label}: ran {kind}")
        check(row["replaced_draws_equal"],
              f"B2_sparse {label}: draws differ from the replaced kernel's")
        rows.setdefault("B2_sparse", row)
        check(mis <= MISMATCH_MAX, f"B2_sparse {label}: draw mismatch {mis}")
        check(exact, f"B2_sparse {label}: ndt differs from counts of z")
        if label == "slice_cap4":
            # the rows of this sweep for the device function alone (B4):
            # every real token's word, its chain's index row, and weights
            # shaped like a sweep's (mass on the word's occupied topics)
            b4_in = (sh.tokens, sh.mask, ntw_t, index)

    # B3's sparse rows in the product form, and at T = 512 in the log
    # form too (its inputs from B3's T512_log generator, ROADMAP C5)
    for label, t, cap, product, g3 in (
            [(lb, t_, c_, True, gen) for lb, t_, c_ in sparse_shapes]
            + [("T512_log", 512, 32, False, gen_c5)]):
        docs = train.n_docs if t == T0 else 1024
        sh = partition(train.map(lambda x: x[:docs]), M)
        d = sh.n_docs
        i3 = dict(int32, generator=g3)
        z = torch.randint(0, t, tuple(sh.tokens.shape), **i3)
        ndt, ntw, nt = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        index = index_of(ntw_t, cap)            # launch-frozen
        eta = torch.randn((M, t), device=dev, generator=g3) * 2.0
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), **i3)
        inv_len = 1.0 / sh.mask.sum(-1).clamp(min=1.0)
        db = build_plan(sh, cfg).train_doc_block(d)
        a = (sh.tokens, sh.mask, sd, z, ndt, sh.y, inv_len, ntw_t, nt, eta)
        kw = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho, n_sweeps=8,
                  doc_block=db, supervised=True, product_form=product)
        (z_k, ndt_k), kind = variant_of(
            slda_train.variant_launches,
            lambda: slda_train.slda_train_sweeps_cuda(
                *a, topic_index=index, **kw))
        (z_p, ndt_p), share = tallied(lambda: ref.slda_train_sweeps_chains(
            *a, topic_index=index, **kw))
        same = replaced_agrees(
            (z_k, ndt_k), slda_train.slda_train_sweeps_cuda(
                *a, topic_index=index, kernel_variant="block", **kw),
            sh.mask)
        real = float(sh.mask.sum())
        fused_mis = float(((z_k != z_p) & (sh.mask > 0)).sum()) / real
        c5 = {}
        if t == 512:
            sweep_mis, c5["torch_sum_sweep_mismatch"] = sweep_by_sweep(
                a, kw, real, index, torch_sum=True)
        else:
            sweep_mis = sweep_by_sweep(a, kw, real, index)
        mis = max(sweep_mis)
        err = float((ndt_k - ndt_p).abs().max())
        recount, _, _ = counts_from_assignments(sh.tokens, sh.mask, z_k, t,
                                                W)
        exact = bool(torch.equal(recount, ndt_k))
        ms = event_ms(lambda: slda_train.slda_train_sweeps_cuda(
            *a, topic_index=index, **kw), 10)
        replaced_ms = event_ms(lambda: slda_train.slda_train_sweeps_cuda(
            *a, topic_index=index, kernel_variant="block", **kw), 10)
        dense_ms = event_ms(lambda: slda_train.slda_train_sweeps_cuda(
            *a, **kw), 10)
        plain = event_ms(lambda: ref.slda_train_sweeps_chains(
            *a, topic_index=index, **kw), 1, warm=False)
        copies = M * -(-d // db)
        k_cap = index[0].shape[-1]
        form = "B3_product" if product else "B3_log"
        b_ms, b_by = bound_ms(
            list(a) + list(index) + [z_k, ndt_k],
            ((OPS_PER_TOPIC[form] - DENSE_DRAW_OPS) * t
             + sparse_draw_ops(t, k_cap, share)) * real * 8,
            extra_bytes=copies * W * t * 4)
        row = {"phase": "B3_sparse", "shape": label, "M": M, "D": d,
               "N": sh.max_len, "T": t, "W": W, "cap": k_cap,
               "doc_block": db, "sweeps": 8, "product_form": product,
               "real_tokens": real, "draw_mismatch": mis,
               "sweep_mismatch": sweep_mis, **c5,
               "fused_mismatch": fused_mis,
               "max_abs_err": err, "counts_exact": exact,
               "stage2_share": share, "variant": kind, "ms": ms,
               "replaced_ms": replaced_ms, "dense_ms": dense_ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               "replaced_draws_equal": same,
               **b3_critical_path(sh.mask, d, db, t, 8, ms, replaced_ms)}
        emit(row)
        check(kind == "cluster", f"B3_sparse {label}: ran {kind}")
        check(same, f"B3_sparse {label}: draws differ from the replaced "
              f"kernel's")
        check(mis <= MISMATCH_MAX,
              f"B3_sparse {label}: a sweep's draw mismatch {sweep_mis}")
        check(exact, f"B3_sparse {label}: ndt differs from counts of z")

    # ---- B4 alone: the draw on the rows of one sweep at the slice's
    # shape with cap 4, and at T = 128 and 512 with cap 32; every form of
    # it at T <= 16 (first the one most sparse launches run), and the
    # records packed on the card against the plain packing
    for label, t, cap in (("slice_cap4", T0, 4), ("T128", 128, 32),
                          ("T512", 512, 32)):
        if t == T0:
            tok, msk, table, index = b4_in
        else:
            sh = partition(train.map(lambda x: x[:1024]), M)
            z = torch.randint(0, t, tuple(sh.tokens.shape), **int32)
            _, ntw, _ = counts_from_assignments(sh.tokens, sh.mask, z, t, W)
            tok, msk = sh.tokens, sh.mask
            table = ntw.transpose(1, 2).contiguous()
            index = index_of(table, cap)
        chain = torch.arange(M, device=dev)[:, None, None].expand_as(tok)
        real_at = msk > 0
        rows_w = (chain * W + tok.long())[real_at]      # [R] stacked rows
        R = rows_w.numel()
        pw = (table.reshape(M * W, t)[rows_w] + cfg.beta) * (
            torch.rand((R, t), device=dev, generator=gen) + 0.1)
        pw = pw.contiguous()
        uw = torch.rand((R,), device=dev, generator=gen)
        iw = tuple(x.reshape(M * W, -1)[rows_w].contiguous() for x in index)
        z_p, stage2 = sparse.two_stage_draw(pw, uw, *iw)
        kind = sparse.draw_variant(t)
        forms = [kind] + [v for v in sparse.VARIANTS
                          if v != kind and (t <= sparse.LANE_TOPICS
                                            or v == "warp")]
        # times by events back to back (host-bound at these sizes: a
        # call's host work outlasts its two kernels) and device times
        # by the profiler (the packing and the draw, summed)
        form_mis, form_ms, form_us = {}, {}, {}
        for v in forms:
            z_k = sparse.sparse_two_stage_draw_cuda(pw, uw, *iw,
                                                    kernel_variant=v)
            form_mis[v] = float((z_k != z_p).sum()) / R
            call = lambda: sparse.sparse_two_stage_draw_cuda(  # noqa: E731
                pw, uw, *iw, kernel_variant=v)
            form_ms[v] = event_ms(call, 20)
            form_us[v] = device_us(call)[0]
            if v == kind:
                err = float((z_k - z_p).abs().max())
        pack_equal = bool(torch.equal(sparse.pack_topic_index_cuda(*iw),
                                      sparse.pack_topic_index(*iw)))
        pack_ms = event_ms(lambda: sparse.pack_topic_index_cuda(*iw), 20)
        pack_us = device_us(lambda: sparse.pack_topic_index_cuda(*iw))[0]
        plain = event_ms(lambda: sparse.sparse_two_stage_draw(pw, uw, *iw),
                         5)
        share = float(stage2.float().mean())
        b_ms, b_by = bound_ms([pw, uw, *iw, z_p],
                              sparse_draw_ops(t, cap, share) * R)
        row = {"phase": "B4", "shape": label, "rows": R, "T": t, "cap": cap,
               "variant": kind, "draw_mismatch": form_mis[kind],
               "max_abs_err": err, "stage2_share": share,
               "ms": form_ms[kind], "variant_ms": form_ms,
               "device_us": form_us[kind], "variant_device_us": form_us,
               "variant_mismatch": form_mis, "pack_ms": pack_ms,
               "pack_device_us": pack_us, "pack_equal": pack_equal,
               "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.setdefault("B4", row)
        check(max(form_mis.values()) <= MISMATCH_MAX,
              f"B4 {label}: draw mismatch {form_mis}")
        check(pack_equal, f"B4 {label}: records differ from the plain "
              f"packing")

    # ---- small shapes, every kernel dense and sparse, on inputs drawn from
    # a generator of their own: z mostly a function of the word (so a
    # word's occupancy stays below T), φ̂ with exact zeros
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for t, cap, d, w_dim, n in ((16, 16, 512, 500, 60), (16, 4, 512, 500, 60),
                                (40, 8, 256, 300, 40), (3, 2, 128, 50, 20),
                                (128, 32, 128, 400, 40),
                                (256, 32, 64, 300, 30),
                                (512, 32, 64, 300, 30)):
        tok = torch.randint(0, w_dim, (M, d, n), device=dev, generator=g,
                            dtype=torch.int32)
        lens = torch.randint(n // 3, n + 1, (M, d), device=dev, generator=g)
        msk = (torch.arange(n, device=dev) < lens[..., None]).float()
        z = torch.randint(0, t, (M, d, n), device=dev, generator=g,
                          dtype=torch.int32)
        zw = torch.remainder(tok * 7 + torch.randint(
            0, 3, (M, d, n), device=dev, generator=g, dtype=torch.int32),
            t).int()
        z = torch.where(torch.rand((M, d, n), device=dev, generator=g) < 0.8,
                        zw, z).int()
        ndt, ntw, nt = counts_from_assignments(tok, msk, z, t, w_dim)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=g)
        y = torch.randn((M, d), device=dev, generator=g)
        il = 1.0 / msk.sum(-1).clamp(min=1.0)
        u = torch.rand((M, d, n), device=dev, generator=g)
        real = float(msk.sum())
        for mode in ("dense", "sparse"):
            ti = index_of(ntw_t, cap) if mode == "sparse" else None
            kw = dict(alpha=0.1, beta=0.01, rho=0.25, supervised=True,
                      topic_index=ti)
            a = (tok, msk, u, z, ndt, y, il, ntw_t, nt, eta)
            (z_k, ndt_k), kind2 = variant_of(
                slda_gibbs.variant_launches,
                lambda: slda_gibbs.slda_gibbs_sweep_cuda(*a, **kw))
            z_p, _ = ref.ref_slda_gibbs_sweep_chains(*a, **kw)
            mis2 = float(((z_k != z_p) & (msk > 0)).sum()) / real
            rc = counts_from_assignments(tok, msk, z_k, t, w_dim)[0]
            ex2 = bool(torch.equal(rc, ndt_k))
            same2 = kind2 == "warp" or replaced_agrees(
                (z_k, ndt_k), slda_gibbs.slda_gibbs_sweep_cuda(
                    *a, kernel_variant="warp", **kw), msk)
            sd = torch.randint(0, 2 ** 31 - 1, (M, d), device=dev,
                               generator=g, dtype=torch.int32)
            kw3 = dict(alpha=0.1, beta=0.01, rho=0.25, n_sweeps=4,
                       doc_block=64, supervised=True, product_form=True,
                       topic_index=ti)
            a3 = (tok, msk, sd, z, ndt, y, il, ntw_t, nt, eta)
            z_k, ndt_k = slda_train.slda_train_sweeps_cuda(*a3, **kw3)
            z_p, _ = ref.slda_train_sweeps_chains(*a3, **kw3)
            mis3 = float(((z_k != z_p) & (msk > 0)).sum()) / real
            rc = counts_from_assignments(tok, msk, z_k, t, w_dim)[0]
            ex3 = bool(torch.equal(rc, ndt_k))
            phi = torch.rand((M, w_dim, t), device=dev, generator=g) ** 8
            phi = phi / phi.sum(1, keepdim=True)
            phi = torch.where(phi < 1e-4, torch.zeros_like(phi),
                              phi).contiguous()
            tp = index_of(phi, cap) if mode == "sparse" else None
            kw1 = dict(alpha=0.1, n_burnin=0, n_samples=1, topic_index=tp)
            m0 = msk[0][None].expand(M, -1, -1)
            n0 = counts_from_assignments(tok[0][None].expand(M, -1, -1), m0,
                                         z, t, w_dim)[0]
            a1 = (tok[0].contiguous(), msk[0].contiguous(), sd, z, n0, phi)
            (avg_k, z_k), kind1 = variant_of(
                slda_predict.variant_launches,
                lambda: slda_predict.slda_predict_sweeps_cuda(*a1, **kw1))
            _, z_p = ref.slda_predict_sweeps_chains(*a1, **kw1)
            mis1 = float(((z_k != z_p) & (m0 > 0)).sum()) / float(m0.sum())
            same1 = kind1 == "warp" or replaced_agrees(
                (z_k, avg_k), slda_predict.slda_predict_sweeps_cuda(
                    *a1, kernel_variant="warp", **kw1)[::-1], m0)
            emit({"phase": "small_shapes", "T": t, "cap": cap, "D": d,
                  "W": w_dim, "N": n, "mode": mode, "B1_variant": kind1,
                  "B1_mismatch": mis1, "B1_replaced_draws_equal": same1,
                  "B2_variant": kind2, "B2_mismatch": mis2,
                  "B2_counts_exact": ex2, "B2_replaced_draws_equal": same2,
                  "B3_mismatch": mis3, "B3_counts_exact": ex3})
            check(max(mis1, mis2, mis3) <= MISMATCH_MAX,
                  f"small_shapes T={t} {mode}: draw mismatch")
            check(ex2 and ex3, f"small_shapes T={t} {mode}: counts differ")
            check(same1 and same2, f"small_shapes T={t} {mode}: draws "
                  f"differ from the replaced kernels'")

    # ---- prefix_order: whether the plain draws' prefix sums are the
    # kernels' left-to-right chain at the shapes the rows above handed them
    # (the dense draw's and the sparse draw's): for each [R, T], the rows
    # of random weights in which `mathutil.prefix_sum` differs anywhere
    # from one chain of float32 adds a row, column by column (a gate: none
    # may), and beside it, reported, those in which one GEMM p @ triu(T),
    # the reference's form, does
    ref.prefix_sum = sparse.prefix_sum = plain_prefix_sum
    for r_rows, t in sorted(prefix_shapes, key=lambda rt: (rt[1], rt[0])):
        p = torch.rand((r_rows, t), device=dev, generator=gen) + 0.01
        chain, c = torch.empty_like(p), torch.zeros_like(p[:, 0])
        for j in range(t):
            c = c + p[:, j]
            chain[:, j] = c
        one = p @ upper_tri_ones(t, dev)
        out_of_order = int((ref.prefix_sum(p) != chain).any(-1).sum())
        emit({"phase": "prefix_order", "rows": r_rows, "T": t,
              "one_gemm_rows_out_of_order":
                  int((one != chain).any(-1).sum()),
              "prefix_sum_rows_out_of_order": out_of_order})
        check(out_of_order == 0, f"prefix_order [{r_rows}, {t}]: "
              f"{out_of_order} rows out of left-to-right order")

    # ---- end to end: the four algorithms through their entry points, at
    # one sweep per launch (B2) and at eight (B3), dense and sparse; each
    # run's launch counts are zeroed just before it and read just after
    fused = dataclasses.replace(cfg, sweeps_per_launch=8)
    sparse_one = dataclasses.replace(cfg, sampler_mode="sparse")
    sparse_fused = dataclasses.replace(fused, sampler_mode="sparse")
    modules = {"B1": slda_predict, "B2": slda_gibbs, "B3": slda_train}
    counted = {}

    def zero_counts():
        for mod in modules.values():
            mod.launches = mod.sparse_launches = 0
            for v in mod.variant_launches:
                mod.variant_launches[v] = 0

    def read_counts():
        """B1–B3's launches, sparse launches and launches by variant."""
        return ({k: mod.launches for k, mod in modules.items()},
                {k: mod.sparse_launches for k, mod in modules.items()},
                {k: dict(mod.variant_launches) for k, mod in modules.items()})
    for phase, run_cfg, want in (
            ("end_to_end", cfg, {"B1": 4, "B2": 4 * cfg.n_iters, "B3": 0}),
            ("end_to_end_fused", fused, {"B1": 4, "B2": 0, "B3": 16}),
            ("end_to_end_sparse", sparse_one,
             {"B1": 4, "B2": 4 * cfg.n_iters, "B3": 0}),
            ("end_to_end_sparse", sparse_fused,
             {"B1": 4, "B2": 0, "B3": 16})):
        fig6_mdna.run(args.seed, dev, data=(train, test),
                      cfg=run_cfg)                           # warm-up
        zero_counts()
        res = fig6_mdna.run(args.seed, dev, data=(train, test), cfg=run_cfg)
        torch.cuda.synchronize()
        launches, sparse_launches, variants = read_counts()
        counted[phase, run_cfg.sweeps_per_launch] = (launches,
                                                     sparse_launches,
                                                     variants)
        emit({"phase": phase, "card": smi,
              "sweeps_per_launch": run_cfg.sweeps_per_launch,
              "sampler_mode": run_cfg.sampler_mode,
              "sparse_topic_cap": min(run_cfg.sparse_topic_cap, T0),
              "launches": launches, "sparse_launches": sparse_launches,
              "variant_launches": variants, **res})
        mse = {k: v["test_mse"] for k, v in res["algorithms"].items()}
        var_y = res["var_y_test"]
        check(launches == want, f"{phase}: launch counts {launches}")
        # every launch of the main path on its variant: B1 lane and B2
        # half_warp for the dense draw (warp for the sparse), B3 cluster
        is_sparse = run_cfg.sampler_mode == "sparse"
        main_variant = {
            "B1": slda_predict.variant(T0, is_sparse, test.max_len),
            "B2": slda_gibbs.variant(T0), "B3": "cluster"}
        check(all(variants[k][v] == launches[k]
                  for k, v in main_variant.items()),
              f"{phase}: launches by variant {variants}")
        want_sparse = launches if run_cfg.sampler_mode == "sparse" else \
            {k: 0 for k in launches}
        check(sparse_launches == want_sparse,
              f"{phase}: sparse launch counts {sparse_launches}")
        check(all(v == v and abs(v) != float("inf") for v in mse.values()),
              f"{phase}: non-finite test MSE {mse}")
        for name in ("nonparallel", "simple", "weighted"):
            check(mse[name] < 0.6 * var_y,
                  f"{phase}: {name} MSE {mse[name]} >= 0.6 var(y) "
                  f"{0.6 * var_y}")
        check(mse["naive"] > mse["simple"],
              f"{phase}: naive not worse than simple {mse}")

    # ---- sparse_T512: one Simple Average run at spl 8 on the slice's
    # corpus with T = 512, the top of the reference's sparse grid
    # (BENCH_slda_sparse.json), dense and sparse with cap 32; the launch
    # counts are zeroed just before the timed run and read just after
    from repro_torch.timing import PhaseTimer
    for mode in ("dense", "sparse"):
        run_cfg = dataclasses.replace(fused, n_topics=512, sampler_mode=mode,
                                      sparse_topic_cap=32)
        ALGORITHMS["simple"](args.seed + 1, train, test, run_cfg, M,
                             device=dev)                     # warm-up
        zero_counts()
        timer = PhaseTimer(dev)
        yhat = ALGORITHMS["simple"](args.seed + 1, train, test, run_cfg, M,
                                    device=dev, timer=timer)
        torch.cuda.synchronize()
        launches, sparse_launches, variants = read_counts()
        mse = float(((yhat - test.y) ** 2).mean())
        emit({"phase": "sparse_T512", "card": smi, "sampler_mode": mode,
              "T": 512, "sparse_topic_cap": 32, "sweeps_per_launch": 8,
              "phase_ms": timer.ms(), "test_mse": mse,
              "var_y_test": float(test.y.var(unbiased=False)),
              "launches": launches, "sparse_launches": sparse_launches,
              "variant_launches": variants})
        check(mse == mse and abs(mse) != float("inf"),
              f"sparse_T512 {mode}: non-finite test MSE {mse}")
        want = {"B1": 1, "B2": 0, "B3": -(-run_cfg.n_iters // 8)}
        check(launches == want, f"sparse_T512 {mode}: launches {launches}")
        check(sparse_launches == (launches if mode == "sparse" else
                                  {k: 0 for k in launches}),
              f"sparse_T512 {mode}: sparse launches {sparse_launches}")
        check(variants["B1"][slda_predict.variant(
            512, mode == "sparse", test.max_len)] == 1
              and variants["B3"]["cluster"] == want["B3"],
              f"sparse_T512 {mode}: launches by variant {variants}")

    # ---- end_to_end_binary: Figure 7 (binary labels) at the reference
    # harness's scale 1.0 (`repro_torch.fig7_imdb`), the four algorithms
    # through their entry points at spl 1 (B2) and 8 (B3), dense, and
    # sparse at 8; each run's launch counts zeroed just before it and read
    # just after
    from repro_torch import fig7_imdb
    f7_data = fig7_imdb.make_data(args.seed, dev)
    f7_cfg = fig7_imdb.CFG
    f7_fused = dataclasses.replace(f7_cfg, sweeps_per_launch=8)
    for run_cfg in (f7_cfg, f7_fused,
                    dataclasses.replace(f7_fused, sampler_mode="sparse")):
        fig7_imdb.run(args.seed, dev, data=f7_data, cfg=run_cfg)  # warm-up
        zero_counts()
        res = fig7_imdb.run(args.seed, dev, data=f7_data, cfg=run_cfg)
        torch.cuda.synchronize()
        launches, sparse_launches, variants = read_counts()
        spl = run_cfg.sweeps_per_launch
        is_sparse = run_cfg.sampler_mode == "sparse"
        n_b = -(-run_cfg.n_iters // spl)
        want = {"B1": 4, "B2": 4 * n_b if spl == 1 else 0,
                "B3": 0 if spl == 1 else 4 * n_b}
        emit({"phase": "end_to_end_binary", "card": smi,
              "sweeps_per_launch": spl, "sampler_mode": run_cfg.sampler_mode,
              "docs": fig7_imdb.N_DOCS, "train_docs": fig7_imdb.N_TRAIN,
              "W": fig7_imdb.VOCAB, "T": fig7_imdb.N_TOPICS,
              "launches": launches, "sparse_launches": sparse_launches,
              "variant_launches": variants, **res})
        acc = {k: v["test_acc"] for k, v in res["algorithms"].items()}
        check(launches == want, f"end_to_end_binary: launches {launches}")
        main_variant = {
            "B1": slda_predict.variant(fig7_imdb.N_TOPICS, is_sparse,
                                       fig7_imdb.DOC_LEN),
            "B2": slda_gibbs.variant(fig7_imdb.N_TOPICS), "B3": "cluster"}
        check(all(variants[k][v] == launches[k]
                  for k, v in main_variant.items()),
              f"end_to_end_binary: launches by variant {variants}")
        check(sparse_launches == (launches if is_sparse else
                                  {k: 0 for k in launches}),
              f"end_to_end_binary: sparse launches {sparse_launches}")
        for name in ("nonparallel", "simple", "weighted"):
            check(acc[name] >= BINARY_ACC_MIN,
                  f"end_to_end_binary: {name} accuracy {acc[name]}")
        check(acc["naive"] < acc["simple"],
              f"end_to_end_binary: naive not below simple {acc}")

    # ---- end_to_end_ragged: the four algorithms over the padded corpus
    # against length buckets (`length_buckets` 8, the config's token block
    # and overhead), at the MD&A slice at spl 1 (dense and sparse) and 8,
    # and at Figure 7 at spl 8.  The bucketed run goes twice: with the
    # plan's own choice of streams (`plan._streams_for`: multi-sweep
    # launches on streams of their own, single sweeps in turn) and with
    # the other choice for every launch, so that both forms are timed on
    # the same inputs.  Every form's launch counts are zeroed just before
    # its run and read just after
    from repro_torch.core import build_schedule
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.types import _concat_corpora
    streams_for = plan_mod._streams_for

    def swapped_streams(n_sweeps, n_calls, dev_):
        return (dev_.type == "cuda" and n_calls > 1
                and not streams_for(n_sweeps, n_calls, dev_))

    def algorithms(run_cfg, data):
        """Every algorithm's ŷ, phase ms and metric over `data`."""
        tr, te = data
        out = {}
        for name, fn in ALGORITHMS.items():
            timer = PhaseTimer(dev)
            extra = () if name == "nonparallel" else (M,)
            yhat = fn(args.seed + 1, tr, te, run_cfg, *extra, device=dev,
                      timer=timer)
            out[name] = {"yhat": yhat, "phase_ms": timer.ms()}
        return out

    def schedule(corpus, run_cfg):
        d = build_plan(build_schedule(corpus, run_cfg), run_cfg).describe()
        return {k: d[k] for k in ("bucket_widths", "bucket_counts",
                                  "padded_slot_frac",
                                  "slot_vs_effective_tok_ratio")}

    for label, base, data, binary in (
            ("mdna", cfg, (train, test), False),
            ("mdna", sparse_one, (train, test), False),
            ("mdna", fused, (train, test), False),
            ("fig7", f7_fused, f7_data, True)):
        tr, te = data
        bcfg = dataclasses.replace(base, length_buckets=8)
        spl = base.sweeps_per_launch
        n_b = -(-base.n_iters // spl)
        k = {"train_1": partition(tr, 1), "train_M": partition(tr, M),
             "test": te, "weighted": _concat_corpora(te, tr)}
        scheds = {key: schedule(c, bcfg) for key, c in k.items()}
        kb = {key: len(v["bucket_widths"]) for key, v in scheds.items()}
        trained = n_b * (kb["train_1"] + 3 * kb["train_M"])
        want = {"B1": 3 * kb["test"] + kb["weighted"],
                "B2": trained if spl == 1 else 0,
                "B3": 0 if spl == 1 else trained}
        forms, on_streams = {}, {}
        for form, run_cfg, choice in (("padded", base, streams_for),
                                      ("buckets", bcfg, streams_for),
                                      ("buckets_swapped", bcfg,
                                       swapped_streams)):
            plan_mod._streams_for = choice
            try:
                algorithms(run_cfg, data)                      # warm-up
                zero_counts()
                out = algorithms(run_cfg, data)
                torch.cuda.synchronize()
                on_streams[form] = build_plan(
                    build_schedule(k["test"], run_cfg),
                    run_cfg).describe()["bucket_streams"]
            finally:
                plan_mod._streams_for = streams_for
            forms[form] = (out, read_counts())
        is_sparse = base.sampler_mode == "sparse"
        row = {"phase": "end_to_end_ragged", "card": smi, "corpus": label,
               "sweeps_per_launch": spl, "sampler_mode": base.sampler_mode,
               "length_buckets": bcfg.length_buckets,
               "bucket_token_block": bcfg.bucket_token_block,
               "bucket_overhead_docs": bcfg.bucket_overhead_docs,
               "schedules": scheds, "want_bucketed_launches": want,
               "on_streams": on_streams}
        for form, (out, (launches, sparse_launches, variants)) in \
                forms.items():
            metric = {}
            for name, r in out.items():
                yh = r["yhat"]
                metric[name] = (fig7_imdb.accuracy(yh, te.y) if binary
                                else float(((yh - te.y) ** 2).mean()))
            row[form] = {
                "phase_ms": {n: r["phase_ms"] for n, r in out.items()},
                "train_ms": sum(r["phase_ms"].get("train", 0.0)
                                for r in out.values()),
                "predict_ms": sum(r["phase_ms"].get("predict", 0.0)
                                  for r in out.values()),
                "test_acc" if binary else "test_mse": metric,
                "launches": launches, "sparse_launches": sparse_launches,
                "variant_launches": variants}
        pad_out, bkt_out = forms["padded"][0], forms["buckets"][0]
        swp_out = forms["buckets_swapped"][0]
        row["bitwise_equal_to_padded"] = {
            n: bool(torch.equal(bkt_out[n]["yhat"], pad_out[n]["yhat"]))
            for n in pad_out}
        row["swapped_streams_equal"] = {
            n: bool(torch.equal(swp_out[n]["yhat"], bkt_out[n]["yhat"]))
            for n in bkt_out}
        emit(row)
        main_variant = {
            "B1": slda_predict.variant(base.n_topics, is_sparse,
                                       te.max_len),
            "B2": slda_gibbs.variant(base.n_topics), "B3": "cluster"}
        for form in ("buckets", "buckets_swapped"):
            launches, sparse_launches, variants = forms[form][1]
            check(launches == want, f"end_to_end_ragged {label} spl {spl} "
                  f"{form}: launches {launches}, want {want}")
            check(all(variants[kk][v] == launches[kk]
                      for kk, v in main_variant.items()),
                  f"end_to_end_ragged {label} {form}: launches by variant "
                  f"{variants}")
            check(sparse_launches == (launches if is_sparse else
                                      {kk: 0 for kk in launches}),
                  f"end_to_end_ragged {label} {form}: sparse launches "
                  f"{sparse_launches}")
        check(all(row["swapped_streams_equal"].values()),
              f"end_to_end_ragged {label} spl {spl}: streams changed ŷ")
        if spl == 1:
            check(all(row["bitwise_equal_to_padded"].values()),
                  f"end_to_end_ragged {label} {base.sampler_mode}: "
                  f"bucketed ŷ differs from padded "
                  f"{row['bitwise_equal_to_padded']}")
            continue
        for form in ("padded", "buckets"):
            if binary:
                acc = row[form]["test_acc"]
                check(all(acc[n] >= BINARY_ACC_MIN for n in
                          ("nonparallel", "simple", "weighted"))
                      and acc["naive"] < acc["simple"],
                      f"end_to_end_ragged {label} {form}: accuracy {acc}")
            else:
                mse, var_y = row[form]["test_mse"], float(
                    te.y.var(unbiased=False))
                check(all(mse[n] < 0.6 * var_y for n in
                          ("nonparallel", "simple", "weighted"))
                      and mse["naive"] > mse["simple"],
                      f"end_to_end_ragged {label} {form}: MSE {mse}")

    # ---- ragged_small_buckets: B1, B2 and B3 against their plain versions
    # over the few long documents a tail bucket holds (D = 1 to 8 a chain,
    # T = 16, N = 120, B3 at the plan's doc block), dense and sparse
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    for d in range(1, 9):
        n, t = 120, T0
        tok = torch.randint(0, W, (M, d, n), device=dev, generator=g,
                            dtype=torch.int32)
        lens = torch.randint(n // 2, n + 1, (M, d), device=dev, generator=g)
        msk = (torch.arange(n, device=dev) < lens[..., None]).float()
        z = torch.randint(0, t, (M, d, n), device=dev, generator=g,
                          dtype=torch.int32)
        ndt, ntw, nt = counts_from_assignments(tok, msk, z, t, W)
        ntw_t = ntw.transpose(1, 2).contiguous()
        eta = torch.randn((M, t), device=dev, generator=g)
        y = torch.randn((M, d), device=dev, generator=g)
        il = 1.0 / msk.sum(-1).clamp(min=1.0)
        u = torch.rand((M, d, n), device=dev, generator=g)
        sd = torch.randint(0, 2 ** 31 - 1, (M, d), device=dev, generator=g,
                           dtype=torch.int32)
        phi_t = rand_table(M, t, g).transpose(1, 2).contiguous()
        real = float(msk.sum())
        doc_block = build_plan(partition(train, M), cfg).train_doc_block(d)
        for mode in ("dense", "sparse"):
            ti = index_of(ntw_t, cfg.sparse_topic_cap) \
                if mode == "sparse" else None
            a2 = (tok, msk, u, z, ndt, y, il, ntw_t, nt, eta)
            kw2 = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                       supervised=True, topic_index=ti)
            z_k, ndt_k = slda_gibbs.slda_gibbs_sweep_cuda(*a2, **kw2)
            z_p, _ = ref.ref_slda_gibbs_sweep_chains(*a2, **kw2)
            mis2 = float(((z_k != z_p) & (msk > 0)).sum()) / real
            ex2 = bool(torch.equal(counts_from_assignments(
                tok, msk, z_k, t, W)[0], ndt_k))
            a3 = (tok, msk, sd, z, ndt, y, il, ntw_t, nt, eta)
            kw3 = dict(alpha=cfg.alpha, beta=cfg.beta, rho=cfg.rho,
                       n_sweeps=8, doc_block=doc_block, supervised=True,
                       product_form=True, ctr_stride=2 * n)
            z_k, ndt_k = slda_train.slda_train_sweeps_cuda(
                *a3, topic_index=ti, **kw3)
            ex3 = bool(torch.equal(counts_from_assignments(
                tok, msk, z_k, t, W)[0], ndt_k))
            mis3 = sweep_by_sweep(a3, kw3, real, ti)
            tp = index_of(phi_t, cfg.sparse_topic_cap) \
                if mode == "sparse" else None
            m0 = msk[0][None].expand(M, -1, -1)
            n0 = counts_from_assignments(tok[0][None].expand(M, -1, -1), m0,
                                         z, t, W)[0]
            a1 = (tok[0].contiguous(), msk[0].contiguous(), sd, z, n0, phi_t)
            kw1 = dict(alpha=cfg.alpha, n_burnin=2, n_samples=2,
                       ctr_stride=2 * n, topic_index=tp)
            _, z_k = slda_predict.slda_predict_sweeps_cuda(*a1, **kw1)
            _, z_p = ref.slda_predict_sweeps_chains(*a1, **kw1)
            mis1 = float(((z_k != z_p) & (m0 > 0)).sum()) / float(m0.sum())
            emit({"phase": "ragged_small_buckets", "D": d, "M": M, "N": n,
                  "T": t, "mode": mode, "doc_block": doc_block,
                  "B1_mismatch": mis1, "B2_mismatch": mis2,
                  "B2_counts_exact": ex2, "B3_sweep_mismatch": mis3,
                  "B3_counts_exact": ex3})
            check(max(mis1, mis2, *mis3) <= MISMATCH_MAX and ex2 and ex3,
                  f"ragged_small_buckets D={d} {mode}: draws or counts "
                  f"differ")

    # ---- supervised: checkpointed training under the health probe, with
    # faults injected, at the slice's full scale at spl 1 and 8 dense and
    # at 8 sparse; each config's launches zeroed before its runs and read
    # after them
    def main_variant(run_cfg):
        is_sparse = run_cfg.sampler_mode == "sparse"
        return {"B1": slda_predict.variant(T0, is_sparse, test.max_len),
                "B2": slda_gibbs.variant(T0), "B3": "cluster"}
    supervised = supervised_phase(
        args.seed, dev, smi, train, test,
        (("spl1", cfg), ("spl8", fused), ("spl8_sparse", sparse_fused)),
        zero_counts, read_counts, main_variant)

    # ---- slda_serving: the prediction service at the slice's full width
    # and at the reference's own serving configuration
    serving = serving_phase(args.seed, dev, smi,
                            serving_rows(args.seed, dev, train, test),
                            zero_counts, read_counts)

    # ---- parallel: one process a rank under torch.distributed, world 1
    # under NCCL and 4 ranks sharing the card under gloo; elastic: the
    # elastic runner over a simulated pool; each counts its launches
    parallel = parallel_phase(
        args.seed, dev, smi, train, test,
        (("spl1", cfg), ("spl8", fused), ("spl8_sparse", sparse_fused)),
        zero_counts, read_counts, main_variant)
    elastic = elastic_phase(
        args.seed, dev, smi, train, test,
        (("spl1", cfg), ("spl8_sparse", sparse_fused)),
        zero_counts, read_counts, main_variant)

    # ---- where the time goes: one simple-average run under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # device kernels only: an operator's row repeats its kernels' time
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # the kernels one topic-index build launches (argsort, gather, the occm
    # scatter), and its time at the slice's training table
    # (from ntw [M, T, W] seen as [M, W, T], as the ops see it)
    ntw_view = b4_in[2].transpose(1, 2).contiguous().transpose(1, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sparse.build_topic_index(ntw_view, cfg.sparse_topic_cap)
        torch.cuda.synchronize()
    index_kernels = {e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and dev_us(e) > 0}
    index_ms = event_ms(lambda: sparse.build_topic_index(
        ntw_view, cfg.sparse_topic_cap), 20)
    # the slice at each setting and sparse at 8, then padded against 8
    # length buckets (the plan's choice of streams) at the slice at spl 1
    # and 8 and at Figure 7 at 8
    bucketed = lambda c: dataclasses.replace(c, length_buckets=8)
    mdna = (train, test)
    for label, data, run_cfg in (
            ("mdna", mdna, cfg), ("mdna", mdna, fused),
            ("mdna", mdna, sparse_fused), ("mdna", mdna, bucketed(cfg)),
            ("mdna", mdna, bucketed(fused)), ("fig7", f7_data, f7_fused),
            ("fig7", f7_data, bucketed(f7_fused))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ALGORITHMS["simple"](args.seed + 1, *data, run_cfg, M,
                                 device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
        busy_ms = sum(dev_us(e) for e in ops) / 1e3
        # B3's kernels (either variant) as a share of the busy time, and
        # the B1–B3 kernels' time together
        b3_ms = sum(dev_us(e) for e in ops if "train_cluster_kernel" in e.key
                    or "train_sweeps_kernel" in e.key) / 1e3
        sampler_ms = sum(dev_us(e) for e in ops if any(
            k in e.key for k in ("predict_", "gibbs_", "train_"))) / 1e3
        line = {"phase": "profile", "algorithm": "simple", "corpus": label,
                "sweeps_per_launch": run_cfg.sweeps_per_launch,
                "sampler_mode": run_cfg.sampler_mode,
                "length_buckets": run_cfg.length_buckets,
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms if ops else None,
                "b3_ms": b3_ms,
                "b3_share_of_busy": b3_ms / busy_ms if ops else None,
                "sampler_kernels_ms": sampler_ms,
                "top_kernels": [{"name": e.key[:70], "calls": e.count,
                                 "ms": dev_us(e) / 1e3} for e in ops[:8]]}
        if run_cfg.sampler_mode == "sparse":
            # one build per launch and one for prediction; the build's
            # kernels where they rank (names shared with other operations
            # count those too)
            line["index_build"] = {
                "ms_per_build": index_ms,
                "builds": -(-run_cfg.n_iters // run_cfg.sweeps_per_launch)
                + 1,
                "kernels": [{"rank": i + 1, "name": e.key[:70],
                             "calls": e.count, "ms": dev_us(e) / 1e3}
                            for i, e in enumerate(ops)
                            if e.key in index_kernels]}
        emit(line)

    # ---- the LM serving slice: B5, B7, lm_parity, lm_serve
    lm_rows, lm_launches = lm_phases(args.seed, dev, smi, event_ms,
                                     bound_ms)
    rows.update(lm_rows)

    # ---- the Mamba-2 serving slice: B6, ssm_parity, hybrid_parity,
    # ssm_serve, ssm_profile
    ssm_rows, ssm_launches = ssm_phases(args.seed, dev, smi, event_ms,
                                        bound_ms)
    rows.update(ssm_rows)

    # ---- the rest of the LM zoo and training: moe_serve, arctic_serve,
    # frontend_serve, lm_train
    zoo_launches = zoo_phases(args.seed, dev, smi, event_ms, bound_ms)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the multi-device half at world 1: sharded serving and training
    # bit-equal to plain tensors, the dry-run held to the card
    sharded_phase(args.seed, dev, smi, event_ms)

    # each kernel's launches in the run of the path it carries; B4 runs
    # inside every sparse launch of B1–B3, at both settings; B5 (decode)
    # and B7 in lm_serve's generate, B5_prefill in its fused prefill; B6 in
    # ssm_serve's (its chain weights' forward)
    sparse_runs = [counted["end_to_end_sparse", s][1] for s in (1, 8)]
    launches_of = {
        "B1": counted["end_to_end", 1][0]["B1"],
        "B2": counted["end_to_end", 1][0]["B2"],
        "B3": counted["end_to_end_fused", 8][0]["B3"],
        "B4": sum(sum(run.values()) for run in sparse_runs),
        **lm_launches, **ssm_launches}
    # and in the supervised phase's runs (B4 in its sparse launches)
    supervised_of = {k: sum(run[0][k] for run in supervised.values())
                     for k in ("B1", "B2", "B3")}
    supervised_of["B4"] = sum(sum(run[1].values())
                              for run in supervised.values())
    # B1's, B2's and B3's launches in those runs by variant (all of them
    # lane, half_warp and cluster, checked)
    variants_of = {"B1": counted["end_to_end", 1][2]["B1"],
                   "B2": counted["end_to_end", 1][2]["B2"],
                   "B3": counted["end_to_end_fused", 8][2]["B3"]}
    sources = {"B1": ("slda_predict_sweeps", "slda_predict.cu",
                      "src/repro/kernels/slda_predict.py:119"),
               "B2": ("slda_gibbs_sweep", "slda_gibbs.cu",
                      "src/repro/kernels/slda_gibbs.py:31"),
               "B3": ("slda_train_sweeps", "slda_train.cu",
                      "src/repro/kernels/slda_train.py:99"),
               "B4": ("sparse_two_stage_draw", "slda_common.cuh",
                      "src/repro/kernels/sparse.py:53"),
               "B5": ("flash_attention", "flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:26"),
               "B5_prefill": ("flash_attention_prefill",
                              "flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:26"),
               "B6": ("ssd_scan", "ssd_scan.cu",
                      "src/repro/kernels/ssd_scan.py:28"),
               "B7": ("rmsnorm", "rmsnorm.cu",
                      "src/repro/kernels/rmsnorm.py:12")}
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": rep,
        "launches": launches_of[k],
        "max_abs_err": rows[k].get("max_abs_err",
                                   rows[k].get("one_sweep_max_abs_err")),
        "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
        "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
        "library_ms": rows[k].get("library_ms"),
        **({"variant": rows[k]["variant"]} if "variant" in rows[k] else {}),
        **({"variant_launches": variants_of[k]} if k in variants_of
           else {}),
        **({"supervised_launches": supervised_of[k]} if k in supervised_of
           else {}),
        **({"serving_launches": sum(row[k] for row in serving.values())}
           if k in ("B1", "B4") else {}),
        **({"parallel_launches": parallel[k], "elastic_launches": elastic[k]}
           if k in parallel else {}),
        **({"zoo_launches": {ph: n[k] for ph, n in zoo_launches.items()}}
           if k in ("B5", "B5_prefill", "B7") else {})}
        for k, (name, src, rep) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
