"""Runs one cell of `BENCHMARK.json` once and prints its result line.

Everything that belongs to one cell is found by name: the cell's entry
in `BENCHMARK.json` names its configuration (`perfbench/configs/`, the
file its `configs` entry gives) and its traffic (`perfbench/traffic/
<traffic>.json`), whose `kind` names the code that drives it
(`perfbench/traffic/<kind>.py`); each per-layer metric is read by
`perfbench/metrics/<metric>.py`.  So a later cell, configuration or
metric is new files and new entries, and no edit here.

A run: set-up (the kind draws its inputs from the seed, builds and warms
up every shape), `setup_s` from process start to the window, the window
of `--seconds` (under the profiler with `--trace 1`), the peak memory,
the check against the plain reference, the quality line, the import
guard, the numbers compared beside their limits as the last lines on
standard error, and the result as the last line on standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import guard, profile_read

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    """The module of the file `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def read_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def end_to_end_of(spec: dict, cell: str) -> list:
    """The cell's end-to-end metrics: those without a `workloads` key and
    those that list it."""
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(spec: dict, cell: str) -> list:
    """The cell's per-layer metrics: those that list it, and those without
    a `workloads` key whose `moves` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def load_cell(spec: dict, cell_name: str, root: Path = ROOT):
    """(cell, configuration, traffic, kind module) of a cell by name."""
    cell = find(spec["workloads"], cell_name, "workload")
    conf = find(spec["configs"], cell["config"], "configuration")
    config = json.loads((root / conf["file"]).read_text())
    bench = root / BENCH.name
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    kind = load_module(bench / "traffic" / f"{traffic['kind']}.py",
                       f"perfbench_traffic_{_safe(traffic['kind'])}")
    return cell, config, traffic, kind


def read_metric(name: str, ctx: dict, root: Path = ROOT):
    """The per-layer metric `name` from its reader, or None where the
    reader finds nothing to read."""
    mod = load_module(root / BENCH.name / "metrics" / f"{name}.py",
                      f"perfbench_metric_{_safe(name)}")
    return mod.read(ctx)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _short(kernel: str) -> str:
    """A kernel's name without its parameter list (the last parenthesised
    group, which its own name may hold, as in `(anonymous namespace)`)."""
    name, depth = kernel.rstrip(), 0
    if name.endswith(")"):
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                # a signature's list follows the name without a space
                if i and name[i - 1] != " ":
                    name = name[:i]
                break
    return name[:160]


def full_float32():
    """Float32 as the configurations state it: no TF32 in matrix
    products, for the program and the reference alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _number(x: float) -> float:
    """A reading as JSON carries it: infinities as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t0: float, root: Path = ROOT):
    """One run of a cell on `device`.  Returns (result, quality, checks)
    with checks {name: (value, limit)}; the caller prints them."""
    cell, config, traffic, kind = load_cell(spec, cell_name, root)
    started_s = time.perf_counter() - t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        full_float32()
    with kind.opened(config, traffic, seed, dev, trace) as run:
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t0
        if trace:
            from torch.profiler import ProfilerActivity, profile
            # the device's activity only: the host's spans come from the
            # timer hook, on the profiler's clock, at far less cost than
            # the profiler's record of every host operation
            acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                w0 = time.time_ns()
                run.window(seconds)
                w1 = time.time_ns()
            tr = profile_read.read(prof, (w0, w1), run.host_spans)
            del prof
        else:
            run.window(seconds)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        device_info = {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        if cuda:
            device_info["power_limit_w"] = power_limit_w()
        metrics = {}
        if trace:
            ctx = {**run.layer_context(), "trace": tr}
            w0, w1 = tr["window"]
            device_info.update(busy_s=tr["busy_s"],
                               window_s=(w1 - w0) * 1e-9)
            for m in per_layer_of(spec, cell_name):
                value = read_metric(m["name"], ctx, root)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            ops = sorted(tr["ops"].items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[_short(k), v] for k, v in ops],
                         "idle_gaps": [[k, v] for k, v in tr["gaps"]]}
        else:
            e2e = {**run.end_to_end(), "setup_s": setup_s}
            for m in end_to_end_of(spec, cell_name):
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": _number(e2e[m["name"]]),
                                          "unit": m["unit"]}
        attempted, failed, errors = run.attempted, run.failed, run.errors()
        setup_parts = run.setup_parts
        quality = run.quality()
        if cuda:
            torch.cuda.empty_cache()
        values, limits = run.checks(), run.limits()
    checks = {k: (values[k], limits[k]) for k in values}
    correct = (attempted > 0 and failed == 0
               and all(v <= lim for v, lim in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _number(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    quality = {"quality": quality, "workload": cell_name, "seed": seed,
               "setup_parts_s": {"before_cell": started_s, **setup_parts},
               "errors": errors[:5]}
    return result, quality, checks


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(
        description="One run of one benchmark cell (BENCHMARK.json).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    t_main = time.perf_counter()
    spec = read_spec()
    cell = find(spec["workloads"], a.workload, "workload")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"perfbench: {a.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    t_query = time.perf_counter()
    result, quality, checks = run_cell(spec, a.workload, a.seed, a.seconds,
                                       bool(a.trace), "cuda", t0)
    # the imports' share of set-up: Python's and torch's, then the query
    # of the devices (the CUDA driver's start)
    quality["setup_parts_s"].update(python_torch=t_main - t0,
                                    device_query=t_query - t_main)
    bad = guard.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 5
    print(json.dumps(quality), flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
