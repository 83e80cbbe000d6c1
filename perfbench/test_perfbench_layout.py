"""The benchmark's layout, yardstick and result line, on the CPU."""
from __future__ import annotations

import hashlib
import json
import re
import time

import pytest
import torch

from perfbench import guard, harness, roofline, tiny


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _spec():
    return harness.read_spec()


def test_spec_keys_names_and_bounds():
    spec = _spec()
    assert set(spec) == KEYS
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_each_cell_is_found_by_name(cell):
    spec = _spec()
    c, config, traffic, kind = harness.load_cell(spec, cell)
    assert c["chips"] == 1 and config["name"] == c["config"]
    assert callable(kind.opened)
    assert set(config["limits"]) == set(kind.CHECKS)
    for m in harness.per_layer_of(spec, cell):
        assert callable(harness.load_module(
            harness.BENCH / "metrics" / f"{m['name']}.py", "m").read)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_new_files_only(tmp_path):
    root = tiny.tiny_root(tmp_path)
    before = _digests(root)
    (root / "perfbench" / "metrics" / "fits_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx['fits'])\n")
    spec = harness.read_spec(root)
    spec["per_layer"].append({
        "name": "fits_in_window", "unit": "fits", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "fit_ms",
        "workloads": ["tiny-mdna-weighted"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    changed = [p for p in before if after[p] != before[p]]
    assert [str(p) for p in changed] == ["BENCHMARK.json"]
    spec = harness.read_spec(root)
    cell, config, traffic, _ = harness.load_cell(spec, "tiny-mdna-weighted",
                                                 root)
    assert config["name"] == "tiny-mdna" and traffic["algorithm"] == \
        "weighted"
    names = [m["name"] for m in harness.per_layer_of(spec,
                                                     "tiny-mdna-weighted")]
    assert "fits_in_window" in names
    assert harness.read_metric("fits_in_window", {"fits": 3}, root) == 3.0


def test_train_and_predict_work_match_hand_counts():
    w = {"T": 2, "W": 5, "chains": 2, "n_iters": 3, "launches": 2,
         "train_docs": 4, "train_real_tokens": 10, "predict_docs": 3,
         "predict_real_tokens": 7, "pred_sweeps": 4}
    ops, nbytes = roofline.train_work(w)
    assert ops == 21 * 2 * 10 * 3
    # a launch: 10 tokens × (id, topic in, topic out) + 4 docs × (seed,
    # y, 1/len, ndt in and out) + 2 chains × (table, nt, η)
    assert nbytes == 2 * (10 * 12 + 4 * (12 + 2 * 2 * 4) + 2 * (10 + 4) * 4)
    ops, nbytes = roofline.predict_work(w)
    assert ops == 7 * 2 * 7 * 2 * 4
    # 7 token ids once; each chain: 7 × (topic in, out), 3 × (seed, ndt0,
    # mean ndt), φ̂
    assert nbytes == 7 * 4 + 2 * 7 * 8 + 2 * 3 * (4 + 16) + 2 * 10 * 4
    assert roofline.least_s(67e12, 1.0) == (1.0, "operations")
    assert roofline.least_s(1.0, 3.35e12) == (1.0, "bytes")


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "reprox", "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["repro.core", "jaxlib.xla_client",
                                    "jax", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_no_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = _spec()["workloads"][0]["name"]
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 7),
                       "--seconds", "1", "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_required_keys(tmp_path, trace):
    root = tiny.tiny_root(tmp_path)
    spec = harness.read_spec(root)
    result, quality, checks = harness.run_cell(
        spec, "tiny-imdb-weighted", 2 ** 31 + 12345, 0.5, bool(trace), "cpu",
        time.perf_counter(), root)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[:5] == keys and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["checks"]) == set(checks)
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"train_ms", "predict_ms", "slots_per_token"} <= \
            set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"fit_ms", "fit_p95_ms", "setup_s"}
        assert result["metrics"]["fit_p95_ms"]["value"] >= \
            0.5 * result["metrics"]["fit_ms"]["value"]
    assert 0.0 <= quality["quality"]["test_acc_mean"] <= 1.0
    json.dumps(result)
