"""The two sLDA examples of the port (`repro_torch.quickstart`,
`repro_torch.parallel_slda`) at their own size on the CPU, in a process
of their own that loads nothing of JAX: the accuracy guards of the
slice (Nonparallel, Simple and Weighted MSE under 0.6·var(y_test), Naive
worse than Simple), the bucketed runs' predictions bit for bit the
padded ones at one sweep a launch, the staircase executor's plan, and
the kill-a-chain combines."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MSE_FRAC = 0.6


@pytest.fixture(scope="module")
def runs():
    """Both examples' `main(["--device", "cpu"])` in one fresh process
    (one torch thread), with the modules it loaded."""
    prog = textwrap.dedent("""
        import json, sys
        import torch
        torch.set_num_threads(1)
        from repro_torch import parallel_slda, quickstart
        out = {"quickstart": quickstart.main(["--device", "cpu"]),
               "parallel_slda": parallel_slda.main(["--device", "cpu"])}
        out["bad_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("RESULT " + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    line = done.stdout.strip().splitlines()[-1]
    assert line.startswith("RESULT ")
    return json.loads(line[len("RESULT "):]), done.stdout


def test_examples_load_no_jax_and_print_their_lines(runs):
    res, stdout = runs
    assert res["bad_modules"] == []
    for line in ("non-parallel  : test MSE", "simple average: test MSE",
                 "=== the paper's four algorithms (Fig. 6 layout) ===",
                 "  plan: executor=stair buckets=",
                 "  weighted (ragged plan)   test MSE",
                 "  chains alive [1, 0, 0, 1]  test MSE"):
        assert line in stdout, line


def test_quickstart_meets_the_accuracy_guards(runs):
    q = runs[0]["quickstart"]
    var = q["var_y_test"]
    assert q["nonparallel_mse"] < MSE_FRAC * var
    assert q["simple_mse"] < MSE_FRAC * var
    assert q["ragged_equals_padded"]
    assert q["simple_ragged_mse"] == q["simple_mse"]


def test_parallel_slda_meets_the_accuracy_guards(runs):
    p = runs[0]["parallel_slda"]
    var, algo = p["var_y_test"], p["algorithms"]
    assert list(algo) == ["nonparallel", "naive", "simple", "weighted"]
    for name in ("nonparallel", "simple", "weighted"):
        assert algo[name]["mse"] < MSE_FRAC * var, name
    assert algo["naive"]["mse"] > algo["simple"]["mse"]
    assert all(a["wall_s"] > 0 for a in algo.values())


def test_parallel_slda_ragged_run_is_the_padded_one_on_the_stair(runs):
    r = runs[0]["parallel_slda"]["ragged"]
    assert r["executor"] == "stair" and len(r["bucket_widths"]) > 1
    assert r["slot_tokens_per_sweep"] >= r["real_tokens_per_sweep"]
    assert r["equals_padded"]
    assert r["weighted_mse"] == \
        runs[0]["parallel_slda"]["algorithms"]["weighted"]["mse"]


def test_parallel_slda_drops_chains_without_retraining(runs):
    p = runs[0]["parallel_slda"]
    kill = p["kill"]
    assert [k["alive"] for k in kill] == [[1, 1, 1, 1], [1, 0, 1, 1],
                                          [1, 0, 0, 1]]
    assert all(math.isfinite(k["mse"]) for k in kill)
    assert kill[0]["mse"] == p["kill_unmasked_mse"]
    assert all(k["mse"] < MSE_FRAC * p["var_y_test"] for k in kill)
