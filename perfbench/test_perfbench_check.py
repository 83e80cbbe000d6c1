"""The check that decides `correct`, on the CPU at a tiny size: the plain
reference agrees with the program's CPU route, and the control and each
fault a fit cell can have come out as not correct."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness, tiny
from perfbench.reference import slda_fit


@pytest.fixture(autouse=True)
def _one_thread():
    with tiny.one_thread():
        yield


SEED = 2 ** 31 + 99


@pytest.fixture
def blocks_executor(monkeypatch):
    """The card's executor on the CPU: the port's CPU route over several
    buckets is the staircase executor, whose fused launches refresh the
    table from the whole corpus; the card's, which the reference follows,
    refreshes each doc block's own copy."""
    from repro_torch.core import plan
    monkeypatch.setattr(plan.ExecutionPlan, "executor",
                        property(lambda self: "blocks"))


def _run(tmp_path, cell, seconds=0.4):
    root = tiny.tiny_root(tmp_path)
    return harness.run_cell(harness.read_spec(root), cell, SEED, seconds,
                            False, "cpu", time.perf_counter(), root)


@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
def test_reference_agrees_with_the_port(tmp_path, blocks_executor, cell):
    result, _, checks = _run(tmp_path, cell)
    assert result["correct"], checks
    assert all(v == 0.0 for v, _ in checks.values()), checks


@pytest.mark.parametrize("control", ["tf32", "bfloat16"])
@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
def test_control_is_not_correct(tmp_path, blocks_executor, cell, control):
    root = tiny.tiny_root(tmp_path)
    spec = harness.read_spec(root)
    _, config, traffic, kind = harness.load_cell(spec, cell, root)
    with kind.opened(config, traffic, SEED, "cpu") as run:
        run.window(0.2)
        readings = run.checks(control)
        limits = run.limits()
    assert any(readings[k] > limits[k] for k in limits), readings


def test_tf32_rounding_keeps_ten_mantissa_bits():
    ulp = 2.0 ** -10                    # TF32's step at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + 1.5 * ulp), 3.0, 0.0])
    got = slda_fit.tf32_round(x)
    want = torch.tensor([1 + ulp, 1.0, -(1 + 2 * ulp), 3.0, 0.0])
    assert torch.equal(got, want)


def _halve_chains(fn):
    def half(yhat, *args, **kw):
        h = yhat.shape[0] // 2
        return fn(yhat[:h], *(a[:h] for a in args),
                  **{k: (v[:h] if torch.is_tensor(v) else v)
                     for k, v in kw.items()})
    return half


def _state_unchanged(ops):
    def train(tokens, mask, z0, ndt0, *args, **kw):
        return z0, ndt0
    return train


def _token_altered(fn):
    def predict(*args, **kw):
        avg, z = fn(*args, **kw)
        avg = avg.clone()
        avg[0, 0, 0] -= 1.0             # one token moved to another topic
        avg[0, 0, 1] += 1.0
        return avg, z
    return predict


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_chains",
                                   "token_altered"])
def test_faults_are_not_correct(tmp_path, monkeypatch, fault):
    from repro_torch.core import combine
    from repro_torch.kernels import ops
    if fault == "state_unchanged":
        monkeypatch.setattr(ops, "slda_train_sweeps", _state_unchanged(ops))
    elif fault == "half_the_chains":
        monkeypatch.setattr(combine, "weighted_average",
                            _halve_chains(combine.weighted_average))
    else:
        monkeypatch.setattr(ops, "slda_predict_sweeps",
                            _token_altered(ops.slda_predict_sweeps))
    result, _, checks = _run(tmp_path, "tiny-mdna-weighted")
    assert result["correct"] is False, checks
