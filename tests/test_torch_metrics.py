"""The port's metrics (`repro_torch.metrics`) against the reference's
`repro.metrics` on the same numpy-made inputs: the robust z-score (bit
for bit, at odd and even counts, with NaN, a `valid` mask and a scale
floor), chain divergence, the ensemble health probe, and the JSONL
logger's restart semantics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.metrics import chain_divergence as j_divergence
from repro.metrics import ensemble_health as j_health
from repro.metrics import robust_z as j_robust_z
from repro_torch.metrics import (MetricLogger, chain_divergence,
                                 ensemble_health, nanmedian, robust_z,
                                 throughput_tokens_per_s)

NAN = float("nan")


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_nanmedian_averages_the_middle_pair_at_even_counts():
    """torch.nanmedian returns the lower middle value; the reference's
    jnp.nanmedian the mean of the two."""
    v = [1.0, 2.0, 3.0, NAN, 10.0]
    assert float(torch.nanmedian(_t(v))) == 2.0
    assert float(nanmedian(_t(v))) == float(jnp.nanmedian(jnp.asarray(v)))
    assert float(nanmedian(_t(v))) == 2.5
    assert np.isnan(float(nanmedian(_t([NAN, NAN]))))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9])
def test_nanmedian_matches_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(50):
        v = (rng.normal(size=n) * rng.uniform(0.1, 100)).astype(np.float32)
        v[rng.random(n) < 0.25] = np.nan
        want = np.asarray(jnp.nanmedian(jnp.asarray(v)))
        got = nanmedian(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)


def _cases():
    rng = np.random.default_rng(3)
    out = [("even_with_nan", [1.0, 2.0, 3.0, NAN, 10.0], None, 0.0),
           ("four_chains", [0.31, 0.29, 0.33, 2.9], [1, 1, 1, 1], 0.5),
           ("masked", [0.31, 0.29, 0.33, 2.9, 0.30, 0.28],
            [1, 0, 1, 1, 1, 1], 0.5),
           ("inf", [0.2, np.inf, 0.25, -np.inf], None, 0.0),
           ("all_masked", [0.1, 0.2], [0, 0], 0.5)]
    for n in (3, 4, 7, 8):
        v = rng.lognormal(size=n).astype(np.float32)
        v[rng.integers(n)] = np.nan
        out.append((f"random_{n}", v, (rng.random(n) > 0.2).astype(
            np.float32), float(rng.choice([0.0, 0.5]))))
    return out


@pytest.mark.parametrize("name,v,valid,floor", _cases(),
                         ids=[c[0] for c in _cases()])
def test_robust_z_matches_reference_bit_for_bit(name, v, valid, floor):
    want = np.asarray(j_robust_z(
        jnp.asarray(v, jnp.float32),
        None if valid is None else jnp.asarray(valid, jnp.float32),
        rel_floor=floor))
    got = robust_z(_t(v), None if valid is None else _t(valid),
                   rel_floor=floor)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_robust_z_takes_lists_on_the_named_device():
    got = robust_z([0.3, 0.31, 9.0], device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_robust_z(jnp.asarray([0.3, 0.31, 9.0]))))


def _logits(seed, shape=(3, 4, 16), scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_divergence_matches_reference(seed):
    lg = _logits(seed)
    np.testing.assert_allclose(chain_divergence(_t(lg)).numpy(),
                               np.asarray(j_divergence(jnp.asarray(lg))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss,logits", [
    ([2.30, 2.28, 2.31, 45.0], None),                  # a diverged chain
    ([2.3, NAN, 2.31], None),                          # a NaN chain
    ([2.3, 2.3], "same"),                              # collapse
    ([2.3, 2.3], "different"),
    ([2.3, 2.29, 2.32, 2.31], "different"),
])
def test_ensemble_health_matches_reference(loss, logits):
    lg = None
    if logits == "same":
        lg = np.broadcast_to(np.arange(16.0, dtype=np.float32),
                             (len(loss), 4, 16)).copy()
    elif logits == "different":
        lg = _logits(1, (len(loss), 4, 16))
    j_alive, j_rep = j_health(jnp.asarray(loss, jnp.float32),
                              None if lg is None else jnp.asarray(lg))
    alive, rep = ensemble_health(_t(loss), None if lg is None else _t(lg))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(j_alive))
    np.testing.assert_array_equal(rep["z"].numpy(), np.asarray(j_rep["z"]))
    assert rep["collapsed"] == j_rep["collapsed"]
    if "median_pairwise_kl" in j_rep:
        np.testing.assert_allclose(float(rep["median_pairwise_kl"]),
                                   float(j_rep["median_pairwise_kl"]),
                                   rtol=1e-5, atol=1e-6)


def test_logger_roundtrip_and_restart(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricLogger(path)
    for s in range(5):
        log.log(s, loss=torch.tensor([1.0 / (s + 1), 2.0]), lr=1e-3)
    # a restart from step 3 logs steps 3 and 4 again: later lines win
    MetricLogger(path).log(3, loss=[9.0, 9.0], lr=1e-3)
    rows = MetricLogger(path).read()
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 4]
    assert rows[3]["loss"] == [9.0, 9.0] and rows[4]["loss"][1] == 2.0


def test_logger_survives_a_partial_line(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricLogger(path)
    log.log(0, loss=1.0)
    with open(path, "a") as f:
        f.write('{"step": 1, "loss"')               # a crash mid-write
    assert [r["step"] for r in log.read()] == [0]
    assert throughput_tokens_per_s(256, 4096, 2.0) == 256 * 4096 / 2.0
