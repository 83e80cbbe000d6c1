"""`repro_torch.route_parity`, the float32 route comparison that
`chip_smoke.py`'s parity phases run on the card: its tolerance reading,
its wrapper swap, and one whole comparison at a small size on the CPU
(where both routes run the plain versions, so every gap is 0)."""
import numpy as np
import pytest
import torch

from repro_torch import route_parity
from repro_torch.configs import SMOKES
from repro_torch.kernels import flash_attention, ref, rmsnorm, ssd_scan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", [0.5, 40.0])
def test_need_is_the_least_tolerance_of_the_logit_rule(scale):
    rng = np.random.default_rng(0)
    want = torch.tensor(scale * rng.standard_normal((2, 3, 5, 7)),
                        dtype=torch.float32)
    got = want + torch.tensor(1e-3 * rng.standard_normal(want.shape),
                              dtype=torch.float32)
    tol, max_abs, pos = route_parity.need(got, want)
    rms = max(1.0, float(want.square().mean().sqrt()))

    def holds(t):
        return bool(((got - want).abs() <= t * rms + t * want.abs()).all())

    assert holds(tol * (1 + 1e-5)) and not holds(tol * (1 - 1e-3))
    assert max_abs == pytest.approx(float((got - want).abs().max()))
    ratio = (got - want).abs() / (rms + want.abs())
    assert pos == int(torch.nonzero(ratio == ratio.max())[0, 2])


def test_plain_route_swaps_the_named_wrappers_and_restores_them():
    wrappers = (flash_attention.flash_attention_cuda, ssd_scan.ssd_scan_cuda,
                rmsnorm.rmsnorm_cuda)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 1, 3, 4)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((2, 4)), dtype=torch.float32)
    ssd_scan.launches = rmsnorm.launches = 0
    with route_parity.plain_route("B7"):
        assert ssd_scan.ssd_scan_cuda is wrappers[1]
        assert rmsnorm.rmsnorm_cuda is not wrappers[2]
        torch.testing.assert_close(rmsnorm.rmsnorm_cuda(x, w, eps=1e-5),
                                   ref.ref_rmsnorm(x, w, 1e-5))
    with route_parity.plain_route():
        assert all(getattr(m, n) is not f for m, n, f in zip(
            (flash_attention, ssd_scan, rmsnorm),
            ("flash_attention_cuda", "ssd_scan_cuda", "rmsnorm_cuda"),
            wrappers))
    assert (flash_attention.flash_attention_cuda, ssd_scan.ssd_scan_cuda,
            rmsnorm.rmsnorm_cuda) == wrappers
    assert ssd_scan.launches == rmsnorm.launches == 0


def test_route_gaps_runs_every_comparison_on_the_cpu():
    cfg = SMOKES["zamba2-2.7b"]
    row = route_parity.route_gaps(cfg, 0, torch.device("cpu"), noise=1e-7)
    for k in ("forward", "decode8"):
        assert row[k][:2] == (0.0, 0.0)
    assert 0 < row["fused_vs_decode_prefill"][0] < 2e-3
    assert 0 < row["plain_under_noise"][0] < 2e-3
    assert row["plain_route_launches"] == 0
    assert row["plain_logit_rms"] > 0.5
