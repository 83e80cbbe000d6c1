"""The port's counter-hash PRNG against the reference, bit for bit."""
import numpy as np
import pytest
import torch

from repro.kernels import slda_predict as jref
from repro_torch.kernels import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("lo,hi", [
    (0, 1 << 12),                       # small counters, no wrap
    (int(2 ** 31 / 1.618033988749895), 2 ** 31 - 1),  # ctr·φ wraps 2^32
    (-2 ** 31, 2 ** 31 - 1),            # the whole int32 range
])
def test_counter_uniform_bit_equal(lo, hi):
    rng = np.random.default_rng(lo & 0xFFFF)
    seeds = rng.integers(-2 ** 31, 2 ** 31, 100_000).astype(np.int32)
    ctrs = rng.integers(lo, hi, 100_000).astype(np.int32)
    want = jref.counter_uniform(seeds, ctrs)
    got = prng.counter_uniform(torch.from_numpy(seeds),
                               torch.from_numpy(ctrs))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("n_sweeps,n_tokens,ctr_stride",
                         [(3, 17, None), (25, 120, None), (4, 9, 40)])
def test_predict_uniforms_bit_equal(n_sweeps, n_tokens, ctr_stride):
    seeds = np.random.default_rng(1).integers(
        0, 2 ** 31 - 1, 11).astype(np.int32)
    want = jref.predict_uniforms(seeds, n_sweeps, n_tokens,
                                 ctr_stride=ctr_stride)
    got = prng.predict_uniforms(torch.from_numpy(seeds), n_sweeps, n_tokens,
                                ctr_stride=ctr_stride)

    assert tuple(got.shape) == (11, n_sweeps, n_tokens)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
