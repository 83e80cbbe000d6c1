"""The port's plain attention (B5) and RMSNorm (B7) against the reference.

The same numpy-made inputs go to both packages; the reference's Pallas
kernels run in interpret mode under `jax.jit`, as `tests/test_kernels.py`
runs them.  Tolerances (numpy's allclose, atol = rtol): float32 2e-6
(summation order), bf16 2e-2 (one rounding of the output); RMSNorm
float32 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention, ops, rmsnorm
from repro_torch.models import layers

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """Each numpy array as a jax and a torch tensor of `dtype`."""
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (1, 2, 2, 32, 32, 16),       # MHA, square
    (2, 4, 2, 64, 64, 32),       # GQA 2:1
    (1, 8, 1, 96, 96, 64),       # MQA; seq not a block multiple
    (2, 4, 4, 1, 128, 32),       # decode: 1 query vs cache
    (1, 4, 2, 16, 80, 32),       # queries the last 16 of 80 keys
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_the_reference_kernel(b, hq, hkv, sq, sk, dh,
                                                      dtype):
    """The grid of `tests/test_kernels.py`: no padded block there, so the
    reference's Pallas route is right and both must agree."""
    (jq, jk, jv), (tq, tk, tv) = _both(_normal(
        0, (b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)), dtype)
    want = jax.jit(lambda q, k, v: jops.attention(
        q, k, v, causal=True, block_q=32, block_k=32))(jq, jk, jv)
    _close(ops.attention(tq, tk, tv, causal=True), want, TOL[dtype])


def test_plain_attention_matches_the_oracle_where_the_reference_kernel_does_not():
    """A causal square call of 200 rows with the reference's default
    blocks of 128: its Pallas route pads q to 256 and shifts every row's
    diagonal by the padding (ROADMAP section C); the port, which pads
    nothing, computes the oracle's attention."""
    (jq, jk, jv), (tq, tk, tv) = _both(_normal(
        0, (1, 2, 200, 32), (1, 1, 200, 32), (1, 1, 200, 32)), "float32")
    oracle = np.asarray(jref.ref_attention(jq, jk, jv, causal=True))
    _close(ops.attention(tq, tk, tv, causal=True), oracle, TOL["float32"])
    faulty = np.asarray(jax.jit(lambda q, k, v: jops.attention(
        q, k, v, causal=True))(jq, jk, jv))
    assert np.abs(faulty - oracle).max() > 1.0


def test_plain_attention_kv_len_masks_the_cache_tail():
    """Decode against a padded cache: kv_len [17, 50]; K and V past each
    row's kv_len poisoned with 1e4 change nothing."""
    (jq, jk, jv), (tq, tk, tv) = _both(_normal(
        1, (2, 4, 1, 32), (2, 2, 64, 32), (2, 2, 64, 32)), "float32")
    kv_len = np.array([17, 50], np.int32)
    want = jax.jit(lambda q, k, v, n: jops.attention(
        q, k, v, causal=True, kv_len=n, block_k=32))(jq, jk, jv, kv_len)
    oracle = jref.ref_attention(jq, jk, jv, causal=True,
                                kv_len=jnp.asarray(kv_len))
    got = ops.attention(tq, tk, tv, causal=True,
                        kv_len=torch.from_numpy(kv_len))
    _close(got, want, 1e-5)
    _close(got, oracle, TOL["float32"])
    tail = (torch.arange(64)[None, :] >= torch.from_numpy(kv_len)[:, None])
    tail = tail[:, None, :, None]
    poisoned = ops.attention(tq, tk.masked_fill(tail, 1e4),
                             tv.masked_fill(tail, 1e4), causal=True,
                             kv_len=torch.from_numpy(kv_len))
    assert torch.equal(poisoned, got)


def test_plain_attention_noncausal():
    (jq, jk, jv), (tq, tk, tv) = _both(_normal(
        2, (1, 2, 32, 16), (1, 2, 64, 16), (1, 2, 64, 16)), "float32")
    want = jax.jit(lambda q, k, v: jops.attention(
        q, k, v, causal=False, block_q=16, block_k=16))(jq, jk, jv)
    _close(ops.attention(tq, tk, tv, causal=False), want, TOL["float32"])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA route launches its kernel or raises: handed CPU tensors,
    the wrappers try to build for a card there is none of, and do not fall
    back to the plain versions."""
    x = torch.zeros((1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention.flash_attention_cuda(x, x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        rmsnorm.rmsnorm_cuda(x[0], torch.ones((2, 8)))


# ------------------------------------------------------------------ rmsnorm

@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 96), (130, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rmsnorm_matches_the_reference_kernel(shape, dtype):
    """One weight [D] for every row: the TPU kernel's form, C = 1."""
    (jx,), (tx,) = _both(_normal(5, shape), dtype)
    (w,) = _normal(6, shape[-1:])
    want = jax.jit(jops.rmsnorm)(jx, jnp.asarray(w))
    _close(ops.rmsnorm(tx, torch.from_numpy(w)), want, NORM_TOL[dtype])


@pytest.mark.parametrize("shape", [(3, 2, 5, 64), (3, 2, 5, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_rmsnorm_takes_a_weight_per_chain(shape, dtype):
    """The models' norm: w [c, D] scales chain c's rows, as the
    reference's `models.layers.rmsnorm` broadcasts it."""
    (jx,), (tx,) = _both(_normal(7, shape), dtype)
    (w,) = _normal(8, (shape[0], shape[-1]))
    want = jax.jit(lambda x, w: jlayers.rmsnorm(x, w, 1e-5))(
        jx, jnp.asarray(w))
    _close(layers.rmsnorm(tx, torch.from_numpy(w), 1e-5), want,
           NORM_TOL[dtype])


@pytest.mark.parametrize("x_shape,w_shape", [
    ((6, 4, 8), (2, 8)),         # reshapes to [2, -1, 8], chains mixed
    ((2, 4, 8), (2, 16)),        # another width
    ((8,), (1, 8))])             # no chain axis to match
def test_rmsnorm_refuses_a_weight_of_another_shape(x_shape, w_shape):
    """x's chain axis must be w's: both routes raise alike, where the
    kernel's [C, -1, D] view would give rows another chain's weight."""
    with pytest.raises(ValueError, match="rmsnorm"):
        ops.rmsnorm(torch.zeros(x_shape), torch.ones(w_shape))
