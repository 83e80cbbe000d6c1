"""The plain attention twins (`kernels.ref.attention_blocked`,
`attention_triangular`) against the reference's
(`repro.kernels.ops.attention_blocked_jnp`, `attention_triangular_jnp`)
on the same numpy inputs, and the plain route's choice among them
(`kernels.ops.attention(use_kernels=False)`, the reference's
`ops.attention(use_pallas=False)`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

F32_TOL = 2e-6
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, Hq, Hkv, Sq, Sk, Dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32)
    return q, k, v


def _t(*a):
    return [torch.from_numpy(x) for x in a]


@pytest.mark.parametrize("Sq,Sk,block,causal", [
    (40, 40, 16, True),       # S not a multiple of the block
    (12, 40, 8, True),        # queries the last Sq positions
    (24, 24, 16, False),
])
def test_blocked_equals_the_reference(Sq, Sk, block, causal):
    q, k, v = _qkv(0, 2, 4, 2, Sq, Sk, 16)
    want = np.asarray(jops.attention_blocked_jnp(
        q, k, v, causal=causal, block_q=block))
    got = ref.attention_blocked(*_t(q, k, v), causal=causal, block_q=block)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_blocked_with_kv_len_equals_the_reference():
    q, k, v = _qkv(1, 3, 4, 4, 8, 32, 16)
    n = np.array([5, 32, 17], np.int32)
    want = np.asarray(jops.attention_blocked_jnp(
        q, k, v, causal=False, kv_len=jnp.asarray(n), block_q=4))
    got = ref.attention_blocked(*_t(q, k, v), causal=False,
                                kv_len=torch.from_numpy(n), block_q=4)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_blocked_bf16_probabilities_equal_the_reference(monkeypatch):
    """The reference reads its switch from a module global at trace
    time; the port takes it as an argument."""
    q, k, v = _qkv(2, 2, 4, 2, 40, 40, 16)
    monkeypatch.setitem(jops.OPT, "probs_bf16", True)
    want = np.asarray(jops.attention_blocked_jnp(q, k, v, block_q=16))
    got = ref.attention_blocked(*_t(q, k, v), block_q=16, probs_bf16=True)
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    exact = ref.attention_blocked(*_t(q, k, v), block_q=16)
    assert not torch.equal(got, exact)


# S not a multiple of the block; one short block
@pytest.mark.parametrize("S,block", [(40, 16), (20, 64)])
def test_triangular_equals_the_reference(S, block):
    """bf16 probabilities (both packages' default); float32 ones."""
    q, k, v = _qkv(3, 2, 4, 2, S, S, 16)
    want = np.asarray(jops.attention_triangular_jnp(q, k, v, block=block))
    got = ref.attention_triangular(*_t(q, k, v), block=block)
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    want = np.asarray(jops.attention_triangular_jnp(
        q, k, v, block=block, probs_dtype=jnp.float32))
    got = ref.attention_triangular(*_t(q, k, v), block=block,
                                   probs_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_triangular_equals_blocked_in_float32():
    q, k, v = _qkv(4, 1, 2, 1, 50, 50, 8)
    tri = ref.attention_triangular(*_t(q, k, v), block=16,
                                   probs_dtype=torch.float32)
    blk = ref.attention_blocked(*_t(q, k, v), block_q=16)
    torch.testing.assert_close(tri, blk, atol=F32_TOL, rtol=0)


def test_the_plain_route_chooses_as_the_reference(monkeypatch):
    """One query → the oracle; the causal switch on a square causal call
    → triangular; otherwise blocked at the block switch or 512; and the
    kernel route's CPU version stays `ref_attention`."""
    calls = []
    for name in ("ref_attention", "attention_blocked",
                 "attention_triangular"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("block_q"))), _f(*a, **k))[1])
    q, k, v = _t(*_qkv(5, 1, 2, 2, 24, 24, 8))
    ops.attention(q[:, :, :1], k, v, use_kernels=False)
    ops.attention(q, k, v, use_kernels=False, causal_skip=True)
    ops.attention(q, k, v, use_kernels=False)
    ops.attention(q, k, v, use_kernels=False, block_q=8)
    ops.attention(q[:, :, :12], k, v, use_kernels=False, causal_skip=True)
    ops.attention(q, k, v)
    assert calls == [("ref_attention", None), ("attention_triangular", None),
                     ("attention_blocked", 512), ("attention_blocked", 8),
                     ("attention_blocked", 512), ("ref_attention", None)]
    # the reference's route on the same calls
    jq, jk, jv = (x.numpy() for x in (q, k, v))
    got = ops.attention(q, k, v, use_kernels=False, causal_skip=True)
    monkeypatch.setitem(jops.OPT, "causal_skip", True)
    want = np.asarray(jax.jit(lambda a, b, c: jops.attention(
        a, b, c, use_pallas=False))(jq, jk, jv))
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
