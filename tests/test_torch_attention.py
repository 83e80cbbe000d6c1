"""The port's plain attention (B5) and RMSNorm (B7) against the reference.

The same numpy-made inputs go to both packages; the reference's Pallas
kernels run in interpret mode under `jax.jit`, as `tests/test_kernels.py`
runs them.  Tolerances (numpy's allclose, atol = rtol): float32 2e-6
(summation order), bf16 2e-2 (one rounding of the output); RMSNorm
float32 1e-5.  The kernels' variant choice, and a numerics model of the
bf16 tensor-core variant, are held here too: the kernels themselves run
only on the card (`chip_smoke.py`).
"""
import ctypes
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.configs import ARCHS
from repro_torch.kernels import build, flash_attention, ops, ref, rmsnorm
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


def _chip_smoke():
    """`chip_smoke.py` as a module: its shape tables and gates (its import
    loads no torch and touches no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


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


# ------------------------------------------------------- kernel variants

# the variant of each B5 row of chip_smoke.py in bf16 and in float32
SMOKE_B5_VARIANTS = {
    "prefill_200": ("prefill_wgmma", "cuda_cores"),
    "prefill_512": ("prefill_wgmma", "cuda_cores"),
    "decode_256": ("decode", "decode"),
    "prefill_200_dh80": ("prefill_wgmma", "cuda_cores"),
    "decode_256_dh80": ("decode", "decode"),
    "prefill_200_gqa4_dh64": ("prefill_wgmma", "cuda_cores"),
    "small_mqa": ("prefill_wgmma", "cuda_cores"),
    "small_sq_lt_sk": ("prefill_wgmma", "cuda_cores"),
    "small_noncausal": ("prefill_wgmma", "cuda_cores"),
    "small_decode_kv0": ("decode", "decode"),
}


@pytest.mark.parametrize("row", SMOKE.B5_SHAPES, ids=lambda r: r[0])
def test_attention_variant_of_each_chip_smoke_shape(row):
    label, _, _, _, sq, _, dh = row[:7]
    want = SMOKE_B5_VARIANTS[label]
    got = tuple(flash_attention.variant(d, sq, dh)
                for d in (torch.bfloat16, torch.float32))
    assert got == want


@pytest.mark.parametrize("arch", sorted(
    a for a, c in ARCHS.items() if "A" in c.pattern or c.shared_attn_every))
def test_attention_variant_of_each_served_shape(arch):
    """Every served model's bf16 prefill runs on the tensor cores and its
    decode steps on the decode variant; float32 (the parity route) stays
    on the CUDA cores at prefill."""
    hd = ARCHS[arch].hd
    assert flash_attention.variant(torch.bfloat16, 200, hd) == \
        "prefill_wgmma"
    assert flash_attention.variant(torch.float32, 200, hd) == "cuda_cores"
    for dtype in (torch.bfloat16, torch.float32):
        assert flash_attention.variant(dtype, 1, hd) == "decode"


@pytest.mark.parametrize("label,shape", SMOKE.B7_SHAPES)
def test_rmsnorm_variant_of_each_chip_smoke_shape(label, shape):
    for dtype in (torch.bfloat16, torch.float32):
        assert rmsnorm.variant(dtype, shape[-1]) == "rows_in_registers"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 8, "rows_in_registers"),
    (torch.bfloat16, 16384, "rows_in_registers"),
    (torch.bfloat16, 16392, "two_pass"),     # more than 2,048 pieces
    (torch.bfloat16, 100, "two_pass"),       # not whole 16-byte pieces
    (torch.float32, 8192, "rows_in_registers"),
    (torch.float32, 8196, "two_pass"),
    (torch.float32, 6, "two_pass")])
def test_rmsnorm_variant_edges(dtype, d, want):
    assert rmsnorm.variant(dtype, d) == want


def test_wrappers_refuse_what_their_variant_cannot_read():
    """A variant that does not fit the operands, named or by alignment,
    raises before anything is built."""
    flat = torch.zeros(1 + 2 * 64 * 8, dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 64, 8)           # 2 bytes off 16
    k = torch.zeros((1, 2, 64, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention_cuda(q, k, k)
    x = torch.zeros((1, 2, 64, 8))
    with pytest.raises(ValueError, match="no prefill_wgmma variant"):
        flash_attention.flash_attention_cuda(x, x, x,
                                             kernel_variant="prefill_wgmma")
    with pytest.raises(ValueError, match="no rows_in_registers variant"):
        rmsnorm.rmsnorm_cuda(torch.zeros((1, 2, 6)), torch.ones((1, 6)),
                             kernel_variant="rows_in_registers")
    xs = torch.zeros(1 + 2 * 8, dtype=torch.bfloat16)[1:].view(1, 2, 8)
    with pytest.raises(ValueError, match="aligned"):
        rmsnorm.rmsnorm_cuda(xs, torch.ones((1, 8)))


def test_bind_binds_each_launcher_once(monkeypatch):
    """`build.bind` hands back the same bound function on every call, its
    argument types set once: a launch pays no rebinding."""
    libc = ctypes.CDLL(None)
    loads = []
    monkeypatch.setattr(build, "_bound", {})
    monkeypatch.setattr(build, "load",
                        lambda stem: loads.append(stem) or libc)
    first = build.bind("libc", "abs", [ctypes.c_int])
    again = build.bind("libc", "abs", [ctypes.c_int])
    assert again is first and loads == ["libc"]
    assert first.argtypes == [ctypes.c_int] and first.restype is ctypes.c_int
    assert first(-3) == 3


def test_ops_rmsnorm_hands_the_kernel_its_operands_uncopied(monkeypatch):
    """On the kernel route a contiguous x reaches the wrapper as a view of
    its own storage and a float32 contiguous w as itself; other operands
    are made so.  The result is the plain version's."""
    seen = []

    def fake(x, w, *, eps):
        seen.append((x, w))
        return ref.ref_rmsnorm(x, w, eps)
    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(ops._rmsnorm, "rmsnorm_cuda", fake)
    x = torch.randn(2, 3, 5, 16)
    w = torch.randn(2, 16)
    got = ops.rmsnorm(x, w, eps=1e-6)
    (kx, kw), = seen
    assert kx.data_ptr() == x.data_ptr() and kx.shape == (2, 15, 16)
    assert kw is w
    torch.testing.assert_close(got, ref.ref_rmsnorm(x, w, 1e-6))
    ops.rmsnorm(x.transpose(1, 2), w.double().t().contiguous().t(), eps=1e-6)
    kx, kw = seen[-1]
    assert kx.is_contiguous() and kw.dtype == torch.float32 and \
        kw.is_contiguous()
    ops.rmsnorm(x[0], w[0], eps=1e-6)        # one weight for every row
    assert seen[-1][1].shape == (1, 16)


# ------------------------------------------ the bf16 tensor-core numerics

def _attention_p_rounded(q, k, v, *, causal=True, split=False):
    """`ref.ref_attention`'s attention with the prefill_wgmma variant's
    rounding: P = exp(S - max) enters P·V in bf16 (with `split`, as a bf16
    hi plus the bf16 of the residual), the normaliser sums P in float32.
    float32 out, unrounded."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(Hq // Hkv, dim=1)
    v = v.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * Dh ** -0.5
    if causal and Sq > 1:
        qi = torch.arange(Sq)[:, None] + (Sk - Sq)
        s = s.masked_fill(torch.arange(Sk)[None, :] > qi, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    out = torch.einsum("bhqk,bhkd->bhqd", hi, v)
    if split:
        out = out + torch.einsum("bhqk,bhkd->bhqd",
                                 (p - hi).bfloat16().float(), v)
    return out / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (1, 16, 8, 200, 200, 128),   # lm_parity's qwen3-1.7b, one batch row
    (1, 32, 32, 200, 200, 80),   # zamba2-2.7b's shared block
    (1, 16, 4, 200, 200, 64),    # GQA 4:1
    (2, 8, 1, 96, 96, 32),       # chip_smoke.py's small shapes
    (1, 4, 2, 16, 80, 32),
    (1, 2, 2, 32, 64, 16),
])
def test_bf16_probabilities_hold_the_gates(b, hq, hkv, sq, sk, dh):
    """Rounding P to bf16 before P·V keeps the output within B5's bf16
    gate of the reference's oracle; splitting P into bf16 hi and lo keeps
    it within the float32 gate (chip_smoke.B5_TOL)."""
    causal = (sq, sk) != (32, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(_normal(
        9, (b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)), "bfloat16")
    oracle = jax.jit(lambda q, k, v: jref.ref_attention(
        q, k, v, causal=causal))
    got = _attention_p_rounded(tq, tk, tv, causal=causal)
    _close(got.bfloat16(), oracle(jq, jk, jv),
           SMOKE.B5_TOL["bfloat16"])
    exact = oracle(*(x.astype(jnp.float32) for x in (jq, jk, jv)))
    split = _attention_p_rounded(tq, tk, tv, causal=causal, split=True)
    _close(split, exact, SMOKE.B5_TOL["float32"])
