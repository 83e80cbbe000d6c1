"""Kernel B6's tensor_cores variant on the CPU: a plain-torch model of its
numerics against the reference, its variant choice, and its wrapper.

The kernel itself runs only on the card (`chip_smoke.py` holds it against
its plain version there).  `_tc_model` rounds every operand as the
kernel's tensor-core products take it: x exactly (it is bf16), every float32
operand (C, B, G∘M, the carried state h₀, x∘w) as a bf16 hi plus the bf16
of its residual, a product of two float32 operands as hi·hi + hi·lo +
lo·hi and a product with x as hi·x + lo·x, sums in float32, G = C·Bᵀ
once per (row, chunk) for every head, and y rounded to bf16 once.  It
must hold B6's bf16 gate (`chip_smoke.B6_TOL`) against the reference's
Pallas `ssd` in interpret mode and against its sequential oracle
`ref_ssd`, at the reference's grids and at one mamba2-1.3b-width slice.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs
from repro_torch.kernels import ssd_scan

CHAINS = 2


def _chip_smoke():
    """`chip_smoke.py` as a module: its shape tables and gates (its import
    loads no torch and touches no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
TOL = SMOKE.B6_TOL["bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, c, b, s, h, p, n, a_scale=1.0):
    """x (bf16-representable), dt, A, B, C as numpy float32, drawn as
    `chip_smoke.py` draws B6's rows."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((c, b, s, h, p))).astype(f)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    dt = np.log1p(np.exp(rng.standard_normal((c, b, s, h)))).astype(f)
    A = (-a_scale * np.exp(0.3 * rng.standard_normal((c, h)))).astype(f)
    B = (0.5 * rng.standard_normal((c, b, s, n))).astype(f)
    C = (0.5 * rng.standard_normal((c, b, s, n))).astype(f)
    return x, dt, A, B, C


def _split(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _prod(eq, a, b, *, exact_b=False, split=True):
    """a·b as the kernel's products take them: a float32 operand split in
    hi and lo; b exact (bf16 x) or split too (lo·lo dropped).  `split`
    False rounds each float32 operand to bf16 once instead."""
    if not split:
        r = lambda t: t.bfloat16().float()  # noqa: E731
        return torch.einsum(eq, r(a), b if exact_b else r(b))
    a_hi, a_lo = _split(a)
    if exact_b:
        return torch.einsum(eq, a_lo, b) + torch.einsum(eq, a_hi, b)
    b_hi, b_lo = _split(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _tc_model(x, dt, A, B, C, chunk, split=True):
    """The tensor_cores variant's arithmetic: x [C, b, s, h, p] bf16; dt
    [C, b, s, h], A [C, h], B, C [C, b, s, n] float32.  Returns bf16.
    `split` False: each float32 operand rounded to bf16 once."""
    prod = functools.partial(_prod, split=split)
    Cn, b, s, h, p = x.shape
    xf = x.float()
    state = torch.zeros((Cn, b, h, p, B.shape[-1]))
    ys = []
    for t0 in range(0, s, chunk):
        lc = min(chunk, s - t0)
        xk, dk = xf[:, :, t0:t0 + lc], dt[:, :, t0:t0 + lc]
        bk, ck = B[:, :, t0:t0 + lc], C[:, :, t0:t0 + lc]
        cum = (A[:, None, None, :] * dk).cumsum(2)             # [C,b,L,h]
        G = prod("cbtn,cbsn->cbts", ck, bk)                    # once a row
        tri = torch.ones((lc, lc), dtype=torch.bool).tril()
        decay = torch.where(tri[:, :, None], (cum[:, :, :, None]
                                              - cum[:, :, None]).exp(), 0.0)
        M = G[..., None] * (decay * dk[:, :, None])            # [C,b,t,s,h]
        y = cum.exp()[..., None] * prod("cbhpn,cbtn->cbthp", state, ck)
        y = y + prod("cbtsh,cbshp->cbthp", M, xk, exact_b=True)
        w = (cum[:, :, -1:] - cum).exp() * dk                  # [C,b,L,h]
        state = state * cum[:, :, -1].exp()[..., None, None] + prod(
            "cbshp,cbsn->cbhpn", xk * w[..., None], bk)
        ys.append(y)
    return torch.cat(ys, 2).bfloat16()


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 8, 8, 16),        # the grid of tests/test_kernels.py
    (2, 128, 4, 16, 8, 32),
    (1, 96, 1, 32, 16, 32),
    (1, 50, 2, 8, 8, 16),        # s not a chunk multiple
    (1, 1, 2, 8, 8, 64),         # one step
    (1, 200, 4, 64, 128, 64),    # mamba2-1.3b's widths: 3 chunks + 8
])
def test_tensor_core_numerics_hold_the_bf16_gate(b, s, h, p, n, chunk):
    """The split-operand products keep the bf16 route within B6_TOL of the
    reference's kernel and of its sequential oracle."""
    arrays = _inputs(11, CHAINS, b, s, h, p, n)
    jx = [jnp.asarray(a) for a in arrays]
    jx[0] = jx[0].astype(jnp.bfloat16)
    want = jax.jit(jax.vmap(functools.partial(jops.ssd, chunk=chunk)))(*jx)
    oracle = jax.jit(jax.vmap(jref.ref_ssd))(*jx)
    tx = [torch.from_numpy(a) for a in arrays]
    tx[0] = tx[0].bfloat16()
    got = _tc_model(*tx, min(chunk, s))
    _close(got, want.astype(jnp.float32))
    _close(got, oracle.astype(jnp.float32))


def test_one_bf16_rounding_misses_the_bf16_gate():
    """Why the kernel splits its float32 operands: rounded to bf16 once
    each, the products move outputs near zero by more than B6_TOL allows
    (mamba2-1.3b's widths, 8 heads of 2 rows)."""
    arrays = _inputs(11, 1, 2, 200, 8, 64, 128)
    tx = [torch.from_numpy(a) for a in arrays]
    tx[0] = tx[0].bfloat16()
    want = ref_ssd_chunked_f32(*tx)
    worst = lambda got: float(((got.float() - want).abs()  # noqa: E731
                               / (TOL + TOL * want.abs())).max())
    assert worst(_tc_model(*tx, 64, split=False)) > 1.0
    assert worst(_tc_model(*tx, 64)) < 0.5


def ref_ssd_chunked_f32(x, dt, A, B, C):
    """The port's plain version at chunk 64, in float32 (unrounded)."""
    from repro_torch.kernels import ref
    return ref.ref_ssd_chunked(x.float(), dt, A, B, C, chunk=64)


def test_tensor_core_numerics_stay_finite_where_the_exponent_overflows():
    """A·dt of about -250 a step (chip_smoke's overflow_128 row): the
    model, like the kernel, forms exp(cum_t - cum_s) for s <= t only."""
    arrays = _inputs(5, 1, 2, 128, 2, 8, 8, a_scale=200.0)
    tx = [torch.from_numpy(a) for a in arrays]
    tx[0] = tx[0].bfloat16()
    got = _tc_model(*tx, 64)
    assert got.isfinite().all()
    jx = [jnp.asarray(a) for a in arrays]
    jx[0] = jx[0].astype(jnp.bfloat16)
    _close(got, jax.vmap(jref.ref_ssd)(*jx).astype(jnp.float32))


@pytest.mark.parametrize("row", SMOKE.B6_SHAPES, ids=lambda r: r[0])
def test_b6_variant_of_every_chip_smoke_row(row):
    """Every bf16 row of chip_smoke's B6 phase runs on the tensor cores;
    every float32 row on the CUDA cores (the float32 gates' route)."""
    _, c, b, s, h, p, n, chunk, _, _ = row
    assert ssd_scan.variant(torch.bfloat16, p, n) == "tensor_cores"
    assert ssd_scan.variant(torch.float32, p, n) == "cuda_cores"


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_b6_variant_of_every_served_config(arch):
    """The served models' bf16 prefill takes the tensor cores at full
    width and at the smoke widths; their float32 parity route does not."""
    for cfg in (configs.get_arch(arch), configs.get_arch(arch, smoke=True)):
        p, n = cfg.ssm_head_dim, cfg.ssm_state
        assert ssd_scan.variant(torch.bfloat16, p, n) == "tensor_cores"
        assert ssd_scan.variant(torch.float32, p, n) == "cuda_cores"


def test_b6_variant_needs_whole_pieces():
    """Widths the 16-byte copies cannot cut stay on the CUDA cores."""
    assert ssd_scan.variant(torch.bfloat16, 12, 128) == "cuda_cores"
    assert ssd_scan.variant(torch.bfloat16, 64, 6) == "cuda_cores"


def test_b6_tensor_core_wrapper_refuses_cpu_tensors():
    """Named or chosen, the tensor_cores variant launches its kernel or
    raises: on CPU tensors it tries to build for a card there is none of,
    and runs no plain version in its place; float32 has no tensor_cores
    variant."""
    arrays = _inputs(6, 1, 1, 8, 2, 8, 8)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    n = ssd_scan.launches, dict(ssd_scan.variant_launches)
    for variant in (None, "tensor_cores", "cuda_cores"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ssd_scan.ssd_scan_cuda(x.bfloat16(), dt, A, B, C,
                                   kernel_variant=variant)
    with pytest.raises(ValueError, match="no tensor_cores variant"):
        ssd_scan.ssd_scan_cuda(x, dt, A, B, C, kernel_variant="tensor_cores")
    assert (ssd_scan.launches, ssd_scan.variant_launches) == n
