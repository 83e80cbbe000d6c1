"""The port's plain sampler versions against the reference's.

Every input (tokens, topics, counts, η, uniforms or seeds) is the same
numpy-made array on both sides.  Float log/exp and prefix sums cannot
match bit for bit across the two frameworks, so a draw may differ where a
uniform lies within rounding of a CDF boundary: the share of real tokens
whose draw differs must stay ≤ 1e-3 (it is printed).  Counts are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.slda_gibbs import slda_gibbs_sweep_pallas
from repro.kernels.slda_predict import (slda_predict_sweeps_chains_jnp,
                                        slda_predict_sweeps_chains_pallas)
from repro_torch.core.types import counts_from_assignments
from repro_torch.kernels import (build, flash_attention, ops, ref, rmsnorm,
                                 slda_gibbs, slda_predict, slda_train, sparse,
                                 ssd_scan)

MISMATCH_MAX = 1e-3
ALPHA, BETA, RHO = 0.1, 0.01, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _counts(tok, mask, z, t, w):
    return counts_from_assignments(_t(tok), _t(mask), _t(z), t, w)


def _gibbs_inputs(seed, m, d, t, w, n):
    """Chain-batched sweep inputs with consistent counts, as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, w, (m, d, n)).astype(np.int32)
    lens = rng.integers(n // 2, n + 1, (m, d))
    mask = (np.arange(n) < lens[..., None]).astype(np.float32)
    z = rng.integers(0, t, (m, d, n)).astype(np.int32)
    ndt, ntw, nt = (a.numpy() for a in _counts(tok, mask, z, t, w))
    y = rng.normal(size=(m, d)).astype(np.float32)
    inv_len = (1.0 / np.maximum(mask.sum(-1), 1.0)).astype(np.float32)
    u = rng.random((m, d, n), dtype=np.float32)
    eta = (rng.normal(size=(m, t)) + 0.3).astype(np.float32)
    ntw_t = np.ascontiguousarray(np.swapaxes(ntw, 1, 2))
    return tok, mask, u, z, ndt, y, inv_len, ntw_t, nt, eta


def _mismatch(z_a, z_b, mask):
    return float(((np.asarray(z_a) != np.asarray(z_b))
                  * np.asarray(mask)).sum() / np.asarray(mask).sum())


@pytest.mark.parametrize("n_docs,n_topics,vocab,doc_len", [
    (16, 8, 100, 30), (10, 16, 64, 20), (8, 128, 200, 16)])
@pytest.mark.parametrize("supervised", [True, False])
def test_gibbs_plain_matches_reference(n_docs, n_topics, vocab, doc_len,
                                       supervised):
    a = _gibbs_inputs(0, 1, n_docs, n_topics, vocab, doc_len)
    z_r, ndt_r = jref.ref_slda_gibbs_sweep(*(jnp.asarray(x[0]) for x in a),
                                           ALPHA, BETA, RHO, supervised)
    z_p, ndt_p = ref.ref_slda_gibbs_sweep(
        *(torch.from_numpy(x[0]) for x in a), ALPHA, BETA, RHO, supervised)
    rate = _mismatch(z_r, z_p, a[1][0])
    print(f"B2 plain vs reference T={n_topics} sup={supervised}: "
          f"draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    assert z_p.dtype == torch.int32
    ndt_c, _, _ = _counts(a[0][0], a[1][0], z_p, n_topics, vocab)
    assert torch.equal(ndt_p, ndt_c)


def test_gibbs_plain_matches_interpret_kernel():
    a = _gibbs_inputs(1, 1, 8, 8, 40, 12)
    z_k, ndt_k = slda_gibbs_sweep_pallas(
        *(jnp.asarray(x[0]) for x in a), alpha=ALPHA, beta=BETA, rho=RHO,
        doc_block=8, interpret=True)
    z_p, ndt_p = ops.slda_gibbs_sweep(
        *(torch.from_numpy(x) for x in a[:7]),
        torch.from_numpy(np.ascontiguousarray(np.swapaxes(a[7], 1, 2))),
        *(torch.from_numpy(x) for x in a[8:]), alpha=ALPHA, beta=BETA,
        rho=RHO)
    rate = _mismatch(z_k, z_p[0], a[1][0])
    print(f"B2 plain vs interpret kernel: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    ndt_c, _, _ = _counts(a[0], a[1], z_p, 8, 40)
    assert torch.equal(ndt_p, ndt_c)


def test_gibbs_chains_are_independent():
    """Chain c of a batched sweep equals chain c swept alone."""
    a = _gibbs_inputs(2, 3, 6, 8, 30, 10)
    tz = [torch.from_numpy(x) for x in a]
    z_all, ndt_all = ref.ref_slda_gibbs_sweep_chains(*tz, ALPHA, BETA, RHO)
    for c in range(3):
        z1, ndt1 = ref.ref_slda_gibbs_sweep(*(x[c] for x in tz), ALPHA, BETA,
                                            RHO, True)
        assert torch.equal(z1, z_all[c]) and torch.equal(ndt1, ndt_all[c])


def _predict_inputs(seed, m, d, t, w, n):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, w, (d, n)).astype(np.int32)
    lens = rng.integers(n // 3, n + 1, d)
    mask = (np.arange(n) < lens[:, None]).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, (m, d)).astype(np.int32)
    z0 = rng.integers(0, t, (m, d, n)).astype(np.int32)
    ndt0 = _counts(np.broadcast_to(tok, (m, d, n)),
                   np.broadcast_to(mask, (m, d, n)), z0, t, w)[0].numpy()
    phi = rng.random((m, w, t)).astype(np.float32) ** 4
    phi_t = (phi / phi.sum(1, keepdims=True)).astype(np.float32)
    return tok, mask, seeds, z0, ndt0, phi_t


@pytest.mark.parametrize("n_burnin,n_samples", [(0, 1), (15, 10)])
@pytest.mark.parametrize("t", [8, 40])
def test_predict_plain_matches_reference_twin(n_burnin, n_samples, t):
    a = _predict_inputs(t, 3, 24, t, 60, 32)
    kw = dict(alpha=ALPHA, n_burnin=n_burnin, n_samples=n_samples)
    avg_r, z_r = slda_predict_sweeps_chains_jnp(*map(jnp.asarray, a), **kw)
    avg_p, z_p = ref.slda_predict_sweeps_chains(*map(torch.from_numpy, a),
                                                **kw)
    mask = np.broadcast_to(a[1], z_p.shape)
    rate = _mismatch(z_r, z_p, mask)
    print(f"B1 plain vs reference twin T={t} sweeps={n_burnin}+{n_samples}: "
          f"draw mismatch {rate:.2e}")
    if n_burnin == 0:        # one sweep, every input identical
        assert rate <= MISMATCH_MAX
        ndt_c = _counts(np.broadcast_to(a[0], mask.shape), mask, z_p, t,
                        60)[0]
        assert torch.equal(avg_p, ndt_c)
    # every post-burn-in average still holds each document's tokens
    np.testing.assert_allclose(avg_p.sum(-1).numpy(), mask.sum(-1),
                               rtol=1e-5)
    np.testing.assert_allclose(avg_p.numpy(), np.asarray(avg_r), atol=1.0)


def test_predict_plain_matches_interpret_kernel():
    a = _predict_inputs(5, 2, 8, 8, 30, 10)
    kw = dict(alpha=ALPHA, n_burnin=2, n_samples=1)
    avg_k, z_k = slda_predict_sweeps_chains_pallas(
        *map(jnp.asarray, a), doc_block=8, interpret=True, **kw)
    avg_p, z_p = ops.slda_predict_sweeps(
        torch.from_numpy(a[0]), torch.from_numpy(a[1]),
        torch.from_numpy(a[3]), torch.from_numpy(a[4]),
        torch.from_numpy(np.ascontiguousarray(np.swapaxes(a[5], 1, 2))),
        torch.from_numpy(a[2]), **kw)
    rate = _mismatch(z_k, z_p, np.broadcast_to(a[1], z_p.shape))
    print(f"B1 plain vs interpret kernel: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX


def test_predict_explicit_uniform_oracle_matches_reference_oracle():
    a = _predict_inputs(7, 1, 12, 8, 40, 16)
    u = np.random.default_rng(7).random((12, 4, 16), dtype=np.float32)
    args = (a[0], a[1], u, a[3][0], a[4][0], a[5][0])
    avg_r, z_r = jref.ref_slda_predict_sweeps(*map(jnp.asarray, args),
                                              ALPHA, 2)
    avg_p, z_p = ref.ref_slda_predict_sweeps(*map(torch.from_numpy, args),
                                             ALPHA, 2)
    rate = _mismatch(z_r, z_p, a[1])
    print(f"B1 explicit-uniform oracle vs reference: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    np.testing.assert_allclose(avg_p.sum(-1).numpy(), a[1].sum(-1),
                               rtol=1e-5)


def test_predict_explicit_uniform_oracle_matches_hash_twin():
    """The explicit-uniform oracle fed predict_uniforms is the hash twin."""
    from repro_torch.kernels.prng import predict_uniforms
    a = [torch.from_numpy(x) for x in _predict_inputs(6, 2, 10, 8, 30, 12)]
    tok, mask, seeds, z0, ndt0, phi_t = a
    u = torch.stack([predict_uniforms(s, 5, 12) for s in seeds])
    avg_o, z_o = ref.ref_slda_predict_sweeps_chains(tok, mask, u, z0, ndt0,
                                                    phi_t, ALPHA, 3)
    avg_h, z_h = ref.slda_predict_sweeps_chains(
        tok, mask, seeds, z0, ndt0, phi_t, alpha=ALPHA, n_burnin=3,
        n_samples=2)
    assert torch.equal(z_o, z_h) and torch.equal(avg_o, avg_h)


def test_cuda_wrappers_raise_without_a_card():
    """On a CPU-only machine the kernel wrappers raise; they never run the
    plain version in the kernel's place, and count no launch."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    a = [torch.from_numpy(x) for x in _gibbs_inputs(0, 1, 4, 8, 20, 6)]
    n = (slda_gibbs.launches, slda_predict.launches, slda_train.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        slda_gibbs.slda_gibbs_sweep_cuda(*a, alpha=ALPHA, beta=BETA, rho=RHO)
    p = [torch.from_numpy(x) for x in _predict_inputs(0, 1, 4, 8, 20, 6)]
    with pytest.raises(RuntimeError, match="CUDA"):
        slda_predict.slda_predict_sweeps_cuda(*p, alpha=ALPHA, n_burnin=1,
                                              n_samples=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        slda_train.slda_train_sweeps_cuda(*_train_args(a), **_TRAIN_KW)
    assert (slda_gibbs.launches, slda_predict.launches,
            slda_train.launches) == n


def test_cuda_wrapper_checks_operands():
    a = [torch.from_numpy(x) for x in _gibbs_inputs(0, 1, 4, 8, 20, 6)]
    a[3] = a[3].long()                          # z must be int32
    with pytest.raises(ValueError, match="z: dtype"):
        slda_gibbs.slda_gibbs_sweep_cuda(*a, alpha=ALPHA, beta=BETA, rho=RHO)


_TRAIN_KW = dict(alpha=ALPHA, beta=BETA, rho=RHO, n_sweeps=2, doc_block=8)


def _train_args(gibbs_args):
    """B3's operands from a B2 input set: seeds in place of the uniforms."""
    tok, mask, _, z, ndt, y, inv_len, ntw_t, nt, eta = gibbs_args
    seeds = torch.arange(tok.shape[0] * tok.shape[1],
                         dtype=torch.int32).reshape(tok.shape[:2])
    return [tok, mask, seeds, z, ndt, y, inv_len, ntw_t, nt, eta]


def test_train_cuda_wrapper_checks_operands():
    a = [torch.from_numpy(x) for x in _gibbs_inputs(0, 2, 5, 8, 20, 6)]
    t = _train_args(a)
    t[2] = t[2].long()                          # seeds must be int32
    with pytest.raises(ValueError, match="seeds: dtype"):
        slda_train.slda_train_sweeps_cuda(*t, **_TRAIN_KW)
    t = _train_args(a)
    t[7] = t[7][:1]                             # one table per chain
    with pytest.raises(ValueError, match="ntw_t: shape"):
        slda_train.slda_train_sweeps_cuda(*t, **_TRAIN_KW)
    t = _train_args(a)
    t[4] = t[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="ndt0: not contiguous"):
        slda_train.slda_train_sweeps_cuda(*t, **_TRAIN_KW)


@pytest.mark.parametrize("variant", ["cluster", "block"])
def test_train_kernel_variants_refuse_cpu_tensors(variant):
    """Either B3 variant launches its kernel or raises: on CPU tensors it
    tries to build for a card there is none of, counts no launch, and
    runs no plain version in its place."""
    a = _train_args([torch.from_numpy(x) for x in
                     _gibbs_inputs(0, 2, 5, 8, 20, 6)])
    n = slda_train.launches
    by_variant = dict(slda_train.variant_launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        slda_train.slda_train_sweeps_cuda(*a, kernel_variant=variant,
                                          **_TRAIN_KW)
    with pytest.raises(ValueError, match="no warp variant"):
        slda_train.slda_train_sweeps_cuda(*a, kernel_variant="warp",
                                          **_TRAIN_KW)
    assert slda_train.launches == n
    assert slda_train.variant_launches == by_variant


@pytest.mark.parametrize("module,variant", [
    (slda_predict, "lane"), (slda_predict, "warp"),
    (slda_gibbs, "half_warp"), (slda_gibbs, "warp")])
def test_sampler_kernel_variants_refuse_cpu_tensors(module, variant):
    """Either variant of B1 and of B2 launches its kernel or raises: on
    CPU tensors it tries to build for a card there is none of, counts no
    launch, by variant or at all, and runs no plain version in its
    place; an unknown variant, or the new one where it does not apply
    (T > 16), is refused before any build."""
    if module is slda_predict:
        a = [torch.from_numpy(x) for x in _predict_inputs(0, 2, 6, 8, 20, 7)]
        kw = dict(alpha=ALPHA, n_burnin=1, n_samples=1)
        call = slda_predict.slda_predict_sweeps_cuda
        wide = [torch.from_numpy(x) for x in
                _predict_inputs(0, 2, 6, 17, 20, 7)]
    else:
        a = [torch.from_numpy(x) for x in _gibbs_inputs(0, 2, 5, 8, 20, 6)]
        kw = dict(alpha=ALPHA, beta=BETA, rho=RHO)
        call = slda_gibbs.slda_gibbs_sweep_cuda
        wide = [torch.from_numpy(x) for x in _gibbs_inputs(0, 2, 5, 17, 20, 6)]
    n = module.launches
    by_variant = dict(module.variant_launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(*a, kernel_variant=variant, **kw)
    with pytest.raises(ValueError, match="no block variant"):
        call(*a, kernel_variant="block", **kw)
    new = module.VARIANTS[1]
    with pytest.raises(ValueError, match=f"the {new} variant draws at"):
        call(*wide, kernel_variant=new, **kw)
    assert module.launches == n
    assert module.variant_launches == by_variant


def test_ops_refuse_other_devices():
    a = [torch.from_numpy(x).to("meta") for x in
         _gibbs_inputs(0, 1, 4, 8, 20, 6)]
    with pytest.raises(ValueError, match="no sampler kernel"):
        ops.slda_gibbs_sweep(*a, alpha=ALPHA, beta=BETA, rho=RHO)


def _chain(p):
    """The kernels' prefix sum, written out: one float32 add a column."""
    s, seq = torch.zeros(p.shape[:-1]), torch.empty_like(p)
    for t in range(p.shape[-1]):
        s = s + p[..., t]
        seq[..., t] = s
    return seq


@pytest.mark.parametrize("T", [1, 2, 3, 16, 40, 128, 256, 257, 300, 512])
def test_plain_prefix_sum_is_left_to_right(T):
    """The plain draw's prefix sum is the left-to-right float32 chain the
    kernels compute, bit for bit, at every T (where one GEMM p @ triu(T)
    on the card sums in another order), and on the CPU over 300 rows, as
    the samplers' tests draw them, it is the reference's GEMM itself up to
    256 topics (over one row the CPU's GEMM too adds out of order)."""
    from repro_torch.mathutil import prefix_sum, upper_tri_ones
    rng = np.random.default_rng(T)
    for rows in (1, 7, 300):
        p = torch.from_numpy(rng.random((rows, T), dtype=np.float32) ** 8)
        assert torch.equal(prefix_sum(p), _chain(p))
    if T <= 256:
        assert torch.equal(prefix_sum(p), p @ upper_tri_ones(T))


def test_plain_prefix_sum_is_the_chain_at_every_T():
    """T = 1 to 512, several row counts and a leading batch dim."""
    from repro_torch.mathutil import prefix_sum
    rng = np.random.default_rng(0)
    for T in range(1, 513):
        for lead in ((1,), (5,), (3, 4)):
            p = torch.from_numpy(rng.random(lead + (T,), dtype=np.float32))
            assert torch.equal(prefix_sum(p), _chain(p)), (T, lead)


def _lane_model(ndt, eta):
    """Σ_t η_t·N_dt of one row as the sampler kernels' group of G lanes
    adds it, written as their loops: lane l's running sum over its topics
    l, l + G, .. (`s_part += nd[k] * eta_r[k]` from 0), then the xor
    butterfly of `group_sum` / `warp_sum` (v += shfl_xor(v, o), o = G/2
    .. 1), read at lane 0, every float32 add rounded on its own."""
    T = len(ndt)
    G = 16 if T <= 16 else 32
    f = np.float32
    v = [f(0.0)] * G
    for t in range(T):
        v[t % G] = f(v[t % G] + f(f(ndt[t]) * f(eta[t])))
    o = G // 2
    while o:
        v = [f(v[l] + v[l ^ o]) for l in range(G)]
        o //= 2
    return v[0]


@pytest.mark.parametrize("T", [1, 3, 16, 17, 40, 128, 512])
def test_plain_eta_dot_is_the_kernels_lane_order(T):
    """ROADMAP C5: the plain samplers' running Σ_t η_t·N_dt starts from
    the kernels' lane order, bit for bit (a torch reduction adds in
    another order, which on the card parted B3's draws from the kernel's
    at T = 512 on up to 4.5e-4 of a sweep's tokens)."""
    rng = np.random.default_rng(T)
    ndt = rng.integers(0, 9, (64, T)).astype(np.float32)
    eta = (rng.normal(size=(64, T)) * 2).astype(np.float32)
    got = ref.lane_eta_dot(torch.from_numpy(ndt), torch.from_numpy(eta))
    want = [_lane_model(n, e) for n, e in zip(ndt, eta)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_draw_stays_in_range_for_a_non_positive_total():
    """A chain whose counts went negative (state the supervisor's probe
    flags) draws at most T - 1, as the kernels clamp it, and not T, which
    would index past its table."""
    p = torch.tensor([[-5.0, 0.5, 0.25], [0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    u = torch.tensor([0.5, 0.5, 0.999])
    assert ref._draw(p, u).tolist() == [2, 0, 2]


def test_build_targets_hopper_without_fast_math():
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.FLAGS
    assert not any("fast" in f for f in build.FLAGS)
    assert all((build.CSRC / s).exists() for s in build.SOURCES)
    assert build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch_kernels")


@pytest.mark.parametrize("module,stem,fn", [
    (slda_predict, "slda_predict", "slda_predict_sweeps_launch"),
    (slda_gibbs, "slda_gibbs", "slda_gibbs_sweep_launch"),
    (slda_train, "slda_train", "slda_train_sweeps_launch"),
    (sparse, "slda_predict", "slda_sparse_draw_launch"),
    (sparse, "slda_predict", "slda_pack_topic_index_launch"),
    (flash_attention, "flash_attention", "flash_attention_launch"),
    (ssd_scan, "ssd_scan", "ssd_scan_launch"),
    (rmsnorm, "rmsnorm", "rmsnorm_launch")])

def test_ctypes_argtypes_match_the_c_launchers(module, stem, fn):
    """The ctypes argument list of each launcher matches its C prototype
    (a pointer is c_void_p, int c_int, float c_float), so no argument is
    cut or misread on the card."""
    import ctypes
    import re
    src = (build.CSRC / f"{stem}.cu").read_text()
    params = re.search(rf"extern \"C\" int {fn}\((.*?)\)", src, re.S)[1]
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params.split(",")]
    args = module._PACK_ARGS if fn == "slda_pack_topic_index_launch" \
        else module._ARGS
    assert args == want
