"""The port's sparse two-stage sampler (kernel B4's plain version) and the
sparse path of B1, B2, B3 and the EM loop, against the reference.

Every input is the same numpy-made array on both sides, or reference
state carried across with `repro_torch.convert`.  Float prefix sums
cannot be promised to round alike across the two frameworks, so a draw
may differ where a uniform lies within rounding of a CDF boundary: the
share of real tokens (or rows) whose draw differs must stay ≤ 1e-3, and
is printed.  The index is integer and 0/1 data: it must match bit for
bit.  Counts are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SLDAConfig as JConfig
from repro.core import run_nonparallel as j_nonparallel
from repro.core import run_simple_average as j_simple
from repro.core import run_weighted_average as j_weighted
from repro.core import types as jtypes
from repro.core.plan import build_plan as j_build_plan
from repro.core.types import partition as j_partition
from repro.kernels import ref as jref
from repro.kernels.slda_gibbs import slda_gibbs_sweep_pallas
from repro.kernels.slda_predict import (slda_predict_sweeps_chains_jnp,
                                        slda_predict_sweeps_chains_pallas)
from repro.kernels.slda_train import (slda_train_sweeps_chains_jnp,
                                      slda_train_sweeps_chains_pallas)
from repro.kernels.sparse import sparse_two_stage_draw as j_draw
from repro_torch.core import (ALGORITHMS, SLDAConfig,
                              counts_from_assignments, partition, types)
from repro_torch.core.plan import build_plan
from repro_torch.kernels import (build, ops, ref, slda_gibbs, slda_predict,
                                 slda_train, sparse)
from repro_torch.kernels.prng import predict_uniforms
from repro_torch.kernels.sparse import (pack_topic_index, residual_blocks,
                                        sparse_two_stage_draw)
# the EM-loop helpers and the corpus of the port's other tests
from test_torch_parallel import _ref_predict_draws, _ref_train_draws
from test_torch_train import (CFG, SEEDS, _em_against_reference,  # noqa: F401
                              _ref_fused_draws, corpus_pair)

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
    return torch.from_numpy(np.array(x))


def _rate(z_a, z_b, mask=None):
    diff = np.asarray(z_a) != np.asarray(z_b)
    if mask is None:
        return float(diff.mean())
    mask = np.broadcast_to(np.asarray(mask), diff.shape)
    return float((diff * mask).sum() / mask.sum())


def _index_np(table, cap):
    """The reference's index of a numpy table, as numpy arrays."""
    return [np.asarray(a) for a in
            jtypes.topic_occupancy_index(jnp.asarray(table), cap)]


# ------------------------------------------------------------ the draw

def _random_index(rng, r, t, cap):
    """Distinct random topics per row, random valid slots, and their
    membership mask: any index content is allowed."""
    idx = np.argsort(rng.random((r, t)), axis=-1)[:, :cap].astype(np.int32)
    vmask = (rng.random((r, cap)) < 0.8).astype(np.float32)
    occm = np.zeros((r, t), np.float32)
    np.put_along_axis(occm, idx, vmask, axis=-1)
    return idx, vmask, occm


@pytest.mark.parametrize("t,cap", [
    (t, cap) for cap in (1, 2, 8, 32) for t in (3, 16, 40, 128)]
    + [(512, 32)])
def test_draw_matches_reference(t, cap):
    """Identical (p, u, idx, vmask, occm) through both draws: a random
    index, a stale index (another table's), and the fresh index of a
    count table; T = 3 and 40 are not multiples of the residual block,
    T = 512 is the top of the reference's sparse grid."""
    rng = np.random.default_rng(t * 100 + cap)
    cap = min(cap, t)
    r, w = 3000, 64
    p = (rng.random((r, t), dtype=np.float32) ** 3).astype(np.float32)
    p[rng.random((r, t)) < 0.2] = 0.0
    u = rng.random(r, dtype=np.float32)
    words = rng.integers(0, w, r)
    counts = (rng.integers(0, 4, (w, t))
              * (rng.random((w, t)) < 0.4)).astype(np.float32)
    stale = rng.permutation(counts)           # another word's rows
    kinds = {"random": _random_index(rng, r, t, cap),
             "stale": [a[words] for a in _index_np(stale, cap)],
             "fresh": [a[words] for a in _index_np(counts, cap)]}
    draw = jax.jit(j_draw)
    for kind, index in kinds.items():
        z_r = draw(jnp.asarray(p), jnp.asarray(u), *map(jnp.asarray, index))
        z_p = sparse_two_stage_draw(_t(p), _t(u), *map(_t, index))
        rate = _rate(z_r, z_p)
        print(f"sparse draw T={t} cap={cap} {kind} index: "
              f"draw mismatch {rate:.2e}")
        assert z_p.dtype == torch.int32
        assert int(z_p.min()) >= 0 and int(z_p.max()) < t
        assert rate <= MISMATCH_MAX


def _model_index(rng, r, t, cap, fresh):
    """An index of r rows: a count table's own (`fresh`), else distinct
    random topics with random valid slots and their membership mask."""
    if fresh:
        counts = (rng.integers(0, 4, (r, t))
                  * (rng.random((r, t)) < 0.3)).astype(np.float32)
        return types.topic_occupancy_index(torch.from_numpy(counts), cap)
    return tuple(map(torch.from_numpy, _random_index(rng, r, t, cap)))


def _f32(x):
    return np.float32(x)


def _record_draw_model(p, u, rec, t, cap):
    """The lane / half-warp form of the draw at T <= 16 as a plain loop in
    float32: the bucket sv_i = p[idx_i] where vmask's bit i is set, else
    0; the residual r_t = 0 where occm's bit t is set, else p_t; each sum
    left to right over 16 positions padded with zeros; the residual one
    block (blk = T), so its total is the block total and stage 2's
    remainder is tgt - q_s.  The counts are taken both as the half-warp
    takes them (slots below cap, topics below T) and as the lane takes
    them (all 16, the clamps alone bounding them); returns both topics
    and whether stage 2 drew."""
    om, vm = int(rec[0]) & 0xFFFFFFFF, int(rec[1]) & 0xFFFFFFFF
    nib = (int(rec[2]) & 0xFFFFFFFF) | (int(rec[3]) & 0xFFFFFFFF) << 32

    def topic(i):
        return (nib >> (4 * i)) & 15
    pad = [p[j] if j < t else _f32(0) for j in range(16)]
    sv = [pad[topic(i)] if i < cap and vm >> i & 1 else _f32(0)
          for i in range(16)]
    rv = [_f32(0) if j < t and om >> j & 1 else pad[j] for j in range(16)]
    cs, cf = [], []
    a = b = _f32(0)
    for i in range(16):              # zero-padded, left to right
        a = _f32(a + sv[i])
        b = _f32(b + rv[i])
        cs.append(a)
        cf.append(b)
    q_s, q_r = cs[cap - 1], cf[t - 1]
    tgt = _f32(u * _f32(q_s + q_r))
    rem = _f32(tgt - q_s)
    stage1 = tgt < q_s or q_r <= 0
    out = []
    for n_s, n_f in ((cap, t), (16, 16)):
        ks = sum(1 for i in range(n_s) if cs[i] < tgt)
        kf = sum(1 for j in range(n_f) if cf[j] < rem)
        out.append(topic(min(ks, cap - 1)) if stage1 else min(kf, t - 1))
    return out[0], out[1], not stage1


@pytest.mark.parametrize("cap", [1, 2, 4, 16])
@pytest.mark.parametrize("t", [1, 3, 16])
def test_lane_and_half_warp_model_is_the_reference_draw(t, cap):
    """Identical (p, u, idx, vmask, occm) through the loop model on the
    packed record (with the half-warp's guarded counts and the lane's
    unguarded ones), the reference's draw (jitted, as its tests run it)
    and the port's plain version: the same topic on every row, bit for
    bit, with stage 2 taken on some rows (where the index misses mass)."""
    cap = min(cap, t)
    rng = np.random.default_rng(10 * t + cap)
    r = 600
    p = (rng.random((r, t), dtype=np.float32) ** 3).astype(np.float32)
    p[rng.random((r, t)) < 0.2] = 0.0
    u = rng.random(r, dtype=np.float32)
    u[:60] = np.float32(1 - 2 ** -24)     # the largest uniform: tgt at q
    idx, vm, om = _model_index(rng, r, t, cap, fresh=bool(t % 2))
    rec = pack_topic_index(idx, vm, om).numpy()
    # the reference gets numpy copies: no buffer shared with torch
    z_ref = np.asarray(jax.jit(j_draw)(
        jnp.asarray(p), jnp.asarray(u), *(jnp.asarray(np.array(a))
                                          for a in (idx, vm, om))))
    z_port = sparse_two_stage_draw(torch.from_numpy(p), torch.from_numpy(u),
                                   idx, vm, om).numpy()
    model = [_record_draw_model(p[i], u[i], rec[i], t, cap) for i in range(r)]
    z_half = np.array([z for z, _, _ in model])
    z_lane = np.array([z for _, z, _ in model])
    stage2 = sum(s for _, _, s in model)
    print(f"T={t} cap={cap}: {stage2} of {r} rows took stage 2")
    assert np.array_equal(z_half, z_ref)
    assert np.array_equal(z_lane, z_ref)
    assert np.array_equal(z_half, z_port)
    if cap < t:
        assert stage2 > 0


@pytest.mark.parametrize("t,cap", [(1, 1), (3, 2), (16, 4), (16, 16),
                                   (17, 5), (40, 32), (128, 32), (300, 7),
                                   (512, 32)])
def test_sparse_draw_prefix_sums_are_left_to_right(monkeypatch, t, cap):
    """The sparse plain draw's three prefix sums (the bucket's, each
    residual block's, the block totals') are the left-to-right float32
    chains of the kernels, bit for bit, T = 1 to 512."""
    from repro_torch.kernels import sparse as psparse
    from repro_torch.mathutil import prefix_sum
    seen = []

    def recorded(x):
        out = prefix_sum(x)
        seen.append((x, out))
        return out
    monkeypatch.setattr(psparse, "prefix_sum", recorded)
    rng = np.random.default_rng(t + cap)
    for r in (1, 50):
        p = (rng.random((r, t), dtype=np.float32) ** 3).astype(np.float32)
        u = rng.random(r, dtype=np.float32)
        idx, vm, om = _model_index(rng, r, t, cap, fresh=True)
        seen.clear()
        sparse_two_stage_draw(torch.from_numpy(p), torch.from_numpy(u), idx,
                              vm, om)
        blk, nb = residual_blocks(t)
        assert [tuple(x.shape) for x, _ in seen] == [(r, cap), (r, nb, blk),
                                                      (r, nb)]
        for x, out in seen:
            s, want = torch.zeros(x.shape[:-1]), torch.empty_like(x)
            for j in range(x.shape[-1]):
                s = s + x[..., j]
                want[..., j] = s
            assert torch.equal(out, want)


def test_residual_blocks_match_reference():
    from repro.kernels.sparse import residual_blocks as j_blocks
    for t in (1, 3, 15, 16, 17, 40, 128, 256, 512):
        assert residual_blocks(t) == j_blocks(t)


@pytest.mark.parametrize("t", [3, 8, 17, 32, 128])
def test_collapse_identity_index_is_the_dense_draw(t):
    """idx = arange(T), cap = T, vmask = occm = 1: the residual is exactly
    zero and the draw is bit for bit the port's dense draw."""
    rng = np.random.default_rng(t)
    r = 2000
    p = _t(rng.random((r, t), dtype=np.float32) ** 3)
    u = _t(rng.random(r, dtype=np.float32))
    idx = torch.arange(t, dtype=torch.int32).expand(r, t)
    ones = torch.ones((r, t))
    z_sparse = sparse_two_stage_draw(p, u, idx, ones, ones)
    z_dense = ref._draw(p, u)
    assert torch.equal(z_sparse, z_dense)


@pytest.mark.parametrize("cap", [1, 2, 4])
def test_two_stage_distributionally_exact_any_index(cap):
    """The port's own draw under an index with cap below the true
    occupancy (stage 2 fires): on a fine u-grid each topic's measure is
    the dense sampler's within 4/n_grid (a topic's preimage is at most two
    intervals under the two-stage map and one under dense)."""
    t, w, n = 11, 5, 40_000
    rng = np.random.default_rng(3)
    table = _t((rng.random((w, t)) > 0.5).astype(np.float32) * 7.0)
    idx, vm, om = types.topic_occupancy_index(table, cap)
    assert int(types.topic_occupancy(table).max()) > cap
    pw = _t(rng.random((w, t), dtype=np.float32) ** 2 + 1e-4)
    us = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    for word in range(w):
        z = sparse_two_stage_draw(
            pw[word].expand(n, t), us, idx[word].expand(n, cap),
            vm[word].expand(n, cap), om[word].expand(n, t))
        frac = torch.bincount(z.long(), minlength=t).double() / n
        want = (pw[word] / pw[word].sum()).double()
        assert float((frac - want).abs().max()) <= 4.0 / n, (word, cap)


# ------------------------------------------------------------ the index

def _tables(kind, rng):
    if kind == "counts":          # integer counts, many ties, zeros above all
        return (rng.integers(0, 3, (60, 16))
                * (rng.random((60, 16)) < 0.4)).astype(np.float32), 4
    if kind == "phi":             # float φ rows with exact zeros
        phi = rng.random((60, 16)).astype(np.float32) ** 4
        phi[rng.random(phi.shape) < 0.3] = 0.0
        return phi / np.maximum(phi.sum(0, keepdims=True), 1e-30), 8
    if kind == "cap_above_t":
        return rng.integers(0, 2, (30, 8)).astype(np.float32), 32
    # leading [M] dims
    return (rng.integers(0, 4, (3, 40, 12))
            * (rng.random((3, 40, 12)) < 0.5)).astype(np.float32), 5


@pytest.mark.parametrize("kind", ["counts", "phi", "cap_above_t", "chains"])
def test_topic_occupancy_index_matches_reference_bitwise(kind):
    table, cap = _tables(kind, np.random.default_rng(len(kind)))
    want = _index_np(table, cap)
    got = types.topic_occupancy_index(_t(table), cap)
    assert got[0].dtype == torch.int32
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w)
    assert np.array_equal(types.topic_occupancy(_t(table)).numpy(),
                          np.asarray(jtypes.topic_occupancy(
                              jnp.asarray(table))))


# ------------------------------------------- plain B1 / B2 / B3, sparse

def _inputs(seed, m, d, t, w, n):
    """Chain-batched sampler inputs with consistent counts, as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, w, (m, d, n)).astype(np.int32)
    lens = rng.integers(n // 3, n + 1, (m, d))
    mask = (np.arange(n) < lens[..., None]).astype(np.float32)
    z = rng.integers(0, t, (m, d, n)).astype(np.int32)
    ndt, ntw, nt = (a.numpy() for a in counts_from_assignments(
        _t(tok), _t(mask), _t(z), t, w))
    return dict(
        tokens=tok, mask=mask, z0=z, ndt0=ndt, ntw=ntw, nt=nt,
        ntw_t=np.ascontiguousarray(np.swapaxes(ntw, 1, 2)),
        y=rng.normal(size=(m, d)).astype(np.float32),
        inv_len=(1.0 / np.maximum(mask.sum(-1), 1.0)).astype(np.float32),
        seeds=rng.integers(0, 2 ** 31 - 1, (m, d)).astype(np.int32),
        eta=(rng.normal(size=(m, t)) + 0.3).astype(np.float32))


_HASH = ("tokens", "mask", "seeds", "z0", "ndt0", "y", "inv_len", "ntw_t",
         "nt", "eta")
_ORACLE = ("tokens", "mask", "uniforms", "z0", "ndt0", "y", "inv_len",
           "ntw_t", "nt", "eta")


def _check_counts(a, z, ndt, t, w):
    ndt_c, _, _ = counts_from_assignments(_t(a["tokens"]), _t(a["mask"]),
                                          z, t, w)
    assert z.dtype == torch.int32 and torch.equal(ndt, ndt_c)


@pytest.mark.parametrize("cap,product_form", [(2, False), (4, True)])
def test_train_sparse_plain_matches_reference(cap, product_form):
    """Plain B3 in sparse mode against the reference's oracle (explicit
    uniforms), blocked twin and interpret-mode kernel: 2 chains of 16
    documents in doc blocks of 4, 3 sweeps, T = 8 with cap below the
    occupancy.  The index is launch-frozen on both sides."""
    t, w, n, sweeps = 8, 30, 10, 3
    a = _inputs(cap * 10 + product_form, 2, 16, t, w, n)
    kw = dict(alpha=ALPHA, beta=BETA, rho=RHO, n_sweeps=sweeps, doc_block=4,
              product_form=product_form)
    jkw = dict(kw, sampler_mode="sparse", sparse_topic_cap=cap)
    hash_args = [a[k] for k in _HASH]
    z_twin, _ = jax.jit(lambda *x: slda_train_sweeps_chains_jnp(
        *x, **jkw))(*hash_args)
    z_kern, _ = slda_train_sweeps_chains_pallas(
        *map(jnp.asarray, hash_args), interpret=True, **jkw)
    u = np.stack([np.asarray(predict_uniforms(_t(s), sweeps, n))
                  for s in a["seeds"]])
    oracle_args = [u if k == "uniforms" else a[k] for k in _ORACLE]
    z_orc, _ = jax.jit(lambda *x: jref.ref_slda_train_sweeps_chains(
        *x, ALPHA, BETA, RHO, True, 4, product_form=product_form,
        sampler_mode="sparse", sparse_topic_cap=cap))(
        *(jnp.asarray(x) for x in oracle_args))

    index = types.topic_occupancy_index(_t(a["ntw_t"]), cap)
    z_po, ndt_po = ref.ref_slda_train_sweeps_chains(
        *map(_t, oracle_args), ALPHA, BETA, RHO, True, 4,
        product_form=product_form, topic_index=index)
    z_p, ndt_p = ops.slda_train_sweeps(
        *(_t(a[k]) for k in ("tokens", "mask", "z0", "ndt0", "y", "inv_len",
                             "ntw", "nt", "eta", "seeds")),
        sampler_mode="sparse", sparse_topic_cap=cap, **kw)
    for what, z_r, z_port in (("oracle", z_orc, z_po), ("twin", z_twin, z_p),
                              ("interpret kernel", z_kern, z_p)):
        rate = _rate(z_r, z_port, a["mask"])
        print(f"B3 sparse cap={cap} product form {product_form} vs "
              f"reference {what}: draw mismatch {rate:.2e}")
        assert rate <= MISMATCH_MAX
    assert torch.equal(z_po, z_p) and torch.equal(ndt_po, ndt_p)
    _check_counts(a, z_p, ndt_p, t, w)
    z_dense, _ = ops.slda_train_sweeps(
        *(_t(a[k]) for k in ("tokens", "mask", "z0", "ndt0", "y", "inv_len",
                             "ntw", "nt", "eta", "seeds")), **kw)
    assert not torch.equal(z_dense, z_p), "sparse is its own sampler"


def test_predict_sparse_plain_matches_reference():
    """Plain B1 in sparse mode against the reference's oracle, twin and
    interpret-mode kernel, each chain's index built from its own φ̂."""
    t, w, n, cap = 8, 40, 12, 3
    a = _inputs(21, 2, 16, t, w, n)
    rng = np.random.default_rng(21)
    phi = rng.random((2, t, w)).astype(np.float32) ** 4
    phi[rng.random(phi.shape) < 0.3] = 0.0
    phi = (phi / phi.sum(-1, keepdims=True)).astype(np.float32)
    phi_t = np.ascontiguousarray(np.swapaxes(phi, 1, 2))
    tok, mask = a["tokens"][0], a["mask"][0]
    z0 = a["z0"]
    ndt0 = counts_from_assignments(_t(np.broadcast_to(tok, z0.shape)),
                                   _t(np.broadcast_to(mask, z0.shape)),
                                   _t(z0), t, w)[0].numpy()
    kw = dict(alpha=ALPHA, n_burnin=1, n_samples=2)
    jkw = dict(kw, sampler_mode="sparse", sparse_topic_cap=cap)
    args = (tok, mask, a["seeds"], z0, ndt0, phi_t)
    avg_j, z_twin = slda_predict_sweeps_chains_jnp(*map(jnp.asarray, args),
                                                   **jkw)
    _, z_kern = slda_predict_sweeps_chains_pallas(
        *map(jnp.asarray, args), doc_block=8, interpret=True, **jkw)
    u = np.stack([np.asarray(predict_uniforms(_t(s), 3, n))
                  for s in a["seeds"]])
    _, z_orc = jref.ref_slda_predict_sweeps_chains(
        *(jnp.asarray(x) for x in (tok, mask, u, z0, ndt0, phi_t)), ALPHA, 1,
        sampler_mode="sparse", sparse_topic_cap=cap)
    index = types.topic_occupancy_index(_t(phi_t), cap)
    _, z_po = ref.ref_slda_predict_sweeps_chains(
        *map(_t, (tok, mask, u, z0, ndt0, phi_t)), ALPHA, 1,
        topic_index=index)
    avg_p, z_p = ops.slda_predict_sweeps(
        _t(tok), _t(mask), _t(z0), _t(ndt0), _t(phi), _t(a["seeds"]),
        sampler_mode="sparse", sparse_topic_cap=cap, **kw)
    for what, z_r, z_port in (("oracle", z_orc, z_po), ("twin", z_twin, z_p),
                              ("interpret kernel", z_kern, z_p)):
        rate = _rate(z_r, z_port, mask)
        print(f"B1 sparse vs reference {what}: draw mismatch {rate:.2e}")
        assert rate <= MISMATCH_MAX
    assert torch.equal(z_po, z_p)
    np.testing.assert_allclose(avg_p.sum(-1).numpy(),
                               np.broadcast_to(mask.sum(-1), (2, 16)),
                               rtol=1e-5)
    np.testing.assert_allclose(avg_p.numpy(), np.asarray(avg_j), atol=1.0)
    _, z_dense = ops.slda_predict_sweeps(
        _t(tok), _t(mask), _t(z0), _t(ndt0), _t(phi), _t(a["seeds"]), **kw)
    assert not torch.equal(z_dense, z_p), "sparse is its own sampler"


def test_single_sweep_sparse_plain_matches_reference():
    """Plain B2 in sparse mode against the reference's oracle and
    interpret-mode kernel, the index built from the sweep-frozen table."""
    t, w, n, cap = 8, 40, 12, 3
    a = _inputs(31, 1, 16, t, w, n)
    u = np.random.default_rng(31).random((1, 16, n), dtype=np.float32)
    args = [u[0] if k == "uniforms" else a[k][0] for k in _ORACLE]
    skw = dict(sampler_mode="sparse", sparse_topic_cap=cap)
    z_orc, _ = jref.ref_slda_gibbs_sweep(*map(jnp.asarray, args), ALPHA,
                                         BETA, RHO, True, **skw)
    z_kern, _ = slda_gibbs_sweep_pallas(
        *map(jnp.asarray, args), alpha=ALPHA, beta=BETA, rho=RHO,
        doc_block=8, interpret=True, **skw)
    z_p, ndt_p = ops.slda_gibbs_sweep(
        *(_t(u) if k == "uniforms" else _t(a[k]) for k in
          ("tokens", "mask", "uniforms", "z0", "ndt0", "y", "inv_len",
           "ntw", "nt", "eta")), alpha=ALPHA, beta=BETA, rho=RHO, **skw)
    for what, z_r in (("oracle", z_orc), ("interpret kernel", z_kern)):
        rate = _rate(z_r, z_p[0], a["mask"][0])
        print(f"B2 sparse vs reference {what}: draw mismatch {rate:.2e}")
        assert rate <= MISMATCH_MAX
    _check_counts(a, z_p, ndt_p, t, w)


def test_cuda_wrappers_check_the_topic_index():
    """The index operands are checked before any pointer is handed over:
    cap ≤ T, int32 idx, one index per chain."""
    a = _inputs(41, 2, 4, 8, 20, 6)
    u = np.random.default_rng(0).random((2, 4, 6), dtype=np.float32)
    g = [_t(u) if k == "uniforms" else _t(a[k]) for k in _ORACLE]
    kw = dict(alpha=ALPHA, beta=BETA, rho=RHO)
    idx, vm, om = types.topic_occupancy_index(g[7], 4)
    n = (slda_gibbs.launches, slda_gibbs.sparse_launches)
    with pytest.raises(ValueError, match="idx: dtype"):
        slda_gibbs.slda_gibbs_sweep_cuda(*g, topic_index=(idx.long(), vm, om),
                                         **kw)
    with pytest.raises(ValueError, match="occm: shape"):
        slda_gibbs.slda_gibbs_sweep_cuda(*g, topic_index=(idx, vm, om[:1]),
                                         **kw)
    wide = torch.zeros((2, 20, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="cap 9"):
        slda_gibbs.slda_gibbs_sweep_cuda(
            *g, topic_index=(wide, wide.float(), om), **kw)
    h = [_t(a[k]) for k in _HASH]
    with pytest.raises(ValueError, match="vmask: dtype"):
        slda_train.slda_train_sweeps_cuda(
            *h, topic_index=(idx, vm.double(), om), n_sweeps=2, doc_block=4,
            **kw)
    p = [h[0][0], h[1][0], h[2], h[3], h[4], h[7]]
    with pytest.raises(ValueError, match="idx: shape"):
        slda_predict.slda_predict_sweeps_cuda(
            *p, topic_index=(idx[:1], vm, om), alpha=ALPHA, n_burnin=1,
            n_samples=1)
    assert (slda_gibbs.launches, slda_gibbs.sparse_launches) == n
    if not torch.cuda.is_available():    # a valid index gets to the build
        with pytest.raises(RuntimeError, match="CUDA"):
            slda_gibbs.slda_gibbs_sweep_cuda(*g, topic_index=(idx, vm, om),
                                             **kw)
    assert build.topic_index_operands(None, 2, 20, 8, "cpu") == (0, 0, 0, 0)


def test_draw_alone_cuda_wrapper_checks_and_needs_a_card():
    """The device function's own wrapper checks its operands and launches
    or raises: it never computes the plain draw in the kernel's place."""
    r, t, cap = 6, 8, 3
    p, u = torch.rand((r, t)), torch.rand(r)
    idx, vm, om = types.topic_occupancy_index(torch.rand((r, t)), cap)
    with pytest.raises(ValueError, match="cap=9"):
        sparse.sparse_two_stage_draw_cuda(p, u, *(a.repeat(1, 3)
                                                  for a in (idx, vm)), om)
    with pytest.raises(ValueError, match="u: shape"):
        sparse.sparse_two_stage_draw_cuda(p, u[:2], idx, vm, om)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sparse.sparse_two_stage_draw_cuda(p, u, idx, vm, om)


# ------------------------------------------ the slice as a whole, sparse

SPARSE = dict(sampler_mode="sparse", sparse_topic_cap=3)


def test_sparse_em_one_sweep_per_launch_matches_reference(corpus_pair):
    """4 EM iterations of 4 chains at spl=1, each sweep drawing through the
    sparse draw against the index of its sweep-frozen table, under the
    reference's own draws: draw for draw, counts exact."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=4, count_rebuild_every=3, **SPARSE)
    j_shards, p_shards = j_partition(j_train, 4), partition(p_train, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    j_state, j_models = jax.jit(
        lambda k, c: j_build_plan(c, JConfig(**kw)).train(k))(keys, j_shards)
    z, us = _ref_train_draws(keys, 80, 50, 8, 4)
    p_state, p_models = build_plan(p_shards, SLDAConfig(**kw)).train(
        _t(z), (_t(u) for u in us))
    rate = _rate(p_state.z, j_state.z, j_shards.mask)
    print(f"sparse, 4 EM iterations at spl=1 under the reference's draws: "
          f"draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    counts = counts_from_assignments(p_shards.tokens, p_shards.mask,
                                     p_state.z, 8, 200)
    for f, c in zip(("ndt", "ntw", "nt"), counts):
        assert torch.equal(getattr(p_state, f), c)
    np.testing.assert_allclose(p_models.eta.numpy(),
                               np.asarray(j_models.eta), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_models.phi.numpy(),
                               np.asarray(j_models.phi), rtol=1e-3, atol=1e-6)


def test_sparse_fused_em_matches_reference(corpus_pair):
    """spl=3 over 7 iterations (two launches and a remainder of one), four
    chains in five doc blocks each, every launch drawing against the index
    of its entry table, under the reference's own seeds."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=7, sweeps_per_launch=3, count_rebuild_every=2,
              train_doc_block=16, **SPARSE)
    _em_against_reference(j_partition(j_train, 4), partition(p_train, 4),
                          kw, jax.random.split(jax.random.PRNGKey(6), 4),
                          False, "sparse, 7 sweeps in 3 fused launches")


def test_sparse_fused_mse_matches_reference(corpus_pair):
    """3-seed test MSEs with the sparse draw at spl=8 (cap 3 < T = 8, so
    stage 2 is live), held as the dense spl=8 run is held: Simple's and
    Weighted's means within 15% of the reference's sparse run, and Naive
    worse than Simple."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    cfg_p = SLDAConfig(**CFG, sweeps_per_launch=8, **SPARSE)
    cfg_j = JConfig(**CFG, sweeps_per_launch=8, **SPARSE)
    port = {"naive": [], "simple": [], "weighted": []}
    for s in SEEDS:
        for name in port:
            y = ALGORITHMS[name](s, p_train, p_test, cfg_p, 4, device="cpu")
            port[name].append(float(((y - p_test.y) ** 2).mean()))
    # the reference's orchestrators run its module-level jitted phases,
    # compiled once for both algorithms
    ref_mse = {name: [float(jnp.mean((fn(jax.random.PRNGKey(s), j_train,
                                         j_test, cfg_j, 4)
                                      - j_test.y) ** 2)) for s in SEEDS]
               for name, fn in (("simple", j_simple),
                                ("weighted", j_weighted))}
    print("sparse spl=8 test MSE, port", {k: np.round(v, 4).tolist()
                                          for k, v in port.items()},
          "reference", ref_mse)
    for name in ("simple", "weighted"):
        want = np.mean(ref_mse[name])
        assert abs(np.mean(port[name]) - want) <= 0.15 * want, name
    assert np.mean(port["naive"]) > np.mean(port["simple"])


def test_sparse_fused_nonparallel_matches_reference_on_its_draws(
        corpus_pair):
    """Non-parallel with the sparse draw at spl=8 (one chain in three doc
    blocks), 3 seeds.  Its test MSE is heavy-tailed (the reference's
    seeds 7/8/9 read about 0.73, 0.26 and 0.59), so three seeds of each
    package's own random streams need not agree in their median; here
    the port runs from the reference's own draws of
    each seed (initial topics, launch seeds, prediction topics and seeds),
    and its 3-seed median is held within 15% of the reference's."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    kw = dict(CFG, sweeps_per_launch=8, **SPARSE)
    cfg_j, cfg_p = JConfig(**kw), SLDAConfig(**kw)
    n_launches = -(-kw["n_iters"] // 8)
    ref_mse, port_mse = [], []
    for s in SEEDS:
        y = j_nonparallel(jax.random.PRNGKey(s), j_train, j_test, cfg_j)
        ref_mse.append(float(jnp.mean((y - j_test.y) ** 2)))
        k_train, k_pred = jax.random.split(jax.random.PRNGKey(s))
        z, seeds = _ref_fused_draws(k_train[None], p_train.n_docs,
                                    p_train.max_len, 8, n_launches)
        _, models = build_plan(p_train, cfg_p, chained=True).train(
            _t(z), (_t(x) for x in seeds))
        z0, seeds = _ref_predict_draws(k_pred[None], p_test.n_docs,
                                       p_test.max_len, 8)
        y = build_plan(p_test, cfg_p).predict(_t(z0), _t(seeds), models)[0]
        port_mse.append(float(((y - p_test.y) ** 2).mean()))
    print(f"sparse spl=8 Non-parallel test MSE on the reference's draws: "
          f"port {np.round(port_mse, 4).tolist()}, reference "
          f"{np.round(ref_mse, 4).tolist()}")
    want = np.median(ref_mse)
    assert abs(np.median(port_mse) - want) <= 0.15 * want
