"""The port's fused training path (sweeps_per_launch > 1, kernel B3's
plain version) against the reference, on the same numpy-made inputs and
the reference's own random draws.

Float log/exp and prefix sums cannot match bit for bit across the two
frameworks, so a draw may differ where a uniform lies within rounding of
a CDF boundary: the share of real tokens whose draw differs must stay
≤ 1e-3 (it is printed).  Counts are exact.
"""
import functools

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
from repro.data import make_slda_corpus as j_make
from repro.data import train_test_split as j_split
from repro.kernels import ref as jref
from repro.kernels.slda_train import (slda_train_sweeps_chains_jnp,
                                      slda_train_sweeps_chains_pallas)
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import (ALGORITHMS, SLDAConfig,
                              counts_from_assignments, partition, types)
from repro_torch.core.plan import build_plan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.prng import predict_uniforms

MISMATCH_MAX = 1e-3
ALPHA, BETA, RHO = 0.1, 0.01, 0.5
CFG = dict(n_topics=8, vocab_size=200, n_iters=25, rho=0.25)
SEEDS = (7, 8, 9)


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


def _mismatch(z_a, z_b, mask):
    return float(((np.asarray(z_a) != np.asarray(z_b))
                  * np.asarray(mask)).sum() / np.asarray(mask).sum())


def _train_inputs(seed, m, d, t, w, n, n_sweeps):
    """Chain-batched fused-launch inputs with consistent counts, as numpy:
    tokens, mask, uniforms [M, D, S, N], seeds, z0, ndt0, y, inv_len,
    ntw_t, nt, eta."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, w, (m, d, n)).astype(np.int32)
    lens = rng.integers(n // 3, n + 1, (m, d))
    mask = (np.arange(n) < lens[..., None]).astype(np.float32)
    z = rng.integers(0, t, (m, d, n)).astype(np.int32)
    ndt, ntw, nt = (a.numpy() for a in counts_from_assignments(
        _t(tok), _t(mask), _t(z), t, w))
    y = rng.normal(size=(m, d)).astype(np.float32)
    inv_len = (1.0 / np.maximum(mask.sum(-1), 1.0)).astype(np.float32)
    u = rng.random((m, d, n_sweeps, n), dtype=np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, (m, d)).astype(np.int32)
    eta = (rng.normal(size=(m, t)) + 0.3).astype(np.float32)
    ntw_t = np.ascontiguousarray(np.swapaxes(ntw, 1, 2))
    return dict(tokens=tok, mask=mask, uniforms=u, seeds=seeds, z0=z,
                ndt0=ndt, y=y, inv_len=inv_len, ntw_t=ntw_t, nt=nt, eta=eta)


def _check_counts(a, z, ndt, t, w):
    ndt_c, _, _ = counts_from_assignments(_t(a["tokens"]), _t(a["mask"]),
                                          z, t, w)
    assert z.dtype == torch.int32 and torch.equal(ndt, ndt_c)


# ------------------------------------------- plain B3 against the reference

_ORACLE_ARGS = ("tokens", "mask", "uniforms", "z0", "ndt0", "y", "inv_len",
                "ntw_t", "nt", "eta")


@pytest.mark.parametrize("n_sweeps", [1, 3])
@pytest.mark.parametrize("product_form", [False, True])
def test_explicit_uniform_oracle_matches_reference(n_sweeps, product_form):
    """doc_block 8 does not divide D = 21: the padded block structure is
    part of the semantics on both sides."""
    a = _train_inputs(n_sweeps, 2, 21, 8, 60, 16, n_sweeps)
    args = [a[k] for k in _ORACLE_ARGS]
    z_r, ndt_r = jax.jit(lambda *x: jref.ref_slda_train_sweeps_chains(
        *x, ALPHA, BETA, RHO, True, 8, product_form=product_form))(*args)
    z_p, ndt_p = ref.ref_slda_train_sweeps_chains(
        *map(_t, args), ALPHA, BETA, RHO, True, 8,
        product_form=product_form)
    rate = _mismatch(z_r, z_p, a["mask"])
    print(f"B3 oracle vs reference, {n_sweeps} sweeps, product form "
          f"{product_form}: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    _check_counts(a, z_p, ndt_p, 8, 60)


_HASH_ARGS = ("tokens", "mask", "seeds", "z0", "ndt0", "y", "inv_len",
              "ntw_t", "nt", "eta")


def _pad(a, d_pad):
    """The reference's twins take D already padded to the doc block."""
    return {k: np.pad(v, ((0, 0), (0, d_pad - v.shape[1]))
                      + ((0, 0),) * (v.ndim - 2))
            if v.ndim >= 2 and k not in ("ntw_t", "nt", "eta") else v
            for k, v in a.items()}


@pytest.mark.parametrize("product_form", [False, True])
def test_hash_plain_matches_reference_twin(product_form):
    a = _train_inputs(3, 3, 20, 8, 50, 24, 1)
    kw = dict(alpha=ALPHA, beta=BETA, rho=RHO, n_sweeps=4, doc_block=8,
              product_form=product_form)
    ap = _pad(a, 24)
    z_r, ndt_r = jax.jit(lambda *x: slda_train_sweeps_chains_jnp(*x, **kw))(
        *(ap[k] for k in _HASH_ARGS))
    z_p, ndt_p = ref.slda_train_sweeps_chains(
        *(_t(a[k]) for k in _HASH_ARGS), **kw)
    rate = _mismatch(np.asarray(z_r)[:, :20], z_p, a["mask"])
    print(f"B3 plain vs reference twin, product form {product_form}: "
          f"draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    _check_counts(a, z_p, ndt_p, 8, 50)


def test_hash_plain_matches_interpret_kernel():
    a = _train_inputs(4, 2, 16, 8, 30, 10, 1)
    kw = dict(alpha=ALPHA, beta=BETA, rho=RHO, n_sweeps=3, doc_block=8,
              product_form=True)
    z_k, _ = slda_train_sweeps_chains_pallas(
        *(jnp.asarray(a[k]) for k in _HASH_ARGS), interpret=True, **kw)
    z_p, ndt_p = ops.slda_train_sweeps(
        *(_t(a[k]) for k in ("tokens", "mask", "z0", "ndt0", "y",
                             "inv_len")),
        _t(np.ascontiguousarray(np.swapaxes(a["ntw_t"], 1, 2))),
        *(_t(a[k]) for k in ("nt", "eta", "seeds")), **kw)
    rate = _mismatch(z_k, z_p, a["mask"])
    print(f"B3 plain vs interpret kernel: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    _check_counts(a, z_p, ndt_p, 8, 30)


def test_hash_plain_is_the_oracle_under_train_uniforms():
    a = {k: _t(v) for k, v in _train_inputs(5, 2, 13, 8, 40, 12, 1).items()}
    u = torch.stack([predict_uniforms(s, 3, 12) for s in a["seeds"]])
    z_o, ndt_o = ref.ref_slda_train_sweeps_chains(
        *(u if k == "uniforms" else a[k] for k in _ORACLE_ARGS),
        ALPHA, BETA, RHO, True, 8, product_form=True)
    z_h, ndt_h = ref.slda_train_sweeps_chains(
        *(a[k] for k in _HASH_ARGS), alpha=ALPHA, beta=BETA, rho=RHO,
        n_sweeps=3, doc_block=8, product_form=True)
    assert torch.equal(z_o, z_h) and torch.equal(ndt_o, ndt_h)


def test_one_log_form_sweep_is_one_b2_sweep():
    """At n_sweeps=1 in log form a fused launch is one seed-semantics sweep
    under the same uniforms (the reference's own contract)."""
    a = {k: _t(v) for k, v in _train_inputs(6, 3, 19, 8, 40, 14, 1).items()}
    u = torch.stack([predict_uniforms(s, 1, 14)[:, 0] for s in a["seeds"]])
    z_b2, ndt_b2 = ref.ref_slda_gibbs_sweep_chains(
        *(u if k == "uniforms" else a[k] for k in
          ("tokens", "mask", "uniforms", "z0", "ndt0", "y", "inv_len",
           "ntw_t", "nt", "eta")), ALPHA, BETA, RHO)
    z_b3, ndt_b3 = ref.slda_train_sweeps_chains(
        *(a[k] for k in _HASH_ARGS), alpha=ALPHA, beta=BETA, rho=RHO,
        n_sweeps=1, doc_block=8, product_form=False)
    assert torch.equal(z_b2, z_b3) and torch.equal(ndt_b2, ndt_b3)


# ------------------------------------------------ count deltas, compacted

@pytest.mark.parametrize("cap", [0, 5, 100_000, None])
def test_apply_count_deltas_compaction_is_the_dense_form(cap):
    """cap 0 forces the dense form, 5 overflows (dense again), a large cap
    compacts; every form equals the reference's bit for bit."""
    rng = np.random.default_rng(11)
    tok = rng.integers(0, 50, (3, 8, 20)).astype(np.int32)
    mask = (rng.random(tok.shape) < 0.7).astype(np.float32)
    z_old = rng.integers(0, 8, tok.shape).astype(np.int32)
    z_new = np.where(rng.random(tok.shape) < 0.1,
                     rng.integers(0, 8, tok.shape), z_old).astype(np.int32)
    _, ntw, nt = jax.vmap(lambda t, m, zz: jtypes.counts_from_assignments(
        t, m, zz, 8, 50))(tok, mask, z_old)
    args = (ntw, nt, tok, mask, z_old, z_new)
    want = jax.jit(jax.vmap(
        lambda *x: jtypes.apply_count_deltas(*x, cap=cap)))(*args)
    got = types.apply_count_deltas(*map(_t, args), cap=cap)
    dense = types.apply_count_deltas(*map(_t, args), cap=0)
    for g, d, w in zip(got, dense, want):
        assert torch.equal(g, d) and np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ the schedule

@pytest.mark.parametrize("spl,n_iters,n_docs", [
    (1, 30, 750), (8, 30, 750), (8, 30, 3000), (3, 7, 80), (4, 8, 5),
    (8, 4, 130)])
def test_schedule_matches_reference(spl, n_iters, n_docs):
    rng = np.random.default_rng(spl)
    arrays = (rng.integers(0, 20, (2, n_docs, 6)).astype(np.int32),
              np.ones((2, n_docs, 6), np.float32),
              rng.normal(size=(2, n_docs)).astype(np.float32))
    kw = dict(n_topics=4, vocab_size=20, n_iters=n_iters,
              sweeps_per_launch=spl)
    j_plan = j_build_plan(jtypes.Corpus(*map(jnp.asarray, arrays)),
                          JConfig(**kw))
    p_plan = build_plan(corpus_from_numpy(*arrays, device="cpu"),
                        SLDAConfig(**kw))
    assert p_plan.sweep_schedule() == j_plan.sweep_schedule()
    assert p_plan.n_boundaries() == j_plan.n_boundaries()
    assert p_plan.train_doc_block(n_docs) == j_plan.train_doc_block(n_docs)


# ------------------------------------ the EM loop under the reference's draws

def _to_port(c):
    return corpus_from_numpy(c.tokens, c.mask, c.y, device="cpu")


@pytest.fixture(scope="module")
def corpus_pair():
    """tests/test_system.py's corpus, drawn by the reference, converted."""
    make = jax.jit(j_make, static_argnums=(1, 2, 3, 4),
                   static_argnames=("rho",))
    corpus, _ = make(jax.random.PRNGKey(0), 400, 200, 8, 50, rho=0.25)
    train, test = j_split(corpus, 320)
    return (train, test), (_to_port(train), _to_port(test))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _ref_fused_draws(keys, d, n, t, n_launches):
    """The initial topics and per-launch document seeds the reference's
    `ExecutionPlan.train(keys)` draws at sweeps_per_launch > 1 (plan.py:
    init_states, train_em, _blocks_launch)."""
    ks = jax.vmap(jax.random.split)(keys)
    z = jax.vmap(lambda k: jax.random.randint(k, (d, n), 0, t, jnp.int32))(
        ks[:, 0])
    lk = jnp.moveaxis(jax.vmap(lambda k: jax.random.split(k, n_launches))(
        ks[:, 1]), 0, 1)
    return z, [jax.vmap(lambda k: jax.random.randint(
        k, (d,), 0, jnp.iinfo(jnp.int32).max, jnp.int32))(lk[i])
        for i in range(n_launches)]


def _em_against_reference(j_corpus, p_corpus, kw, keys, chained, what):
    """Train under the reference's own draws in both packages; z within
    MISMATCH_MAX, counts exact, η and φ close."""
    j_state, j_models = jax.jit(lambda k, c: j_build_plan(
        c, JConfig(**kw), chained=chained).train(k))(keys, j_corpus)
    m, d, n = j_state.z.shape
    n_launches = -(-kw["n_iters"] // kw["sweeps_per_launch"])
    z, seeds = _ref_fused_draws(keys, d, n, kw["n_topics"], n_launches)
    p_state, p_models = build_plan(p_corpus, SLDAConfig(**kw),
                                   chained=chained).train(
        _t(z), (_t(s) for s in seeds))
    tokens, mask = (p_corpus.tokens, p_corpus.mask) if not chained else (
        p_corpus.tokens[None], p_corpus.mask[None])
    rate = _mismatch(p_state.z, j_state.z, mask)
    print(f"{what} under the reference's draws: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    counts = counts_from_assignments(tokens, mask, p_state.z,
                                     kw["n_topics"], kw["vocab_size"])
    for f, c in zip(("ndt", "ntw", "nt"), counts):
        assert torch.equal(getattr(p_state, f), c)
    np.testing.assert_allclose(p_models.eta.numpy(),
                               np.asarray(j_models.eta), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_models.phi.numpy(),
                               np.asarray(j_models.phi), rtol=1e-3, atol=1e-6)


def test_fused_train_with_reference_draws_matches_reference(corpus_pair):
    """spl=3 over 7 iterations: two full launches and a remainder launch
    of one sweep; the rebuild cadence counts launches.  A doc block of 16
    gives each chain's 80 documents five blocks, each blind to the others
    within a launch."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=7, sweeps_per_launch=3, count_rebuild_every=2,
              train_doc_block=16)
    _em_against_reference(j_partition(j_train, 4), partition(p_train, 4),
                          kw, jax.random.split(jax.random.PRNGKey(6), 4),
                          False, "7 sweeps in 3 fused launches, 4 chains")


def test_fused_single_chain_with_reference_draws_matches_reference(
        corpus_pair):
    """Non-parallel's path: one chain over all 320 training documents at
    the default doc block of 128 (blocks of 128, 128 and 64), spl=8 over
    20 iterations (two launches and a remainder of four sweeps)."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=20, sweeps_per_launch=8)
    _em_against_reference(j_train, p_train, kw,
                          jax.random.PRNGKey(5)[None], True,
                          "20 sweeps in 3 fused launches, one chain")


@pytest.mark.parametrize("spl,n_iters", [(1, 3), (3, 7), (8, 16)])
def test_counts_stay_exact_without_rebuilds_and_hook_sees_each_boundary(
        corpus_pair, spl, n_iters):
    from repro_torch.core import rng
    _, (p_train, _) = corpus_pair
    cfg = SLDAConfig(**dict(CFG, n_iters=n_iters, sweeps_per_launch=spl,
                            count_rebuild_every=0))
    shards = partition(p_train, 2)
    plan = build_plan(shards, cfg)
    z, draws = rng.train_draws(rng.chain_generators(3, 2, "cpu"), 160, 50,
                               8, n_iters, spl)
    seen = []

    def hook(state, it, status):
        seen.append(it)
        return state, status + 1

    state, status = plan.train_em(plan.init_states(z), draws, em_hook=hook,
                                  status0=0)
    assert seen == list(range(plan.n_boundaries())) and status == len(seen)
    counts = counts_from_assignments(shards.tokens, shards.mask,
                                     plan.corpus.merge_padded(state.z, z), 8,
                                     200)
    for f, c in zip(("ndt", "ntw", "nt"), counts):
        assert torch.equal(getattr(state, f), c)
    assert float(state.ntw.min()) >= 0.0


# ------------------------------------------ the paper's algorithms at spl=8

@pytest.fixture(scope="module")
def fused_mses(corpus_pair):
    """3-seed test MSEs at sweeps_per_launch=8: every algorithm of the
    port, and the reference's non-parallel, simple and weighted runs."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    cfg_p = SLDAConfig(**CFG, sweeps_per_launch=8)
    cfg_j = JConfig(**CFG, sweeps_per_launch=8)
    port = {name: [] for name in ALGORITHMS}
    for s in SEEDS:
        for name, fn in ALGORITHMS.items():
            args = (s, p_train, p_test, cfg_p) + (
                () if name == "nonparallel" else (4,))
            y = fn(*args, device="cpu")
            port[name].append(float(((y - p_test.y) ** 2).mean()))
    ref_mse = {"nonparallel": [], "simple": [], "weighted": []}
    for name, fn in (("nonparallel", j_nonparallel), ("simple", j_simple),
                     ("weighted", j_weighted)):
        m = () if name == "nonparallel" else (4,)
        jfn = jax.jit(fn, static_argnums=(3,) + (4,) * len(m))
        for s in SEEDS:
            y = jfn(jax.random.PRNGKey(s), j_train, j_test, cfg_j, *m)
            ref_mse[name].append(float(jnp.mean((y - j_test.y) ** 2)))
    print({k: np.round(v, 4).tolist() for k, v in port.items()}, ref_mse)
    return port, ref_mse


@pytest.mark.parametrize("name", ["simple", "weighted"])
def test_fused_mse_within_15_percent_of_reference(fused_mses, name):
    port, ref_mse = (np.mean(m[name]) for m in fused_mses)
    assert abs(port - ref_mse) <= 0.15 * ref_mse


def test_fused_nonparallel_median_within_15_percent_of_reference(fused_mses):
    """One chain in several doc blocks at spl=8 has a heavy-tailed test
    MSE in both packages: a few seeds land twice as high as the rest or
    more.  Its draws match the reference's draw for draw (the
    single-chain test above), so the median over the seeds is held here,
    where a mean would follow the tail."""
    port, ref_mse = (np.median(m["nonparallel"]) for m in fused_mses)
    assert abs(port - ref_mse) <= 0.15 * ref_mse


def test_fused_naive_combination_is_worse(fused_mses):
    port = {k: np.mean(v) for k, v in fused_mses[0].items()}
    assert port["naive"] > port["simple"]
    assert port["naive"] > port["weighted"]



# ----------------------------- one sweep of a fused launch from its state

_HASH_ARGS = ("tokens", "mask", "seeds", "z0", "ndt0", "y", "inv_len",
              "ntw_t", "nt", "eta")


def test_block_tables_are_the_launch_start_plus_each_blocks_moves():
    """The state a sweep of a fused launch starts from: each doc block's
    table is its chain's launch-start table plus the counts of the block's
    tokens under z less those under z0 (the last block short), and its
    nt the column sums of the same."""
    t, w, db = 6, 30, 4
    a = _train_inputs(3, 2, 10, t, w, 12, 1)
    rng = np.random.default_rng(4)
    z = np.where(rng.random(a["z0"].shape) < 0.4,
                 rng.integers(0, t, a["z0"].shape), a["z0"]).astype(np.int32)
    table, nt_b = ref.block_tables(_t(a["tokens"]), _t(a["mask"]),
                                   _t(a["z0"]), _t(z), _t(a["ntw_t"]),
                                   _t(a["nt"]), db)
    assert table.shape == (2, 3, w, t) and nt_b.shape == (2, 3, t)
    for b in range(3):
        docs = slice(b * db, (b + 1) * db)
        blk = lambda x: _t(x[:, docs])                    # noqa: E731
        _, ntw_new, nt_new = counts_from_assignments(
            blk(a["tokens"]), blk(a["mask"]), blk(z), t, w)
        _, ntw_old, nt_old = counts_from_assignments(
            blk(a["tokens"]), blk(a["mask"]), blk(a["z0"]), t, w)
        want = _t(a["ntw_t"]) + (ntw_new - ntw_old).transpose(1, 2)
        assert torch.equal(table[:, b], want)
        assert torch.equal(nt_b[:, b], _t(a["nt"]) + nt_new - nt_old)
    same = ref.block_tables(_t(a["tokens"]), _t(a["mask"]), _t(a["z0"]),
                            _t(a["z0"]), _t(a["ntw_t"]), _t(a["nt"]), db)
    assert torch.equal(same[0], _t(a["ntw_t"])[:, None].expand_as(table))


@pytest.mark.parametrize("sparse_draw", [False, True])
@pytest.mark.parametrize("product_form", [False, True])
def test_one_sweep_from_a_launch_state_is_that_sweep(product_form,
                                                     sparse_draw):
    """Sweep k of a fused launch, handed the state after sweeps 1..k-1
    (z, ndt, the launch-start tables and the block tables they imply) and
    sweep k's uniforms, draws what the launch of k sweeps draws, bit for
    bit: the state `chip_smoke.py` hands the plain version to hold the
    kernel sweep by sweep (D = 10 is not a multiple of the doc block)."""
    t, w, db, n_sweeps = 8, 40, 4, 4
    a = {k: _t(v) for k, v in _train_inputs(11, 2, 10, t, w, 12, 1).items()}
    index = types.topic_occupancy_index(a["ntw_t"], 3) if sparse_draw \
        else None
    kw = dict(alpha=ALPHA, beta=BETA, rho=RHO, doc_block=db,
              supervised=True, product_form=product_form, topic_index=index)
    args = [a[k] for k in _HASH_ARGS]
    z, ndt = a["z0"], a["ndt0"]
    for k in range(1, n_sweeps + 1):
        want = ref.slda_train_sweeps_chains(*args, n_sweeps=k, **kw)
        got = ref.slda_train_sweep_from(
            a["tokens"], a["mask"], a["seeds"], a["z0"], z, ndt, a["y"],
            a["inv_len"], a["ntw_t"], a["nt"], a["eta"], sweep=k - 1, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        z, ndt = want
    assert not torch.equal(z, a["z0"])


# ------------------------------------------ kernel B3's slot assignment

@pytest.mark.parametrize("D,doc_block,T", [
    (750, 128, 16),            # the MD&A slice: 5 full blocks and 110
    (256, 128, 128),           # T = 128: a warp a document
    (300, 128, 16),            # a short last block of 44
    (40, 40, 16),              # D below the configured doc block
    (40, 128, 16),             # ... and the block wider than D
    (750, 128, 256),           # T = 256: 16 warps a CTA
    (750, 128, 17),            # T just past a half-warp
    (1000, 512, 16),           # a block wider than a cluster's groups
    (256, 128, 512),           # T = 512: 8 warps a CTA
])
def test_slot_plan_takes_each_document_once_in_its_block(D, doc_block, T):
    """Every document of a chain is walked by exactly one group of lanes,
    in a CTA of its own block's cluster; clusters have at most 8 CTAs;
    two documents a warp at T <= 16, for the dense and the sparse draw;
    16 warps a CTA up to T = 256, 8 above; and no group walks more
    documents than the block's width needs."""
    from repro_torch.kernels import slda_train
    cluster, slots = slda_train.slot_plan(D, doc_block, T)
    groups = 2 if T <= 16 else 1
    warps = slda_train.WARPS if T <= 256 else slda_train.WARPS // 2
    assert slda_train.cta_warps(T) == warps
    n_blocks = -(-D // doc_block)
    width = min(doc_block, D)
    assert 1 <= cluster <= slda_train.MAX_CLUSTER
    assert tuple(slots.shape[:4]) == (n_blocks, cluster, warps, groups)
    assert slots.dtype == torch.int32
    per_slot = slots.shape[4]
    assert per_slot == -(-width // (cluster * warps * groups))
    if width <= slda_train.MAX_CLUSTER * warps * groups:
        assert per_slot == 1               # one document a group
    taken = slots[slots >= 0]
    assert sorted(taken.tolist()) == list(range(D))
    for b in range(n_blocks):
        docs = slots[b][slots[b] >= 0]
        assert ((docs // doc_block) == b).all()


def test_slot_plan_fills_first_groups_first():
    """A short block gives every CTA's warps their first document before
    any second group starts, so the walks stay one document long."""
    from repro_torch.kernels import slda_train
    cluster, slots = slda_train.slot_plan(300, 128, 16)
    last = slots[-1]                       # 44 documents over 4 CTAs
    assert int((last[..., 0, :] >= 0).sum()) == 44
    assert int((last[..., 1, :] >= 0).sum()) == 0


@pytest.mark.parametrize("variant", ["cluster", "block"])
@pytest.mark.parametrize("D,doc_block,T", [
    (750, 128, 16),            # the MD&A slice
    (256, 128, 128),           # T = 128: 16 warps a block CTA
    (300, 128, 16),            # a short last block
    (40, 128, 16),             # the block wider than D
    (750, 128, 512),           # T = 512: 8 warps a CTA
])
def test_walks_take_each_document_once_in_its_block(variant, D, doc_block,
                                                    T):
    """Each variant's walks hold every document of a chain once, each walk
    inside one doc block; the cluster variant's are its slot plan's."""
    from repro_torch.kernels import slda_train
    walks = slda_train.walks(D, doc_block, T, variant)
    assert walks.dtype == torch.int64 and walks.dim() == 2
    assert sorted(walks[walks >= 0].tolist()) == list(range(D))
    for walk in walks:
        docs = walk[walk >= 0]
        assert (docs // doc_block == docs[:1] // doc_block).all()
    if variant == "cluster":
        _, slots = slda_train.slot_plan(D, doc_block, T)
        assert torch.equal(walks, slots.reshape(-1, slots.shape[-1]).long())


def test_block_walks_follow_the_launchers_warps():
    """The block variant's warp w walks w, w + warps, ... of its block,
    with 32 warps a CTA up to T = 64, 16 up to T = 256 and 8 past it; the
    slice's longest walk is 4 documents there and 1 on the cluster
    variant."""
    from repro_torch.kernels import slda_train
    walks = slda_train.walks(750, 128, 16, "block")
    assert walks.shape == (6 * 32, 4)
    assert walks[3].tolist() == [3, 35, 67, 99]
    assert walks[32 + 1].tolist() == [129, 161, 193, 225]
    assert slda_train.walks(256, 128, 65, "block").shape == (2 * 16, 8)
    assert slda_train.walks(256, 128, 257, "block").shape == (2 * 8, 16)
    cluster = slda_train.walks(750, 128, 16, "cluster")
    assert int((cluster >= 0).sum(-1).max()) == 1
    with pytest.raises(ValueError, match="no warp variant"):
        slda_train.walks(750, 128, 16, "warp")
