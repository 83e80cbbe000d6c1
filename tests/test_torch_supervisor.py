"""The port's supervisor (`repro_torch.core.supervisor`) and fault
injection (`repro_torch.testing`) against the reference's, on the chaos
scenarios of the reference's `tests/test_faults.py`.

Each scenario runs the reference's `ChainSupervisor` and the port's on
the same corpus, fault plan and random draws (the port's supervisor
takes the reference's per-round draws through `SupervisorDraws`, built
as the reference folds its keys: restart epoch, then round).  The
status bits, alive masks, restart counts and event actions must be
equal; the surviving chains' topics may differ only where a uniform lies
within rounding of a CDF boundary (at most 1e-3 of real tokens, the rate
printed).  Within the port, a quarantine is exact: the survivors'
predictions are bit-equal to a clean run's, and the combined prediction
is the clean run's chains combined under the faulty run's alive mask.
A run split into rounds (`train_em(it_offset=...)`) is the unsplit run,
bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.supervisor as jsup
import repro.testing as jtesting
from repro.core import SLDAConfig as JConfig
from repro.core.plan import build_schedule as j_build_schedule
from repro.core.types import GibbsState as JGibbsState
from repro.core.types import partition as j_partition
from repro.data import make_slda_corpus as j_make
from repro.data import train_test_split as j_split
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import (ChainSupervisor, EnsembleHealthError,
                              HealthConfig, RecoveryPolicy, SLDAConfig,
                              SupervisorDraws, combine, partition, rng,
                              supervised_run_average)
from repro_torch.core.plan import build_plan
from repro_torch.core.supervisor import (F_KILLED, F_MSE_OUTLIER, F_NAN_ETA,
                                         F_NDT_SUM, F_NTW_NEG, F_STRAGGLER,
                                         describe_status)
from repro_torch.core.types import GibbsState
from repro_torch.testing import (inject, no_faults, poison,
                                 random_fault_plan, truncate_chain_file)

M = 4
CFG = dict(n_topics=4, vocab_size=32, n_iters=5, n_pred_burnin=2,
           n_pred_samples=2)
NO_RESTART = dict(max_restarts=0, min_alive_frac=0.0)
KEY = 3                                     # the reference's PRNGKey(3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """The reference chaos suite's corpus, drawn by the reference."""
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    j_train, j_test = j_split(c, 32)
    to = lambda x: corpus_from_numpy(x.tokens, x.mask, x.y, device="cpu")
    return (j_train, j_test), (to(j_train), to(j_test))


def _t(x):
    return torch.from_numpy(np.array(x))


def reference_draws(key, m, d, s, cfg: SLDAConfig) -> SupervisorDraws:
    """The draws of the reference's `supervised_run_average(key, ...)`
    (its `ChainSupervisor.train(split(split(key)[0], m))`): init from
    split(keys)[:, 0]; round r of a chain at restart epoch e from
    fold_in(fold_in(base, e), r), split a boundary as `train_em` splits
    it; a fresh init from fold_in(base, 0x5EED + e)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(key))
    ks = jax.vmap(jax.random.split)(jax.random.split(k1, m))
    base, t = ks[:, 1], cfg.n_topics
    randint = jax.jit(jax.vmap(lambda k: jax.random.randint(
        k, (d, s), 0, t, jnp.int32)))

    def round_draws(r, epoch, n_iters):
        keys = jax.vmap(lambda k, e: jax.random.fold_in(
            jax.random.fold_in(k, e), r))(base, jnp.asarray(epoch))
        spl = cfg.sweeps_per_launch
        n_b = n_iters if spl <= 1 else -(-n_iters // spl)
        sk = jnp.moveaxis(jax.vmap(lambda k: jax.random.split(k, n_b))(
            keys), 0, 1)
        if spl <= 1:
            draw = jax.vmap(lambda k: jax.random.uniform(k, (d, s)))
        else:
            draw = jax.vmap(lambda k: jax.random.randint(
                k, (d,), 0, jnp.iinfo(jnp.int32).max, jnp.int32))
        return [_t(draw(sk[i])) for i in range(n_b)]

    def fresh(epoch):
        return _t(randint(jax.vmap(lambda k, e: jax.random.fold_in(
            k, 0x5EED + e))(base, jnp.asarray(epoch))))

    return SupervisorDraws(z_init=_t(randint(ks[:, 0])), round=round_draws,
                           fresh=fresh)


def _run_both(corpus, tmp_path=None, *, fault=None, j_fault_hook=None,
              p_fault_hook=None, health=None, recovery=None,
              round_iters=None, sabotage=False, **cfg_kw):
    """The reference's and the port's supervisor on the same inputs:
    (j_state, j_report), (p_state, p_report), shards mask [M, d, s]."""
    (j_train, _), (p_train, _) = corpus
    kw = dict(CFG, **cfg_kw)
    jcfg, pcfg = JConfig(**kw), SLDAConfig(**kw)
    if fault is not None:
        j_fault_hook = jtesting.poison(M, *fault).hook()
        p_fault_hook = poison(M, *fault, device="cpu").hook()
    out = []
    for side in ("j", "p"):
        extra = {}
        if tmp_path is not None:
            extra = dict(ckpt_dir=str(tmp_path / side),
                         round_iters=round_iters)
        elif round_iters is not None:
            extra = dict(round_iters=round_iters)
        if side == "j":
            sup = jsup.ChainSupervisor(
                j_build_schedule(j_partition(j_train, M), jcfg), jcfg,
                health=None if health is None else jsup.HealthConfig(
                    **health),
                recovery=None if recovery is None else jsup.RecoveryPolicy(
                    **recovery),
                fault_hook=j_fault_hook, **extra)
        else:
            sup = ChainSupervisor(
                partition(p_train, M), pcfg,
                health=None if health is None else HealthConfig(**health),
                recovery=None if recovery is None else RecoveryPolicy(
                    **recovery),
                fault_hook=p_fault_hook, **extra)
        if sabotage:
            orig, d = sup._manager.maybe_save, extra["ckpt_dir"]
            tear = (jtesting.truncate_chain_file if side == "j"
                    else truncate_chain_file)

            def torn(step, state, extra=None, orig=orig, d=d, tear=tear):
                path = orig(step, state, extra)
                if path is not None:    # tear chain 2's file in every save
                    tear(d, step, 2)
                return path
            sup._manager.maybe_save = torn
        if side == "j":
            k1, _ = jax.random.split(jax.random.PRNGKey(KEY))
            state, _, rep = sup.train(jax.random.split(k1, M))
        else:
            d, s = p_train.n_docs // M, p_train.max_len
            state, _, rep = sup.train(
                draws=reference_draws(KEY, M, d, s, pcfg))
        out.append((state, rep))
    mask = np.asarray(j_partition(j_train, M).mask)
    return out[0], out[1], mask


def _actions(rep):
    return [[e["action"] for e in h["events"]] for h in rep.history]


def _assert_same(j, p, mask):
    """Equal reports; the alive chains' topics within the draw bound."""
    (j_state, j_rep), (p_state, p_rep) = j, p
    assert list(p_rep.alive) == list(j_rep.alive)
    np.testing.assert_array_equal(p_rep.status, np.asarray(j_rep.status))
    np.testing.assert_array_equal(p_rep.restarts, j_rep.restarts)
    assert [h["status"] for h in p_rep.history] == \
        [h["status"] for h in j_rep.history]
    assert _actions(p_rep) == _actions(j_rep)
    alive = np.asarray(p_rep.alive)
    real = mask[alive]
    diff = (p_state.z.numpy() != np.asarray(j_state.z))[alive] * real
    rate = float(diff.sum() / real.sum())
    print(f"surviving chains' draw mismatch against the reference: "
          f"{rate:.2e}")
    assert rate <= 1e-3


@functools.lru_cache(maxsize=None)
def _port_run(fault=None, rule="simple", recovery=None):
    """`supervised_run_average` within the port (seed 3), cached."""
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    train, test = (corpus_from_numpy(x.tokens, x.mask, x.y, device="cpu")
                   for x in j_split(c, 32))
    kw = {}
    if fault is not None:
        kw["fault_hook"] = poison(M, *fault, device="cpu").hook()
    if recovery is not None:
        kw["recovery"] = RecoveryPolicy(**dict(recovery))
    return supervised_run_average(KEY, train, test, SLDAConfig(**CFG), M,
                                  rule=rule, device="cpu", **kw)


def test_clean_run_all_alive_status_zero(corpus):
    j, p, mask = _run_both(corpus)
    _assert_same(j, p, mask)
    rep = p[1]
    assert rep.alive.all() and (rep.status == 0).all()
    assert rep.restarts.sum() == 0
    yhat, _ = _port_run()
    assert torch.isfinite(yhat).all()


@pytest.mark.parametrize("rule", ["simple", "weighted"])
def test_nan_poison_quarantined_and_drop_is_exact(corpus, rule):
    """A NaN-poisoned chain is flagged in the round it fires and
    quarantined; the survivors' predictions are bit-equal to the clean
    run's, and ŷ is the clean chains combined under the faulty mask."""
    if rule == "simple":
        j, p, mask = _run_both(corpus, fault=(1, 2, "nan"),
                               recovery=NO_RESTART)
        _assert_same(j, p, mask)
    y_clean, rep_clean = _port_run(rule=rule)
    y_bad, rep_bad = _port_run((1, 2, "nan"), rule,
                               tuple(NO_RESTART.items()))
    assert list(rep_bad.alive) == [True, False, True, True]
    assert rep_bad.status[1] & F_NAN_ETA
    for c in (0, 2, 3):
        np.testing.assert_array_equal(rep_bad.yhat_chains[c],
                                      rep_clean.yhat_chains[c])
    alive = rep_bad.alive_mask("cpu")
    if rule == "simple":
        want = combine.simple_average(_t(rep_clean.yhat_chains),
                                      alive=alive)
    else:
        from repro_torch.core.parallel import _combine_weighted
        train = _port_train()
        want = _combine_weighted(_t(rep_clean.yhat_chains),
                                 _t(rep_clean.yhat_train_chains), train.y,
                                 SLDAConfig(**CFG), alive)
    assert torch.equal(y_bad, want) and torch.isfinite(y_bad).all()


@functools.lru_cache(maxsize=None)
def _port_train():
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    tr, _ = j_split(c, 32)
    return corpus_from_numpy(tr.tokens, tr.mask, tr.y, device="cpu")


def test_kill_restarts_from_checkpoint_and_completes(corpus, tmp_path):
    j, p, mask = _run_both(corpus, tmp_path, fault=(2, 1, "kill"),
                           round_iters=2)
    _assert_same(j, p, mask)
    rep = p[1]
    assert rep.alive.all() and list(rep.restarts) == [0, 0, 1, 0]
    assert rep.status[2] & F_KILLED
    assert any(a.startswith("restart_from_step_")
               for acts in _actions(rep) for a in acts)


def test_persistent_poison_exhausts_budget_then_quarantines(corpus,
                                                            tmp_path):
    j, p, mask = _run_both(corpus, tmp_path, fault=(0, 0, "nan"),
                           round_iters=2,
                           recovery=dict(max_restarts=1, min_alive_frac=0.0))
    _assert_same(j, p, mask)
    rep = p[1]
    assert list(rep.alive) == [False, True, True, True]
    assert rep.restarts[0] == 1
    acts = [a for acts in _actions(rep) for a in acts]
    assert any(a.startswith("restart_") for a in acts)
    assert "quarantine" in acts


@pytest.mark.parametrize("spl", [1, 2])
def test_corrupt_counts_detected_by_invariant_probes(corpus, spl):
    """Finite but wrong counts (η stays finite) are caught by the count
    invariants alone; at spl 2 the product form draws from a negative
    weight, and the draw stays in range."""
    j, p, mask = _run_both(corpus, fault=(3, 1, "corrupt"),
                           recovery=NO_RESTART, sweeps_per_launch=spl)
    _assert_same(j, p, mask)
    rep = p[1]
    assert not rep.alive[3] and rep.alive[[0, 1, 2]].all()
    assert rep.status[3] & F_NDT_SUM and rep.status[3] & F_NTW_NEG
    assert set(describe_status(int(rep.status[3]))) >= {"ndt_sum",
                                                        "ntw_neg"}
    assert int(p[0].z.max()) < CFG["n_topics"]


def test_straggler_is_flag_only(corpus):
    j, p, mask = _run_both(corpus, fault=(1, 1, "straggle"))
    _assert_same(j, p, mask)
    y_clean, _ = _port_run()
    y_strag, rep = _port_run((1, 1, "straggle"))
    assert rep.alive.all() and rep.status[1] & F_STRAGGLER
    assert torch.equal(y_strag, y_clean)


def test_truncated_checkpoint_isolated_to_fresh_init(corpus, tmp_path):
    j, p, mask = _run_both(corpus, tmp_path, fault=(2, 1, "kill"),
                           round_iters=2, sabotage=True)
    _assert_same(j, p, mask)
    rep = p[1]
    assert rep.alive.all()
    acts = [a for acts in _actions(rep) for a in acts]
    assert "checkpoint_corrupt" in acts and "restart_fresh_init" in acts
    assert torch.isfinite(p[0].eta).all()


def test_min_alive_frac_aborts_the_run(corpus):
    """Both supervisors raise once the alive fraction falls below the
    policy's floor (the reference's run first: it raises first)."""
    with pytest.raises(jsup.EnsembleHealthError, match="alive"):
        _run_both(corpus, fault=(0, 1, "nan"),
                  recovery=dict(max_restarts=0, min_alive_frac=0.9))
    p_train = corpus[1][0]
    sup = ChainSupervisor(partition(p_train, M), SLDAConfig(**CFG),
                          recovery=RecoveryPolicy(max_restarts=0,
                                                  min_alive_frac=0.9),
                          fault_hook=poison(M, 0, 1, "nan",
                                            device="cpu").hook())
    with pytest.raises(EnsembleHealthError, match="alive"):
        sup.train(KEY)


def test_mse_outlier_soft_quarantine(corpus):
    """A finite but diverged chain (η set to 1e4 from boundary 1) trips
    only the statistical probe and is quarantined without a restart."""
    def j_diverge(state, it):
        eta = state.eta.at[1].set(jnp.where(it >= 1, 1e4, state.eta[1][0]))
        return JGibbsState(z=state.z, ndt=state.ndt, ntw=state.ntw,
                           nt=state.nt, eta=eta), jnp.zeros((M,), jnp.uint32)

    def p_diverge(state, it):
        eta = state.eta.clone()
        eta[1] = 1e4 if it >= 1 else state.eta[1, 0]
        return dataclasses.replace(state, eta=eta), torch.zeros(
            M, dtype=torch.int32)

    j, p, mask = _run_both(corpus, j_fault_hook=j_diverge,
                           p_fault_hook=p_diverge,
                           health=dict(mse_warmup=0),
                           recovery=dict(max_restarts=2, min_alive_frac=0.0))
    _assert_same(j, p, mask)
    rep = p[1]
    assert not rep.alive[1] and rep.status[1] & F_MSE_OUTLIER
    assert rep.restarts[1] == 0


def test_fault_plan_is_seed_deterministic():
    a = random_fault_plan(11, 8, 10, device="cpu")
    b = random_fault_plan(11, 8, 10, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = random_fault_plan(12, 8, 10, device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == torch.int32 and x.shape == (8,) for x in a)


@pytest.mark.parametrize("kind", [None, "nan", "corrupt", "kill",
                                  "straggle"])
def test_inject_matches_reference_and_is_a_no_op_when_unarmed(corpus, kind):
    """`inject` at boundaries before, at and after the trigger gives the
    reference's state and bits; with no fault armed it changes nothing."""
    (j_train, _), (p_train, _) = corpus
    cfg = SLDAConfig(**CFG)
    plan = build_plan(partition(p_train, M), cfg)
    z0 = reference_draws(5, M, 8, 8, cfg).z_init
    state = plan.init_states(z0)
    j_state = JGibbsState(z=tuple(jnp.asarray(z.numpy()) for z in state.z),
                          ndt=jnp.asarray(state.ndt.numpy()),
                          ntw=jnp.asarray(state.ntw.numpy()),
                          nt=jnp.asarray(state.nt.numpy()),
                          eta=jnp.asarray(state.eta.numpy()))
    fp = no_faults(M, device="cpu") if kind is None else poison(
        M, 2, 3, kind, device="cpu")
    jfp = jtesting.no_faults(M) if kind is None else jtesting.poison(
        M, 2, 3, kind)
    for it in (2, 3, 4):
        got, bits = inject(state, it, fp)
        want, j_bits = jax.jit(jtesting.inject)(j_state, jnp.int32(it), jfp)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
        for f in ("ndt", "ntw", "nt", "eta"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        if kind is None:
            assert (bits == 0).all()
            assert all(torch.equal(getattr(got, f), getattr(state, f))
                       for f in ("ndt", "ntw", "nt", "eta"))


def test_train_em_hook_is_transparent(corpus):
    """A probe that finds nothing leaves every bit of the run as it is."""
    p_train = corpus[1][0]
    cfg = SLDAConfig(**CFG)
    plan = build_plan(partition(p_train, M), cfg)
    d = reference_draws(5, M, 8, 8, cfg)
    plain = plan.train_em(plan.init_states(d.z_init),
                          d.round(0, np.zeros(M, np.int32), 5))
    sup = ChainSupervisor(partition(p_train, M), cfg)
    hooked, status = plan.train_em(
        plan.init_states(d.z_init), d.round(0, np.zeros(M, np.int32), 5),
        em_hook=sup.hook(plan, torch.ones(M)),
        status0=torch.zeros(M, dtype=torch.int32))
    assert (status == 0).all()
    for f in ("ndt", "ntw", "nt", "eta"):
        assert torch.equal(getattr(plain, f), getattr(hooked, f))
    assert all(torch.equal(a, b) for a, b in zip(plain.z, hooked.z))


@pytest.mark.parametrize("spl,n_iters,rounds", [(1, 7, (3, 3, 1)),
                                                (2, 8, (4, 4)),
                                                (2, 7, (4, 3))])
def test_rounds_with_it_offset_equal_the_unsplit_run(corpus, spl, n_iters,
                                                     rounds):
    """Under the same draws, `train_em` round by round with `it_offset`
    is the one run bit for bit: the hook sees the same boundaries, and
    the exact rebuilds (every 3 boundaries) fall on the same ones."""
    p_train = corpus[1][0]
    cfg = SLDAConfig(**dict(CFG, n_iters=n_iters, sweeps_per_launch=spl,
                            count_rebuild_every=3))
    shards = partition(p_train, M)
    gens = rng.chain_generators(9, M, "cpu")
    z0, draws = rng.train_draws(gens, 8, 8, 4, n_iters, spl)
    draws = list(draws)
    seen, seen_split = [], []

    def hook(log):
        def em_hook(state, it, status):
            log.append(it)
            return state, status
        return em_hook

    plan = build_plan(shards, cfg)
    whole, _ = plan.train_em(plan.init_states(z0), draws,
                             em_hook=hook(seen), status0=0)
    state, off = plan.init_states(z0), 0
    for r in rounds:
        rp = build_plan(shards, dataclasses.replace(cfg, n_iters=r))
        nb = rp.n_boundaries()
        state, _ = rp.train_em(state, draws[off:off + nb],
                               em_hook=hook(seen_split), status0=0,
                               it_offset=off)
        off += nb
    assert seen_split == seen == list(range(len(draws)))
    for f in ("ndt", "ntw", "nt", "eta"):
        assert torch.equal(getattr(whole, f), getattr(state, f))
    assert all(torch.equal(a, b) for a, b in zip(whole.z, state.z))
    assert isinstance(state, GibbsState)
