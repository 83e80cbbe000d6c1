"""The port's elastic runner (`repro_torch.launch.elastic`) against the
reference's `tests/test_elastic.py`, and against the reference's runner.

Every test of the reference's file runs here on the port, bitwise claims
included: survivors of a device loss equal the same lanes of an
undisturbed run; restored victims, after catch-up, equal the undisturbed
run; resume after preemption equals it; asynchronous and synchronous
checkpoints give the same bits; a repack builds no round plan (the
reference's "never retraces": `round_plans` counts the plans built).

Then the port's runner and the reference's run the same scenarios under
the reference's draws (`test_torch_supervisor.reference_draws` with the
elastic runner's fold_in(root, chain) keys and per-chain rounds): the
reports agree, z and the counts are equal, η within 1e-3.  The elastic
event lists are the reference's for the same seeds, and a supervised
run's draws are unchanged by the per-chain rounds.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.elastic as jel
import repro.testing as jtesting
from repro.core import SLDAConfig as JConfig
from repro.core.plan import build_schedule as j_build_schedule
from repro.core.types import partition as j_partition
from repro.data import make_slda_corpus as j_make
from repro.data import train_test_split as j_split
from repro_torch.checkpoint import (latest_step, read_manifest,
                                    restore_checkpoint, sweep_stale)
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import SLDAConfig, build_schedule, partition, rng
from repro_torch.core.supervisor import (F_KILLED, F_STRAGGLER,
                                         ChainSupervisor, seeded_draws)
from repro_torch.launch.elastic import (DevicePool, ElasticConfig,
                                        ElasticRunner, PreemptionSignal,
                                        compute_placement,
                                        elastic_run_average)
from repro_torch.testing import (ElasticEvent, VirtualClock,
                                 random_elastic_events)

from test_torch_supervisor import reference_draws

M = 4
EL = ElasticConfig(round_iters=2)       # 6 iterations: R = 3 rounds
SEED = 7
CFG = dict(n_topics=4, vocab_size=32, n_iters=6, n_pred_burnin=2,
           n_pred_samples=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_corpus():
    """The reference elastic suite's corpus, drawn by the reference."""
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    return j_split(c, 32)


@pytest.fixture(scope="module")
def corpus(ref_corpus):
    return tuple(corpus_from_numpy(x.tokens, x.mask, x.y, device="cpu")
                 for x in ref_corpus)


@pytest.fixture(scope="module")
def cfg():
    return SLDAConfig(**CFG)


@pytest.fixture(scope="module")
def shards(corpus, cfg):
    return build_schedule(partition(corpus[0], M), cfg)


@pytest.fixture(scope="module")
def undisturbed(shards, cfg):
    """No events, no checkpoints: what every scenario must equal bit for
    bit (or lane for lane)."""
    state, models, rep = ElasticRunner(shards, cfg, devices=2,
                                       elastic=EL).train(SEED)
    assert rep.alive.all() and (rep.progress == rep.logical_rounds).all()
    return state, models, rep


def leaves_equal(a, b, idx=None):
    for f in ("z", "ndt", "ntw", "nt", "eta"):
        x, y = getattr(a, f), getattr(b, f)
        if idx is not None:
            x, y = x[idx], y[idx]
        if not torch.equal(x, y):
            return False
    return True


# --------------------------------------------- placement and membership

def test_compute_placement_balanced_and_deterministic():
    p = compute_placement(range(7), ["a", "b", "c"])
    assert p == {"a": (0, 1, 2), "b": (3, 4), "c": (5, 6)}
    assert p == compute_placement([6, 5, 4, 3, 2, 1, 0], ["a", "b", "c"])
    sizes = [len(v) for v in p.values()]
    assert max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        compute_placement([0, 1], [])
    for n, k in ((7, 3), (4, 2), (5, 4), (1, 3)):
        assert compute_placement(range(n), range(k)) == \
            jel.compute_placement(range(n), range(k))


def test_device_pool_membership_and_epoch():
    pool = DevicePool(3)
    assert pool.ids == (0, 1, 2) and pool.epoch == 0
    assert pool.lose(1) and pool.ids == (0, 2) and pool.epoch == 1
    assert not pool.lose(1)
    assert pool.join(5) and pool.ids == (0, 2, 5) and pool.epoch == 2
    assert not pool.join(5)
    pool.lose(0), pool.lose(2)
    with pytest.raises(RuntimeError, match="last pool member"):
        pool.lose(5)


def test_preemption_signal_latches_sigterm():
    sig = PreemptionSignal().install()
    try:
        assert not sig.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert sig.triggered
        sig.clear()
        assert not sig.triggered
    finally:
        sig.uninstall()


# ----------------------------------------------------------- determinism

def test_clean_run_is_deterministic_and_builds_one_round_plan(
        shards, cfg, undisturbed):
    state0, _, _ = undisturbed
    state, _, rep = ElasticRunner(shards, cfg, devices=2,
                                  elastic=EL).train(SEED)
    assert leaves_equal(state, state0)
    assert rep.round_plans == 1
    assert rep.wall_rounds == rep.logical_rounds == 3
    assert all(h["round_ms"] > 0 for h in rep.history)


def test_placement_is_bitwise_irrelevant(shards, cfg, undisturbed):
    state0, _, _ = undisturbed
    for ndev in (1, 4):
        state, _, _ = ElasticRunner(shards, cfg, devices=ndev,
                                    elastic=EL).train(SEED)
        assert leaves_equal(state, state0), f"devices={ndev} changed bits"


def test_undisturbed_run_is_the_supervised_run(shards, cfg, undisturbed):
    """Per-chain rounds that all agree draw what one round for all draws:
    the elastic run is the supervisor's run in rounds of the same size."""
    state0, _, _ = undisturbed
    state, _, rep = ChainSupervisor(shards, cfg,
                                    round_iters=EL.round_iters).train(SEED)
    assert rep.alive.all() and leaves_equal(state, state0)


# ------------------------------------------------------------ device loss

def test_device_loss_without_ckpt_quarantines_exactly(shards, cfg,
                                                      undisturbed):
    state0, _, _ = undisturbed
    ev = [ElasticEvent("device_loss", at_round=2, device=1)]
    state, _, rep = ElasticRunner(shards, cfg, devices=2, elastic=EL,
                                  events=ev).train(SEED)
    victims = np.nonzero(~rep.alive)[0]
    assert list(victims) == [2, 3]
    assert all(rep.status[v] & F_KILLED for v in victims)
    survivors = np.nonzero(rep.alive)[0]
    assert leaves_equal(state, state0, idx=survivors)
    assert rep.round_plans == 1


def test_device_loss_at_boundary_restores_with_zero_rewind(
        shards, cfg, tmp_path, undisturbed):
    state0, _, _ = undisturbed
    ev = [ElasticEvent("device_loss", at_round=2, device=1)]
    state, _, rep = ElasticRunner(shards, cfg, devices=2, elastic=EL,
                                  events=ev,
                                  ckpt_dir=str(tmp_path)).train(SEED)
    assert rep.alive.all()
    assert (rep.progress == rep.logical_rounds).all()
    assert rep.wall_rounds == rep.logical_rounds
    assert leaves_equal(state, state0)
    assert rep.round_plans == 1


def test_device_loss_with_sparse_ckpt_catches_up_bitwise(shards, cfg,
                                                         tmp_path):
    cfg8 = dataclasses.replace(cfg, n_iters=8)       # R = 4
    state0, _, rep0 = ElasticRunner(shards, cfg8, devices=2,
                                    elastic=EL).train(SEED)
    assert rep0.wall_rounds == 4
    el = ElasticConfig(round_iters=2, ckpt_every=2)
    ev = [ElasticEvent("device_loss", at_round=3, device=1)]
    state, _, rep = ElasticRunner(shards, cfg8, devices=2, elastic=el,
                                  events=ev,
                                  ckpt_dir=str(tmp_path)).train(SEED)
    assert rep.alive.all()
    assert (rep.progress == rep.logical_rounds).all()
    assert rep.wall_rounds == 5          # victims rewound 3 → 2
    assert leaves_equal(state, state0)
    assert rep.round_plans == 1


def test_torn_chain_file_falls_back_to_fresh_init(shards, cfg, tmp_path):
    """A victim whose chain file is torn starts over from a fresh init
    with its epoch bumped; the other victim restores."""
    from repro_torch.testing import truncate_chain_file
    runner = ElasticRunner(shards, cfg, devices=2, elastic=EL,
                           events=[ElasticEvent("device_loss", at_round=2,
                                                device=1)],
                           ckpt_dir=str(tmp_path))
    orig = runner.manager.maybe_save

    def torn(step, state, extra=None):
        path = orig(step, state, extra)
        runner.manager.flush()
        if path is not None:
            truncate_chain_file(str(tmp_path), step, 3)
        return path
    runner.manager.maybe_save = torn
    state, _, rep = runner.train(SEED)
    acts = [e["action"] for h in rep.history for e in h["events"]
            if "chain" in e]
    assert "restore_corrupt_fresh" in acts
    assert any(a.startswith("restore_step_") for a in acts)
    assert rep.alive.all() and (rep.progress == rep.logical_rounds).all()
    assert torch.isfinite(state.eta).all()


def test_device_join_repacks_without_new_round_plan(shards, cfg,
                                                    undisturbed):
    state0, _, _ = undisturbed
    ev = [ElasticEvent("device_join", at_round=1, device=9)]
    runner = ElasticRunner(shards, cfg, devices=2, elastic=EL, events=ev)
    state, _, rep = runner.train(SEED)
    assert 9 in runner.pool
    assert leaves_equal(state, state0)
    assert rep.round_plans == 1


# ------------------------------------- property: random elastic scenarios

def _loss_survivors_equal(train, cfg, ndev, cpd, at_round, device):
    m = ndev * cpd
    shards = build_schedule(partition(train, m), cfg)
    state0, _, _ = ElasticRunner(shards, cfg, devices=ndev,
                                 elastic=EL).train(SEED)
    ev = [ElasticEvent("device_loss", at_round=at_round, device=device)]
    state, _, rep = ElasticRunner(shards, cfg, devices=ndev, elastic=EL,
                                  events=ev).train(SEED)
    survivors = np.nonzero(rep.alive)[0]
    assert 0 < len(survivors) < m
    assert leaves_equal(state, state0, idx=survivors)
    assert rep.round_plans == 1


@pytest.mark.parametrize("seed,ndev,cpd", [(0, 2, 1), (1, 2, 2),
                                           (2, 4, 2)])
def test_repack_property_random_scenarios(corpus, cfg, seed, ndev, cpd):
    g = np.random.default_rng(seed)
    _loss_survivors_equal(corpus[0], cfg, ndev, cpd,
                          int(g.integers(1, 3)), int(g.integers(0, ndev)))


try:  # the rest of this module runs without hypothesis
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    _HAVE_HYPOTHESIS = False
    given = settings = lambda *a, **k: (lambda f: f)

    class st:  # noqa: N801 — placeholder so the decorators below parse
        sampled_from = integers = data = staticmethod(lambda *a, **k: None)


@pytest.mark.skipif(not _HAVE_HYPOTHESIS, reason=(
    "property tests need hypothesis (pip install -r requirements-dev.txt)"))
@settings(max_examples=8, deadline=None)
@given(ndev=st.sampled_from([2, 4]), cpd=st.sampled_from([1, 2]),
       data=st.data())
def test_repack_property_hypothesis(ndev, cpd, data):
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    tr, _ = j_split(c, 32)
    train = corpus_from_numpy(tr.tokens, tr.mask, tr.y, device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _loss_survivors_equal(train, SLDAConfig(**CFG), ndev, cpd,
                              data.draw(st.integers(1, 2)),
                              data.draw(st.integers(0, ndev - 1)))
    finally:
        torch.set_num_threads(n)


# ------------------------------------------------------ preempt / resume

def test_preempt_then_resume_is_bitwise_transparent(shards, cfg, tmp_path,
                                                    undisturbed):
    state0, _, _ = undisturbed
    ev = [ElasticEvent("preempt", at_round=2)]
    _, _, rep1 = ElasticRunner(shards, cfg, devices=2, elastic=EL,
                               events=ev,
                               ckpt_dir=str(tmp_path)).train(SEED)
    assert rep1.preempted
    assert latest_step(str(tmp_path)) >= rep1.wall_rounds - 1
    state2, _, rep2 = ElasticRunner(
        shards, cfg, devices=2, elastic=EL,
        ckpt_dir=str(tmp_path)).train(SEED, resume=True)
    assert rep2.resume_round == rep1.wall_rounds
    assert rep2.wall_rounds == rep2.logical_rounds
    assert leaves_equal(state2, state0)


def test_preempt_during_flush_leaves_zero_corrupt_steps(shards, cfg,
                                                        tmp_path,
                                                        monkeypatch,
                                                        undisturbed):
    """The notice lands while the writer is mid-flush and the writer dies
    inside a later write: every published step still restores, no
    temporary directory is left, and the run resumes bit for bit."""
    import repro_torch.checkpoint.store as store
    state0, _, _ = undisturbed
    calls = {"n": 0}
    real_savez = store.np.savez

    def flaky_savez(f, **kw):
        calls["n"] += 1
        if calls["n"] == 6:
            raise OSError("killed mid-flush")
        return real_savez(f, **kw)

    monkeypatch.setattr(store.np, "savez", flaky_savez)
    ev = [ElasticEvent("preempt", at_round=2)]
    r1 = ElasticRunner(shards, cfg, devices=2, elastic=EL, events=ev,
                       ckpt_dir=str(tmp_path))
    try:
        r1.train(SEED)
    except OSError:
        pass                                 # the writer's death surfaced
    monkeypatch.undo()
    assert calls["n"] >= 6

    sweep_stale(str(tmp_path))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps, "nothing durable survived the chaos"
    helper = ElasticRunner(shards, cfg, devices=2, elastic=EL)
    tmpl = helper.sup.plan.init_states(
        seeded_draws(SEED, helper.sup.plan).z_init)
    for s in steps:
        read_manifest(str(tmp_path), s)
        restore_checkpoint(str(tmp_path), s, tmpl)
    assert not any(d.startswith(".tmp_") for d in os.listdir(tmp_path))
    state2, _, _ = ElasticRunner(
        shards, cfg, devices=2, elastic=EL,
        ckpt_dir=str(tmp_path)).train(SEED, resume=True)
    assert leaves_equal(state2, state0)


# ------------------------------------------------------------ stragglers

def test_straggler_flag_then_escalate_to_eviction(shards, cfg,
                                                  undisturbed):
    state0, _, _ = undisturbed
    clock = VirtualClock()
    ev = [ElasticEvent("straggle", at_round=1, device=1, delay_s=5.0,
                       rounds=3)]
    el = ElasticConfig(round_iters=2, device_round_s=1.0, deadline_s=2.0,
                       straggle_rounds=2)
    runner = ElasticRunner(shards, cfg, devices=2, elastic=el, events=ev,
                           clock=clock)
    state, _, rep = runner.train(SEED)
    assert [bool(s & F_STRAGGLER) for s in rep.status] == [False, False,
                                                           True, True]
    assert rep.alive.all()
    assert leaves_equal(state, state0)
    assert runner.pool.ids == (0,)
    acts = [e["action"] for h in rep.history for e in h["events"]]
    assert acts.count("deadline_miss") == 2
    assert "straggler_evicted" in acts
    assert rep.round_plans == 1
    assert rep.sim_seconds > rep.wall_rounds * el.device_round_s


def test_speculative_replace_moves_slowest_devices_chains(shards, cfg):
    ev = [ElasticEvent("straggle", at_round=1, device=0, delay_s=9.0,
                       rounds=3)]
    el = ElasticConfig(round_iters=2, device_round_s=1.0, deadline_s=2.0,
                       straggle_rounds=5, speculative_replace=True)
    runner = ElasticRunner(shards, cfg, devices=2, elastic=el, events=ev,
                           clock=VirtualClock())
    _, _, rep = runner.train(SEED)
    spec = [e for h in rep.history for e in h["events"]
            if e["action"] == "speculative_replace"]
    assert spec and spec[0]["device"] == 0 and spec[0]["target"] == 1
    assert runner.pool.ids == (0, 1)
    assert runner.placement[1] == (0, 1, 2, 3)


def test_random_elastic_events_deterministic():
    a = random_elastic_events(5, n_rounds=6, n_devices=3, n_events=4)
    b = random_elastic_events(5, n_rounds=6, n_devices=3, n_events=4)
    assert a == b
    assert sum(e.kind == "device_loss" for e in a) <= 2
    with pytest.raises(ValueError):
        random_elastic_events(0, n_rounds=4, n_devices=2, kinds=("nope",))


@pytest.mark.parametrize("kinds", [("device_loss", "straggle"),
                                   ("device_loss", "preempt", "straggle",
                                    "device_join")])
def test_random_elastic_events_equal_the_reference(kinds):
    for seed in range(50):
        kw = dict(n_rounds=3 + seed % 5, n_devices=1 + seed % 4,
                  n_events=seed % 6, kinds=kinds)
        got = random_elastic_events(seed, **kw)
        want = jtesting.random_elastic_events(seed, **kw)
        assert [tuple(e) for e in got] == [tuple(e) for e in want], seed


# ---------------------------------------------------- async checkpoints

def test_async_and_sync_checkpointing_identical_bits(shards, cfg,
                                                     tmp_path):
    rs = ElasticRunner(shards, cfg, devices=2,
                       elastic=ElasticConfig(round_iters=2,
                                             async_ckpt=False),
                       ckpt_dir=str(tmp_path / "sync"))
    ra = ElasticRunner(shards, cfg, devices=2,
                       elastic=ElasticConfig(round_iters=2,
                                             async_ckpt=True),
                       ckpt_dir=str(tmp_path / "async"))
    state_s, _, _ = rs.train(SEED)
    state_a, _, _ = ra.train(SEED)
    assert leaves_equal(state_a, state_s)
    assert latest_step(str(tmp_path / "sync")) == \
        latest_step(str(tmp_path / "async")) == 3
    for step in (2, 3):
        ms = read_manifest(str(tmp_path / "sync"), step)
        ma = read_manifest(str(tmp_path / "async"), step)
        assert ms == ma
        for chain in range(M):
            name = f"step_{step:08d}/chain_{chain:03d}.npz"
            with np.load(tmp_path / "sync" / name) as a, \
                    np.load(tmp_path / "async" / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert np.array_equal(a[k], b[k]), (step, chain, k)


def test_manifest_extra_carries_resume_bookkeeping(shards, cfg, tmp_path):
    ElasticRunner(shards, cfg, devices=2, elastic=EL,
                  ckpt_dir=str(tmp_path)).train(SEED)
    extra = read_manifest(str(tmp_path), 3)["extra"]
    assert extra["progress"] == [3, 3, 3, 3]
    assert extra["alive"] == [True] * 4
    assert extra["wall_round"] == 3
    assert extra["pool"] == [0, 1]


# ------------------------------------------------------------ end to end

def test_elastic_run_average_end_to_end(corpus, cfg, tmp_path):
    train, test = corpus
    ev = [ElasticEvent("device_loss", at_round=2, device=0)]
    yhat, rep = elastic_run_average(
        3, train, test, cfg, M, devices=2, rule="simple", elastic=EL,
        events=ev, ckpt_dir=str(tmp_path), device="cpu")
    assert torch.isfinite(yhat).all() and yhat.shape == (test.n_docs,)
    assert rep.alive.all()
    assert (rep.progress == rep.logical_rounds).all()


@pytest.mark.parametrize("rule", ["simple", "weighted"])
def test_elastic_run_average_is_the_supervised_run(corpus, cfg, rule):
    """Undisturbed, the elastic run predicts what `supervised_run_average`
    predicts for the same seed and round size, bit for bit."""
    from repro_torch.core import supervised_run_average
    train, test = corpus
    y_el, rep = elastic_run_average(3, train, test, cfg, M, rule=rule,
                                    elastic=EL, device="cpu")
    y_sup, rep_sup = supervised_run_average(3, train, test, cfg, M,
                                            rule=rule, round_iters=2,
                                            device="cpu")
    assert torch.equal(y_el, y_sup)
    np.testing.assert_array_equal(rep.yhat_chains, rep_sup.yhat_chains)


def test_round_iters_must_divide_n_iters(shards, cfg):
    with pytest.raises(ValueError, match="must divide"):
        ElasticRunner(shards, cfg, devices=2,
                      elastic=ElasticConfig(round_iters=4))


# --------------------------------- the reference's runner, same scenarios

def _elastic_draws(cfg, d, s):
    """The reference runner's draws: chain keys fold_in(root, chain)."""
    root = jax.random.PRNGKey(SEED)
    keys = jax.vmap(lambda c: jax.random.fold_in(root, c))(jnp.arange(M))
    return reference_draws(None, M, d, s, cfg, chain_keys=keys)


SCENARIOS = {
    "undisturbed": dict(),
    "loss_no_ckpt": dict(events=[("device_loss", 2, 1)]),
    "loss_catch_up": dict(events=[("device_loss", 3, 1)], ckpt=True,
                          n_iters=8, ckpt_every=2),
    "straggler_evicted": dict(events=[("straggle", 1, 1, 5.0, 3)],
                              deadline_s=2.0),
    "join_then_loss": dict(events=[("device_join", 1, 7),
                                   ("device_loss", 2, 0)], ckpt=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_runner_equals_reference_runner(ref_corpus, corpus, tmp_path,
                                             name):
    sc = SCENARIOS[name]
    kw = dict(CFG, n_iters=sc.get("n_iters", CFG["n_iters"]))
    jcfg, pcfg = JConfig(**kw), SLDAConfig(**kw)
    el = dict(round_iters=2, ckpt_every=sc.get("ckpt_every", 1),
              deadline_s=sc.get("deadline_s"))
    out = []
    for side in ("j", "p"):
        ckpt = str(tmp_path / side) if sc.get("ckpt") else None
        if side == "j":
            events = [jtesting.ElasticEvent(*e) for e in
                      sc.get("events", ())]
            runner = jel.ElasticRunner(
                j_build_schedule(j_partition(ref_corpus[0], M), jcfg), jcfg,
                devices=2, elastic=jel.ElasticConfig(**el), events=events,
                ckpt_dir=ckpt, clock=jtesting.VirtualClock())
            state, _, rep = runner.train(jax.random.PRNGKey(SEED))
        else:
            events = [ElasticEvent(*e) for e in sc.get("events", ())]
            sh = build_schedule(partition(corpus[0], M), pcfg)
            runner = ElasticRunner(sh, pcfg, devices=2,
                                   elastic=ElasticConfig(**el),
                                   events=events, ckpt_dir=ckpt,
                                   clock=VirtualClock())
            state, _, rep = runner.train(draws=_elastic_draws(
                pcfg, sh.n_docs, sh.max_len))
        out.append((state, rep, runner.pool.ids))
    (j_state, j_rep, j_pool), (p_state, p_rep, p_pool) = out
    assert list(p_rep.alive) == list(j_rep.alive)
    np.testing.assert_array_equal(p_rep.status, np.asarray(j_rep.status))
    np.testing.assert_array_equal(p_rep.progress, j_rep.progress)
    assert p_rep.wall_rounds == j_rep.wall_rounds
    assert p_rep.sim_seconds == j_rep.sim_seconds
    assert p_pool == j_pool
    assert p_rep.placements == j_rep.placements

    def acts(rep):
        return [[e["action"] for e in h["events"]] for h in rep.history]
    assert acts(p_rep) == acts(j_rep)
    np.testing.assert_array_equal(p_state.z.numpy(), np.asarray(j_state.z))
    for f in ("ndt", "ntw", "nt"):
        np.testing.assert_array_equal(getattr(p_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)))
    np.testing.assert_allclose(p_state.eta.numpy(), np.asarray(j_state.eta),
                               rtol=1e-3, atol=1e-3)


# ------------------------------- the supervised run's draws are unchanged

def test_supervised_round_draws_unchanged_by_per_chain_rounds(shards, cfg):
    """A scalar round draws what it drew before per-chain rounds came in
    (generators seeded (seed, SUPERVISED_ROUND, chain, epoch, r)), and an
    [M] of equal rounds draws the same."""
    plan = ChainSupervisor(shards, cfg, round_iters=2).plan
    draws = seeded_draws(SEED, plan)
    epoch = np.array([0, 1, 0, 2])
    d, s = plan.corpus.n_docs, plan.corpus.ctr_stride
    for r in (0, 2):
        gens = [rng.generator("cpu", SEED, rng.SUPERVISED_ROUND, c,
                              int(epoch[c]), r) for c in range(M)]
        want = list(rng.em_draws(gens, d, s, 2))
        for got in (list(draws.round(r, epoch, 2)),
                    list(draws.round(np.full(M, r), epoch, 2))):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    mixed = list(draws.round(np.array([0, 1, 2, 0]), epoch, 2))
    for c, r in enumerate((0, 1, 2, 0)):
        alone = list(draws.round(r, epoch, 2))
        assert all(torch.equal(a[c], b[c]) for a, b in zip(mixed, alone))
