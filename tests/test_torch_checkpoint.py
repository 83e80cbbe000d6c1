"""The port's checkpoint store (`repro_torch.checkpoint`): the behaviours
the reference's `tests/test_checkpoint.py` holds its store to (atomic
publish and the aside rename, the stale-garbage sweep, the async
manager's bounded staleness, the typed not-found error, elastic restore,
fault isolation of a torn chain file), and both directions across the
packages: files the reference writes restore in the port bit for bit,
and the port's in the reference."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro_torch.checkpoint.store as store
from repro.core.types import GibbsState as JGibbsState
from repro_torch.checkpoint import (AsyncCheckpointManager, CheckpointManager,
                                    CheckpointNotFoundError, latest_step,
                                    list_chains, read_manifest, restore_chain,
                                    restore_checkpoint, restore_elastic,
                                    save_checkpoint, sweep_stale)
from repro_torch.core.types import GibbsState
from repro_torch.testing import mislabel_manifest, truncate_chain_file
from repro_torch.tree import leaves_with_paths, map_with_paths


def make_state(seed, chains=4, d=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"params": {"w": f(chains, d, d), "b": torch.zeros(chains, d)},
            "opt": {"m": f(chains, d, d),
                    "step": torch.full((chains,), 7, dtype=torch.int32)}}


def _leaves(tree):
    return [x for _, x in leaves_with_paths(tree)]


def trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def chain(tree, i):
    return map_with_paths(lambda _, x: x[i], tree)


def test_save_restore_roundtrip(tmp_path):
    state = make_state(0)
    save_checkpoint(str(tmp_path), 100, state)
    assert latest_step(str(tmp_path)) == 100
    assert list_chains(str(tmp_path), 100) == [0, 1, 2, 3]
    restored, manifest = restore_checkpoint(str(tmp_path), 100, state)
    assert manifest == {"step": 100, "n_chains": 4, "extra": {}}
    assert trees_equal(state, restored)


def test_atomicity_no_partial_checkpoint_visible(tmp_path):
    """A save that fails part way leaves no step directory behind."""
    class Exploding:
        shape = (4, 4)

        def __array__(self, *a, **k):
            raise RuntimeError("boom")

    bad = make_state(1)
    bad["opt"]["bomb"] = Exploding()
    with pytest.raises(RuntimeError, match="boom"):
        save_checkpoint(str(tmp_path), 5, bad)
    assert latest_step(str(tmp_path)) is None
    assert not any(d.startswith(("step_", ".tmp_"))
                   for d in os.listdir(tmp_path))


def test_elastic_restore_to_a_prefix_and_an_extension(tmp_path):
    state = make_state(2, chains=4)
    save_checkpoint(str(tmp_path), 10, state)
    small = make_state(3, chains=2)
    restored, info = restore_elastic(str(tmp_path), 10, small, lambda i: None)
    assert info["restored_chains"] == [0, 1]
    assert trees_equal(map_with_paths(lambda _, x: x[:2], state), restored)
    big = make_state(4, chains=6)
    fresh = make_state(5, chains=1)
    restored, info = restore_elastic(
        str(tmp_path), 10, big,
        lambda i: map_with_paths(lambda _, x: x[0] + i, fresh))
    assert info["restored_chains"] == [0, 1, 2, 3]
    assert trees_equal(map_with_paths(lambda _, x: x[:4], state),
                       map_with_paths(lambda _, x: x[:4], restored))
    assert trees_equal(chain(restored, 5),
                       map_with_paths(lambda _, x: x[0] + 5, fresh))


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
def test_a_damaged_chain_file_is_isolated(tmp_path, damage):
    """A corrupt or torn chain file falls back to init_fn for that chain
    alone; the strict single-chain reader refuses it outright."""
    state = make_state(6, chains=4)
    save_checkpoint(str(tmp_path), 20, state)
    if damage == "corrupt":
        with open(tmp_path / "step_00000020" / "chain_002.npz", "wb") as f:
            f.write(b"corrupted")
    else:
        truncate_chain_file(str(tmp_path), 20, 2)
    fresh = make_state(7, chains=1)
    init_fn = lambda i: map_with_paths(lambda _, x: x[0] * 0 - 1, fresh)
    restored, info = restore_elastic(str(tmp_path), 20, state, init_fn)
    assert info["restored_chains"] == [0, 1, 3]
    for i in (0, 1, 3):
        assert trees_equal(chain(state, i), chain(restored, i))
    assert float(restored["params"]["w"][2, 0, 0]) == -1.0
    with pytest.raises(Exception):
        restore_chain(str(tmp_path), 20, 2, chain(state, 0))


def test_chain_count_mismatch_needs_restore_elastic(tmp_path):
    save_checkpoint(str(tmp_path), 3, make_state(8, chains=4))
    with pytest.raises(ValueError, match="restore_elastic"):
        restore_checkpoint(str(tmp_path), 3, make_state(8, chains=2))


def test_crash_mid_second_save_keeps_previous_step(tmp_path, monkeypatch):
    state = make_state(9)
    save_checkpoint(str(tmp_path), 1, state)
    calls = {"n": 0}
    real_savez = store.np.savez

    def dying_savez(f, **kw):
        calls["n"] += 1
        if calls["n"] == 3:        # the third chain of the second save
            raise OSError("disk gone")
        return real_savez(f, **kw)

    monkeypatch.setattr(store.np, "savez", dying_savez)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 2, state)
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 1
    restored, manifest = restore_checkpoint(str(tmp_path), 1, state)
    assert manifest["step"] == 1 and trees_equal(state, restored)
    assert not any(d.startswith(".tmp_") for d in os.listdir(tmp_path))


def test_manifest_step_mismatch_raises(tmp_path):
    state = make_state(12, chains=2)
    save_checkpoint(str(tmp_path), 40, state)
    mislabel_manifest(str(tmp_path), 40, 39)
    for fn in (lambda: restore_checkpoint(str(tmp_path), 40, state),
               lambda: restore_chain(str(tmp_path), 40, 0, chain(state, 0)),
               lambda: restore_elastic(str(tmp_path), 40, state,
                                       lambda i: None),
               lambda: read_manifest(str(tmp_path), 40)):
        with pytest.raises(ValueError, match="torn or mislabelled"):
            fn()


def test_restore_chain_roundtrip(tmp_path):
    state = make_state(13, chains=4)
    save_checkpoint(str(tmp_path), 50, state)
    for c in (0, 3):
        got = restore_chain(str(tmp_path), 50, c, chain(state, 0))
        assert trees_equal(chain(state, c), got)
    with pytest.raises(FileNotFoundError):
        restore_chain(str(tmp_path), 50, 9, chain(state, 0))


def test_manager_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2)
    for step in range(1, 6):
        mgr.maybe_save(step, make_state(8, chains=2))
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000004",
                                                "step_00000005"]
    assert mgr.latest_durable() == 5


def test_kill_mid_save_garbage_swept_by_next_save(tmp_path):
    orphan = os.path.join(str(tmp_path), ".tmp_deadwriter")
    os.makedirs(orphan)
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2)
    assert not os.path.exists(orphan)       # swept at start
    os.makedirs(orphan)                     # a writer dies again
    mgr.maybe_save(1, make_state(20, chains=2))
    assert not os.path.exists(orphan)
    assert latest_step(str(tmp_path)) == 1


def test_sweep_recovers_aside_when_publish_never_happened(tmp_path):
    state = make_state(21, chains=2)
    save_checkpoint(str(tmp_path), 3, state)
    os.replace(tmp_path / "step_00000003", tmp_path / ".prev_step_00000003")
    assert latest_step(str(tmp_path)) is None
    assert sweep_stale(str(tmp_path))["recovered"] == [3]
    restored, _ = restore_checkpoint(str(tmp_path), 3, state)
    assert trees_equal(state, restored)


def test_crash_during_overwrite_keeps_old_version(tmp_path, monkeypatch):
    """A crash at the publish, after the old step went aside, loses
    nothing: the sweep renames the old version back."""
    old, new = make_state(22, chains=2), make_state(23, chains=2)
    save_checkpoint(str(tmp_path), 7, old)
    real_replace = os.replace

    def dying_replace(src, dst):
        if os.path.basename(src).startswith(".tmp_"):
            raise OSError("killed at publish")
        return real_replace(src, dst)

    monkeypatch.setattr(store.os, "replace", dying_replace)
    with pytest.raises(OSError, match="killed at publish"):
        save_checkpoint(str(tmp_path), 7, new)
    monkeypatch.undo()
    sweep_stale(str(tmp_path))
    restored, _ = restore_checkpoint(str(tmp_path), 7, old)
    assert trees_equal(old, restored)
    save_checkpoint(str(tmp_path), 7, new)          # an undisturbed one
    restored, _ = restore_checkpoint(str(tmp_path), 7, new)
    assert trees_equal(new, restored)
    assert not any(d.startswith((".tmp_", ".prev_"))
                   for d in os.listdir(tmp_path))


def test_missing_step_raises_typed_error_naming_available(tmp_path):
    state = make_state(24, chains=2)
    save_checkpoint(str(tmp_path), 10, state)
    save_checkpoint(str(tmp_path), 20, state)
    for fn in (lambda: list_chains(str(tmp_path), 15),
               lambda: read_manifest(str(tmp_path), 15),
               lambda: restore_checkpoint(str(tmp_path), 15, state),
               lambda: restore_elastic(str(tmp_path), 15, state,
                                       lambda i: None)):
        with pytest.raises(CheckpointNotFoundError) as ei:
            fn()
        assert ei.value.step == 15 and ei.value.available_steps == [10, 20]
        assert "[10, 20]" in str(ei.value)
    os.remove(tmp_path / "step_00000010" / "manifest.json")
    with pytest.raises(FileNotFoundError):
        read_manifest(str(tmp_path), 10)


def test_async_manager_publishes_the_bits_of_the_sync_one(tmp_path):
    state = make_state(26, chains=3)
    sm = CheckpointManager(str(tmp_path / "sync"), interval=1, keep=3)
    am = AsyncCheckpointManager(str(tmp_path / "async"), interval=1, keep=3)
    for step in (1, 2, 3):
        sm.maybe_save(step, state)
        am.maybe_save(step, state)
    am.close()
    a, _ = restore_checkpoint(str(tmp_path / "async"), 3, state)
    s, _ = restore_checkpoint(str(tmp_path / "sync"), 3, state)
    assert trees_equal(a, s) and trees_equal(a, state)


def test_async_manager_bounded_staleness(tmp_path, monkeypatch):
    """With a slow writer, step r is accepted only once step r − 1 is
    durable."""
    real_save = store.save_checkpoint

    def slow_save(*a, **kw):
        time.sleep(0.15)
        return real_save(*a, **kw)

    am = AsyncCheckpointManager(str(tmp_path), interval=1, keep=5)
    monkeypatch.setattr(store, "save_checkpoint", slow_save)
    try:
        for step in (1, 2, 3, 4):
            am.maybe_save(step, make_state(27, chains=2))
            assert (latest_step(str(tmp_path)) or 0) >= step - 1
        am.flush()
        assert latest_step(str(tmp_path)) == 4 and am.stats["waits"] >= 1
    finally:
        am.close()


def test_async_manager_snapshot_isolated_from_later_mutation(tmp_path):
    state = {"x": torch.arange(8, dtype=torch.float32).reshape(2, 4)}
    am = AsyncCheckpointManager(str(tmp_path), interval=1, keep=3)
    am.maybe_save(1, state)
    state["x"] += 100.0                     # in place, after the enqueue
    am.close()
    restored, _ = restore_checkpoint(str(tmp_path), 1,
                                     {"x": torch.zeros(2, 4)})
    assert torch.equal(restored["x"],
                       torch.arange(8, dtype=torch.float32).reshape(2, 4))


def test_async_manager_writer_error_surfaces(tmp_path, monkeypatch):
    am = AsyncCheckpointManager(str(tmp_path), interval=1, keep=3)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_checkpoint", boom)
    am.maybe_save(1, make_state(28, chains=2))
    with pytest.raises(OSError, match="disk full"):
        am.flush()
    monkeypatch.undo()
    am.maybe_save(2, make_state(28, chains=2))
    am.close()
    assert latest_step(str(tmp_path)) == 2


# ------------------------------------------------ across the two packages

def _gibbs_pair(seed, m=3):
    """The same supervisor state as the reference's and the port's
    `GibbsState`: z a tuple of two per-bucket int32 arrays."""
    rng = np.random.default_rng(seed)
    z = (rng.integers(0, 8, (m, 5, 16)).astype(np.int32),
         rng.integers(0, 8, (m, 4, 8)).astype(np.int32))
    f = lambda *s: rng.integers(0, 9, s).astype(np.float32)
    parts = dict(ndt=f(m, 9, 8), ntw=f(m, 8, 30), nt=f(m, 8),
                 eta=rng.normal(size=(m, 8)).astype(np.float32))
    j = JGibbsState(z=tuple(jnp.asarray(a) for a in z),
                    **{k: jnp.asarray(v) for k, v in parts.items()})
    p = GibbsState(z=tuple(torch.from_numpy(a) for a in z),
                   **{k: torch.from_numpy(v) for k, v in parts.items()})
    return j, p


def _same(port_tree, ref_tree):
    got = [np.asarray(x) for x in _leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    return len(got) == len(want) and all(
        g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["gibbs", "dict"])
def test_reference_checkpoints_restore_in_the_port(tmp_path, kind):
    if kind == "gibbs":
        j_state, p_tmpl = _gibbs_pair(30)
    else:
        p_tmpl = make_state(31, chains=3)
        j_state = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p_tmpl)
    jckpt.save_checkpoint(str(tmp_path), 6, j_state, extra={"by": "jax"})
    restored, manifest = restore_checkpoint(str(tmp_path), 6, p_tmpl)
    assert manifest["extra"] == {"by": "jax"} and _same(restored, j_state)
    one = restore_chain(str(tmp_path), 6, 2, chain(p_tmpl, 0))
    assert _same(one, jax.tree.map(lambda x: x[2], j_state))


@pytest.mark.parametrize("kind", ["gibbs", "dict"])
def test_port_checkpoints_restore_in_the_reference(tmp_path, kind):
    if kind == "gibbs":
        j_tmpl, p_state = _gibbs_pair(32)
    else:
        p_state = make_state(33, chains=3)
        j_tmpl = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p_state)
    save_checkpoint(str(tmp_path), 8, p_state)
    with np.load(tmp_path / "step_00000008" / "chain_001.npz") as z:
        flat = {k: z[k] for k in z.files}
    want = {jax.tree_util.keystr(path): np.asarray(x)[1] for path, x in
            jax.tree_util.tree_flatten_with_path(j_tmpl)[0]}
    assert sorted(flat) == sorted(want)
    assert all(flat[k].dtype == want[k].dtype for k in want)
    restored, manifest = jckpt.restore_checkpoint(str(tmp_path), 8, j_tmpl)
    assert manifest["n_chains"] == 3 and _same(p_state, restored)
    with open(tmp_path / "step_00000008" / "manifest.json") as f:
        assert json.load(f) == {"step": 8, "n_chains": 3, "extra": {}}
