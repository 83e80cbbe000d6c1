"""Per-chain checkpoint store.

Chains share nothing (the paper's communication-free property), so the
layout is per chain: under `<dir>/step_%08d/` one `chain_%03d.npz` a
chain and a `manifest.json` ({"step", "n_chains", "extra"}).  Each .npz
maps a leaf's path in the state's tree to its array, the path written as
JAX's `jax.tree_util.keystr` writes it (`.field` for a dataclass or named
tuple field, `[i]` for a list or tuple item, `['key']` for a dict entry,
dict keys sorted), with the leaf's own dtype and no pickle.  So the
supervisor's state (`GibbsState`, its z a tuple of per-bucket arrays)
writes `.z[0]`, `.ndt`, `.ntw`, `.nt` and `.eta` here and in the JAX
reference package alike, and either package restores the other's files.

  * A chain failure never corrupts another chain's state: a restart
    restores the failed chain alone from its own file.
  * Elastic rescale: restore onto more chains (the new ones start fresh)
    or fewer (a prefix of the ensemble).
  * Atomicity: a save writes into a temporary directory, fsyncs every
    file, then renames it into place.  Overwriting a step first renames
    the old one aside (never deleting the live directory: a crash
    between a delete and the publish would lose both versions),
    publishes, fsyncs the parent directory so the renames are durable,
    and only then deletes the aside copy.
  * A killed writer leaves garbage that is swept, never trusted
    (`sweep_stale`): orphaned `.tmp_*` directories are removed, and a
    `.prev_*` directory whose step vanished (a crash between the aside
    rename and the publish) is renamed back.

`AsyncCheckpointManager` takes the write off the training loop: its
`maybe_save` copies the state to host memory and a writer thread
publishes the copy through the same atomic `save_checkpoint`.  A new save
is not accepted until the previous one is durable, so the newest
published step is at most one save interval behind the loop.

Tensors may lie on any device; a restore puts each array on its template
leaf's device with its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, map_with_paths

#: temporary directories of this process's saves in flight: the sweep
#: never reclaims a directory another thread (the async writer) fills
_ACTIVE_TMP: set = set()
_ACTIVE_LOCK = threading.Lock()


class CheckpointNotFoundError(FileNotFoundError):
    """A requested step does not exist (never written, or collected).  A
    FileNotFoundError whose message and `step` / `available_steps`
    attributes name what was asked for and what the store holds."""

    def __init__(self, ckpt_dir: str, step: int, available: list):
        self.step = step
        self.available_steps = list(available)
        super().__init__(
            f"no checkpoint for step {step} under {ckpt_dir!r}; "
            f"available steps: {self.available_steps or 'none'}")


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array (a fresh copy if `copy`).  numpy has no
    bfloat16: a bf16 tensor is written as float32, exactly, and a restore
    casts it back to its template leaf's dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t, copy = t.float(), False
        return (t.to("cpu", copy=True) if copy else t.cpu()).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _chain_slice(tree, i):
    return map_with_paths(lambda _, x: x[i] if getattr(x, "ndim", 0) > 0 else x,
                tree)


def _n_chains(tree) -> int:
    return leaves_with_paths(tree)[0][1].shape[0]


def _stack(chains):
    """Per-chain trees of tensors → one tree with a leading chain dim."""
    flat = [dict(leaves_with_paths(c)) for c in chains]
    return map_with_paths(lambda path, _: torch.stack([f[path] for f in flat]),
                chains[0])


def _unflatten_into(template_chain, flat):
    """The template's tree (of tensors) with each leaf read from `flat` by
    its path, in the template leaf's dtype and on its device."""
    return map_with_paths(lambda path, tmpl: torch.from_numpy(np.array(flat[path])).to(
        device=tmpl.device, dtype=tmpl.dtype), template_chain)


# ------------------------------------------------------------ the store

def _fsync_dir(path: str):
    """fsync a directory so a rename inside it is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))


def _step_dir(ckpt_dir: str, step: int) -> str:
    """A step's directory, or the typed not-found error."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(d):
        raise CheckpointNotFoundError(ckpt_dir, step, _list_steps(ckpt_dir))
    return d


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    n_chains: int | None = None, extra: dict | None = None):
    """Publish `state` as step `step`: a tree whose array leaves have a
    leading chain dim (0-d leaves are written into every chain's file).
    Returns the step's directory."""
    host = map_with_paths(lambda _, x: _host(x), state)
    if n_chains is None:
        n_chains = _n_chains(host)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    aside = os.path.join(ckpt_dir, f".prev_step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    with _ACTIVE_LOCK:
        _ACTIVE_TMP.add(tmp)
    try:
        for i in range(n_chains):
            flat = dict(leaves_with_paths(_chain_slice(host, i)))
            path = os.path.join(tmp, f"chain_{i:03d}.npz")
            with open(path, "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
        manifest = {"step": step, "n_chains": n_chains,
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # the old step, if any, goes aside and is deleted only after the
        # new one is published: no window loses both versions
        if os.path.isdir(aside):        # an older crash's aside copy
            shutil.rmtree(aside)
        had_old = os.path.exists(final)
        if had_old:
            os.replace(final, aside)
        os.replace(tmp, final)          # the atomic publish
        _fsync_dir(ckpt_dir)
        if had_old:
            shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE_TMP.discard(tmp)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest published step (one with a manifest), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def list_chains(ckpt_dir: str, step: int) -> list[int]:
    d = _step_dir(ckpt_dir, step)
    return sorted(int(f.split("_")[1].split(".")[0])
                  for f in os.listdir(d) if f.startswith("chain_"))


def _load_manifest(step_dir: str, step: int) -> dict:
    """A step's manifest, checked: a manifest that records another step
    than its directory's is a torn or hand-copied checkpoint, and
    restoring it would resume from the wrong point."""
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mpath):
        ckpt_dir = os.path.dirname(step_dir)
        raise CheckpointNotFoundError(ckpt_dir, step, _list_steps(ckpt_dir))
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("step") != step:
        raise ValueError(
            f"checkpoint manifest in {step_dir} records step "
            f"{manifest.get('step')!r}, expected {step} — torn or "
            "mislabelled checkpoint")
    return manifest


def _read_chain(step_dir: str, chain: int, template_chain):
    with np.load(os.path.join(step_dir, f"chain_{chain:03d}.npz")) as z:
        return _unflatten_into(template_chain, dict(z))


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """A step's checked manifest, read before paying to load any chain
    file.  Raises `CheckpointNotFoundError` for a missing step,
    ValueError for a torn or mislabelled manifest."""
    return _load_manifest(_step_dir(ckpt_dir, step), step)


def restore_checkpoint(ckpt_dir: str, step: int, template):
    """Every chain of a step onto `template` (a tree with the target
    leading chain dim; its values are ignored).  The manifest's chain
    count must equal the template's: rescale is `restore_elastic`.
    Returns (state, manifest)."""
    d = _step_dir(ckpt_dir, step)
    manifest = _load_manifest(d, step)
    n, target = manifest["n_chains"], _n_chains(template)
    if n != target:
        raise ValueError(
            f"checkpoint at step {step} holds {n} chains, template "
            f"expects {target} — use restore_elastic for rescale")
    tmpl0 = _chain_slice(template, 0)
    return _stack([_read_chain(d, i, tmpl0) for i in range(n)]), manifest


def restore_chain(ckpt_dir: str, step: int, chain: int, template_chain):
    """One chain's tree (no chain dim), from its own file and nobody
    else's: the supervisor's restart.  Raises on a missing, corrupt or
    truncated file; the caller picks the fallback."""
    d = _step_dir(ckpt_dir, step)
    _load_manifest(d, step)
    return _read_chain(d, chain, template_chain)


def restore_elastic(ckpt_dir: str, step: int, template, init_fn,
                    *, missing_ok: bool = True):
    """A step onto `template`'s chain count: fewer chains restore a
    prefix; more take the missing ones from `init_fn(chain_index)`.  A
    corrupt or missing chain file falls back to `init_fn` as well (fault
    isolation).  Returns (state, {"restored_chains", "step", "extra"})."""
    d = _step_dir(ckpt_dir, step)
    manifest = _load_manifest(d, step)
    tmpl0 = _chain_slice(template, 0)
    chains, restored = [], []
    for i in range(_n_chains(template)):
        try:
            chains.append(_read_chain(d, i, tmpl0))
            restored.append(i)
        except (FileNotFoundError, KeyError, ValueError, OSError, EOFError,
                zipfile.BadZipFile):        # a truncated .npz: a torn write
            if not missing_ok:
                raise
            chains.append(init_fn(i))
    return _stack(chains), {"restored_chains": restored,
                            "step": manifest["step"],
                            "extra": manifest.get("extra", {})}


def sweep_stale(ckpt_dir: str) -> dict:
    """Reclaim crash garbage under `ckpt_dir`, safe at any time for a
    single writer (this process's saves in flight are skipped):

      * `.tmp_*`: a save killed mid-write, never published: removed;
      * `.prev_step_X` beside `step_X`: the crash hit after the publish,
        before the aside copy was deleted: removed;
      * `.prev_step_X` with no `step_X`: the crash hit between the aside
        rename and the publish, and the aside copy is the only one of
        that step: renamed back.

    Returns {"removed_tmp": n, "removed_aside": n, "recovered": [steps]}."""
    out = {"removed_tmp": 0, "removed_aside": 0, "recovered": []}
    if not os.path.isdir(ckpt_dir):
        return out
    with _ACTIVE_LOCK:
        active = set(_ACTIVE_TMP)
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.startswith(".tmp_") and path not in active:
            shutil.rmtree(path, ignore_errors=True)
            out["removed_tmp"] += 1
        elif name.startswith(".prev_step_"):
            final = os.path.join(ckpt_dir, name[len(".prev_"):])
            if os.path.isdir(final):
                shutil.rmtree(path, ignore_errors=True)
                out["removed_aside"] += 1
            else:
                os.replace(path, final)
                out["recovered"].append(int(name.rsplit("_", 1)[1]))
    return out


class CheckpointManager:
    """Saves every `interval` steps and keeps the last `keep`.  Crash
    garbage is swept when the manager starts and at every collection
    (`sweep_stale`)."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        sweep_stale(ckpt_dir)

    def maybe_save(self, step: int, state, extra=None):
        if step % self.interval:
            return None
        path = save_checkpoint(self.dir, step, state, extra=extra)
        self._gc()
        return path

    def latest_durable(self) -> int | None:
        """The newest published step: what a restart can restore."""
        return latest_step(self.dir)

    def flush(self):
        """Every save this manager accepted is already durable."""

    def close(self):
        self.flush()

    def _gc(self):
        sweep_stale(self.dir)
        for s in _list_steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)


class AsyncCheckpointManager(CheckpointManager):
    """Checkpoints written by a background thread, with bounded staleness.

    `maybe_save` does the part that must see the loop's state, a host
    copy of it, and hands the copy to a writer thread, which publishes it
    through the same atomic `save_checkpoint`.  A new save is not
    accepted until the previous one is durable (`maybe_save` waits for
    the write in flight first), so the newest published step is at most
    one save interval behind the loop.  `flush()` blocks until the write
    in flight is published; `close()` flushes and stops the writer.  A
    failure of the writer is raised by the next `maybe_save` or
    `flush`."""

    def __init__(self, ckpt_dir: str, interval: int = 1, keep: int = 3):
        super().__init__(ckpt_dir, interval=interval, keep=keep)
        self._job = None            # (step, snapshot, extra) or None
        self._job_ready = threading.Event()
        self._job_done = threading.Event()    # nothing queued or writing
        self._job_done.set()
        self._stop = False
        self._error = None
        self._lock = threading.Lock()
        self.stats = {"writes": 0, "waits": 0, "wait_s": 0.0}
        self._thread = threading.Thread(
            target=self._writer, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _writer(self):
        while True:
            self._job_ready.wait()
            with self._lock:
                if self._stop and self._job is None:
                    return
                job, self._job = self._job, None
                self._job_ready.clear()
            if job is None:
                continue
            step, snap, extra = job
            try:
                save_checkpoint(self.dir, step, snap, extra=extra)
                self._gc()
                self.stats["writes"] += 1
            except BaseException as e:  # noqa: BLE001 — raised to the caller
                with self._lock:
                    self._error = e
            finally:
                self._job_done.set()

    def _raise_pending_error(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def maybe_save(self, step: int, state, extra=None):
        """Copy `state` to host memory and queue its write.  Returns the
        directory the write will publish (None off the interval).  Blocks
        only until the previous write is durable and the copy is taken."""
        if step % self.interval:
            return None
        if not self._job_done.is_set():
            t0 = time.perf_counter()
            self._job_done.wait()
            self.stats["waits"] += 1
            self.stats["wait_s"] += time.perf_counter() - t0
        self._raise_pending_error()
        # a fresh host copy of every leaf: the writer owns it until its
        # publish, whatever the loop does to its own tensors next
        snap = map_with_paths(lambda _, x: _host(x, copy=True), state)
        with self._lock:
            self._job = (step, snap, extra)
            self._job_done.clear()
            self._job_ready.set()
        return os.path.join(self.dir, f"step_{step:08d}")

    def flush(self):
        """Block until the write in flight, if any, is published."""
        self._job_done.wait()
        self._raise_pending_error()

    def close(self):
        self.flush()
        with self._lock:
            self._stop = True
            self._job_ready.set()
        self._thread.join(timeout=30.0)
        self._raise_pending_error()
