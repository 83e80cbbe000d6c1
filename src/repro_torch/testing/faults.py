"""Deterministic fault injection for the chain ensemble.

Chaos testing the supervisor needs faults that are deterministic (same
seed, same fault, same EM boundary, so that a failure reproduces bit for
bit) and that act where the supervisor's health probe looks: at the EM
boundary, on the device, with no host synchronization.  A `FaultPlan`
is therefore data, not control flow: per-chain int32 trigger boundaries
(−1 = never) on the state's device, compared with the boundary index
`it`.  `FaultPlan.hook()` plugs into `ChainSupervisor(fault_hook=...)`,
which runs it before the health probe, so a fault injected at boundary
`it` is detectable at that same boundary.

How each fault behaves mirrors the failure it stands for:

  * `nan_eta_step`, persistent (every boundary from the step on): a
    diverged sampler produces NaN again after any restart, so this is
    the fault that spends the restart budget and ends in quarantine.
  * `corrupt_counts_step`, persistent: ndt[c, 0, 0] += 7 (breaks
    Σ ndt = Σ lengths) and ntw[c, 0, 0] = −5 (breaks ntw ≥ 0); η stays
    finite, so only the count probes can catch it.
  * `kill_step`, transient (exactly one boundary): a dead worker loses
    its state once (poisoned to NaN here) and raises F_KILLED, as a
    cluster runtime reports a lost worker out of band.  A restart from
    the checkpoint recovers it.
  * `straggle_step`, transient and flag-only (F_STRAGGLER): a late chain
    is correct, and nothing of its state changes.

NaN and count faults set no bits: the health probes must find them.
Kill and straggle set their bits, because a dead or late worker has no
signature in the state.

The serving half drives `serving.SLDAPredictionService`: model tables
poisoned after training (`poison_model_table`), a straggling dispatch
(`inject_dispatch_delay`), and deterministic open-loop overload
(`burst_trace` replayed by `replay_open_loop` on a `VirtualClock`).  The
elastic half (`ElasticEvent`, `random_elastic_events`) is the timeline of
device losses, joins, stragglers and preemptions that
`launch.elastic.ElasticRunner` replays.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.supervisor import F_KILLED, F_STRAGGLER
from repro_torch.core.types import GibbsState
from repro_torch.device import resolve_device

_KINDS = ("nan", "corrupt", "kill", "straggle")


class FaultPlan(NamedTuple):
    """Per-chain trigger boundaries, int32 [M] tensors, −1 = never."""

    nan_eta_step: torch.Tensor
    corrupt_counts_step: torch.Tensor
    kill_step: torch.Tensor
    straggle_step: torch.Tensor

    def hook(self):
        """The `fault_hook(state, it) -> (state, bits)` of this plan."""
        return lambda state, it: inject(state, it, self)


def inject(state: GibbsState, it, fp: FaultPlan):
    """Apply `fp` (on the state's device) at EM boundary `it` (an int or
    a 0-d tensor) → (state', bits int32 [M]).  Tensor code with no host
    read; the state's tensors are not modified in place."""
    def armed(step):
        return step >= 0

    # persistent divergence: η goes NaN at every boundary from the step on
    nan_on = armed(fp.nan_eta_step) & (fp.nan_eta_step <= it)
    eta = torch.where(nan_on[:, None], float("nan"), state.eta)

    # persistent count corruption: finite but breaking the invariants
    cor = armed(fp.corrupt_counts_step) & (fp.corrupt_counts_step <= it)
    ndt = state.ndt.clone()
    ndt[:, 0, 0] += torch.where(cor, 7.0, 0.0)
    ntw = state.ntw.clone()
    ntw[:, 0, 0] = torch.where(cor, -5.0, state.ntw[:, 0, 0])

    # a one-shot kill: the worker's state is lost once
    kill = armed(fp.kill_step) & (fp.kill_step == it)
    eta = torch.where(kill[:, None], float("nan"), eta)
    ndt = torch.where(kill[:, None, None], float("nan"), ndt)

    strag = armed(fp.straggle_step) & (fp.straggle_step == it)
    bits = kill.to(torch.int32) * F_KILLED | strag.to(torch.int32) * \
        F_STRAGGLER
    return GibbsState(z=state.z, ndt=ndt, ntw=ntw, nt=state.nt,
                      eta=eta), bits


# ------------------------------------------------------------ constructors

def no_faults(m: int, *, device="cuda") -> FaultPlan:
    never = torch.full((m,), -1, dtype=torch.int32,
                       device=resolve_device(device))
    return FaultPlan(never, never, never, never)


def poison(m: int, chain: int, step: int, kind: str = "nan", *,
           device="cuda") -> FaultPlan:
    """One fault: `kind` on `chain` at EM boundary `step`."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    dev = resolve_device(device)
    cols = [torch.full((m,), -1, dtype=torch.int32) for _ in _KINDS]
    cols[_KINDS.index(kind)][chain] = step
    return FaultPlan(*(c.to(dev) for c in cols))


def random_fault_plan(seed: int, m: int, n_boundaries: int, *,
                      p_fault: float = 0.3, device="cuda") -> FaultPlan:
    """Seeded chaos: each chain draws whether it faults (probability
    `p_fault`), which kind, and at which boundary.  The draws come from a
    CPU generator seeded with `seed`, so the same seed gives the same
    plan on any device."""
    g = torch.Generator().manual_seed(seed)
    hit = torch.rand((m,), generator=g) < p_fault
    kind = torch.randint(0, len(_KINDS), (m,), generator=g)
    step = torch.randint(0, max(n_boundaries, 1), (m,), generator=g,
                         dtype=torch.int32)
    dev = resolve_device(device)
    never = torch.full((m,), -1, dtype=torch.int32)
    return FaultPlan(*(torch.where(hit & (kind == i), step, never).to(dev)
                       for i in range(len(_KINDS))))


# ------------------------------------------------- faults of the storage

def truncate_chain_file(ckpt_dir: str, step: int, chain: int,
                        keep_bytes: int = 16) -> str:
    """A torn write: truncate ONE chain's .npz of a published checkpoint
    to `keep_bytes`.  The manifest stays valid: every other chain
    restores, and the supervisor restarts this one from a fresh init."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}",
                        f"chain_{chain:03d}.npz")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(min(keep_bytes, size))
    return path


def mislabel_manifest(ckpt_dir: str, step: int, wrong_step: int) -> str:
    """Rewrite a published checkpoint's manifest to record the wrong step
    (a hand-copied or torn checkpoint), which `read_manifest` refuses."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["step"] = wrong_step
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


# ------------------------------------------------- faults of the serving

class VirtualClock:
    """A settable clock for simulated time: every deadline, rate limit
    and latency decision of a service built with `clock=` reads simulated
    seconds."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def set(self, t: float):
        self._t = float(t)

    def advance(self, dt: float):
        self._t += float(dt)


def poison_model_table(models, chain: int, kind: str = "nan_phi"):
    """Corrupt ONE chain's exported model (a copy; the input is left as
    it was).  Each kind trips one `core.supervisor.model_status` probe:
    "nan_phi" F_NAN_PHI, "nan_eta" F_NAN_ETA, "bad_rowsum" F_PHI_ROWSUM,
    "nan_mse" F_NAN_MSE."""
    phi, eta = models.phi.clone(), models.eta.clone()
    mse = models.train_mse.clone()
    if kind == "nan_phi":
        phi[chain, 0, 0] = float("nan")
    elif kind == "nan_eta":
        eta[chain, 0] = float("nan")
    elif kind == "bad_rowsum":
        phi[chain, 0, :] = phi[chain, 0, :] * 3.0
    elif kind == "nan_mse":
        mse[chain] = float("inf")
    else:
        raise ValueError(
            "kind must be one of ('nan_phi', 'nan_eta', 'bad_rowsum', "
            f"'nan_mse'), got {kind!r}")
    return dataclasses.replace(models, phi=phi, eta=eta, train_mse=mse)


def inject_dispatch_delay(service, delay_s: float):
    """Make every dispatch of `service` take `delay_s` more seconds (a
    straggling card).  It wraps the dispatch-cache lookup
    (`_dispatch_fn`), not the cached callables, so the captures and the
    no-recapture property are untouched; the dispatch is waited for (the
    card synchronized) before the delay, which advances a `VirtualClock`
    without sleeping.  Returns an undo callable."""
    orig = service._dispatch_fn
    clock = service._clock

    def delayed(plan_key):
        fn = orig(plan_key)

        def run(*args):
            out = fn(*args)
            if service.device.type == "cuda":
                torch.cuda.synchronize(service.device)
            if isinstance(clock, VirtualClock):
                clock.advance(delay_s)
            else:
                time.sleep(delay_s)
            return out

        return run

    service._dispatch_fn = delayed

    def undo():
        service._dispatch_fn = orig

    return undo


def burst_trace(seed: int, vocab: int, max_len: int, *,
                base_rate: float, burst_rate: float, n_steady: int,
                n_burst: int, n_tail: int, len_lam: float = 12.0):
    """A deterministic open-loop arrival trace: steady Poisson traffic at
    `base_rate` requests/s, a burst at `burst_rate`, then a steady tail.
    Returns [(arrival_time_s, int32 tokens)] in time order; the numpy
    draws are the reference's, so a seed gives its trace bit for bit."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for n, rate in ((n_steady, base_rate), (n_burst, burst_rate),
                    (n_tail, base_rate)):
        for _ in range(n):
            t += rng.exponential(1.0 / rate)
            L = int(np.clip(rng.poisson(len_lam), 1, max_len))
            out.append((t, rng.integers(0, vocab, L).astype(np.int32)))
    return out


# ------------------------------------------ the elastic runner's events
#
# The elastic runner (`repro_torch.launch.elastic`) takes a timeline of
# environment events, applied on the host at round boundaries, so that a
# chaos run is a function of (seed, event list) and replays bit for bit.

class ElasticEvent(NamedTuple):
    """One environment event of the elastic runner's timeline.

    kind      "device_loss" (the device leaves the pool; its chains
              restore from the newest durable checkpoint, or are
              quarantined without a checkpoint directory), "preempt"
              (the SIGTERM notice: drain the checkpoints and stop,
              resumable, at the next round boundary), "straggle" (the
              device runs `delay_s` slow for `rounds` rounds: correct,
              merely late) or "device_join" (a device joins the pool and
              the chains repack over it at the boundary);
    at_round  the wall round at whose start the event applies (from 0);
    device    the pool id it targets (ignored by "preempt");
    delay_s   simulated seconds added a round ("straggle" only);
    rounds    how many rounds in a row the straggle lasts."""

    kind: str
    at_round: int
    device: int = 0
    delay_s: float = 0.0
    rounds: int = 1


_ELASTIC_KINDS = ("device_loss", "preempt", "straggle", "device_join")


def random_elastic_events(seed: int, *, n_rounds: int, n_devices: int,
                          n_events: int = 2,
                          kinds=("device_loss", "straggle")) -> list:
    """Seeded elastic chaos: `n_events` events over the round timeline,
    drawn from numpy's `default_rng(seed)` in the reference's order, so a
    seed names the same event list in both packages.  Device losses never
    drain the pool below one device (a loss past that is a straggle)."""
    for k in kinds:
        if k not in _ELASTIC_KINDS:
            raise ValueError(
                f"kinds must be among {_ELASTIC_KINDS}, got {k!r}")
    g = np.random.default_rng(seed)
    events, losses = [], 0
    for _ in range(n_events):
        kind = kinds[int(g.integers(0, len(kinds)))]
        if kind == "device_loss" and losses >= n_devices - 1:
            kind = "straggle"
        if kind == "device_loss":
            losses += 1
        events.append(ElasticEvent(
            kind=kind,
            at_round=int(g.integers(1, max(n_rounds, 2))),
            device=int(g.integers(0, n_devices)),
            delay_s=float(g.uniform(0.5, 3.0)),
            rounds=int(g.integers(1, 4))))
    return sorted(events, key=lambda e: e.at_round)


def replay_open_loop(service, trace, clock: VirtualClock):
    """Replay an arrival `trace` through `service` open loop on a
    `VirtualClock` (the service built with `auto_flush=False` and
    `clock=clock`): the dispatcher flushes full micro-batches whenever it
    is free, and arrivals keep landing while a dispatch is in flight,
    which fills the bounded queue and expires deadlines in a burst.
    Returns {req_id: arrival_time_s}."""
    if service.svc.auto_flush:
        raise ValueError("replay_open_loop needs auto_flush=False — "
                         "auto-flush serves synchronously at submit "
                         "time and no queueing can ever build up")
    batch = service.svc.batch_docs
    free_at = 0.0
    arrivals = {}
    for t_arr, doc in trace:
        # the dispatcher catches up on what it could run before t_arr
        while free_at <= t_arr and len(service._pending) >= batch:
            clock.set(free_at)
            service.flush()
            free_at = clock.now()
        clock.set(t_arr)
        rid = service.submit(doc)
        arrivals[rid] = t_arr
    clock.set(max(free_at, clock.now()))
    service.drain()
    return arrivals
