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
signature in the state.  The serving and elastic helpers of the
reference (`inject_dispatch_delay`, `burst_trace`, `replay_open_loop`,
`ElasticEvent`, `random_elastic_events`) come with the services they
drive.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

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
