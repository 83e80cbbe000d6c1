"""Elastic, preemption-tolerant ensemble training.

The port of the reference's `launch/elastic.py`.  Chains never
communicate, so where a chain runs is scheduling metadata: its Gibbs
stream depends on its own shard, its own generators (seeded by its
global id, its restart epoch and its round, `core.rng`) and its own
state, never on its device or its neighbours.  This module turns that
into elasticity:

  * **dynamic placement**: `DevicePool` is a membership view (ordered
    device ids and an epoch bumped on every change) and
    `compute_placement` packs the M chains onto it in balanced
    contiguous groups.  Placement changes at round boundaries only and
    never reaches the round: every wall round runs the same [M]-wide
    round plan (`ChainSupervisor.make_round_plan`, built once), so a
    repack after a device loss builds nothing, and the survivors' bits
    are those of a run launched on the surviving layout.
  * **per-chain progress**: each chain draws its round from its own
    round counter (`SupervisorDraws.round` with an [M] round vector), so
    one [M]-wide round serves chains at different logical rounds: a chain
    restored after a device loss replays its round s while the others run
    round r.  The catch-up loop freezes the finished chains with a
    selective merge (`torch.where` on the active mask, which copies bits)
    until every alive chain has run R rounds, so the final ensemble is
    bit for bit an undisturbed run's, device loss or not.
  * **round deadlines and stragglers**, on the `VirtualClock` of the
    chaos suite: a device whose round passes `deadline_s` has its chains
    flagged `F_STRAGGLER` (correct, merely late: a flag only);
    `straggle_rounds` misses in a row evict the device (its chains
    repack, state intact); `speculative_replace` moves the slow device's
    chains to the least loaded on-time device at the first miss.
  * **asynchronous crash-consistent checkpoints**
    (`checkpoint.AsyncCheckpointManager`): a snapshot to host memory at
    the boundary, published by a writer thread through the atomic
    rename; a save is taken only once the previous one is durable, so a
    resume loses at most `ckpt_every` rounds.  SIGTERM, or a "preempt"
    `ElasticEvent`, is latched by `PreemptionSignal` and honoured at the
    next boundary: flush, one synchronous save with the host bookkeeping
    (progress, alive, epoch, restarts, wall round, pool) in the
    manifest's `extra`, stop resumable.

A lost device's chains restore from the newest durable checkpoint with
no epoch bump (the state was healthy, the environment failed, and an
exact replay is what makes recovery exact); a torn chain file falls back
to a fresh init of that chain with an epoch bump; without a checkpoint
directory they are quarantined, exact as always.  A slow device's
chains are never restored: they are correct.

The devices here are simulated, as in the reference: one process runs
every chain on one card (`launch.slda_parallel` runs real processes).
Where the reference counts jit traces of the round (`round_traces`), the
port has no tracing: `ElasticReport.round_plans` counts the round plans
built, one for any run.  Each wall round's host-clock ms and its
checkpoint's ride in `history`.
"""
from __future__ import annotations

import dataclasses
import signal as _signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointManager,
                                    CheckpointManager, read_manifest,
                                    restore_chain, restore_elastic,
                                    save_checkpoint)
from repro_torch.core.parallel import _shards
from repro_torch.core.supervisor import (F_KILLED, F_STRAGGLER,
                                         ChainSupervisor, SupervisorDraws,
                                         _chain_of, _with_chain,
                                         predict_and_combine, seeded_draws)
from repro_torch.core.types import GibbsState, SLDAConfig
from repro_torch.device import resolve_device
from repro_torch.testing.faults import ElasticEvent, VirtualClock

__all__ = ["DevicePool", "compute_placement", "PreemptionSignal",
           "ElasticConfig", "ElasticReport", "ElasticRunner",
           "elastic_run_average", "ElasticEvent"]


# ----------------------------------------------------------- membership

class DevicePool:
    """Ordered device membership and an epoch bumped on every change.  A
    view: it holds ids (ints or strings), not devices, and no round ever
    sees it."""

    def __init__(self, devices):
        if isinstance(devices, int):
            devices = list(range(devices))
        if not devices:
            raise ValueError("device pool cannot start empty")
        self._ids = list(devices)
        self.epoch = 0
        self.history = [("init", tuple(self._ids))]

    @property
    def ids(self):
        return tuple(self._ids)

    def __len__(self):
        return len(self._ids)

    def __contains__(self, dev):
        return dev in self._ids

    def lose(self, dev):
        if dev not in self._ids:
            return False
        if len(self._ids) == 1:
            raise RuntimeError(
                f"device {dev!r} is the last pool member — losing it "
                "leaves nowhere to run; treat as total failure upstream")
        self._ids.remove(dev)
        self.epoch += 1
        self.history.append(("lose", dev))
        return True

    def join(self, dev):
        if dev in self._ids:
            return False
        self._ids.append(dev)
        self.epoch += 1
        self.history.append(("join", dev))
        return True


def compute_placement(chain_ids, devices) -> dict:
    """Balanced placement: the chains, sorted, split into len(devices)
    contiguous groups, the earlier devices taking the remainder.  A
    function of (chains, device order) alone, so an event log replays the
    same placements."""
    devices = list(devices)
    if not devices:
        raise ValueError("cannot place chains on an empty pool")
    chains = sorted(int(c) for c in chain_ids)
    per, rem = divmod(len(chains), len(devices))
    out, i = {}, 0
    for j, dev in enumerate(devices):
        take = per + (1 if j < rem else 0)
        out[dev] = tuple(chains[i:i + take])
        i += take
    return out


# ---------------------------------------------------- preemption signal

class PreemptionSignal:
    """A latched preemption notice.  `install()` hooks SIGTERM (the cloud
    preemption convention), so an outside notice and a "preempt"
    `ElasticEvent` set the same flag; the runner honours it at the next
    round boundary."""

    def __init__(self):
        self.triggered = False
        self._prev = None

    def set(self, *_args):
        self.triggered = True

    def clear(self):
        self.triggered = False

    def install(self):
        self._prev = _signal.signal(_signal.SIGTERM, self.set)
        return self

    def uninstall(self):
        if self._prev is not None:
            _signal.signal(_signal.SIGTERM, self._prev)
            self._prev = None


# -------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """The pool's policy (a chain's health and recovery stay in
    `HealthConfig` / `RecoveryPolicy`).

    round_iters          EM iterations a round; must divide cfg.n_iters,
                         so that a chain replaying round s after a
                         restore replays the round it first ran
    async_ckpt           `AsyncCheckpointManager`, else synchronous saves
    ckpt_every           a checkpoint every k wall rounds: a resume or a
                         restore loses at most k rounds
    keep_checkpoints     steps kept on disk
    catch_up             run extra wall rounds until every alive chain
                         has run R rounds (exact recovery); False: a fixed
                         wall budget, laggards reported
    device_round_s       simulated seconds a device takes a round
    deadline_s           the round deadline; None disables the straggler
                         policy
    straggle_rounds      misses in a row before a device is evicted
    speculative_replace  move the slowest device's chains to the least
                         loaded on-time device at the first miss"""

    round_iters: int = 2
    async_ckpt: bool = True
    ckpt_every: int = 1
    keep_checkpoints: int = 3
    catch_up: bool = True
    device_round_s: float = 1.0
    deadline_s: float | None = None
    straggle_rounds: int = 2
    speculative_replace: bool = False


@dataclasses.dataclass
class ElasticReport:
    """What an elastic run observed, the pool-level twin of
    `SupervisorReport`: `alive`, `status` (OR of every round) and
    `restarts` as there; `progress`, each chain's completed rounds (R
    everywhere after a clean or fully caught-up run); `round_plans`, the
    round plans the supervisor built (one for any run: placement never
    reaches the round)."""

    alive: np.ndarray
    status: np.ndarray
    restarts: np.ndarray
    progress: np.ndarray
    wall_rounds: int
    logical_rounds: int
    history: list
    pool_history: list
    placements: list
    preempted: bool = False
    resume_round: int | None = None
    sim_seconds: float = 0.0
    round_plans: int = 0
    yhat_chains: np.ndarray = None
    yhat_train_chains: np.ndarray = None

    def alive_mask(self, device="cuda") -> torch.Tensor:
        return torch.as_tensor(self.alive, dtype=torch.float32,
                               device=resolve_device(device))

    def quarantined(self) -> list:
        return [int(c) for c in np.nonzero(~self.alive)[0]]

    def laggards(self) -> list:
        return [int(c) for c in
                np.nonzero(self.alive & (self.progress
                                         < self.logical_rounds))[0]]


def _merge(new: GibbsState, old: GibbsState, active) -> GibbsState:
    """`new` where the chain was active this wall round, else `old`: a
    frozen chain passes through bit for bit (`torch.where` copies)."""
    act = torch.as_tensor(np.asarray(active), dtype=torch.bool,
                          device=old.eta.device)

    def pick(n, o):
        return torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
    return GibbsState(z=tuple(pick(n, o) for n, o in zip(new.z, old.z)),
                      ndt=pick(new.ndt, old.ndt), ntw=pick(new.ntw, old.ntw),
                      nt=pick(new.nt, old.nt), eta=pick(new.eta, old.eta))


# ---------------------------------------------------------------- runner

class ElasticRunner:
    """Drives `ChainSupervisor.run_round` under a dynamic device pool.

    One process simulates the pool, as the reference does: every wall
    round runs the whole [M]-wide round once and the selective merge
    keeps only the active chains' new state, so chains at different
    logical rounds, on any placement, share one round plan.  Membership,
    placement, deadlines and restores are host bookkeeping between
    rounds.  `shards` is the chain-sharded training schedule on the run's
    device, as `ChainSupervisor` takes it."""

    def __init__(self, shards, cfg: SLDAConfig, *, devices=2,
                 elastic: ElasticConfig | None = None, health=None,
                 recovery=None, ckpt_dir=None, fault_hook=None,
                 clock: VirtualClock | None = None, events=(),
                 preemption: PreemptionSignal | None = None):
        self.elastic = elastic or ElasticConfig()
        if cfg.n_iters % self.elastic.round_iters:
            raise ValueError(
                f"round_iters={self.elastic.round_iters} must divide "
                f"cfg.n_iters={cfg.n_iters}: elastic replay needs every "
                "round to be the same round")
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.sup = ChainSupervisor(
            shards, cfg, health=health, recovery=recovery,
            ckpt_dir=ckpt_dir, round_iters=self.elastic.round_iters,
            fault_hook=fault_hook,
            keep_checkpoints=self.elastic.keep_checkpoints)
        self.pool = DevicePool(devices)
        self.clock = clock or VirtualClock()
        self.events = sorted(events, key=lambda e: e.at_round)
        self.preemption = preemption or PreemptionSignal()
        self.placement: dict = {}
        if ckpt_dir is not None:
            mgr_cls = (AsyncCheckpointManager if self.elastic.async_ckpt
                       else CheckpointManager)
            self.manager = mgr_cls(ckpt_dir,
                                   interval=self.elastic.ckpt_every,
                                   keep=self.elastic.keep_checkpoints)
        else:
            self.manager = None

    # ---- host bookkeeping

    def _extra(self, bk, wall):
        return {"progress": [int(x) for x in bk["progress"]],
                "alive": [bool(x) for x in bk["alive"]],
                "epoch": [int(x) for x in bk["epoch"]],
                "restarts": [int(x) for x in bk["restarts"]],
                "wall_round": int(wall),
                "pool": [int(d) for d in self.pool.ids]}

    def _restore_victim(self, state, c, bk, events, draws):
        """Device loss, chain c: its state from the newest durable
        checkpoint and its progress rewound to the manifest's, with no
        epoch bump (the state was healthy; replaying its rounds exactly is
        what makes it bit-equal to a chain that never moved).  A torn or
        corrupt chain file falls back to a fresh init with an epoch bump
        (that chain did lose its history)."""
        durable = self.manager.latest_durable()
        if durable is None:
            bk["alive"][c] = False
            bk["latched"][c] |= F_KILLED
            events.append({"chain": c, "action": "quarantine_no_checkpoint"})
            return state
        try:
            chain_state = restore_chain(self.ckpt_dir, durable, c,
                                        _chain_of(state, c))
            extra = read_manifest(self.ckpt_dir, durable).get("extra", {})
            rewind = int(extra.get("progress", [0] * (c + 1))[c])
            events.append({"chain": c, "action":
                           f"restore_step_{durable}_progress_{rewind}"})
        except Exception as e:  # noqa: BLE001 — a torn file stays local
            bk["epoch"][c] += 1
            rewind = 0
            fresh = self.sup.plan.init_states(draws.fresh(bk["epoch"]))
            chain_state = _chain_of(fresh, c)
            events.append({"chain": c, "action": "restore_corrupt_fresh",
                           "error": repr(e)})
        bk["progress"][c] = rewind
        # amnesty while it replays: its MSE lags the ensemble's until it
        # has caught up
        bk["grace"][c] = int(max(bk["progress"]) - rewind) + 1
        return _with_chain(state, c, chain_state)

    def _record_placement(self, placements, why):
        placements.append({"why": why, "pool_epoch": self.pool.epoch,
                           "placement": {str(d): list(cs) for d, cs
                                         in self.placement.items()}})

    def _repack(self, bk, placements, why):
        alive_chains = [c for c in range(len(bk["alive"]))
                        if bk["alive"][c]]
        self.placement = compute_placement(alive_chains, self.pool.ids)
        self._record_placement(placements, why)

    def _apply_event(self, ev, state, bk, events, placements, straggles,
                     draws):
        if ev.kind == "preempt":
            self.preemption.set()
            events.append({"action": "preempt_notice"})
        elif ev.kind == "device_loss":
            if not self.pool.lose(ev.device):
                events.append({"action": "device_loss_noop",
                               "device": ev.device})
                return state
            victims = [c for c in self.placement.get(ev.device, ())
                       if bk["alive"][c]]
            events.append({"action": "device_loss", "device": ev.device,
                           "victims": victims})
            if self.manager is not None:
                # settle the write in flight first: the last completed
                # round's snapshot is already taken, so every victim then
                # restores from the same (newest) step
                self.manager.flush()
            for c in victims:
                if self.manager is None:
                    bk["alive"][c] = False
                    bk["latched"][c] |= F_KILLED
                    events.append({"chain": c,
                                   "action": "quarantine_no_checkpoint"})
                else:
                    state = self._restore_victim(state, c, bk, events,
                                                 draws)
            self._repack(bk, placements, f"device_loss:{ev.device}")
        elif ev.kind == "device_join":
            if self.pool.join(ev.device):
                events.append({"action": "device_join",
                               "device": ev.device})
                self._repack(bk, placements, f"device_join:{ev.device}")
        elif ev.kind == "straggle":
            straggles.append([ev.device, float(ev.delay_s),
                              int(ev.rounds)])
            events.append({"action": "straggle_start",
                           "device": ev.device, "delay_s": ev.delay_s,
                           "rounds": ev.rounds})
        else:
            raise ValueError(f"unknown elastic event kind {ev.kind!r}")
        return state

    def _round_clock(self, bk, events, placements, straggles, late):
        """Advance the virtual clock by the wall round's slowest device and
        apply the straggler policy (flag, evict, or re-place).  Returns
        each device's finish time."""
        el = self.elastic
        finish = {}
        for dev in self.pool.ids:
            delay = sum(s[1] for s in straggles
                        if s[0] == dev and s[2] > 0)
            finish[dev] = el.device_round_s + delay
        for s in straggles:
            if s[2] > 0:
                s[2] -= 1
        self.clock.advance(max(finish.values()) if finish else 0.0)
        if el.deadline_s is None:
            return finish
        on_time = [d for d in self.pool.ids if finish[d] <= el.deadline_s]
        for dev in list(self.pool.ids):
            if finish[dev] <= el.deadline_s:
                late[dev] = 0
                continue
            late[dev] = late.get(dev, 0) + 1
            for c in self.placement.get(dev, ()):
                bk["latched"][c] |= F_STRAGGLER
            events.append({"action": "deadline_miss", "device": dev,
                           "finish_s": finish[dev],
                           "consecutive": late[dev]})
            if late[dev] >= el.straggle_rounds and len(self.pool) > 1:
                # slow is not dead: evict the device, keep the chains
                self.pool.lose(dev)
                events.append({"action": "straggler_evicted",
                               "device": dev})
                self._repack(bk, placements, f"straggler:{dev}")
            elif el.speculative_replace and on_time:
                target = min(on_time,
                             key=lambda d: len(self.placement.get(d, ())))
                moved = self.placement.get(dev, ())
                if moved and target != dev:
                    self.placement[target] = tuple(
                        sorted(self.placement.get(target, ()) + moved))
                    self.placement[dev] = ()
                    events.append({"action": "speculative_replace",
                                   "device": dev, "target": target,
                                   "chains": list(moved)})
                    self._record_placement(
                        placements, f"speculative:{dev}->{target}")
        return finish

    def _drain(self, state, bk, wall, events):
        """The preemption drain: flush the write in flight, publish one
        synchronous checkpoint with the whole host bookkeeping, and stop
        resumable.  A resume loses at most the round that was in flight
        when the notice came."""
        if self.manager is not None:
            self.manager.flush()
            save_checkpoint(self.ckpt_dir, wall, state,
                            extra=self._extra(bk, wall))
            self.manager._gc()
        events.append({"action": "preempt_drain", "wall_round": wall,
                       "durable": (self.manager.latest_durable()
                                   if self.manager else None)})

    # ---- the wall-round loop

    def train(self, seed: int | None = None, *,
              draws: SupervisorDraws | None = None, resume: bool = False):
        """Train the M chains elastically from `seed` (`seeded_draws`: a
        chain's draws depend on its id, epoch and round alone, whatever
        the pool) or from explicit `draws`.  Returns (GibbsState,
        SLDAModel, ElasticReport), as `ChainSupervisor.train`.  With
        `resume=True` the run continues from the newest durable
        checkpoint in `ckpt_dir` (from the start if there is none)."""
        sup, el = self.sup, self.elastic
        plan = sup.plan
        if (seed is None) == (draws is None):
            raise ValueError("pass exactly one of seed / draws")
        if draws is None:
            draws = seeded_draws(seed, plan)
        m = plan.n_chains
        R = self.cfg.n_iters // el.round_iters
        round_plan = sup.make_round_plan(el.round_iters)
        bpr = round_plan.n_boundaries()
        state = plan.init_states(draws.z_init)

        bk = {"alive": np.ones(m, bool), "epoch": np.zeros(m, np.int32),
              "restarts": np.zeros(m, np.int32),
              "grace": np.zeros(m, np.int32),
              "latched": np.zeros(m, np.uint32),
              "progress": np.zeros(m, np.int32)}
        wall = 0
        resumed_from = None
        if resume:
            if self.manager is None:
                raise ValueError("resume=True needs a ckpt_dir")
            durable = self.manager.latest_durable()
            if durable is not None:
                fresh = state
                state, info = restore_elastic(
                    self.ckpt_dir, durable, state,
                    lambda i: _chain_of(fresh, i))
                extra = info["extra"]
                for name in ("progress", "alive", "epoch", "restarts"):
                    if name in extra:
                        bk[name][:] = np.asarray(extra[name])
                wall = int(extra.get("wall_round", durable))
                resumed_from = durable
        history, placements = [], []
        straggles, late = [], {}
        self._repack(bk, placements, "resume" if resumed_from is not None
                     else "init")
        pending = list(self.events)
        max_wall = R * (2 + m * max(1, sup.recovery.max_restarts))

        while True:
            active = bk["alive"] & (bk["progress"] < R)
            if not active.any():
                break
            if not el.catch_up and wall >= R:
                break
            if wall >= max_wall:
                raise RuntimeError(
                    f"elastic loop exceeded {max_wall} wall rounds — "
                    "restart thrash; see the event history")
            events = []
            for ev in [e for e in pending if e.at_round <= wall]:
                pending.remove(ev)
                state = self._apply_event(ev, state, bk, events,
                                          placements, straggles, draws)
            if self.preemption.triggered:
                self._drain(state, bk, wall, events)
                history.append({"wall_round": wall, "events": events})
                break
            active = bk["alive"] & (bk["progress"] < R)
            if not active.any():
                history.append({"wall_round": wall, "events": events})
                break

            t0 = time.perf_counter()
            it0 = int(bk["progress"].min()) * bpr
            new_state, status_np = sup.run_round(
                round_plan, draws.round(bk["progress"].copy(),
                                        bk["epoch"].copy(), el.round_iters),
                state, bk["alive"], it0)
            state = _merge(new_state, state, active)
            status_np = np.where(active, status_np, 0).astype(np.uint32)
            state = sup.apply_recovery(
                state, status_np, alive=bk["alive"], epoch=bk["epoch"],
                restarts=bk["restarts"], grace=bk["grace"], draws=draws,
                events=events)
            reset = set()
            for e in events:
                # a probe's restart resets that chain's logical clock: a
                # restore replays from the checkpoint's round, a fresh
                # init starts over
                if e.get("action", "").startswith("restart_from_step_"):
                    step = int(e["action"].rsplit("_", 1)[1])
                    prog = read_manifest(self.ckpt_dir, step).get(
                        "extra", {}).get("progress")
                    bk["progress"][e["chain"]] = (
                        int(prog[e["chain"]]) if prog is not None else 0)
                    reset.add(e["chain"])
                elif e.get("action") == "restart_fresh_init":
                    bk["progress"][e["chain"]] = 0
                    reset.add(e["chain"])
            bk["grace"] = np.maximum(bk["grace"] - 1, 0)
            bk["latched"] |= status_np
            sup.check_min_alive(bk["alive"], bk["latched"])
            # a restarted chain rewound its clock: its work this round is
            # gone, so it takes no progress credit
            advance = active & bk["alive"]
            for c in reset:
                advance[c] = False
            bk["progress"] = bk["progress"] + advance.astype(np.int32)
            round_ms = (time.perf_counter() - t0) * 1e3
            finish = self._round_clock(bk, events, placements, straggles,
                                       late)
            wall += 1
            t1 = time.perf_counter()
            if self.manager is not None:
                self.manager.maybe_save(wall, state,
                                        extra=self._extra(bk, wall))
            ckpt_ms = (time.perf_counter() - t1) * 1e3
            history.append({"wall_round": wall,
                            "progress": [int(x) for x in bk["progress"]],
                            "status": [int(s) for s in status_np],
                            "finish_s": {str(d): t
                                         for d, t in finish.items()},
                            "round_ms": round_ms, "ckpt_ms": ckpt_ms,
                            "events": events})

        if self.manager is not None and not self.preemption.triggered:
            self.manager.flush()
        models = plan._export(state)
        state = dataclasses.replace(
            state, z=plan.corpus.merge_padded(state.z, draws.z_init))
        report = ElasticReport(
            alive=bk["alive"], status=bk["latched"],
            restarts=bk["restarts"], progress=bk["progress"],
            wall_rounds=wall, logical_rounds=R, history=history,
            pool_history=list(self.pool.history), placements=placements,
            preempted=self.preemption.triggered,
            resume_round=resumed_from, sim_seconds=self.clock.now(),
            round_plans=len(sup._round_plans))
        return state, models, report


# ------------------------------------------------ end-to-end entry point

def elastic_run_average(seed: int, train, test, cfg: SLDAConfig, m: int, *,
                        devices=2, rule: str = "weighted",
                        elastic: ElasticConfig | None = None, health=None,
                        recovery=None, ckpt_dir=None, events=(),
                        clock=None, preemption=None, resume: bool = False,
                        device="cuda"):
    """The elastic form of `supervised_run_average`: train M chains under
    the elastic runner, predict with every chain, combine under the final
    alive mask.  Training draws `seeded_draws(seed, ...)` and prediction
    the draws `supervised_run_average` uses for the same seed.  Returns
    (ŷ [D_test], ElasticReport)."""
    dev = resolve_device(device)
    train, test = train.to(dev), test.to(dev)
    runner = ElasticRunner(_shards(train, m, cfg, dev), cfg,
                           devices=devices, elastic=elastic, health=health,
                           recovery=recovery, ckpt_dir=ckpt_dir,
                           events=events, clock=clock,
                           preemption=preemption)
    _, models, report = runner.train(seed, resume=resume)
    return predict_and_combine(seed, models, train, test, cfg, rule,
                               report), report
