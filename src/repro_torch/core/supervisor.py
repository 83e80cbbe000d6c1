"""Chain supervisor: health checks, quarantine, checkpointed restart.

The paper's central property, M chains that never communicate, is also
a fault-isolation guarantee: a NaN-poisoned, diverged or dead chain can
be quarantined or restarted without touching any other chain, and the
ensemble's prediction degrades exactly (not approximately) through the
alive masks of `core.combine`.  This layer puts that to use:

  * **health checks at every EM boundary**, attached at
    `ExecutionPlan.train_em(em_hook=...)`: per-chain NaN/Inf flags on
    η, ntw and ndt, the count invariants (Σ ndt = Σ lengths, min ntw ≥
    0), and a train-MSE robust-z outlier score (`metrics.robust_z`),
    folded into an int32 status vector [M] on the device.  The probe is
    tensor code with no host synchronization; the host reads the vector
    once a round;
  * **quarantine**: an unhealthy chain gets `alive=False`, which every
    combine rule honours: because chains never communicate, the
    surviving sub-ensemble's prediction is bit-identical to one that
    never held the dead chain;
  * **recovery**: bounded restart from the latest checkpoint
    (`checkpoint.restore_chain`) with exponential backoff; the restarted
    chain draws from a new stream (its restart epoch is part of its
    generators' seeds), so a transient failure is not replayed draw for
    draw.  With the restart budget spent, or no checkpoint directory,
    the policy falls back to quarantine.

Decision table:

  fault class                 bits                       action
  --------------------------- -------------------------- ----------------
  NaN/Inf state               F_NAN_{ETA,NTW,NDT}        restart → quarantine
  count-invariant violation   F_NDT_SUM, F_NTW_NEG       restart → quarantine
  dead worker                 F_KILLED                   restart → quarantine
  statistical divergence      F_MSE_OUTLIER              quarantine only
  straggler                   F_STRAGGLER                flag only

A hard fault means the chain's state is unusable, and a restart from the
last checkpoint is the only way to recover the lane.  A diverged but
finite chain works (dropping it is exact, restarting it would re-run the
same posterior), and a straggler is correct, merely late.

The bits have the reference package's values, so a status vector reads
the same in both.  Training runs in rounds of `round_iters` EM
iterations: each round starts with a checkpoint, runs `train_em` with
the health hook, and ends with the one host read of the status.  A
round's draws come from generators seeded by (seed, stream, chain,
restart epoch, round), and a fresh re-init's from a stream of its own,
or from explicit draws (`SupervisorDraws`) that a caller hands in.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, \
    restore_chain
from repro_torch.device import resolve_device
from repro_torch.metrics.ensemble import robust_z

from . import combine, rng
from .plan import ExecutionPlan, build_plan
from .types import GibbsState, SLDAConfig, _concat_corpora

# ---------------------------------------------------- per-chain status bits

F_NAN_ETA = 1 << 0       # non-finite regression weights η
F_NAN_NTW = 1 << 1       # non-finite topic-word counts
F_NAN_NDT = 1 << 2       # non-finite doc-topic counts
F_NDT_SUM = 1 << 3       # Σ ndt drifted from Σ true lengths
F_NTW_NEG = 1 << 4       # negative topic-word count
F_MSE_OUTLIER = 1 << 5   # train-MSE robust-z outlier (diverged)
F_KILLED = 1 << 6        # dead worker (reported by the fault layer)
F_STRAGGLER = 1 << 7     # late worker (flag only)

# serve-time bits (model-table screening and dispatch health)
F_NAN_PHI = 1 << 8       # non-finite topic-word table φ̂
F_PHI_ROWSUM = 1 << 9    # φ̂ rows are not probability distributions
F_NAN_MSE = 1 << 10      # non-finite or negative train MSE
F_NAN_YHAT = 1 << 11     # non-finite served prediction at dispatch

#: state-corrupting faults: a restart from a checkpoint is worth trying
HARD_FAULTS = (F_NAN_ETA | F_NAN_NTW | F_NAN_NDT | F_NDT_SUM | F_NTW_NEG
               | F_KILLED)
#: statistical faults: the lane works, and quarantine is exact
SOFT_FAULTS = F_MSE_OUTLIER
#: model-table faults: a chain whose exported model trips one cannot serve
MODEL_FAULTS = F_NAN_PHI | F_PHI_ROWSUM | F_NAN_ETA | F_NAN_MSE

_BIT_NAMES = {
    F_NAN_ETA: "nan_eta", F_NAN_NTW: "nan_ntw", F_NAN_NDT: "nan_ndt",
    F_NDT_SUM: "ndt_sum", F_NTW_NEG: "ntw_neg",
    F_MSE_OUTLIER: "mse_outlier", F_KILLED: "killed",
    F_STRAGGLER: "straggler",
    F_NAN_PHI: "nan_phi", F_PHI_ROWSUM: "phi_rowsum",
    F_NAN_MSE: "nan_mse", F_NAN_YHAT: "nan_yhat",
}


def describe_status(bits: int) -> list:
    """The names of the set status bits."""
    return [name for bit, name in _BIT_NAMES.items() if bits & bit]


class EnsembleHealthError(RuntimeError):
    """The alive fraction fell below `RecoveryPolicy.min_alive_frac`: the
    ensemble is no longer trustworthy."""


# ----------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """What the probe checks at every EM boundary: elementwise reductions
    over the state, no host reads."""

    check_nan: bool = True
    check_counts: bool = True
    check_mse: bool = True
    count_tol: float = 0.5   # counts are exact ±1 float32 adds: any
                             # drift beyond rounding is corruption
    mse_z_cut: float = 6.0   # robust z of a chain's train MSE across the
                             # alive chains; conservative, because shards
                             # differ in difficulty and quarantine of a
                             # soft fault is irreversible
    mse_rel_floor: float = 0.5   # the scale's floor, a fraction of the
                                 # median MSE: with a few near-equal MSEs
                                 # the MAD is about 0 and rounding jitter
                                 # would count as divergence
    mse_warmup: int = 8      # EM boundaries before the MSE probe arms:
                             # burn-in MSEs swing from chain to chain

    @property
    def enabled(self) -> bool:
        return self.check_nan or self.check_counts or self.check_mse


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What to do about an unhealthy chain (the module's decision table).
    Restarts are per chain and bounded; a spent budget falls back to
    quarantine, which is always exact."""

    max_restarts: int = 2
    backoff_base: float = 0.0    # seconds: sleep backoff_base · 2^k
                                 # before a chain's k-th restart
    min_alive_frac: float = 0.25  # below this, EnsembleHealthError

    def backoff_s(self, n_prior_restarts: int) -> float:
        return self.backoff_base * (2.0 ** n_prior_restarts)


# ---------------------------------------------------------- the probe

def _flag(bad: torch.Tensor, flag: int) -> torch.Tensor:
    return bad.to(torch.int32) * flag


_BITS: dict = {}


def _fold_bits(bad: list, device) -> torch.Tensor:
    """Status int32 [M] from [(flag, bad bool [M])]: one stack, one
    weighted sum (the weights cached on the device)."""
    flags = tuple(f for f, _ in bad)
    key = (flags, str(device))
    if key not in _BITS:
        _BITS[key] = torch.tensor(flags, dtype=torch.int32,
                                  device=device)[:, None]
    return (torch.stack([b for _, b in bad]).to(torch.int32)
            * _BITS[key]).sum(0, dtype=torch.int32)


def chain_status(plan: ExecutionPlan, state: GibbsState,
                 health: HealthConfig, alive, it=None) -> torch.Tensor:
    """Per-chain status bits, int32 [M], of the chain-batched state, on
    its device and with no host read (some 50 small device operations:
    the EM loop is host-bound, so each costs host time).  `alive` [M]
    (> 0 alive) masks which chains enter the cross-chain MSE statistic
    (a quarantined lane keeps running garbage and must not skew the
    median); `it`, the EM boundary's index when given, arms the MSE probe
    only after `health.mse_warmup` boundaries."""
    m = state.eta.shape[0]
    bad = []
    if health.check_nan:
        bad += [(F_NAN_ETA, ~torch.isfinite(state.eta).all(-1)),
                (F_NAN_NTW, ~torch.isfinite(state.ntw).flatten(1).all(-1)),
                (F_NAN_NDT, ~torch.isfinite(state.ndt).flatten(1).all(-1))]
    if health.check_counts:
        # NaN counts make the comparisons False: the flags fire too
        drift = (state.ndt.flatten(1).sum(-1) - plan._real_tokens).abs()
        bad += [(F_NDT_SUM, ~(drift <= health.count_tol)),
                (F_NTW_NEG, ~(state.ntw.flatten(1).amin(-1)
                              >= -health.count_tol))]
    if health.check_mse and m >= 3 and (it is None
                                        or it >= health.mse_warmup):
        yhat = torch.einsum("mdt,mt->md",
                            state.ndt / plan._lengths[..., None], state.eta)
        mse = (yhat - plan._y).square().mean(-1)
        z = robust_z(mse, valid=alive, rel_floor=health.mse_rel_floor)
        bad.append((F_MSE_OUTLIER, z >= health.mse_z_cut))
    if not bad:
        return torch.zeros((m,), dtype=torch.int32, device=state.eta.device)
    return _fold_bits(bad, state.eta.device)


def model_status(models, *, rowsum_tol: float = 1e-3) -> torch.Tensor:
    """Per-chain status bits, int32 [M], of exported models (chain-stacked
    `SLDAModel`), the serve-time twin of `chain_status`: NaN/Inf in φ̂ or
    η̂ (`F_NAN_PHI`, `F_NAN_ETA`); a φ̂ row that is not a probability
    distribution, negative or not summing to 1 within `rowsum_tol`
    (`F_PHI_ROWSUM`; a NaN row fails the comparison too); a non-finite or
    negative train MSE (`F_NAN_MSE`: it is Weighted Average's weight).
    A chain with any `MODEL_FAULTS` bit cannot serve."""
    m = models.eta.shape[0]
    status = torch.zeros((m,), dtype=torch.int32, device=models.eta.device)

    def fin(x):
        return torch.isfinite(x).reshape(m, -1).all(-1)
    status = status | _flag(~fin(models.eta), F_NAN_ETA)
    status = status | _flag(~fin(models.phi), F_NAN_PHI)
    rows_ok = ((models.phi.sum(-1) - 1.0).abs() <= rowsum_tol).all(-1)
    nonneg = models.phi.reshape(m, -1).amin(-1) >= -rowsum_tol
    status = status | _flag(~(rows_ok & nonneg), F_PHI_ROWSUM)
    mse_ok = torch.isfinite(models.train_mse) & (models.train_mse >= 0.0)
    return status | _flag(~mse_ok, F_NAN_MSE)


# ----------------------------------------------------------- the draws

@dataclasses.dataclass
class SupervisorDraws:
    """The random draws of a supervised run, in original document order at
    the source's padded shape [M, D, ctr_stride] (`core.rng`):

      z_init    the initial topics, int32 [M, D, S];
      round     round(r, epoch, n_iters) → the draws of round r's
                `n_iters` EM iterations, one tensor a boundary as
                `ExecutionPlan.train_em` takes them; epoch int [M] holds
                each chain's restarts so far;
      fresh     fresh(epoch) → initial topics [M, D, S], of which a chain
                restarted without a usable checkpoint takes its row."""

    z_init: torch.Tensor
    round: Callable[[int, np.ndarray, int], Iterable[torch.Tensor]]
    fresh: Callable[[np.ndarray], torch.Tensor]


def seeded_draws(seed: int, plan: ExecutionPlan) -> SupervisorDraws:
    """Draws from generators on the plan's device: the initial topics from
    (seed, TRAIN, chain), as an unsupervised run draws them; round r of a
    chain from (seed, SUPERVISED_ROUND, chain, epoch, r); a fresh re-init
    from (seed, FRESH_INIT, chain, epoch).  A chain's draws depend on
    nothing of the other chains."""
    bc, cfg, dev = plan.corpus, plan.cfg, plan.device
    m, d, s = plan.n_chains, bc.n_docs, bc.ctr_stride

    def round_draws(r, epoch, n_iters):
        gens = [rng.generator(dev, seed, rng.SUPERVISED_ROUND, c,
                              int(epoch[c]), r) for c in range(m)]
        return rng.em_draws(gens, d, s, n_iters, cfg.sweeps_per_launch)

    def fresh(epoch):
        gens = [rng.generator(dev, seed, rng.FRESH_INIT, c, int(epoch[c]))
                for c in range(m)]
        return rng.init_topics(gens, d, s, cfg.n_topics)

    z_init = rng.init_topics(rng.chain_generators(seed, m, dev, rng.TRAIN),
                             d, s, cfg.n_topics)
    return SupervisorDraws(z_init=z_init, round=round_draws, fresh=fresh)


# -------------------------------------------------------------- supervisor

def _chain_of(state: GibbsState, c: int) -> GibbsState:
    return GibbsState(z=tuple(zb[c] for zb in state.z), ndt=state.ndt[c],
                      ntw=state.ntw[c], nt=state.nt[c], eta=state.eta[c])


def _with_chain(state: GibbsState, c: int, chain: GibbsState) -> GibbsState:
    """`state` with chain c replaced by `chain` (new tensors)."""
    def put(x, xc):
        x = x.clone()
        x[c] = xc
        return x
    return GibbsState(z=tuple(put(zb, zc) for zb, zc in zip(state.z,
                                                            chain.z)),
                      ndt=put(state.ndt, chain.ndt),
                      ntw=put(state.ntw, chain.ntw),
                      nt=put(state.nt, chain.nt),
                      eta=put(state.eta, chain.eta))


@dataclasses.dataclass
class SupervisorReport:
    """What a supervised run observed: the final alive mask (the combine
    rules' mask), the status bits of every round OR-ed, restart counts,
    and each round's events."""

    alive: np.ndarray          # [M] bool
    status: np.ndarray         # [M] uint32, OR of every round
    restarts: np.ndarray       # [M] int32
    rounds: int
    history: list
    yhat_chains: np.ndarray = None        # [M, D_test], supervised runs
    yhat_train_chains: np.ndarray = None  # [M, D_train], Weighted Average

    def alive_mask(self, device="cuda") -> torch.Tensor:
        return torch.as_tensor(self.alive, dtype=torch.float32,
                               device=resolve_device(device))

    def quarantined(self) -> list:
        return [int(c) for c in np.nonzero(~self.alive)[0]]


class ChainSupervisor:
    """The chain-batched EM loop with health checks, quarantine and
    restart from checkpoints (module docstring).  Training runs in rounds
    of `round_iters` EM iterations (one round of all of them by default:
    checking only, no host read until the end); a round is one
    `train_em` with the probe attached, and the ends of rounds are the
    only points where the host reads the [M] status, takes a checkpoint
    (with `ckpt_dir`) and applies the recovery policy.

    `fault_hook(state, it) -> (state, bits)` is where faults are
    injected (`repro_torch.testing.faults`); it runs before the probe, so
    a fault injected at boundary `it` is detectable at that boundary.

    `shards` is the chain-sharded training corpus on the run's device (a
    `Corpus` [M, D, N] or a `BucketedCorpus` built from one)."""

    def __init__(self, shards, cfg: SLDAConfig, *, health=None,
                 recovery=None, ckpt_dir=None, round_iters=None,
                 fault_hook=None, keep_checkpoints=2):
        self.cfg = cfg
        self.health = health or HealthConfig()
        self.recovery = recovery or RecoveryPolicy()
        self.ckpt_dir = ckpt_dir
        self.plan = build_plan(shards, cfg)
        if self.plan.n_chains is None:
            raise ValueError("the supervisor wants a chain-sharded corpus "
                             "[M, D/M, ...]")
        r = cfg.n_iters if round_iters is None else max(1, round_iters)
        n_full, rem = divmod(cfg.n_iters, r)
        self._round_sizes = [r] * n_full + ([rem] if rem else [])
        self._manager = (CheckpointManager(ckpt_dir, interval=1,
                                           keep=keep_checkpoints)
                         if ckpt_dir is not None else None)
        self._fault_hook = fault_hook
        self._round_plans: dict = {}

    def hook(self, plan: ExecutionPlan, alive: torch.Tensor):
        """The `em_hook` of a round: the fault hook, then the probe, their
        bits OR-ed into the status."""
        health, fault_hook = self.health, self._fault_hook

        def em_hook(st, it, status):
            if fault_hook is not None:
                st, fb = fault_hook(st, it)
                status = status | fb.to(torch.int32)
            if health.enabled:
                status = status | chain_status(plan, st, health, alive, it)
            return st, status
        return em_hook

    # ---- the pieces of a round (an elastic runner drives them too)

    def make_round_plan(self, r_iters: int) -> ExecutionPlan:
        """The plan of a round of `r_iters` EM iterations (one a size)."""
        if r_iters not in self._round_plans:
            self._round_plans[r_iters] = ExecutionPlan(
                corpus=self.plan.corpus,
                cfg=dataclasses.replace(self.cfg, n_iters=r_iters))
        return self._round_plans[r_iters]

    def run_round(self, round_plan, draws, state, alive, boundary_off):
        """One round from its draws; returns (state, status uint32 [M] on
        the host).  The status read is the round's one host read of the
        probe."""
        dev = round_plan.device
        alive_t = torch.as_tensor(np.asarray(alive), dtype=torch.float32,
                                  device=dev)
        status0 = torch.zeros((round_plan.n_chains,), dtype=torch.int32,
                              device=dev)
        state, status = round_plan.train_em(
            state, draws, em_hook=self.hook(round_plan, alive_t),
            status0=status0, it_offset=boundary_off)
        return state, status.cpu().numpy().astype(np.uint32)

    def restart_chain(self, state, c, draws: SupervisorDraws, epoch,
                      events):
        """Chain c alone from the latest checkpoint; a corrupt or
        truncated chain file falls back to a fresh init of that one lane
        (`draws.fresh`)."""
        step = (latest_step(self.ckpt_dir)
                if self.ckpt_dir is not None else None)
        chain_state, action = None, None
        if step is not None:
            try:
                chain_state = restore_chain(self.ckpt_dir, step, c,
                                            _chain_of(state, c))
                action = f"restart_from_step_{step}"
            except Exception as e:  # noqa: BLE001 — a corrupt file
                events.append({"chain": c, "action": "checkpoint_corrupt",
                               "error": repr(e)})
        if chain_state is None:
            fresh = self.plan.init_states(draws.fresh(epoch))
            chain_state = _chain_of(fresh, c)
            action = "restart_fresh_init"
        events.append({"chain": c, "action": action})
        return _with_chain(state, c, chain_state)

    def apply_recovery(self, state, status_np, *, alive, epoch, restarts,
                       grace, draws, events):
        """The recovery policy on one round's status.  Updates the host's
        bookkeeping (alive, epoch, restarts, grace) in place and returns
        the state, with restarted chains replaced; the caller counts the
        grace rounds down."""
        recovery = self.recovery
        for c in range(len(status_np)):
            bits = int(status_np[c])
            if grace[c] > 0:
                # a chain restarted from a checkpoint lags the ensemble by
                # up to a round: a worse but converging MSE is expected
                bits &= ~SOFT_FAULTS
            if not alive[c] or bits == 0 or not (bits & ~F_STRAGGLER):
                continue
            if (bits & HARD_FAULTS and restarts[c] < recovery.max_restarts
                    and self._manager is not None):
                wait = recovery.backoff_s(int(restarts[c]))
                if wait > 0:
                    time.sleep(wait)
                state = self.restart_chain(state, c, draws, epoch, events)
                restarts[c] += 1
                epoch[c] += 1
                grace[c] = 2    # counted down by the caller: one round
            else:
                alive[c] = False
                events.append({"chain": c, "action": "quarantine",
                               "status": describe_status(bits)})
        return state

    def check_min_alive(self, alive, latched):
        if alive.mean() < self.recovery.min_alive_frac:
            raise EnsembleHealthError(
                f"only {int(alive.sum())}/{len(alive)} chains alive "
                f"(min_alive_frac={self.recovery.min_alive_frac}); "
                f"latched status: "
                f"{[describe_status(int(s)) for s in latched]}")

    def train(self, seed: int | None = None, *,
              draws: SupervisorDraws | None = None):
        """Supervised chain-batched training, from `seed` (`seeded_draws`)
        or from explicit `draws`.  Returns (GibbsState, SLDAModel,
        SupervisorReport), state and models as `ExecutionPlan.train`
        returns them; the report's `alive` mask must reach the combine
        (quarantined lanes hold garbage by design)."""
        plan = self.plan
        if (seed is None) == (draws is None):
            raise ValueError("pass exactly one of seed / draws")
        if draws is None:
            draws = seeded_draws(seed, plan)
        m = plan.n_chains
        state = plan.init_states(draws.z_init)
        alive = np.ones(m, bool)
        epoch = np.zeros(m, np.int32)
        restarts = np.zeros(m, np.int32)
        grace = np.zeros(m, np.int32)   # rounds of soft-fault amnesty a
                                        # restarted chain gets
        latched = np.zeros(m, np.uint32)
        history = []
        it_done, boundary_off = 0, 0
        for rnd, r_iters in enumerate(self._round_sizes):
            if self._manager is not None:
                self._manager.maybe_save(it_done, state)
            round_plan = self.make_round_plan(r_iters)
            state, status_np = self.run_round(
                round_plan, draws.round(rnd, epoch.copy(), r_iters), state,
                alive, boundary_off)
            events = []
            state = self.apply_recovery(
                state, status_np, alive=alive, epoch=epoch,
                restarts=restarts, grace=grace, draws=draws, events=events)
            grace = np.maximum(grace - 1, 0)
            latched |= status_np
            history.append({"round": rnd, "em_iters_done": it_done + r_iters,
                            "status": [int(s) for s in status_np],
                            "events": events})
            self.check_min_alive(alive, latched)
            boundary_off += round_plan.n_boundaries()
            it_done += r_iters
        models = plan._export(state)
        state = dataclasses.replace(
            state, z=plan.corpus.merge_padded(state.z, draws.z_init))
        report = SupervisorReport(alive=alive, status=latched,
                                  restarts=restarts,
                                  rounds=len(self._round_sizes),
                                  history=history)
        return state, models, report


# --------------------------------------------- supervised end-to-end runs

def supervised_run_average(seed: int, train, test, cfg: SLDAConfig, m: int,
                           *, rule: str = "weighted", health=None,
                           recovery=None, ckpt_dir=None, round_iters=None,
                           fault_hook=None, device="cuda"):
    """The fault-tolerant form of `core.parallel.run_*_average`: train M
    chains under the supervisor, predict with every chain, and combine
    under the supervisor's alive mask, so that a quarantined chain never
    reaches ŷ.  Weighted Average predicts test and train in one pass with
    `cfg.fuse_weighted_predict`.  The prediction draws are those of
    `run_weighted_average` with the same seed.  Returns (ŷ [D_test],
    SupervisorReport); the per-chain predictions ride along as
    `report.yhat_chains` (and `report.yhat_train_chains`)."""
    from .parallel import _combine_weighted, _shards, predict_chains
    dev = resolve_device(device)
    train, test = train.to(dev), test.to(dev)
    sup = ChainSupervisor(_shards(train, m, cfg, dev), cfg, health=health,
                          recovery=recovery, ckpt_dir=ckpt_dir,
                          round_iters=round_iters, fault_hook=fault_hook)
    _, models, report = sup.train(seed)
    alive = report.alive_mask(dev)
    yhat_tr = None
    if rule == "weighted" and cfg.fuse_weighted_predict:
        yhat = predict_chains(seed, models, _concat_corpora(test, train),
                              cfg, device=dev)
        yhat_te, yhat_tr = yhat[:, :test.n_docs], yhat[:, test.n_docs:]
    else:
        yhat_te = predict_chains(seed, models, test, cfg, device=dev)
    report.yhat_chains = yhat_te.cpu().numpy()
    if rule == "simple":
        return combine.simple_average(yhat_te, alive=alive), report
    if rule == "median":
        return combine.median(yhat_te, alive=alive), report
    if rule == "weighted":
        if yhat_tr is None:
            yhat_tr = predict_chains(seed, models, train, cfg, device=dev,
                                     stream=rng.PREDICT_TRAIN)
        report.yhat_train_chains = yhat_tr.cpu().numpy()
        return _combine_weighted(yhat_te, yhat_tr, train.y, cfg,
                                 alive), report
    raise ValueError(rule)
