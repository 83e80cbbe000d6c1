"""The `fit` traffic kind: sLDA fits, one after another, on one corpus.

A fit is one call of `repro_torch.core.parallel.ALGORITHMS[algorithm]`
on the training and test corpora that set-up put on the device, ending
in `torch.cuda.synchronize()` with the combined ŷ; fit i trains its
chains from a seed drawn from the run's seed and i.  Each fit's time is
read on the device's clock, from CUDA events recorded before its first
launch and after its last (the stream is idle between fits, so the span
holds every wait of the device on the host as well).  The traffic file
names the algorithm and the route (`sweeps_per_launch`,
`length_buckets`, `sampler_mode`); the configuration file names the
corpus and the model's settings, and the limits of the check.

Set-up draws the corpus, builds the program's config and runs
`WARM_FITS` fits, which build and load the kernels and fill every cache
the window's fits use.  The program's per-chain outputs are taken where
they are made: `ExecutionPlan.train` returns the chains' export (φ̂, η̂,
train MSE and accuracy, from `train_em` and `_export`) and
`ExecutionPlan.predict` every chain's ŷ (from `predict_zbar`); a
wrapper on each keeps a reference to what it returned, for the one fit
of the window that the seed picks, each fit as likely.  After the window
the plain reference (`perfbench/reference/slda_fit.py`) fits the picked
fit again from its seed and the same corpus, and the gaps are compared
with the configuration's limits.  The window runs in the process's own
conditions: torch's default threads, Python's default collections.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import time

import numpy as np
import torch

from perfbench import corpus as corpus_mod
from perfbench.phase_timer import PhaseTimer
from perfbench.reference import slda_fit

WARM_FITS = 3
# the names and order of the numbers the check compares
CHECKS = ("phi_gap", "eta_gap", "train_score_gap", "yhat_chain_gap",
          "yhat_gap")


def _seed_word(*words: int) -> int:
    s = np.random.SeedSequence([w % 2 ** 64 for w in words])
    a, b = s.generate_state(2, np.uint32)
    return (int(a) << 32 | int(b)) >> 1


def fit_seed(seed: int, i: int) -> int:
    """The chains' seed of fit i of a run (warm-up fits: i < 0)."""
    return _seed_word(seed, 0x666974, i + 2 ** 32)


def settings(config: dict, traffic: dict) -> dict:
    """The model's settings as the reference takes them."""
    s_ = {k: config[k] for k in slda_fit.SETTINGS if k in config}
    s_.update({k: traffic[k] for k in slda_fit.SETTINGS if k in traffic})
    return s_


def gaps(got: dict, want: dict, label_type: str) -> dict:
    """The check's numbers for one fit: `got` the program's outputs, `want`
    the reference's.  phi_gap: the largest L1 distance of a topic's φ̂;
    eta_gap: the largest |Δη̂|; train_score_gap: the largest relative
    gap of a chain's train MSE (continuous) or absolute gap of its train
    accuracy (binary); yhat_chain_gap: the largest |Δŷ| of a chain's
    prediction; yhat_gap: the largest |Δŷ| of the combined prediction."""
    inf = float("inf")

    def amax(x):
        return float(x.abs().max()) if x.numel() else 0.0

    def same(a, b):
        return a is not None and tuple(a.shape) == tuple(b.shape)

    out = dict.fromkeys(CHECKS, inf)
    if same(got.get("phi"), want["phi"]):
        out["phi_gap"] = float((got["phi"] - want["phi"]).abs().sum(-1)
                               .max())
        out["eta_gap"] = amax(got["eta"] - want["eta"])
        if label_type == "binary":
            out["train_score_gap"] = amax(got["train_acc"]
                                          - want["train_acc"])
        else:
            out["train_score_gap"] = amax(
                (got["train_mse"] - want["train_mse"]) / want["train_mse"])
    if same(got.get("yhat_chains"), want["yhat_chains"]):
        out["yhat_chain_gap"] = amax(got["yhat_chains"]
                                     - want["yhat_chains"])
    if same(got.get("yhat"), want["yhat"]):
        out["yhat_gap"] = amax(got["yhat"] - want["yhat"])
    # a NaN gap fails the check as an infinite one does
    return {k: (inf if math.isnan(v) else v) for k, v in out.items()}


class Run:
    """One run of a fit cell: `setup()`, `window(seconds)`, then the
    readings."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.trace = trace
        self.s_ = settings(config, traffic)
        self.fits, self.describe = [], {}
        self.picked = None
        self._cur = None
        self._describing = False
        self.setup_parts = {}
        self.host_spans = []

    # ---------------------------------------------------------- set-up

    def setup(self):
        from repro_torch.core import ALGORITHMS, SLDAConfig
        from repro_torch.core import plan as plan_mod
        from repro_torch.core.types import Corpus

        c, t = self.config, self.traffic
        t0 = time.perf_counter()
        data = corpus_mod.make_corpus(self.seed, c, self.device)
        self.train_c, self.test_c = corpus_mod.split(data, c["n_train"])
        self.train = Corpus(*self.train_c)
        self.test = Corpus(*self.test_c)
        self.cfg = SLDAConfig(
            n_topics=c["n_topics"], vocab_size=c["vocab_size"],
            alpha=c["alpha"], beta=c["beta"], rho=c["rho"], mu=c["mu"],
            sigma=c["sigma"], label_type=c["label_type"],
            n_iters=c["n_iters"], n_pred_burnin=c["n_pred_burnin"],
            n_pred_samples=c["n_pred_samples"],
            train_doc_block=c["train_doc_block"],
            bucket_token_block=c["bucket_token_block"],
            bucket_overhead_docs=c["bucket_overhead_docs"],
            product_form_sweeps=True, fuse_weighted_predict=True,
            sweeps_per_launch=t["sweeps_per_launch"],
            length_buckets=t["length_buckets"],
            sampler_mode=t["sampler_mode"])
        self.fn = ALGORITHMS[t["algorithm"]]
        self._wrap(plan_mod.ExecutionPlan)
        self._sync()
        t1 = time.perf_counter()
        self._describing = True
        warm = []
        for j in range(WARM_FITS):
            self._fit(fit_seed(self.seed, -1 - j), self._timer())
            warm.append(time.perf_counter())
        self._describing = False
        self.host_spans.clear()
        self._work()
        # where set-up went: the corpus, the first fit (its kernels'
        # build or load), the other warm-up fits
        self.setup_parts = {"corpus": t1 - t0, "first_fit": warm[0] - t1,
                            "warm_fits": warm[-1] - warm[0]}

    def _wrap(self, cls):
        """Keep what `cls.train` and `cls.predict` return for the fit in
        hand (and their plans' `describe()` during set-up)."""
        run = self
        train, predict = cls.train, cls.predict

        def train_kept(plan, z_init, draws):
            out = train(plan, z_init, draws)
            if run._cur is not None:
                run._cur["train"].append(out[1])
            if run._describing:
                run.describe["train"] = plan.describe()
            return out

        def predict_kept(plan, z0, seeds, models):
            out = predict(plan, z0, seeds, models)
            if run._cur is not None:
                run._cur["predict"].append(out)
            if run._describing:
                run.describe["predict"] = plan.describe()
            return out

        cls.train, cls.predict = train_kept, predict_kept
        self._unwrap = lambda: (setattr(cls, "train", train),
                                setattr(cls, "predict", predict))

    def close(self):
        """Take the wrappers off the program's plan class."""
        if hasattr(self, "_unwrap"):
            self._unwrap()

    def _timer(self):
        if self.trace:
            return PhaseTimer(self.device, self.host_spans)
        return None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fit(self, seed: int, timer, events=None):
        kw = {} if timer is None else {"timer": timer}
        if events:
            events[0].record()
        out = self.fn(seed, self.train, self.test, self.cfg,
                      self.s_["chains"], device=self.device, **kw)
        if events:
            events[1].record()
        self._sync()
        return out

    def _events(self):
        if self.device.type != "cuda":
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def _work(self):
        """What a fit's work is, counted from the corpus (one host read)."""
        c, t = self.config, self.traffic
        pred = ((self.test_c, self.train_c) if t["algorithm"] == "weighted"
                else (self.test_c,))
        spl = t["sweeps_per_launch"]
        self.work = {
            "T": c["n_topics"], "W": c["vocab_size"], "chains": c["chains"],
            "n_iters": c["n_iters"],
            "pred_sweeps": c["n_pred_burnin"] + c["n_pred_samples"],
            "launches": -(-c["n_iters"] // spl),
            "train_docs": self.train_c[0].shape[0],
            "train_real_tokens": int(self.train_c[1].sum()),
            "predict_docs": sum(p[0].shape[0] for p in pred),
            "predict_real_tokens": int(sum(p[1].sum() for p in pred))}

    # ---------------------------------------------------------- window

    def window(self, seconds: float):
        """Fits one after another until `seconds` have passed; the last
        one started inside ends the window.  The check's fit is picked as
        it goes: the n-th fit that completes replaces the one in hand with
        chance 1/n."""
        pick = random.Random(_seed_word(self.seed, 0x636865636B))
        self.timers = []
        t0 = time.perf_counter()
        i = n_ok = 0
        while time.perf_counter() - t0 < seconds:
            s = fit_seed(self.seed, i)
            timer, events = self._timer(), self._events()
            self._cur = {"train": [], "predict": []}
            a = time.perf_counter()
            try:
                yhat, err = self._fit(s, timer, events), None
            except Exception as e:          # a failed fit is counted
                yhat, err = None, f"{type(e).__name__}: {e}"
            b = time.perf_counter()
            self.fits.append({"i": i, "seed": s, "wall_s": b - a,
                              "events": events, "yhat": yhat, "error": err})
            if timer is not None:
                self.timers.append(timer)
            if err is None:
                n_ok += 1
                if pick.randrange(n_ok) == 0:
                    self.picked = {"seed": s, "i": i, "yhat": yhat,
                                   **self._cur}
            self._cur = None
            i += 1
        self.window_s = time.perf_counter() - t0
        for f in self.fits:
            # a fit that returned a non-finite ŷ failed
            if f["error"] is None and not bool(
                    torch.isfinite(f["yhat"]).all()):
                f["error"] = "non-finite yhat"
            ev = f.pop("events")
            f["ms"] = (ev[0].elapsed_time(ev[1]) if ev and f["error"] is None
                       else f["wall_s"] * 1e3)

    # -------------------------------------------------------- readings

    @property
    def attempted(self) -> int:
        return len(self.fits)

    @property
    def failed(self) -> int:
        return sum(f["error"] is not None for f in self.fits)

    def errors(self) -> list:
        return sorted({f["error"] for f in self.fits if f["error"]})

    def end_to_end(self) -> dict:
        """fit_ms: the window's wall time over the fits it completed;
        fit_p95_ms: the 95th percentile (nearest rank) of every attempted
        fit's time on the device's clock (the host's on the CPU), a
        failed fit counting as infinitely long."""
        done = self.attempted - self.failed
        times = sorted(f["ms"] if f["error"] is None else math.inf
                       for f in self.fits)
        p95 = times[max(0, math.ceil(0.95 * len(times)) - 1)] \
            if times else math.inf
        return {"fit_ms": self.window_s / done * 1e3 if done else math.inf,
                "fit_p95_ms": p95}

    def layer_context(self) -> dict:
        """What the per-layer readers read, besides the trace."""
        ok = [f for f in self.fits if f["error"] is None]
        phases = [t.ms() for t in self.timers]
        return {"fits": len(ok), "fit_ms": [f["ms"] for f in ok],
                "phase_ms": {p: [m.get(p, 0.0) for m in phases]
                             for p in ("train", "predict", "combine")},
                "work": self.work, "plans": self.describe}

    def quality(self) -> dict:
        """The window's fits' test quality beside the baseline the paper
        reads it against: test MSE beside var(y_test), or accuracy beside
        the majority class's rate."""
        ys = [f["yhat"] for f in self.fits if f["error"] is None]
        y = self.test_c[2]
        if not ys:
            return {"fits": 0}
        times = sorted(f["ms"] for f in self.fits if f["error"] is None)
        spread = {f"fit_ms_p{q}": times[min(len(times) - 1,
                                            len(times) * q // 100)]
                  for q in (0, 50, 90, 99)}
        yh = torch.stack(ys)
        if self.config["label_type"] == "binary":
            acc = ((yh > 0.5) == (y > 0.5)).to(torch.float32).mean(-1)
            pos = float((y > 0.5).to(torch.float32).mean())
            return {"fits": len(ys), **spread,
                    "test_acc_mean": float(acc.mean()),
                    "test_acc_min": float(acc.min()),
                    "majority_rate": max(pos, 1.0 - pos)}
        mse = ((yh - y) ** 2).mean(-1)
        return {"fits": len(ys), **spread,
                "test_mse_mean": float(mse.mean()),
                "test_mse_max": float(mse.max()),
                "var_y_test": float(y.var(unbiased=False))}

    def program_outputs(self, kept: dict) -> dict:
        """The picked fit's outputs as the check compares them."""
        out = {"yhat": kept["yhat"]}
        if len(kept["train"]) == 1:
            m = kept["train"][0]
            out.update({f.name: getattr(m, f.name)
                        for f in dataclasses.fields(m)})
        if len(kept["predict"]) == 1:
            out["yhat_chains"] = kept["predict"][0]
        return out

    def checks(self, control: str | None = None) -> dict:
        """The check's numbers: the picked fit's outputs against the
        reference fitted again from the fit's seed, or with `control`
        ("tf32" or "bfloat16") the reference in that precision put in the
        program's place."""
        kept = self.picked
        if kept is None:
            return dict.fromkeys(CHECKS, math.inf)
        with torch.no_grad():
            want = slda_fit.fit(kept["seed"], self.train_c, self.test_c,
                                self.s_)
            got = (self.program_outputs(kept) if control is None
                   else slda_fit.fit(kept["seed"], self.train_c,
                                     self.test_c, self.s_, control))
        return gaps(got, want, self.config["label_type"])

    def limits(self) -> dict:
        return {k: float(self.config["limits"][k]) for k in CHECKS}


@contextlib.contextmanager
def opened(config, traffic, seed, device, trace=False):
    """A set-up `Run`, its wrappers taken off on exit."""
    run = Run(config, traffic, seed, device, trace)
    try:
        run.setup()
        yield run
    finally:
        run.close()
