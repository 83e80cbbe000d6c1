"""slots_per_token: the token slots a fit's launches walk over the real
tokens they hold, from the corpus's real tokens and the buckets of the
plans' `describe()` (`core.plan.build_schedule`): training walks its
schedule's slots for each chain and sweep, prediction walks the shared
corpus's slots for each chain and sweep.  1 is no padding."""


def read(ctx):
    plans, w = ctx["plans"], ctx["work"]
    if "train" not in plans or "predict" not in plans:
        return None
    tr, pr = plans["train"], plans["predict"]
    slots = (tr["slot_tokens_per_sweep"] * tr["chains"] * w["n_iters"]
             + pr["slot_tokens_per_sweep"] * w["chains"]
             * w["pred_sweeps"])
    real = (w["train_real_tokens"] * w["n_iters"]
            + w["predict_real_tokens"] * w["chains"] * w["pred_sweeps"])
    return slots / real
