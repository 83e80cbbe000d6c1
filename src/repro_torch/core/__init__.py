"""Paper core: communication-free embarrassingly parallel MCMC for sLDA."""
from .types import (Corpus, GibbsState, SLDAConfig, SLDAModel,
                    apply_count_deltas, counts_from_assignments, partition)
from .gibbs import init_state, sweep, train_chain, zbar, phi_hat
from .regression import solve_eta, solve_eta_ols
from .plan import ExecutionPlan, build_plan
from .predict import predict
from .combine import (COMBINERS, all_dead, median, simple_average,
                      weighted_average)
from .parallel import (ALGORITHMS, predict_chains, predict_chains_keyed,
                       run_naive, run_nonparallel, run_simple_average,
                       run_weighted_average, train_chains,
                       train_chains_keyed)

__all__ = [
    "Corpus", "GibbsState", "SLDAConfig", "SLDAModel", "apply_count_deltas",
    "counts_from_assignments", "partition", "init_state", "sweep",
    "train_chain", "zbar", "phi_hat", "solve_eta", "solve_eta_ols",
    "ExecutionPlan", "build_plan", "predict", "COMBINERS", "all_dead",
    "median", "simple_average", "weighted_average", "ALGORITHMS",
    "predict_chains", "predict_chains_keyed", "run_naive", "run_nonparallel",
    "run_simple_average", "run_weighted_average", "train_chains",
    "train_chains_keyed",
]
