"""Deterministic fault injection for the chain ensemble: training and
serving (the elastic helpers wait for the elastic runtime)."""
from .faults import (FaultPlan, VirtualClock, burst_trace, inject,
                     inject_dispatch_delay, mislabel_manifest, no_faults,
                     poison, poison_model_table, random_fault_plan,
                     replay_open_loop, truncate_chain_file)

__all__ = ["FaultPlan", "VirtualClock", "burst_trace", "inject",
           "inject_dispatch_delay", "mislabel_manifest", "no_faults",
           "poison", "poison_model_table", "random_fault_plan",
           "replay_open_loop", "truncate_chain_file"]
