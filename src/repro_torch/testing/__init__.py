"""Deterministic fault injection for the chain ensemble: training,
serving and the elastic runner's event timeline."""
from .faults import (ElasticEvent, FaultPlan, VirtualClock, burst_trace,
                     inject, inject_dispatch_delay, mislabel_manifest,
                     no_faults, poison, poison_model_table,
                     random_elastic_events, random_fault_plan,
                     replay_open_loop, truncate_chain_file)

__all__ = ["ElasticEvent", "FaultPlan", "VirtualClock", "burst_trace",
           "inject", "inject_dispatch_delay", "mislabel_manifest",
           "no_faults", "poison", "poison_model_table",
           "random_elastic_events", "random_fault_plan",
           "replay_open_loop", "truncate_chain_file"]
