"""Deterministic fault injection for the chain ensemble (the training
half; the serving and elastic helpers wait for those services)."""
from .faults import (FaultPlan, VirtualClock, inject, mislabel_manifest,
                     no_faults, poison, poison_model_table,
                     random_fault_plan, truncate_chain_file)

__all__ = ["FaultPlan", "VirtualClock", "inject", "mislabel_manifest",
           "no_faults", "poison", "poison_model_table",
           "random_fault_plan", "truncate_chain_file"]
