"""Serving: batched generation of the LM zoo with the paper's combination
at the token level, and the micro-batched sLDA prediction service with
its robustness layer."""
from .engine import GenerationConfig, ServingEngine, sample_token
from .slda_service import (InvalidDocument, Result, ServiceConfig,
                           SLDAPredictionService, calibrate_slots,
                           SHED_STATUSES, STATUS_EXPIRED, STATUS_OK,
                           STATUS_SHED_QUEUE, STATUS_SHED_RATE)

__all__ = ["GenerationConfig", "ServingEngine", "sample_token",
           "InvalidDocument", "Result", "ServiceConfig",
           "SLDAPredictionService", "calibrate_slots",
           "SHED_STATUSES", "STATUS_EXPIRED", "STATUS_OK",
           "STATUS_SHED_QUEUE", "STATUS_SHED_RATE"]
