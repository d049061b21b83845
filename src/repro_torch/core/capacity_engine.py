"""Cluster-scale batched capacity engine — compatibility surface.

The engine machinery first grown as a standalone capacity engine
(coalesced drains, the canonical
colocation-signature cache, vectorized bit-identical feature assembly,
chunked early-exit m-sweep) now lives in the unified
``prediction_service`` module, where it shares one pipeline with the
versioned feature schema, the schedulers' per-schedule inference, and
the online-retraining loop.  ``CapacityEngine`` is a true alias of
``PredictionService`` — one class, not a wrapper — so every call site,
test, and benchmark of the engine keeps working unchanged.
"""
from .prediction_service import (CapacityEngine, EngineConfig, EngineStats,
                                 PredictionService, _Solve, _Template,
                                 coloc_signature)

__all__ = ["CapacityEngine", "EngineConfig", "EngineStats",
           "PredictionService", "coloc_signature"]
