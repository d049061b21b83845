"""Public export surface for the unified prediction service.

    from repro_torch.engine import PredictionService, FeatureSchema

``PredictionService`` owns the forest, the versioned feature schema
(v1 legacy / v2 node-shape-aware), batched+cached capacity solving,
inference-engine selection (numpy / torch / cuda), and epoch/retrain
bookkeeping — see ``repro_torch.core.prediction_service``.
``CapacityEngine`` is the capacity engine's earlier name for the same
class, kept as a true alias.
"""
from .core.prediction_service import (DRAIN_MODES, INFERENCE_ENGINES,
                                      SCHEMA_V1, SCHEMA_V2, CapacityEngine,
                                      EngineConfig, EngineStats,
                                      FeatureSchema, PredictionService,
                                      coloc_signature, get_schema)

__all__ = ["CapacityEngine", "PredictionService", "EngineConfig",
           "EngineStats", "FeatureSchema", "SCHEMA_V1", "SCHEMA_V2",
           "DRAIN_MODES", "INFERENCE_ENGINES",
           "get_schema", "coloc_signature"]
