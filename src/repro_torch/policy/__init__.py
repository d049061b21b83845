"""``repro_torch.policy`` — learned scheduling policy, trained from
DecisionTraces and served as a hot-swappable pipeline stage (the port
of ``repro.policy``).

Production-style split:

  * ``dataset`` — DecisionTrace JSONL -> feature matrices + labels +
    outcome annotations, deterministic train/holdout split,
  * ``train``   — the small MLP scorer: its fit (imitation of jiagu
    traces, plus an offline-RL mode with QoS/cold-start-penalized
    weighting), init and forward (torch and numpy),
  * ``store``   — versioned, epoch-tagged ``.npz`` persistence,
  * ``stage``   — the ``LearnedScorer`` pipeline stage and the
    registered ``"learned"`` scheduler stack, hot-swapped through the
    PredictionService retrain-epoch machinery.

``train`` is re-exported lazily, as in the reference
(``train_policy`` is its ``train``, named so as not to shadow the
submodule).
"""
from .dataset import (DecisionRecord, PolicyDataset, load_traces,
                      matrices, merge, normalization, reward_weights,
                      split)
from .stage import LearnedScheduler, LearnedScorer, ScorerStats
from .store import POLICY_SCHEMA, PolicyStore, PolicyStoreError

#: lazy re-exports from ``.train`` (maps public name -> attribute
#: there; ``train_policy`` avoids shadowing the submodule itself)
_LAZY = {"TrainConfig": "TrainConfig", "train_policy": "train",
         "top1_agreement": "top1_agreement", "np_scores": "np_scores",
         "forward": "forward", "init_params": "init_params"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(".train", __name__)
        return getattr(mod, _LAZY[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DecisionRecord", "PolicyDataset", "load_traces", "matrices",
    "merge", "normalization", "reward_weights", "split",
    "LearnedScheduler", "LearnedScorer", "ScorerStats",
    "POLICY_SCHEMA", "PolicyStore", "PolicyStoreError",
    *sorted(_LAZY),
]
