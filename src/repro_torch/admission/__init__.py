"""``repro.admission`` — vertical scaling, queue-backed admission and
SLO classes as first-class scenario axes.

Three coupled pieces (see module docstrings for detail):

  * :mod:`.queue` — bounded per-function pending-request queues with
    pluggable admit/release stages (registered in the platform stage
    registry as ``admit:*`` / ``queue-release:*``);
  * :mod:`.slo` — ``latency-critical`` vs ``best-effort`` population
    tagging with per-class queue-delay budgets;
  * :mod:`.vertical` — per-function cpu-reservation resize, solved
    through the PredictionService capacity table, driving the
    harvesting scheduler's per-function harvest bounds;
  * :mod:`.controller` — the per-cell ``AdmissionController`` the
    simulator's run loops drive (``enqueue`` -> autoscale -> ``drain``
    -> measure).

Everything is default-off: a ``PlatformConfig`` without an enabled
``admission`` section builds the exact pre-admission control plane
(``AdmissionController`` is ``None``, not a pass-through), which is
what the admission-off bit-parity gates in ``tests/test_admission.py``
pin down.
"""
from .controller import (ADMIT_STAGES, RELEASE_STAGES, AdmissionConfig,
                         AdmissionController)
from .queue import (BoundedFifoAdmit, FunctionQueue, GreedyQueueRelease,
                    PacedQueueRelease, ShedOldestAdmit)
from .slo import (BEST_EFFORT, LATENCY_CRITICAL, SLO_CLASSES,
                  delay_budget_s, tag_slo_classes)
from .vertical import VerticalScaler

__all__ = [
    "AdmissionConfig", "AdmissionController", "ADMIT_STAGES",
    "RELEASE_STAGES", "FunctionQueue", "BoundedFifoAdmit",
    "ShedOldestAdmit", "GreedyQueueRelease", "PacedQueueRelease",
    "VerticalScaler", "LATENCY_CRITICAL", "BEST_EFFORT", "SLO_CLASSES",
    "tag_slo_classes", "delay_budget_s",
]
