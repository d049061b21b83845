"""repro_torch.telemetry — unified observability for the control plane
(the port of ``repro.telemetry``).

One subsystem, four layers:

* :mod:`~repro_torch.telemetry.metrics` — typed metric instruments
  (``Counter`` / ``Gauge`` / ``Histogram`` on ``core.metrics.Reservoir``)
  in a ``MetricsRegistry``, fed by ``MetricsObserver`` through the
  ``EventHub`` and by ``publish_result`` at end-of-run;
* :mod:`~repro_torch.telemetry.spans` — span-based control-plane tracing
  (``span("schedule")``, ``span("retrain")``, ``span("capacity_solve")``)
  with wall-clock + counter deltas, emitted through ``on_span`` into the
  same JSONL streams as ``DecisionTrace``; ``NULL_TRACER`` keeps
  uninstrumented runs free;
* :mod:`~repro_torch.telemetry.report` — the schema-versioned
  ``RunReport`` persisted as a ``BENCH_<study>.json`` trajectory
  (baseline + runs);
* :mod:`~repro_torch.telemetry.gate` / :mod:`~repro_torch.telemetry.dashboard`
  — the regression gate over those files, and the self-contained HTML
  dashboard (``python -m repro_torch.telemetry.dashboard``).

``Telemetry.create()`` bundles a registry + observer + tracer for
``Platform.build`` to wire in one call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .metrics import (Counter, Gauge, Histogram, MetricsObserver,
                      MetricsRegistry, publish_result)
from .report import (BENCH_SCHEMA, REPORT_SCHEMA, RunReport, append_bench,
                     bench_path, load_bench, manifest_hash,
                     promote_baseline, repo_root)
from .spans import NULL_TRACER, Span, SpanTracer

#: gate exports resolve lazily (PEP 562) so ``python -m
#: repro_torch.telemetry.gate`` doesn't re-execute an already-imported
#: module (runpy's double-import warning)
_GATE_EXPORTS = ("DEFAULT_STUDIES", "Delta", "Tolerances",
                 "compare_reports", "gate_study", "print_delta_table")


def __getattr__(name: str):
    if name in _GATE_EXPORTS:
        from . import gate
        return getattr(gate, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


@dataclass
class Telemetry:
    """The bundle ``Platform.build`` attaches when telemetry is on:
    one registry, the observer feeding it, and the span tracer the
    simulator / prediction service publish through."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    observer: Optional[MetricsObserver] = None
    tracer: Any = NULL_TRACER

    @classmethod
    def create(cls, metrics: bool = True, spans: bool = True,
               emit=None) -> "Telemetry":
        registry = MetricsRegistry()
        observer = MetricsObserver(registry) if metrics else None
        tracer = SpanTracer(emit=emit) if spans else NULL_TRACER
        return cls(registry=registry, observer=observer, tracer=tracer)

    def snapshot(self, bins: int = 0) -> Dict[str, Dict[str, Any]]:
        return self.registry.snapshot(bins)

    def span_summary(self) -> List[Dict[str, Any]]:
        return self.tracer.summary()


__all__ = [
    "Telemetry",
    # metrics
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "MetricsObserver", "publish_result",
    # spans
    "Span", "SpanTracer", "NULL_TRACER",
    # reports / trajectories
    "RunReport", "REPORT_SCHEMA", "BENCH_SCHEMA", "append_bench",
    "load_bench", "bench_path", "promote_baseline", "manifest_hash",
    "repo_root",
    # gate
    "Tolerances", "Delta", "compare_reports", "gate_study",
    "print_delta_table", "DEFAULT_STUDIES",
]
