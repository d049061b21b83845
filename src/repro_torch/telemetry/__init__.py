"""Span tracing for the control plane (the port of
``repro.telemetry.spans``); the metrics, report, gate and dashboard
layers of the reference wait for a later slice."""
from .spans import NULL_TRACER, Span, SpanTracer

__all__ = ["NULL_TRACER", "Span", "SpanTracer"]
