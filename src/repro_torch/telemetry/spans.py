"""Span-based control-plane tracing.

The simulator and the prediction service wrap their interesting
sections in spans::

    with tracer.span("schedule", now=now) as sp:
        ...
        sp.attrs["decisions"] = placed

A closed span records wall-clock duration, nesting depth, a sequence
number, and arbitrary attributes (counter deltas, sim time).  Spans are
emitted through the observer hub's ``on_span`` hook as they close, so
``JsonlObserver`` persists them into the same JSONL stream as the
``DecisionTrace`` records — one artifact per run tells the whole story.

``NULL_TRACER`` is the default everywhere: its ``span()`` is a shared
no-op context manager whose ``__enter__`` returns ``None``, so
uninstrumented runs pay two attribute lookups per span site and
allocate nothing (the observer-parity gates run with and without a real
tracer and must agree bit-for-bit — spans only *read* state).

Counter deltas: ``tracer.span(name, stats=obj)`` snapshots
``obj.snapshot()`` (any mapping-returning callable, e.g.
``PredictionService.stats``) on entry and records the numeric deltas on
exit — the "wall-clock + counter deltas" contract without span sites
hand-rolling bookkeeping.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional


class Span:
    """One closed (or in-flight) control-plane section."""

    __slots__ = ("name", "seq", "depth", "t_start_s", "dur_ms", "attrs",
                 "_stats", "_snap0")

    def __init__(self, name: str, seq: int, depth: int,
                 stats: Optional[Any] = None, **attrs: Any):
        self.name = name
        self.seq = seq
        self.depth = depth
        self.t_start_s = 0.0
        self.dur_ms = 0.0
        self.attrs: Dict[str, Any] = dict(attrs)
        self._stats = stats
        self._snap0: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "seq": self.seq, "depth": self.depth,
                "ms": round(self.dur_ms, 4), **self.attrs}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, seq={self.seq}, "
                f"ms={self.dur_ms:.3f}, {self.attrs})")


class _NullSpanCM:
    """Shared no-op ``span()`` result: enters to None, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullSpanCM()


class _NullTracer:
    """The do-nothing default tracer (see module docstring)."""

    enabled = False

    def span(self, name: str, stats: Optional[Any] = None,
             **attrs: Any) -> _NullSpanCM:
        return _NULL_CM

    def summary(self) -> List[Dict[str, Any]]:
        return []


NULL_TRACER = _NullTracer()


class _SpanCM:
    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: "SpanTracer", sp: Span):
        self.tracer = tracer
        self.sp = sp

    def __enter__(self) -> Span:
        self.tracer._depth += 1
        self.sp.t_start_s = time.perf_counter()
        if self.sp._stats is not None:
            self.sp._snap0 = dict(self.sp._stats.snapshot())
        return self.sp

    def __exit__(self, *exc) -> bool:
        sp = self.sp
        sp.dur_ms = (time.perf_counter() - sp.t_start_s) * 1e3
        if sp._snap0 is not None:
            snap1 = self.sp._stats.snapshot()
            for k, v1 in snap1.items():
                d = v1 - sp._snap0.get(k, 0)
                if isinstance(d, float):
                    d = round(d, 6)
                if d:
                    sp.attrs[f"d_{k}"] = d
        self.tracer._depth -= 1
        self.tracer._finish(sp)
        return False


class SpanTracer:
    """Records spans in memory (bounded) and emits each closed span to an
    optional callback — typically ``EventHub.on_span``, which fans out
    to ``JsonlObserver`` and the metrics registry's observer."""

    enabled = True

    def __init__(self, emit: Optional[Callable[[Span], None]] = None,
                 max_spans: int = 100_000):
        self.spans: List[Span] = []
        self.dropped = 0
        self.max_spans = max_spans
        self._emit = emit
        self._depth = 0
        self._seq = 0

    def span(self, name: str, stats: Optional[Any] = None,
             **attrs: Any) -> _SpanCM:
        sp = Span(name, self._seq, self._depth, stats=stats, **attrs)
        self._seq += 1
        return _SpanCM(self, sp)

    def _finish(self, sp: Span) -> None:
        if len(self.spans) < self.max_spans:
            self.spans.append(sp)
        else:
            self.dropped += 1
        if self._emit is not None:
            self._emit(sp)

    # -- aggregation -------------------------------------------------------

    def summary(self) -> List[Dict[str, Any]]:
        """Per-name aggregate rows (count / total / mean / max ms),
        sorted by total wall time descending — the dashboard's
        flamegraph-style span table."""
        agg: Dict[str, Dict[str, Any]] = {}
        for sp in self.spans:
            row = agg.setdefault(sp.name, {
                "name": sp.name, "count": 0, "total_ms": 0.0,
                "max_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += sp.dur_ms
            row["max_ms"] = max(row["max_ms"], sp.dur_ms)
        out = sorted(agg.values(), key=lambda r: -r["total_ms"])
        for row in out:
            row["mean_ms"] = row["total_ms"] / row["count"]
            row["total_ms"] = round(row["total_ms"], 4)
            row["mean_ms"] = round(row["mean_ms"], 4)
            row["max_ms"] = round(row["max_ms"], 4)
        return out
