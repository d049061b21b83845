"""Typed metrics registry: Counters, Gauges and Reservoir-backed
Histograms behind one namespace.

Control-plane components don't write here directly — they keep their
cheap local dataclasses (``SchedMetrics``, ``ScalingMetrics``,
``EngineStats``) on the hot path and the registry is fed through the
observer layer, which keeps the "hooks must not mutate simulation
state" contract trivially true:

  * ``MetricsObserver`` subscribes to the ``EventHub`` and folds the
    live streams (ticks, schedule decisions + ``DecisionTrace``,
    scaling transitions, retrains, spans) into registry metrics as the
    run progresses;
  * ``publish_result`` maps a finished ``SimResult`` (and the
    service's ``EngineStats``) into the same namespace, so the final
    registry snapshot is the single source every ``RunReport`` is
    built from.

Metric names are dotted (``schedule.decisions``, ``cluster.density``,
``span.retrain.ms``); ``MetricsRegistry.snapshot()`` returns plain
JSON-able dicts.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

from ..core.events import Observer
from ..core.metrics import Reservoir


class Counter:
    """Monotonically increasing count (events, rows, retrains)."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += v

    def snapshot(self) -> Dict[str, Any]:
        v = self.value
        return {"kind": self.kind,
                "value": int(v) if float(v).is_integer() else v}


class Gauge:
    """Last-written level (density, node count, epoch)."""

    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Distribution metric backed by ``core.metrics.Reservoir``: exact
    count/mean/min/max always, exact percentiles while fewer than
    ``cap`` values were observed, bounded memory beyond."""

    kind = "histogram"
    __slots__ = ("name", "help", "reservoir")

    def __init__(self, name: str, help: str = "", cap: int = 512,
                 seed: int = 0):
        self.name = name
        self.help = help
        self.reservoir = Reservoir(cap=cap, seed=seed)

    def observe(self, v: float) -> None:
        self.reservoir.append(v)

    @property
    def count(self) -> int:
        return self.reservoir.count

    def snapshot(self, bins: int = 0) -> Dict[str, Any]:
        r = self.reservoir
        snap = {"kind": self.kind, "count": r.count, "mean": r.mean,
                "min": r.min, "max": r.max, "p50": r.p50, "p99": r.p99}
        if bins:
            counts, edges = r.histogram(bins)
            snap["buckets"] = [[round(float(lo), 6), float(c)]
                               for lo, c in zip(edges[:-1], counts)]
        return snap


class MetricsRegistry:
    """Get-or-create namespace of typed metrics.

    Re-requesting a name returns the existing instrument; requesting an
    existing name as a different kind raises (one name, one type)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", cap: int = 512,
                  seed: int = 0) -> Histogram:
        return self._get(Histogram, name, help, cap=cap, seed=seed)

    # -- access ------------------------------------------------------------

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Any]:
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self, bins: int = 0) -> Dict[str, Dict[str, Any]]:
        """``{name: {kind, value | distribution summary}}`` — plain
        JSON-able dicts, the RunReport's ``metrics`` payload."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = m.snapshot(bins) if m.kind == "histogram" \
                else m.snapshot()
        return out


class MetricsObserver(Observer):
    """Folds the live observer streams into a ``MetricsRegistry``.

    Pure consumer: reads event arguments, touches no simulation state
    (the observer-parity gate runs with and without it attached)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        # explicit None check: an empty registry is falsy (__len__)
        self.registry = registry if registry is not None \
            else MetricsRegistry()

    # -- hooks -------------------------------------------------------------

    def on_tick(self, now: float, sim) -> None:
        reg = self.registry
        reg.counter("sim.ticks").inc()
        nodes = len(sim.cluster.nodes)
        inst = sim.cluster.total_instances()
        reg.gauge("cluster.nodes").set(nodes)
        reg.gauge("cluster.instances").set(inst)
        density = inst / nodes if nodes else 0.0
        reg.gauge("cluster.density").set(density)
        reg.histogram("cluster.density_series").observe(density)
        # pending-request backlog; only registered when the admission
        # axis is on (None otherwise), so off-axis snapshots carry no
        # admission names
        depth = sim.queue_depth_total()
        if depth is not None:
            reg.gauge("admission.queue_depth").set(depth)
            reg.histogram("admission.queue_depth_series").observe(depth)

    def on_schedule(self, now: float, fn: str, placements,
                    trace=None) -> None:
        reg = self.registry
        reg.counter("schedule.decisions").inc()
        reg.counter("schedule.instances_placed").inc(
            sum(p.count for p in placements))
        for p in placements:
            reg.histogram("schedule.latency_ms").observe(p.latency_ms)
        if trace is not None:
            if trace.failed:
                reg.counter("schedule.failed_requests").inc(trace.failed)
            for reason, n in trace.filtered.items():
                reg.counter(f"schedule.filtered.{reason}").inc(n)

    def on_scale(self, now: float, fn: str, event: str,
                 count: int) -> None:
        self.registry.counter(f"scale.{event}").inc(count)

    def on_retrain(self, service) -> None:
        reg = self.registry
        reg.counter("prediction.retrains").inc()
        reg.gauge("prediction.epoch").set(service.epoch)
        reg.gauge("prediction.samples").set(service.predictor.n_samples)

    def on_span(self, span) -> None:
        self.registry.histogram(f"span.{span.name}.ms").observe(
            span.dur_ms)


def publish_result(registry: MetricsRegistry, res,
                   engine_stats: Optional[Dict[str, float]] = None
                   ) -> MetricsRegistry:
    """Fold a finished ``SimResult`` (and optionally the prediction
    service's ``EngineStats.snapshot()``) into the registry — the
    end-of-run metrics every ``RunReport`` reads.  Gauges for levels
    and rates, counters for totals, histogram summaries re-exposed
    under stable names."""
    g, c = registry.gauge, registry.counter
    g("run.ticks").set(res.ticks)
    g("run.density").set(res.density)
    g("run.qos_violation_rate").set(res.qos_violation_rate)
    g("run.requests").set(res.requests)
    g("run.nodes_peak").set(res.nodes_peak)
    g("run.mean_nodes").set(res.node_seconds / max(res.ticks, 1))
    s = res.sched
    if s is not None:
        c("run.sched.decisions").inc(s.decisions)
        c("run.sched.instances_placed").inc(s.instances_placed)
        c("run.sched.fast").inc(s.fast)
        c("run.sched.slow").inc(s.slow)
        c("run.sched.failed").inc(s.failed)
        c("run.sched.critical_inference_rows").inc(
            s.critical_inference_rows)
        g("run.sched.latency_ms.mean").set(s.mean_latency_ms)
        g("run.sched.latency_ms.p50").set(s.p50_latency_ms)
        g("run.sched.latency_ms.p99").set(s.p99_latency_ms)
    a = res.scaling
    if a is not None:
        c("run.scaling.real_cold_starts").inc(a.real_cold_starts)
        c("run.scaling.logical_cold_starts").inc(a.logical_cold_starts)
        c("run.scaling.releases").inc(a.releases)
        c("run.scaling.evictions").inc(a.evictions)
        c("run.scaling.migrations").inc(a.migrations)
        g("run.cold_start_ms.mean").set(a.mean_cold_start_ms)
        g("run.cold_start_ms.p50").set(a.cold_start_ms.p50)
        g("run.cold_start_ms.p99").set(a.cold_start_ms.p99)
    if res.class_requests:
        # admission axis (repro.admission): per-SLO-class QoS, queue
        # delay distribution, drops and vertical resize totals
        for cls, rate in res.class_violation_rate().items():
            g(f"run.class.{cls}.requests").set(
                res.class_requests.get(cls, 0.0))
            g(f"run.class.{cls}.violation_rate").set(rate)
        c("run.admission.dropped").inc(res.dropped_requests)
        c("run.admission.vertical_grows").inc(res.vertical_grows)
        c("run.admission.vertical_shrinks").inc(res.vertical_shrinks)
        g("run.admission.queue_depth_peak").set(res.queue_depth_peak)
        q = res.queue_delay_s
        g("run.admission.queue_delay_s.mean").set(q.mean)
        g("run.admission.queue_delay_s.p50").set(q.p50)
        g("run.admission.queue_delay_s.p99").set(q.p99)
    if engine_stats:
        for k, v in engine_stats.items():
            g(f"run.engine.{k}").set(v)
    return registry
