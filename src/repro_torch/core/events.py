"""Observer hooks for the control plane (the ``repro.platform`` API).

Benchmarks and tests used to collect metrics by reaching into simulator
internals (``sim.scheduler.metrics``, ``sim.autoscaler.metrics``, the
service's stats object).  The observer API turns the interesting control
-plane transitions into events any number of observers can subscribe to
without the run loop knowing who is listening:

  * ``on_tick(now, sim)``        — once per simulated second, after
    autoscaling/routing/measurement for that second completed,
  * ``on_schedule(now, fn, placements, trace)`` — a scheduler decision
    placed real (cold-started) instances; ``trace`` is the pipeline's
    ``DecisionTrace`` explaining the placement (None for legacy
    monolithic schedulers),
  * ``on_scale(now, fn, event, count)``  — an autoscaler state
    transition: ``"logical_start"``, ``"real_cold_start"``,
    ``"release"``, ``"evict"``, or ``"migrate"``,
  * ``on_retrain(service)``      — the prediction service's online
    retraining policy fired (forest refit + epoch bump + cache clear),
  * ``on_result(result)``        — the run completed; ``result`` is the
    final ``SimResult`` (cumulative density/QoS counters), emitted once
    at the end of ``Simulation.run`` / ``CellSimulation.run`` so JSONL
    artifacts carry their own outcome record,
  * ``on_span(span)``            — a control-plane span closed
    (``repro.telemetry.spans``): wall-clock + counter deltas for
    ``schedule`` / ``retrain`` / ``capacity_solve`` sections, persisted
    alongside the ``DecisionTrace`` stream.

``EventHub`` fans one event out to every registered observer; the hub
with no observers is the default everywhere and costs one empty-list
iteration per event, so the instrumented and bare runs are the same
code path (parity gates depend on that).  ``JsonlObserver`` persists
the streams to ``artifacts/*.jsonl`` for cross-run dashboards.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional


class Observer:
    """Base observer: subclass and override the hooks you care about.

    Hooks must not mutate simulation state — they exist so benchmarks
    observe without perturbing (the A/B parity gates run with and
    without observers and assert identical results).
    """

    def on_tick(self, now: float, sim) -> None:
        pass

    def on_schedule(self, now: float, fn: str, placements,
                    trace=None) -> None:
        pass

    def on_scale(self, now: float, fn: str, event: str,
                 count: int) -> None:
        pass

    def on_retrain(self, service) -> None:
        pass

    def on_result(self, result) -> None:
        pass

    def on_span(self, span) -> None:
        pass


class EventHub(Observer):
    """Fan-out of control-plane events to registered observers.

    An ``EventHub`` is itself an ``Observer``, so hubs nest (a platform
    hub can subscribe to another platform's hub)."""

    __slots__ = ("observers",)

    def __init__(self, observers: Iterable[Observer] = ()):
        self.observers: List[Observer] = list(observers)

    def add(self, obs: Observer) -> Observer:
        self.observers.append(obs)
        return obs

    def remove(self, obs: Observer) -> None:
        self.observers.remove(obs)

    # -- fan-out ----------------------------------------------------------

    def on_tick(self, now: float, sim) -> None:
        for o in self.observers:
            o.on_tick(now, sim)

    def on_schedule(self, now: float, fn: str, placements,
                    trace=None) -> None:
        for o in self.observers:
            o.on_schedule(now, fn, placements, trace)

    def on_scale(self, now: float, fn: str, event: str,
                 count: int) -> None:
        for o in self.observers:
            o.on_scale(now, fn, event, count)

    def on_retrain(self, service) -> None:
        for o in self.observers:
            o.on_retrain(service)

    def on_result(self, result) -> None:
        for o in self.observers:
            o.on_result(result)

    def on_span(self, span) -> None:
        for o in self.observers:
            o.on_span(span)


class JsonlObserver(Observer):
    """Persist the observer streams to a JSONL artifact, one event per
    line, for cross-run dashboards:

      {"event": "tick", "now": ..., "nodes": ..., "instances": ...,
       "density": ...}
      {"event": "schedule", "fn": ..., "placed": ..., "trace": {...}}
      {"event": "scale", "fn": ..., "kind": "release", "count": ...}
      {"event": "retrain", "epoch": ..., "retrains": ...}

    ``tick_every`` subsamples the per-tick stream (schedule/scale/
    retrain events are always complete); ``trace.summary()`` — the
    compact ``DecisionTrace`` form — rides every schedule event, so a
    dashboard can reconstruct why each placement happened.  Usable as a
    context manager; the file is opened lazily on the first event.

    Durability: the handle is line-buffered and every event is flushed
    as it is written, so a crash mid-run (or an interpreter exit that
    never reached ``close()``) loses at most the event being formatted,
    never a buffered tail.  Nested parent directories are created on
    first write; writing after ``close()`` raises instead of silently
    truncating the artifact with a fresh ``open(.., "w")``."""

    def __init__(self, path: str, tick_every: int = 1,
                 meta: Optional[dict] = None):
        self.path = path
        self.tick_every = max(int(tick_every), 1)
        self.meta = meta
        self.events = 0
        self._fh = None
        self._closed = False

    # -- plumbing ---------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def _write(self, record: dict) -> None:
        if self._closed:
            raise ValueError(
                f"JsonlObserver({self.path!r}) is closed; events after "
                f"close() would truncate the artifact")
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # line-buffered: one event == one line == one flush unit
            self._fh = open(self.path, "w", buffering=1)
            if self.meta:
                self._fh.write(json.dumps(
                    {"event": "meta", **self.meta}) + "\n")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        self.events += 1

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        self._closed = True
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlObserver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- hooks ------------------------------------------------------------

    def on_tick(self, now: float, sim) -> None:
        if int(now) % self.tick_every:
            return
        nodes = len(sim.cluster.nodes)
        inst = sim.cluster.total_instances()
        rec = {"event": "tick", "now": now, "nodes": nodes,
               "instances": inst,
               "density": inst / nodes if nodes else 0.0}
        # cumulative QoS counters so offline readers can label each
        # decision with "breach within horizon" by windowed deltas
        # instead of re-running the simulation
        live = getattr(sim, "live_result", None)
        if live is not None:
            rec["requests"] = round(live.requests, 3)
            rec["violated"] = round(live.violated_requests, 3)
        # pending-request backlog (repro.admission); absent — not 0 —
        # when the admission axis is off, so off-axis streams are
        # byte-identical to the pre-admission format
        depth = sim.queue_depth_total()
        if depth is not None:
            rec["queue_depth"] = round(depth, 3)
        self._write(rec)

    def on_schedule(self, now: float, fn: str, placements,
                    trace=None) -> None:
        rec = {"event": "schedule", "now": now, "fn": fn,
               "placed": sum(p.count for p in placements),
               "placements": [[p.node_id, p.count,
                               round(p.latency_ms, 4)]
                              for p in placements]}
        if trace is not None:
            rec["trace"] = trace.summary()
        self._write(rec)

    def on_scale(self, now: float, fn: str, event: str,
                 count: int) -> None:
        self._write({"event": "scale", "now": now, "fn": fn,
                     "kind": event, "count": count})

    def on_retrain(self, service) -> None:
        self._write({"event": "retrain", "epoch": service.epoch,
                     "retrains": service.stats.retrains,
                     "samples": service.predictor.n_samples})

    def on_result(self, result) -> None:
        self._write({
            "event": "summary",
            "scheduler": result.name,
            "ticks": result.ticks,
            "density": round(result.density, 4),
            "qos_violation_rate": round(result.qos_violation_rate, 6),
            "requests": round(result.requests, 3),
            "violated_requests": round(result.violated_requests, 3),
            "nodes_peak": result.nodes_peak,
            "per_fn_violation_rate": {
                fn: round(r, 6)
                for fn, r in sorted(result.per_fn_violation_rate().items())
            },
            # per-SLO-class accounting (repro.admission); keys absent
            # when the admission axis is off
            **({"class_violation_rate": {
                    c: round(r, 6) for c, r
                    in sorted(result.class_violation_rate().items())},
                "dropped_requests": round(result.dropped_requests, 3),
                "queue_delay_p99_s": round(result.queue_delay_s.p99, 4),
                "queue_depth_peak": round(result.queue_depth_peak, 3)}
               if result.class_requests else {}),
        })

    def on_span(self, span) -> None:
        self._write({"event": "span", **span.to_dict()})
