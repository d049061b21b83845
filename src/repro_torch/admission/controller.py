"""``AdmissionController`` — the per-cell admission/vertical control
loop the simulator drives.

Each simulated tick splits into two admission phases around the
horizontal autoscaler:

  * ``enqueue(now, rps, cluster)`` — arrivals enter the per-function
    bounded queues (the configured admit stage decides overflow), and
    the *scaling signal* the autoscaler will see is derived from queue
    state instead of instantaneous rps (``signal="queue"``, the
    KEDA-style backpressure mode):

        signal = max(min(arrivals, service_rate), depth / target_drain_s)

    A one-tick spike beyond the fleet's current service rate lands in
    the queue; only a backlog that *persists* (depth still high after
    draining) raises the signal, so storms scale out over a few ticks
    of geometric catch-up instead of insta-scaling to the spike peak —
    fewer cold starts, and the burst becomes measurable queueing delay.
    ``signal="rps"`` keeps the legacy instantaneous signal (the
    horizontal-only benchmark arm) while the queues still meter and
    account traffic identically.
  * ``drain(now, cluster, res)`` — after scaling (logical cold starts
    are instant, so fresh capacity is already live), the release stage
    drains each backlog into service up to the fleet's current service
    rate.  The released traffic is what the measurement pass routes;
    its exact per-bucket queueing delays are sampled into
    ``SimResult.queue_delay_s`` and checked against the function's SLO
    class budget — latency-critical requests violate on a tight budget,
    best-effort absorbs queueing.  Overflow drops count as violated
    requests of their class (they were never served).

Per-request conservation (arrived == released + dropped + pending)
holds queue-by-queue; ``conservation_error()`` exposes the fleet
residual and the benchmark gates it at float-eps.

The controller is strictly per-cell state (its queues see only the
cell's traffic share), which keeps the ``cells=1`` wrap bit-exact:
disabled admission is ``None`` everywhere — not a pass-through object
— so every parity code path is structurally unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set

from .queue import (BoundedFifoAdmit, FunctionQueue, GreedyQueueRelease,
                    PacedQueueRelease, ShedOldestAdmit)
from .slo import LATENCY_CRITICAL, delay_budget_s, tag_slo_classes
from .vertical import VerticalScaler

_EPS = 1e-9

#: admission-local stage factories (platform re-registers these under
#: its ``admit:`` / ``queue-release:`` registry keys for config-driven
#: selection; keeping the authoritative dicts here avoids an import
#: cycle with ``core.platform``)
ADMIT_STAGES = {
    BoundedFifoAdmit.name: BoundedFifoAdmit,
    ShedOldestAdmit.name: ShedOldestAdmit,
}
RELEASE_STAGES = {
    GreedyQueueRelease.name: GreedyQueueRelease,
    PacedQueueRelease.name: PacedQueueRelease,
}


@dataclass
class AdmissionConfig:
    """Standalone mirror of ``PlatformConfig.admission`` (same fields,
    same defaults) for direct library/test construction."""

    enabled: bool = True
    vertical: bool = False
    signal: str = "queue"            # "queue" | "rps"
    best_effort_frac: float = 0.5
    slo_seed: int = 0
    queue_cap_s: float = 8.0         # bound, in seconds of arrival rate
    target_drain_s: float = 2.0      # KEDA signal: drain backlog in ~2s
    lc_delay_budget_s: float = 0.25  # latency-critical queueing budget
    be_delay_budget_s: float = 8.0   # best-effort absorbs this much
    catch_up_mult: float = 1.5       # backlog catch-up cap, x arrival peak
    admit: str = "bounded-fifo"
    queue_release: str = "greedy"
    min_share: float = 0.5           # vertical shrink floor
    resize_every_s: float = 15.0


class AdmissionController:
    """Queues + SLO classes + (optionally) the vertical resizer for one
    cluster/cell."""

    def __init__(self, specs, cfg=None, *, store=None,
                 slo: Optional[Dict[str, str]] = None):
        self.specs = specs
        self.cfg = cfg = cfg or AdmissionConfig()
        self.slo: Dict[str, str] = dict(slo) if slo is not None else \
            tag_slo_classes(specs, cfg.best_effort_frac, cfg.slo_seed)
        try:
            self.admit_stage = ADMIT_STAGES[cfg.admit]()
            self.release_stage = RELEASE_STAGES[cfg.queue_release]()
        except KeyError as e:
            raise ValueError(
                f"unknown admission stage {e.args[0]!r} (admit: "
                f"{sorted(ADMIT_STAGES)}, queue-release: "
                f"{sorted(RELEASE_STAGES)})") from None
        self.queues: Dict[str, FunctionQueue] = {}
        self.vertical: Optional[VerticalScaler] = None
        if getattr(cfg, "vertical", False):
            self.vertical = VerticalScaler(
                specs, self.slo, min_share=cfg.min_share,
                resize_every_s=cfg.resize_every_s, store=store)
        #: functions with a non-empty backlog (drives drain + the
        #: event-core due sets)
        self._pending: Set[str] = set()
        #: per-tick drops buffered between enqueue and drain (drain
        #: owns all SimResult accounting)
        self._dropped_now: Dict[str, float] = {}
        #: peak-hold arrival-rate EWMA sizing the queue bound
        self._ewma: Dict[str, float] = {}
        #: post-drain backlog snapshot (fn -> depth) from the previous
        #: tick — the vertical resizer's pressure signal (mid-tick
        #: queue depth counts still-undrained arrivals, not pressure)
        self._backlog: Dict[str, float] = {}
        self.depth_peak = 0.0

    # -- phase 1: arrivals + scaling signal ------------------------------

    def enqueue(self, now: float, rps: Dict[str, float],
                cluster) -> Dict[str, float]:
        """Admit this tick's arrivals; return the autoscaler's signal
        (covers every function in ``rps`` plus any with backlog)."""
        cfg = self.cfg
        signal = dict(rps)
        fns = [fn for fn, v in rps.items() if v > _EPS]
        if self._pending:
            fns += [fn for fn in self._pending
                    if rps.get(fn, 0.0) <= _EPS]
        for fn in fns:
            spec = self.specs[fn]
            arr = rps.get(fn, 0.0)
            q = self.queues.get(fn)
            if q is None:
                q = self.queues[fn] = FunctionQueue(
                    fn, cfg.queue_cap_s * spec.saturated_rps)
            # peak-hold EWMA keeps the bound from collapsing onto a
            # still-draining backlog the tick a storm ends
            ew = max(arr, 0.9 * self._ewma.get(fn, 0.0))
            self._ewma[fn] = ew
            q.cap = cfg.queue_cap_s * max(spec.saturated_rps, ew)
            _accepted, dropped = self.admit_stage.admit(q, arr, now)
            if dropped > _EPS:
                self._dropped_now[fn] = \
                    self._dropped_now.get(fn, 0.0) + dropped
            if q.depth > _EPS:
                self._pending.add(fn)
                if q.depth > self.depth_peak:
                    self.depth_peak = q.depth
            else:
                self._pending.discard(fn)
            if cfg.signal == "queue":
                # catch-up provisioning to drain the backlog in
                # ~target_drain_s, capped at catch_up_mult x the
                # peak-held arrival rate: a storm-sized backlog must
                # not insta-scale the fleet to the backlog itself
                # (that is the horizontal-only failure mode the queue
                # exists to absorb)
                catch_up = min(q.depth / cfg.target_drain_s,
                               cfg.catch_up_mult * max(ew, arr))
                if self.slo.get(fn) == LATENCY_CRITICAL:
                    # latency-critical cannot afford queueing (any
                    # queued tick blows a sub-second budget): scale on
                    # instantaneous arrivals plus backlog catch-up
                    signal[fn] = max(arr, catch_up)
                else:
                    # best-effort absorbs the burst: the autoscaler
                    # sees at most current capacity until a backlog
                    # *persists* past drains — geometric catch-up
                    # instead of insta-scaling to the storm peak
                    rate = cluster.sat_count(fn) * spec.saturated_rps
                    signal[fn] = max(min(arr, rate), catch_up)
            else:
                signal[fn] = arr
        return signal

    def pending_fns(self) -> Set[str]:
        return set(self._pending)

    # -- phase 2: drain into service + accounting ------------------------

    def drain(self, now: float, cluster, res) -> Dict[str, float]:
        """Release backlog into service at the fleet's current rate;
        account queue delays, class budgets and drops into ``res``.
        Returns the served rps dict the measurement pass routes."""
        cfg = self.cfg
        served: Dict[str, float] = {}
        for fn in sorted(self._pending):
            q = self.queues[fn]
            spec = self.specs[fn]
            rate = cluster.sat_count(fn) * spec.saturated_rps
            buckets = self.release_stage.release(q, rate, now)
            cls = self.slo.get(fn)
            budget = delay_budget_s(cls, cfg.lc_delay_budget_s,
                                    cfg.be_delay_budget_s)
            got = viol = 0.0
            for t0, c in buckets:
                d = now - t0
                got += c
                res.queue_delay_s.append(d)
                if d > budget:
                    viol += c
            if got > _EPS:
                served[fn] = got
            if viol > _EPS:
                # queueing blew the class budget: violated regardless
                # of how fast execution itself is (the requests are
                # still served and counted by the measurement pass)
                res.violated_requests += viol
                res.per_fn_violations[fn] = \
                    res.per_fn_violations.get(fn, 0.0) + viol
                res.class_violations[cls] = \
                    res.class_violations.get(cls, 0.0) + viol
            if q.depth <= _EPS:
                self._pending.discard(fn)
        self._backlog = {fn: q.depth for fn, q in self.queues.items()
                         if q.depth > _EPS}
        if self._dropped_now:
            for fn, d in self._dropped_now.items():
                cls = self.slo.get(fn)
                # never served: count arrival AND violation here (the
                # measurement pass will not see these requests)
                res.requests += d
                res.violated_requests += d
                res.dropped_requests += d
                res.per_fn_requests[fn] = \
                    res.per_fn_requests.get(fn, 0.0) + d
                res.per_fn_violations[fn] = \
                    res.per_fn_violations.get(fn, 0.0) + d
                res.class_requests[cls] = \
                    res.class_requests.get(cls, 0.0) + d
                res.class_violations[cls] = \
                    res.class_violations.get(cls, 0.0) + d
            self._dropped_now.clear()
        return served

    # -- vertical + trace hooks ------------------------------------------

    def vertical_tick(self, now: float, cluster, scheduler,
                      events) -> None:
        if self.vertical is not None:
            self.vertical.tick(now, cluster, scheduler, self._backlog,
                               events)

    def stamp_trace(self, trace, fn: str, now: float) -> None:
        """Decision-trace admission context (schema v3 fields)."""
        q = self.queues.get(fn)
        trace.queue_depth = q.depth if q is not None else 0.0
        trace.queue_age_s = q.oldest_age(now) if q is not None else 0.0
        trace.slo_class = self.slo.get(fn)

    # -- bookkeeping ------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        t = {"arrived": 0.0, "released": 0.0, "dropped": 0.0,
             "depth": 0.0}
        for q in self.queues.values():
            t["arrived"] += q.arrived
            t["released"] += q.released
            t["dropped"] += q.dropped
            t["depth"] += q.depth
        return t

    def queue_depth(self) -> float:
        return sum(q.depth for q in self.queues.values())

    def conservation_error(self) -> float:
        return max((q.conservation_error()
                    for q in self.queues.values()), default=0.0)

    def finalize(self, res) -> None:
        """Fold end-of-run admission state into the SimResult (cells
        call this once per cell controller; counters accumulate)."""
        res.queue_depth_peak = max(res.queue_depth_peak,
                                   self.depth_peak)
        if self.vertical is not None:
            res.vertical_grows += self.vertical.grows
            res.vertical_shrinks += self.vertical.shrinks
