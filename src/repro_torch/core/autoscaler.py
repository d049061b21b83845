"""Autoscaling: traditional keep-alive vs Jiagu's dual-staged scaling
(paper §5), plus on-demand migration of cached instances.

Dual-staged timeline for a load drop (paper Fig. 10, defaults §6):
    t=0       expected saturated count drops below current
    t=release_s   "release": re-route, excess instances become *cached*
    t=keepalive_s "real eviction": still-cached instances are destroyed
A load rise first consumes cached instances via *logical cold starts*
(re-route, <1 ms) and only then asks the scheduler for real cold starts.

The autoscaler consumes its scheduler only through the ``repro.platform``
capability protocols — ``ReleasePicker`` / ``LogicalStartPicker`` for
the dual-staged picks and ``CapacityProvider`` for migration targeting —
never through concrete class identity, so any scheduler that opts into
dual-staged scaling (the ``BaseScheduler`` greedy defaults, or its own
overrides) gets the full release / logical-cold-start / migration
machinery.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

from .cluster import Cluster, Node
from .events import EventHub
from .metrics import Reservoir
from .scheduler import REROUTE_MS, BaseScheduler

DEFAULT_KEEPALIVE_S = 60.0


@dataclass
class ScalingConfig:
    release_s: float = 45.0          # dual-staged release sensitivity
    keepalive_s: float = DEFAULT_KEEPALIVE_S
    init_ms: float = 8.4             # cfork container init; docker: 85.5
    dual_staged: bool = True
    migrate: bool = True             # on-demand migration of cached insts


@dataclass
class ScalingMetrics:
    real_cold_starts: int = 0
    logical_cold_starts: int = 0
    blocked_logical: int = 0         # cached present but node full ->
    #                                  would-be real cold start (paper
    #                                  Fig 14-b "migrations needed")
    migrations: int = 0
    releases: int = 0
    evictions: int = 0
    # bounded: long traces record one sample per (logical) cold start
    cold_start_ms: Reservoir = field(default_factory=lambda: Reservoir(512))

    @property
    def mean_cold_start_ms(self) -> float:
        return self.cold_start_ms.mean   # exact (running sum/count)

    @property
    def p99_cold_start_ms(self) -> float:
        return self.cold_start_ms.p99


class _CachedLedger:
    """FIFO of released (cached) instances per function, for keep-alive
    eviction accounting.  Entries: (release_time, node_id, count)."""

    def __init__(self):
        self.q: Dict[str, Deque[List]] = {}

    def push(self, fn: str, t: float, node_id: int, k: int):
        self.q.setdefault(fn, deque()).append([t, node_id, k])

    def pop_newest(self, fn: str, node_id: int, k: int) -> int:
        """Consume up to k cached instances of fn on node (newest first,
        so the oldest keep aging toward eviction)."""
        got = 0
        dq = self.q.get(fn)
        if not dq:
            return 0
        for entry in reversed(dq):
            if k <= 0:
                break
            if entry[1] != node_id:
                continue
            take = min(k, entry[2])
            entry[2] -= take
            got += take
            k -= take
        self.q[fn] = deque(e for e in dq if e[2] > 0)
        return got

    def expired(self, fn: str, now: float, ttl: float
                ) -> List[Tuple[int, int]]:
        """Pop all entries older than ttl; returns [(node_id, count)]."""
        dq = self.q.get(fn)
        out: List[Tuple[int, int]] = []
        if not dq:
            return out
        while dq and now - dq[0][0] >= ttl:
            _, node_id, k = dq.popleft()
            out.append((node_id, k))
        return out

    def move(self, fn: str, src: int, dst: int, k: int):
        dq = self.q.get(fn)
        if not dq:
            return
        splits = []
        for entry in dq:
            if k <= 0:
                break
            if entry[1] != src:
                continue
            take = min(k, entry[2])
            if take == entry[2]:
                entry[1] = dst
            else:
                entry[2] -= take
                splits.append([entry[0], dst, take])
            k -= take
        dq.extend(splits)


class SchedulerCapacityProvider:
    """Default ``platform.CapacityProvider``: best known capacity of fn
    on node is the capacity-table entry, else a zero-cost
    ``PredictionService`` cache hit (nodes that share a colocation
    signature — and, under schema v2, a node shape — with an
    already-solved node get an answer without any inference), else
    None.  Table-free schedulers simply report None everywhere."""

    def __init__(self, scheduler: BaseScheduler):
        self.scheduler = scheduler

    def node_capacity(self, node: Node, fn: str) -> Optional[int]:
        entry = node.table.get(fn)
        if entry is not None:
            return entry.capacity
        service = self.scheduler.prediction_service
        if service is None:
            return None
        return service.capacity_hint(service.node_coloc(node), fn,
                                     node_res=node.res)


class Autoscaler:
    """``release_picker`` / ``logical_start_picker`` / ``capacity``
    plug the scaling policies (defaults: the scheduler itself, which
    implements the picker protocols, and a table/cache-hint capacity
    provider); ``events`` receives ``on_schedule`` / ``on_scale``
    observer callbacks."""

    def __init__(self, cluster: Cluster, scheduler: BaseScheduler,
                 cfg: ScalingConfig, *,
                 release_picker=None, logical_start_picker=None,
                 capacity=None, events: Optional[EventHub] = None):
        self.cluster = cluster
        self.scheduler = scheduler
        self.cfg = cfg
        self.release_picker = release_picker or scheduler
        self.logical_start_picker = logical_start_picker or scheduler
        self.capacity = capacity or SchedulerCapacityProvider(scheduler)
        self.events = events or EventHub()
        self.metrics = ScalingMetrics()
        #: AdmissionController (repro.admission) — wired by
        #: ``build_simulation`` when the admission axis is enabled.
        #: Drives the end-of-tick vertical resize pass and stamps
        #: queue/SLO context onto DecisionTraces; None (default) keeps
        #: every pre-admission code path untouched.
        self.admission = None
        self._below_since: Dict[str, Optional[float]] = {}
        self._ledger = _CachedLedger()
        #: event-core hook — called with fn when an out-of-band mutation
        #: (a scheduler-initiated release) means fn needs a tick soon
        self.on_fn_dirty: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------

    def note_release(self, fn: str, node: Node, k: int, now: float
                     ) -> bool:
        """Account a *scheduler-initiated* release (e.g. harvesting's
        QoS-breach give-back, performed via ``node.release``): the
        released instances enter the same keep-alive ledger as the
        autoscaler's own releases, so they are keep-alive-evicted,
        migrated, and counted (``metrics.releases`` / ``on_scale``)
        exactly like any other cached instance.

        Returns False without accounting when this autoscaler runs
        traditional keep-alive (``dual_staged=False``): its ledger
        sweep never fires there, so accepting the entry would park the
        instances as permanently-cached — the caller must keep-alive
        them itself."""
        if not self.cfg.dual_staged:
            return False
        if k <= 0:
            return True
        self._ledger.push(fn, now, node.id, k)
        self.metrics.releases += k
        self.events.on_scale(now, fn, "release", k)
        if self.on_fn_dirty is not None:
            self.on_fn_dirty(fn)
        return True

    def expected_instances(self, fn: str, rps: float) -> int:
        spec = self.cluster.specs[fn]
        if rps <= 1e-9:
            return 0
        return max(1, math.ceil(rps / spec.saturated_rps))

    def tick(self, now: float, rps: Dict[str, float],
             fns: Optional[Iterable[str]] = None):
        """One autoscaler pass.  ``fns=None`` (the legacy tick loop)
        visits every spec; the event-driven core passes just the *due*
        functions, already ordered like ``cluster.specs`` — skipped
        functions are exactly those whose ``_tick_fn`` would have been a
        no-op (no load, no timers armed, no ledger entries)."""
        for fn in (self.cluster.specs if fns is None else fns):
            self._tick_fn(now, fn, rps.get(fn, 0.0))
        if self.cfg.dual_staged and self.cfg.migrate:
            self._migrate(now)
        if self.admission is not None:
            # vertical resize rides the horizontal pass: shrink/grow
            # cpu reservations, re-solved against the capacity table
            self.admission.vertical_tick(now, self.cluster,
                                         self.scheduler, self.events)
        self.cluster.reap_empty()

    def next_wake(self, fn: str) -> Optional[float]:
        """Earliest future time fn needs autoscaler attention absent any
        load change: the armed scale-down timer and/or the keep-alive
        expiry of the oldest ledger entry.  None = nothing pending (the
        event core lets the function sleep until its load changes)."""
        t: Optional[float] = None
        if self.cfg.dual_staged:
            dq = self._ledger.q.get(fn)
            if dq:
                t = dq[0][0] + (self.cfg.keepalive_s - self.cfg.release_s)
        since = self._below_since.get(fn)
        if since is not None:
            delay = self.cfg.release_s if self.cfg.dual_staged \
                else self.cfg.keepalive_s
            t = since + delay if t is None else min(t, since + delay)
        return t

    # ------------------------------------------------------------------

    def _scale_up(self, now: float, fn: str, need: int):
        if self.cfg.dual_staged:
            picks = self.logical_start_picker.pick_logical_start_nodes(
                fn, need)
            for node, k in picks:
                got = node.logical_start(fn, k)
                self._ledger.pop_newest(fn, node.id, got)
                self.metrics.logical_cold_starts += got
                self.metrics.cold_start_ms.extend([REROUTE_MS] * got)
                need -= got
                self.scheduler.notify_change(node, now)
                if got:
                    self.events.on_scale(now, fn, "logical_start", got)
            if need > 0 and self.cluster.cached_count(fn) > 0:
                # cached instances exist but their nodes are full: these
                # conversions would have been real cold starts; migration
                # exists to prevent this state (paper Fig 14-b).
                self.metrics.blocked_logical += min(
                    need, self.cluster.cached_count(fn))
        if need > 0:
            placements = self.scheduler.schedule(fn, need, now)
            placed = sum(p.count for p in placements)
            self.metrics.real_cold_starts += placed
            for p in placements:
                self.metrics.cold_start_ms.extend(
                    [p.latency_ms + self.cfg.init_ms] * p.count)
            # pipeline schedulers attach a DecisionTrace explaining the
            # placement; legacy monolithic schedulers yield None
            trace = self.scheduler.take_trace()
            if trace is not None and self.admission is not None:
                # schema-v3 admission context: queue depth/age + class
                self.admission.stamp_trace(trace, fn, now)
            self.events.on_schedule(now, fn, placements, trace)
            if placed:
                self.events.on_scale(now, fn, "real_cold_start", placed)

    def _scale_down_dual(self, now: float, fn: str, expected: int,
                         n_sat: int):
        since = self._below_since.get(fn)
        if since is None:
            self._below_since[fn] = now
            return
        if now - since < self.cfg.release_s:
            return
        excess = n_sat - expected
        for node, k in self.release_picker.pick_release_nodes(fn, excess):
            got = node.release(fn, k)
            self._ledger.push(fn, now, node.id, got)
            self.metrics.releases += got
            self.scheduler.notify_change(node, now)
            if got:
                self.events.on_scale(now, fn, "release", got)
        self._below_since[fn] = now  # re-arm for further drops

    def _scale_down_traditional(self, now: float, fn: str, expected: int,
                                n_sat: int):
        since = self._below_since.get(fn)
        if since is None:
            self._below_since[fn] = now
            return
        if now - since < self.cfg.keepalive_s:
            return
        excess = n_sat - expected
        for node, k in self.release_picker.pick_release_nodes(fn, excess):
            got = node.evict_sat(fn, k)
            self.metrics.evictions += got
            self.scheduler.notify_change(node, now)
            if got:
                self.events.on_scale(now, fn, "evict", got)
        self._below_since[fn] = now

    def _tick_fn(self, now: float, fn: str, rps: float):
        expected = self.expected_instances(fn, rps)
        n_sat = self.cluster.sat_count(fn)

        if expected > n_sat:
            self._below_since[fn] = None
            self._scale_up(now, fn, expected - n_sat)
        elif expected < n_sat:
            if self.cfg.dual_staged:
                self._scale_down_dual(now, fn, expected, n_sat)
            else:
                self._scale_down_traditional(now, fn, expected, n_sat)
        else:
            self._below_since[fn] = None

        # keep-alive eviction of cached instances (dual-staged only)
        if self.cfg.dual_staged:
            ttl = self.cfg.keepalive_s - self.cfg.release_s
            for node_id, k in self._ledger.expired(fn, now, ttl):
                node = self.cluster.nodes.get(node_id)
                if node is None:
                    continue
                got = node.evict_cached(fn, k)
                self.metrics.evictions += got
                if got:
                    self.scheduler.notify_change(node, now)
                    self.events.on_scale(now, fn, "evict", got)

    # -- on-demand migration (paper §5) ---------------------------------

    def _node_capacity(self, node: Node, fn: str) -> Optional[int]:
        """Best known capacity of fn on node, via the pluggable
        ``CapacityProvider`` (default: capacity table, then zero-cost
        service cache hints)."""
        return self.capacity.node_capacity(node, fn)

    def _migrate(self, now: float):
        """Move cached instances off nodes where they could no longer be
        re-saturated (n_sat + n_cached > capacity), hiding the real cold
        start they would otherwise cost.  Additionally *consolidates*:
        a node left with only cached instances migrates them to busy
        nodes with headroom so the empty server can be returned (paper
        §6: "an empty server will be evicted to optimize costs" — cached
        instances must not pin otherwise-idle machines).

        Scans only nodes holding cached instances (the cluster's
        ``nodes_with_cached`` index, ascending id like the old full
        scan): zero-cached nodes are no-ops here, and a node that
        *gains* cached instances mid-pass as a migration target either
        was already in the snapshot or keeps ``n_sat > 0`` with
        post-move excess <= 0 (the target-fit condition), so the full
        scan would not have acted on it either."""
        for node in self.cluster.nodes_with_cached():
            all_cached = all(s.n_sat == 0 for s in node.funcs.values()) \
                and node.n_instances() > 0
            for fn, st in list(node.funcs.items()):
                if st.n_cached == 0:
                    continue
                cap = self._node_capacity(node, fn)
                if all_cached:
                    k = st.n_cached
                elif cap is not None:
                    excess = st.n_sat + st.n_cached - cap
                    if excess <= 0:
                        continue
                    k = min(excess, st.n_cached)
                else:
                    continue
                target = self._find_migration_target(fn, node, k)
                if target is None:
                    continue
                node.evict_cached(fn, k)
                target.add_cached(fn, k)
                self._ledger.move(fn, node.id, target.id, k)
                self.metrics.migrations += k
                self.scheduler.notify_change(node, now)
                self.scheduler.notify_change(target, now)
                self.events.on_scale(now, fn, "migrate", k)

    def _find_migration_target(self, fn: str, src: Node, k: int
                               ) -> Optional[Node]:
        for node in sorted(self.cluster.nodes_with(fn),
                           key=lambda n: -n.funcs[fn].n_sat):
            if node.id == src.id:
                continue
            cap = self._node_capacity(node, fn)
            if cap is None:
                continue
            st = node.funcs[fn]
            if (cap - st.n_sat - st.n_cached >= k
                    and self.cluster.mem_headroom(node, fn) >= k):
                return node
        return None
