"""Schedulers: Jiagu pre-decision scheduling + the three baselines
(Kubernetes, Gsight-style, Owl-style) from the paper's evaluation.

Scheduling-cost accounting is *measured*, not assumed: every slow-path /
per-schedule inference is a real call into the RFR predictor and its wall
time is what lands in the metrics.  Fast-path decisions cost a table
lookup (FAST_PATH_MS).  Asynchronous capacity-table updates run real
inference too, but their time is billed to background work, never to the
scheduling critical path — the paper's core claim.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .capacity import M_MAX_DEFAULT, QoSStore, capacity_of, \
    update_capacity_table
from .cluster import CapEntry, Cluster, Node
from .metrics import Reservoir
from .predictor import PerfPredictor
from .prediction_service import EngineConfig, PredictionService
from .profiles import FunctionSpec, ProfileStore
from .registry import Registry

FAST_PATH_MS = 0.05     # capacity-table lookup + comparison
REROUTE_MS = 0.5        # logical cold start: K8s Service label flip


@dataclass
class SchedMetrics:
    decisions: int = 0
    instances_placed: int = 0
    fast: int = 0
    slow: int = 0
    failed: int = 0
    sched_time_ms: float = 0.0
    # bounded: 512-node full-trace runs record one sample per decision
    sched_latencies: Reservoir = field(
        default_factory=lambda: Reservoir(512))
    critical_inference_rows: int = 0
    critical_inference_calls: int = 0
    async_inference_rows: int = 0
    async_updates: int = 0

    @property
    def mean_latency_ms(self) -> float:
        return self.sched_latencies.mean   # exact (running sum/count)

    @property
    def p50_latency_ms(self) -> float:
        return self.sched_latencies.p50

    @property
    def p99_latency_ms(self) -> float:
        return self.sched_latencies.p99


@dataclass
class Placement:
    node_id: int
    count: int
    latency_ms: float      # scheduling latency experienced by this decision


class BaseScheduler:
    name = "base"
    #: table-driven schedulers (Jiagu) accept an attached
    #: ``PredictionService`` for batched/cached capacity solving
    accepts_service = False
    #: True for schedulers whose ``observe`` learns from *healthy* nodes
    #: too (Owl's safe-set promotion): the measurement pass must then
    #: visit every hosting node, not just those with live traffic — the
    #: dirty-set scan in ``simulator.measure_cluster`` keys off this
    needs_idle_observe = False
    #: pipeline hosts record a ``pipeline.DecisionTrace`` per decision
    #: when True (legacy monolithic schedulers never produce one).
    #: Off by default — traces exist to be consumed through the
    #: ``on_schedule`` observer hook, so ``Platform.build`` turns
    #: recording on when observers are attached (or when the manifest's
    #: ``pipeline.decision_traces`` forces it); standalone consumers
    #: set the attribute directly.
    trace_decisions = False
    #: additionally snapshot every node's raw candidate feature vector
    #: (``pipeline.candidate_feature_row``) and the chosen node into
    #: each ``DecisionTrace`` — the ``repro.policy`` training input.
    #: Off by default: the capture costs O(nodes) per decision, so only
    #: dataset-collection runs opt in (``PlatformConfig
    #: pipeline.trace_features``).  Implies nothing unless
    #: ``trace_decisions`` is also on.
    trace_features = False

    def __init__(self, cluster: Cluster, store: ProfileStore,
                 qos: QoSStore):
        self.cluster = cluster
        self.store = store
        self.qos = qos
        self.metrics = SchedMetrics()
        #: the most recent decision's trace (pipeline schedulers only);
        #: consumed by the autoscaler via ``take_trace`` and forwarded
        #: through the ``on_schedule`` observer hook
        self.last_trace = None
        # dual-staged scaling picks are pipeline stages (swappable via
        # platform.register_stage / PlatformConfig.pipeline)
        from .pipeline import (GreedyLogicalStartPicker,
                               GreedyReleasePicker)
        self.release_stage = GreedyReleasePicker(self)
        self.logical_start_stage = GreedyLogicalStartPicker(self)
        #: keep-alive accountant for scheduler-initiated releases (the
        #: assembled autoscaler, wired by build_simulation; None when
        #: the scheduler runs standalone)
        self.release_ledger = None

    # -- interface ---------------------------------------------------------

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        raise NotImplementedError

    def on_tick(self, now: float):
        pass

    def has_pending_work(self) -> bool:
        """True when ``on_tick`` has queued work whose *timing* matters
        (async capacity-table updates, deferred releases).  The
        event-driven core calls ``on_tick`` every tick while this holds
        even if no function in the cell is due, so deferred work drains
        on the same tick it would under the legacy loop."""
        return False

    def notify_change(self, node: Node, now: float):
        """Called when counts change outside scheduling (release/evict)."""
        pass

    def observe(self, node: Node, ok: bool, now: float):
        """Runtime QoS observation feedback (used by Owl)."""
        pass

    @property
    def prediction_service(self) -> Optional[PredictionService]:
        """The scheduler's ``PredictionService``, if it uses one — the
        ``platform.CapacityProvider`` hint source and the simulator's
        sample-collection client.  None for table-free baselines."""
        return None

    def attach_service(self, service: PredictionService) -> None:
        """Attach a ``PredictionService`` (only meaningful when
        ``accepts_service``)."""
        raise TypeError(f"{type(self).__name__} does not accept a "
                        f"PredictionService")

    # -- decision traces (pipeline schedulers) ----------------------------

    def take_trace(self):
        """Pop the most recent decision's ``DecisionTrace`` (None for
        legacy monolithic schedulers or when tracing is disabled)."""
        trace, self.last_trace = self.last_trace, None
        return trace

    def on_place(self, node: Node, k: int, now: float,
                 latency_ms: float) -> None:
        """Post-placement hook the pipeline's ``DecisionContext`` fires
        for every binding (Jiagu queues its async capacity update
        here)."""

    def qos_cooldown_until(self, node: Node) -> float:
        """Until when the scheduler considers ``node`` QoS-breached
        (harvesting-style policies override; -inf = never breached).
        Consumed by breach-aware release/logical-start stages."""
        return float("-inf")

    # -- dual-staged scaling capabilities (platform.ReleasePicker /
    # -- platform.LogicalStartPicker; the autoscaler consumes these).
    # -- The policies themselves are pipeline stages held in
    # -- ``release_stage`` / ``logical_start_stage`` (greedy defaults;
    # -- Jiagu installs the table-bound logical-start stage) -------------

    def pick_release_nodes(self, fn: str, k: int) -> List[Tuple[Node, int]]:
        return self.release_stage.pick_release_nodes(fn, k)

    def pick_logical_start_nodes(self, fn: str, k: int
                                 ) -> List[Tuple[Node, int]]:
        return self.logical_start_stage.pick_logical_start_nodes(fn, k)

    # -- shared helpers ------------------------------------------------

    def _new_node(self) -> Node:
        return self.cluster.add_node()

    def _mem_room(self, node: Node, fn: str) -> int:
        return self.cluster.mem_headroom(node, fn)


# ---------------------------------------------------------------------------
# Kubernetes baseline: requested-resource bin packing, no overcommitment
# ---------------------------------------------------------------------------


class K8sScheduler(BaseScheduler):
    name = "k8s"

    def _fits(self, node: Node, spec: FunctionSpec) -> bool:
        return (node.cpu_requested(self.cluster.specs) + spec.cpu_req
                <= node.res.cpu_mcores
                and node.mem_used(self.cluster.specs) + spec.mem_req
                <= node.res.mem_mb)

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        spec = self.cluster.specs[fn]
        out: List[Placement] = []
        for _ in range(count):
            target = None
            # most-allocated first (default kube-scheduler bin-packing-ish)
            for node in sorted(self.cluster.nodes.values(),
                               key=lambda n: -n.cpu_requested(
                                   self.cluster.specs)):
                if self._fits(node, spec):
                    target = node
                    break
            if target is None:
                target = self._new_node()
            target.deploy(fn, 1)
            out.append(Placement(target.id, 1, FAST_PATH_MS))
            self.metrics.decisions += 1
            self.metrics.instances_placed += 1
            self.metrics.fast += 1
            self.metrics.sched_latencies.append(FAST_PATH_MS)
            self.metrics.sched_time_ms += FAST_PATH_MS
        return out


# ---------------------------------------------------------------------------
# Jiagu: pre-decision scheduling (fast/slow path + async update + batching)
# ---------------------------------------------------------------------------


class JiaguScheduler(BaseScheduler):
    name = "jiagu"
    accepts_service = True

    def __init__(self, cluster: Cluster, store: ProfileStore, qos: QoSStore,
                 predictor: PerfPredictor, m_max: int = M_MAX_DEFAULT,
                 engine: Optional[PredictionService] = None):
        super().__init__(cluster, store, qos)
        self.predictor = predictor
        self.m_max = m_max
        # optional PredictionService (batched/cached solving; None keeps
        # the legacy per-node reference path)
        self.engine = engine
        self._pending: Dict[int, float] = {}  # node id -> due time
        # logical starts absorb only up to the capacity table's bound
        from .pipeline import TableBoundLogicalStartPicker
        self.logical_start_stage = TableBoundLogicalStartPicker(self)

    @property
    def prediction_service(self) -> Optional[PredictionService]:
        return self.engine

    def attach_service(self, service: PredictionService) -> None:
        self.engine = service

    # -- async update machinery -----------------------------------------

    def _queue_update(self, node: Node, now: float):
        est = max(self.predictor.mean_inference_ms, 0.5) / 1e3
        due = now + est
        self._pending[node.id] = max(self._pending.get(node.id, 0.0), due)
        node.update_pending_until = self._pending[node.id]

    def has_pending_work(self) -> bool:
        return bool(self._pending)

    def on_tick(self, now: float):
        due = [nid for nid, t in self._pending.items() if t <= now]
        if self.engine is not None:
            nodes = []
            for nid in due:
                self._pending.pop(nid)
                node = self.cluster.nodes.get(nid)
                if node is not None:
                    nodes.append(node)
            if nodes:
                # one coalesced drain: every due node's scenarios share
                # the same batched predictor passes and the engine cache
                rows = self.engine.update_nodes(nodes, self.m_max)
                for node in nodes:
                    node.update_pending_until = -1.0
                self.metrics.async_inference_rows += rows
                self.metrics.async_updates += len(nodes)
            return
        for nid in due:
            self._pending.pop(nid)
            node = self.cluster.nodes.get(nid)
            if node is None:
                continue
            rows = update_capacity_table(self.predictor, self.store,
                                         self.qos, self.cluster.specs, node,
                                         self.m_max)
            node.update_pending_until = -1.0
            self.metrics.async_inference_rows += rows
            self.metrics.async_updates += 1

    def notify_change(self, node: Node, now: float):
        # releases/evictions only increase capacities; queue a background
        # refresh so the scheduler can reuse the space (paper §5).
        self._queue_update(node, now)

    # -- scheduling -------------------------------------------------------

    def _coloc_counts(self, node: Node) -> Dict[str, Tuple[float, float]]:
        return {g: (float(s.n_sat), float(s.n_cached))
                for g, s in node.funcs.items() if s.total > 0}

    def _slow_capacity(self, node: Node, fn: str,
                       need: int) -> Tuple[int, float]:
        """Compute capacity on the critical path; returns (cap, ms).

        The sweep is capped at what THIS decision needs (current + need):
        the decision only requires knowing whether `need` more instances
        fit, and the asynchronous update queued by the deployment rebuilds
        the full-depth entry off the critical path — so the slow path
        pays O(need) inference rows, not O(m_max)."""
        t0 = time.perf_counter()
        st = node.funcs.get(fn)
        have = st.total if st is not None else 0
        m_cap = min(self.m_max, have + need + 1)
        if self.engine is not None:
            cap, rows = self.engine.capacity(self._coloc_counts(node), fn,
                                             m_cap, node_res=node.res)
        else:
            cap, rows = capacity_of(self.predictor, self.store, self.qos,
                                    self.cluster.specs,
                                    self._coloc_counts(node), fn, m_cap)
        ms = (time.perf_counter() - t0) * 1e3
        node.table[fn] = CapEntry(capacity=cap, fresh=cap < m_cap)
        self.metrics.critical_inference_rows += rows
        self.metrics.critical_inference_calls += 1
        return cap, ms

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        """Concurrency-aware: `count` co-arriving instances of one function
        are one batched decision wherever capacity allows."""
        out: List[Placement] = []
        remaining = count
        decision_ms = 0.0
        used_slow = False

        def place(node: Node, k: int, ms: float):
            nonlocal remaining
            node.deploy(fn, k)
            out.append(Placement(node.id, k, ms))
            remaining -= k
            self.metrics.instances_placed += k
            self._queue_update(node, now + ms / 1e3)

        # 1) fast path: nodes already running fn with a fresh entry
        for node in sorted(self.cluster.nodes_with(fn),
                           key=lambda n: -n.funcs[fn].n_sat):
            if remaining <= 0:
                break
            entry = node.table.get(fn)
            if entry is None or not entry.fresh:
                continue
            st = node.funcs[fn]
            room = min(entry.capacity - st.n_sat - st.n_cached,
                       self._mem_room(node, fn))
            if room <= 0:
                continue
            k = min(remaining, room)
            decision_ms += FAST_PATH_MS
            place(node, k, decision_ms)
            self.metrics.fast += 1

        # 2) slow path: stale entries on fn's nodes, then other nodes
        if remaining > 0:
            cands = [n for n in self.cluster.nodes_with(fn)
                     if n.table.get(fn) is None or not n.table[fn].fresh]
            others = sorted(
                (n for n in self.cluster.nodes.values()
                 if fn not in n.funcs or n.funcs[fn].total == 0),
                key=lambda n: -n.n_instances())
            for node in cands + others:
                if remaining <= 0:
                    break
                if self._mem_room(node, fn) <= 0:
                    continue
                cap, ms = self._slow_capacity(node, fn, remaining)
                decision_ms += ms
                used_slow = True
                st = node.state(fn)
                room = min(cap - st.n_sat - st.n_cached,
                           self._mem_room(node, fn))
                if room <= 0:
                    continue
                k = min(remaining, room)
                place(node, k, decision_ms)
                self.metrics.slow += 1

        # 3) cluster scale-out: fresh empty node
        while remaining > 0:
            node = self._new_node()
            cap, ms = self._slow_capacity(node, fn, remaining)
            decision_ms += ms
            used_slow = True
            self.metrics.slow += 1
            room = min(max(cap, 1), self._mem_room(node, fn))
            if room <= 0:
                self.metrics.failed += remaining
                break
            place(node, min(remaining, room), decision_ms)

        self.metrics.decisions += 1
        self.metrics.sched_latencies.append(decision_ms)
        self.metrics.sched_time_ms += decision_ms
        return out

    # -- dual-staged scaling hooks: the base class's greedy release
    # -- stage drains least-loaded-first; __init__ installed the
    # -- table-bound logical-start stage (pipeline stages both) ----------


# ---------------------------------------------------------------------------
# Gsight-style: accurate model, inference on every scheduling decision
# ---------------------------------------------------------------------------


class GsightScheduler(BaseScheduler):
    """Same predictor quality as Jiagu but coupled prediction/decision:
    every instance triggers per-candidate-node inference on the critical
    path, with per-instance-granularity inputs (higher row counts).

    Feature assembly and inference go through the shared
    ``PredictionService`` (one self-constructed with the legacy v1
    schema when none is supplied), so Gsight sees the same schema /
    inference-engine selection as Jiagu."""

    name = "gsight"

    def __init__(self, cluster: Cluster, store: ProfileStore, qos: QoSStore,
                 predictor: PerfPredictor, max_candidates: int = 4,
                 service: Optional[PredictionService] = None):
        super().__init__(cluster, store, qos)
        self.predictor = predictor
        self.max_candidates = max_candidates
        self.service = service or PredictionService(
            predictor, store, qos, cluster.specs)

    @property
    def prediction_service(self) -> Optional[PredictionService]:
        return self.service

    def _check_node(self, node: Node, fn: str) -> Tuple[bool, float]:
        """Predict everyone's latency with one more fn instance; per-
        instance granularity: one row per *instance* (not per function)."""
        coloc = {g: (float(s.n_sat), float(s.n_cached))
                 for g, s in node.funcs.items() if s.total > 0}
        coloc[fn] = (coloc.get(fn, (0.0, 0.0))[0] + 1,
                     coloc.get(fn, (0.0, 0.0))[1])
        names, fn_rows, fn_bounds = self.service.rows_for_coloc(coloc,
                                                                node.res)
        rows, bounds = [], []
        for g, row, bound in zip(names, fn_rows, fn_bounds):
            for _ in range(int(coloc[g][0]) or 1):  # instance granularity
                rows.append(row)
                bounds.append(bound)
        t0 = time.perf_counter()
        pred = self.service.predict(np.stack(rows))
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.critical_inference_rows += len(rows)
        self.metrics.critical_inference_calls += 1
        return bool((pred <= np.asarray(bounds)).all()), ms

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        out: List[Placement] = []
        for _ in range(count):
            decision_ms = 0.0
            placed = False
            cands = sorted(self.cluster.nodes.values(),
                           key=lambda n: (fn not in n.funcs,
                                          -n.n_instances()))
            for node in cands[: self.max_candidates]:
                if self._mem_room(node, fn) <= 0:
                    continue
                ok, ms = self._check_node(node, fn)
                decision_ms += ms
                self.metrics.slow += 1
                if ok:
                    node.deploy(fn, 1)
                    out.append(Placement(node.id, 1, decision_ms))
                    placed = True
                    break
            if not placed:
                node = self._new_node()
                ok, ms = self._check_node(node, fn)
                decision_ms += ms
                self.metrics.slow += 1
                node.deploy(fn, 1)
                out.append(Placement(node.id, 1, decision_ms))
            self.metrics.decisions += 1
            self.metrics.instances_placed += 1
            self.metrics.sched_latencies.append(decision_ms)
            self.metrics.sched_time_ms += decision_ms
        return out


# ---------------------------------------------------------------------------
# Owl-style: historical colocation table, at most two functions per node
# ---------------------------------------------------------------------------


class OwlScheduler(BaseScheduler):
    """Historical-information scheduler: colocation combos it has *seen*
    behave well are reused; unknown combos fall back to requested-resource
    packing.  Only two distinct functions may share a node (the paper's
    stated limitation -> lower density)."""

    name = "owl"
    needs_idle_observe = True   # safe-set promotion learns from ok nodes

    def __init__(self, cluster: Cluster, store: ProfileStore, qos: QoSStore):
        super().__init__(cluster, store, qos)
        self.safe: set = set()     # {(fa, na, fb, nb)} observed-safe
        self.unsafe: set = set()
        self.profiled_combos = 0   # O(n^2 k) profiling-cost counter

    @staticmethod
    def _key(coloc: Dict[str, int]) -> tuple:
        items = sorted(coloc.items())
        return tuple(x for kv in items for x in kv)

    def _combo_after(self, node: Node, fn: str) -> Dict[str, int]:
        c = {g: s.total for g, s in node.funcs.items() if s.total > 0}
        c[fn] = c.get(fn, 0) + 1
        return c

    def _fits_requested(self, node: Node, spec: FunctionSpec) -> bool:
        return (node.cpu_requested(self.cluster.specs) + spec.cpu_req
                <= node.res.cpu_mcores
                and node.mem_used(self.cluster.specs) + spec.mem_req
                <= node.res.mem_mb)

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        spec = self.cluster.specs[fn]
        out: List[Placement] = []
        for _ in range(count):
            target = None
            # 1) known-safe overcommitted combos
            for node in sorted(self.cluster.nodes.values(),
                               key=lambda n: -n.n_instances()):
                combo = self._combo_after(node, fn)
                if len(combo) > 2 or self._mem_room(node, fn) <= 0:
                    continue
                key = self._key(combo)
                if key in self.safe and key not in self.unsafe:
                    target = node
                    break
            # 2) exploration within requested resources
            if target is None:
                for node in sorted(self.cluster.nodes.values(),
                                   key=lambda n: -n.n_instances()):
                    combo = self._combo_after(node, fn)
                    if len(combo) > 2:
                        continue
                    if self._key(combo) in self.unsafe:
                        continue
                    if self._fits_requested(node, spec):
                        target = node
                        break
            if target is None:
                target = self._new_node()
            target.deploy(fn, 1)
            out.append(Placement(target.id, 1, FAST_PATH_MS))
            self.metrics.decisions += 1
            self.metrics.instances_placed += 1
            self.metrics.fast += 1
            self.metrics.sched_latencies.append(FAST_PATH_MS)
            self.metrics.sched_time_ms += FAST_PATH_MS
        return out

    def observe(self, node: Node, ok: bool, now: float):
        combo = {g: s.total for g, s in node.funcs.items() if s.total > 0}
        if not combo or len(combo) > 2:
            return
        key = self._key(combo)
        if key not in self.safe and key not in self.unsafe:
            self.profiled_combos += 1
        if ok:
            self.safe.add(key)
        else:
            self.unsafe.add(key)
            self.safe.discard(key)


# ---------------------------------------------------------------------------
# Scheduler registry (the repro.platform name-based component selection)
# ---------------------------------------------------------------------------


@dataclass
class SchedulerBuildContext:
    """Everything a scheduler factory may need.  Factories take what
    they use and ignore the rest, so one registry signature serves
    table-driven, per-schedule-inference, and model-free schedulers."""

    cluster: Cluster
    store: ProfileStore
    qos: QoSStore
    specs: Dict[str, FunctionSpec]
    predictor: Optional[PerfPredictor] = None
    m_max: int = M_MAX_DEFAULT
    max_candidates: int = 4
    schema_version: int = 1
    retrain_every: Optional[int] = None
    #: schema-v2 services learn per-shape QoS margins from validation
    #: error instead of the fixed shape_margin (PlatformConfig
    #: prediction.learned_shape_margin)
    learned_shape_margin: bool = False
    #: harvesting-scheduler knobs (PlatformConfig scheduler section)
    harvest_headroom: float = 0.85
    qos_release_cooldown_s: float = 30.0


@dataclass(frozen=True)
class SchedulerEntry:
    """One registered scheduler: its factory plus the capability facts
    the platform needs at assembly time (instead of `isinstance` checks
    against concrete classes)."""

    name: str
    factory: Callable[[SchedulerBuildContext], BaseScheduler]
    needs_predictor: bool = False     # gets the world's trained forest
    dual_staged_default: bool = False  # opts into dual-staged scaling


_SCHEDULERS = Registry("scheduler")


def register_scheduler(name: str,
                       factory: Callable[[SchedulerBuildContext],
                                         BaseScheduler], *,
                       needs_predictor: bool = False,
                       dual_staged_default: bool = False,
                       overwrite: bool = False) -> SchedulerEntry:
    """Register a scheduler under ``name`` so benchmarks, examples and
    ``PlatformConfig`` manifests can select it by string."""
    return _SCHEDULERS.register(
        name, SchedulerEntry(name, factory, needs_predictor,
                             dual_staged_default), overwrite=overwrite)


def scheduler_entry(name: str) -> SchedulerEntry:
    return _SCHEDULERS.get(name)


def registered_schedulers() -> List[str]:
    return _SCHEDULERS.names()


def build_scheduler(name: str, ctx: SchedulerBuildContext) -> BaseScheduler:
    return scheduler_entry(name).factory(ctx)


def make_gsight_scheduler(ctx: SchedulerBuildContext,
                          cls: Optional[type] = None) -> GsightScheduler:
    """The one Gsight assembly (legacy class and pipeline stack both):
    a single place builds the PredictionService, so the two variants
    can never drift apart in service configuration — the placement-
    parity gate depends on that."""
    cls = cls or GsightScheduler
    return cls(
        ctx.cluster, ctx.store, ctx.qos, ctx.predictor,
        max_candidates=ctx.max_candidates,
        service=PredictionService(
            ctx.predictor, ctx.store, ctx.qos, ctx.specs,
            EngineConfig(m_max=ctx.m_max,
                         retrain_every=ctx.retrain_every,
                         learned_shape_margin=ctx.learned_shape_margin),
            schema=ctx.schema_version))


register_scheduler(
    "jiagu",
    lambda ctx: JiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                               ctx.predictor, m_max=ctx.m_max),
    needs_predictor=True, dual_staged_default=True)
register_scheduler("gsight", make_gsight_scheduler, needs_predictor=True)
register_scheduler(
    "k8s", lambda ctx: K8sScheduler(ctx.cluster, ctx.store, ctx.qos))
register_scheduler(
    "owl", lambda ctx: OwlScheduler(ctx.cluster, ctx.store, ctx.qos))
