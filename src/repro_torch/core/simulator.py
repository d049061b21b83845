"""Tick-driven cluster simulator — the "24-node OpenFaaS testbed" of §7.

Each 1-second tick: read trace RPS -> autoscale (dual-staged or
traditional) -> process async capacity updates -> route load (the
pluggable ``Router`` policy; default: equal split over saturated
instances, the paper's load-balancing router) -> measure ground-truth
latencies per (node, function) -> account QoS violations weighted by
requests -> sample density.  Training samples for the predictor's
incremental learning are collected on the fly (the paper's runtime
dataset maintenance).

``Simulation`` is the run loop the ``repro.platform`` facade owns;
construct it through ``Platform.build`` (or the ``build_simulation`` /
``scenario_simulation`` shims) to get validated configuration, registry
-selected components, and observer hooks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .autoscaler import Autoscaler, ScalingConfig, ScalingMetrics
from .capacity import QoSStore
from .cluster import Cluster, Node
from .events import EventHub
from .interference import GroundTruth, NodeResources
from .metrics import Reservoir
from .predictor import PerfPredictor, build_features
from .prediction_service import get_schema
from .profiles import FunctionSpec, ProfileStore
from .scheduler import BaseScheduler, SchedMetrics
from .traces import Trace
from ..telemetry.spans import NULL_TRACER


class EqualSplitRouter:
    """The paper's load-balancing router: every saturated instance of a
    function receives an equal share of its traffic, so a node hosting
    ``n_sat`` of ``total_sat`` instances serves that fraction of the
    requests.  The default ``platform.Router`` policy.

    Routers may additionally implement the optional ``begin_tick``
    hook — the simulator calls it once per tick with the whole cluster
    before routing, so stateful policies (``LocalityRouter``) can plan
    cluster-wide shares; routers without the hook stay purely
    per-node."""

    name = "equal-split"

    def begin_tick(self, now: float, cluster: Cluster,
                   rps: Dict[str, float],
                   sat_totals: Dict[str, int],
                   specs: Dict[str, FunctionSpec]) -> None:
        pass

    def route(self, spec: FunctionSpec, fn_rps: float, node: Node,
              n_sat: float, total_sat: int) -> Tuple[float, float]:
        """Returns (per_instance_rps, requests_routed_to_node)."""
        return fn_rps / total_sat, fn_rps * (n_sat / total_sat)


class LocalityRouter:
    """Locality/affinity routing: a function's traffic prefers its
    *warm*, least-contended placements and spills the rest by score.

    Per tick (``begin_tick``) the router plans cluster-wide shares per
    function: nodes hosting its saturated instances are scored by
    contention (foreign instances per own instance — a node mostly
    dedicated to the function is its warmest, least-interfered home),
    and traffic waterfills the score order, loading each node's
    instances up to ``load_cap`` of their saturated throughput before
    spilling to the next.  Load beyond the capped cluster capacity is
    distributed proportionally to instance counts (the equal-split
    overload behaviour).  Totals are conserved: the requests routed
    across nodes sum to the function's RPS exactly as equal split does.

    Registered as ``"locality"`` in the router registry; A/B'd against
    ``EqualSplitRouter`` by ``benchmarks/large_cluster.py``."""

    name = "locality"

    def __init__(self, load_cap: float = 0.85):
        self.load_cap = load_cap
        self._share: Dict[Tuple[str, int], float] = {}

    def begin_tick(self, now: float, cluster: Cluster,
                   rps: Dict[str, float],
                   sat_totals: Dict[str, int],
                   specs: Dict[str, FunctionSpec]) -> None:
        self._share.clear()
        # per-node instance totals are shared across every function
        # planned this tick: contention inputs are identical between
        # functions, so one sum per hosting node replaces a re-scan per
        # (function, node) pair — same integers, bit-identical plans
        n_inst: Dict[int, int] = {}
        for fn, total_sat in sat_totals.items():
            fn_rps = rps.get(fn, 0.0)
            if total_sat <= 0 or fn_rps <= 1e-9:
                continue
            spec = specs[fn]
            nodes = [n for n in cluster.nodes_with(fn)
                     if n.funcs[fn].n_sat > 0]

            def contention(n: Node) -> float:
                own = n.funcs[fn]
                ni = n_inst.get(n.id)
                if ni is None:
                    ni = n_inst[n.id] = n.n_instances()
                return (ni - own.total) / max(own.n_sat, 1)

            order = sorted(nodes, key=lambda n: (contention(n), n.id))
            remaining = fn_rps
            for n in order:
                take = min(remaining, n.funcs[fn].n_sat
                           * spec.saturated_rps * self.load_cap)
                self._share[(fn, n.id)] = take
                remaining -= take
            if remaining > 1e-9:
                for n in order:
                    self._share[(fn, n.id)] += \
                        remaining * n.funcs[fn].n_sat / total_sat

    def route(self, spec: FunctionSpec, fn_rps: float, node: Node,
              n_sat: float, total_sat: int) -> Tuple[float, float]:
        reqs = self._share.get((spec.name, node.id))
        if reqs is None:
            # no begin_tick plan (direct use outside the simulator):
            # degrade to the equal split
            return fn_rps / total_sat, fn_rps * (n_sat / total_sat)
        return reqs / max(n_sat, 1e-9), reqs


@dataclass
class SimConfig:
    collect_samples: bool = True
    sample_every_s: int = 20
    seed: int = 0
    # capacity-solve path: True (default since the full-trace A/B parity
    # gate, tests/test_engine_parity.py) attaches a PredictionService to a
    # Jiagu scheduler (coalesced/cached/vectorized cluster-scale solving);
    # False keeps the legacy per-node path as the reference oracle.
    use_capacity_engine: bool = True
    # feature-schema version for the attached service: 1 = legacy
    # node-shape-blind vector (the parity oracle), 2 = node-shape-aware
    # (requires a predictor trained on v2 rows and the engine path)
    schema_version: int = 1
    # online incremental retraining: route runtime samples through
    # PredictionService.on_samples (retrain + epoch-invalidate + refresh
    # capacity tables during the run, all off the critical path)
    online_retrain: bool = False
    # samples between online retrains (None -> the predictor's own
    # retrain_every)
    retrain_every: Optional[int] = None
    # schema-v2 only: learn the per-shape QoS margin from per-shape
    # validation error instead of the fixed shape_margin formula
    learned_shape_margin: bool = False


@dataclass
class SimResult:
    name: str
    ticks: int
    requests: float = 0.0
    violated_requests: float = 0.0
    instance_seconds: float = 0.0
    node_seconds: float = 0.0
    nodes_peak: int = 0
    # bounded uniform sample of the per-tick density series (512-node
    # full traces would otherwise grow this without limit)
    density_series: Reservoir = field(default_factory=lambda: Reservoir(512))
    per_fn_violations: Dict[str, float] = field(default_factory=dict)
    per_fn_requests: Dict[str, float] = field(default_factory=dict)
    sched: Optional[SchedMetrics] = None
    scaling: Optional[ScalingMetrics] = None
    inference_rows: int = 0
    inference_calls: int = 0
    mean_inference_ms: float = 0.0
    # online-retraining accounting (deltas over this run's service stats;
    # background work, reported separately from the critical path)
    retrains: int = 0
    retrain_time_s: float = 0.0
    refresh_rows: int = 0
    refresh_time_s: float = 0.0
    stale_epoch_hits: int = 0
    # admission accounting (repro.admission; all-zero/empty when the
    # admission axis is off — the default)
    class_requests: Dict[str, float] = field(default_factory=dict)
    class_violations: Dict[str, float] = field(default_factory=dict)
    dropped_requests: float = 0.0
    queue_delay_s: Reservoir = field(default_factory=lambda: Reservoir(512))
    queue_depth_peak: float = 0.0
    vertical_grows: int = 0
    vertical_shrinks: int = 0

    @property
    def qos_violation_rate(self) -> float:
        return self.violated_requests / max(self.requests, 1e-9)

    def class_violation_rate(self) -> Dict[str, float]:
        """Per-SLO-class QoS violation rate (empty without admission)."""
        return {c: self.class_violations.get(c, 0.0)
                / max(self.class_requests.get(c, 0.0), 1e-9)
                for c in self.class_requests}

    @property
    def density(self) -> float:
        """Duration-weighted mean instances per active node."""
        return self.instance_seconds / max(self.node_seconds, 1e-9)

    def per_fn_violation_rate(self) -> Dict[str, float]:
        return {fn: self.per_fn_violations.get(fn, 0.0)
                / max(self.per_fn_requests.get(fn, 0.0), 1e-9)
                for fn in self.per_fn_requests}


class Simulation:
    def __init__(self, specs: Dict[str, FunctionSpec], trace: Trace,
                 scheduler: BaseScheduler, autoscaler: Autoscaler,
                 ground_truth: GroundTruth, store: ProfileStore,
                 qos: QoSStore, predictor: Optional[PerfPredictor] = None,
                 cfg: Optional[SimConfig] = None, *,
                 router=None, events: Optional[EventHub] = None):
        self.specs = specs
        self.trace = trace
        self.scheduler = scheduler
        self.autoscaler = autoscaler
        self.gt = ground_truth
        self.store = store
        self.qos = qos
        self.predictor = predictor
        self.cfg = cfg or SimConfig()
        self.router = router or EqualSplitRouter()
        self.events = events or EventHub()
        #: AdmissionController (repro.admission) wired by
        #: ``build_simulation`` when the admission axis is enabled;
        #: None (the default) keeps the run loop structurally identical
        #: to the pre-admission control plane.
        self.admission = None
        #: span tracer for the per-tick scheduling section; the no-op
        #: default keeps uninstrumented runs on the identical code path
        #: (spans only read state — see the observer-parity test)
        self.tracer = NULL_TRACER
        self.cluster = scheduler.cluster
        self._rng = np.random.default_rng(self.cfg.seed)
        if (self.cfg.use_capacity_engine and predictor is not None
                and scheduler.accepts_service
                and scheduler.prediction_service is None):
            from .prediction_service import EngineConfig, PredictionService
            scheduler.attach_service(PredictionService(
                predictor, store, qos, specs,
                EngineConfig(m_max=scheduler.m_max,
                             retrain_every=self.cfg.retrain_every,
                             learned_shape_margin=self.cfg
                             .learned_shape_margin),
                schema=self.cfg.schema_version))
        # the shared service (Jiagu's solver or Gsight's feature/predict
        # client); the legacy per-node path has none
        self._service = scheduler.prediction_service
        if self._service is None and predictor is not None:
            if self.cfg.schema_version != 1:
                raise ValueError(
                    "schema v2 requires the PredictionService path "
                    "(use_capacity_engine=True); the legacy per-node "
                    "solver only speaks the v1 feature layout")
            if self.cfg.online_retrain:
                raise ValueError(
                    "online_retrain requires a PredictionService "
                    "(use_capacity_engine=True); the legacy path has no "
                    "on_samples retraining loop")
        if (self._service is not None
                and self._service.schema.version != self.cfg.schema_version):
            raise ValueError(
                f"scheduler's service speaks schema "
                f"v{self._service.schema.version} but SimConfig requests "
                f"v{self.cfg.schema_version}; pass a matching "
                f"schema_version")

    # ------------------------------------------------------------------

    def run(self, duration_s: Optional[int] = None) -> SimResult:
        T = duration_s or self.trace.duration_s
        res = SimResult(name=self.scheduler.name, ticks=T)
        #: observers read the accumulating result mid-run (tick records
        #: carry cumulative QoS counters for offline outcome labelling)
        self.live_result = res
        svc0 = self._service.stats.snapshot() if self._service else {}
        for t in range(T):
            now = float(t)
            rps = {fn: self.trace.at(fn, t) for fn in self.trace.rps}
            # admission phase 1: arrivals enter the bounded queues and
            # the autoscaler's signal is derived from backlog state
            # (queue depth/age) instead of instantaneous rps
            if self.admission is not None:
                with self.tracer.span("admission") as sp:
                    signal = self.admission.enqueue(now, rps,
                                                    self.cluster)
                    if sp is not None:
                        sp.attrs["now"] = now
                        sp.attrs["queue_depth"] = round(
                            self.admission.queue_depth(), 3)
            else:
                signal = rps
            # async capacity updates flush BEFORE this tick's scheduling:
            # they were queued sub-millisecond work during the previous
            # (idle) second — the paper's "table always up-to-date when
            # scheduling" property (§4.3).
            with self.tracer.span("schedule") as sp:
                if sp is not None:
                    sm = self.scheduler.metrics
                    d0, p0 = sm.decisions, sm.instances_placed
                self.scheduler.on_tick(now)
                self.autoscaler.tick(now, signal)
                if sp is not None:
                    sp.attrs["now"] = now
                    sp.attrs["decisions"] = sm.decisions - d0
                    sp.attrs["placed"] = sm.instances_placed - p0
            # admission phase 2: backlog drains into the (possibly just
            # scaled) fleet; the measurement pass routes served traffic
            if self.admission is not None:
                rps = self.admission.drain(now, self.cluster, res)
            self._measure(now, rps, res)
            if (self.cfg.collect_samples and self.predictor is not None
                    and t % self.cfg.sample_every_s == 0):
                self._collect_sample()
            inst = self.cluster.total_instances()
            nodes = len(self.cluster.nodes)
            res.instance_seconds += inst
            res.node_seconds += nodes
            res.nodes_peak = max(res.nodes_peak, nodes)
            res.density_series.append(inst / nodes if nodes else 0.0)
            self.events.on_tick(now, self)
        res.sched = self.scheduler.metrics
        res.scaling = self.autoscaler.metrics
        if self.predictor is not None:
            res.inference_rows = self.predictor.inference_count
            res.inference_calls = self.predictor.inference_calls
            res.mean_inference_ms = self.predictor.mean_inference_ms
        if self._service is not None:
            # deltas over this run (services may be shared across sims)
            st = self._service.stats.snapshot()
            res.retrains = int(st["retrains"] - svc0.get("retrains", 0))
            res.retrain_time_s = \
                st["retrain_time_s"] - svc0.get("retrain_time_s", 0.0)
            res.refresh_rows = \
                int(st["refresh_rows"] - svc0.get("refresh_rows", 0))
            res.refresh_time_s = \
                st["refresh_time_s"] - svc0.get("refresh_time_s", 0.0)
            res.stale_epoch_hits = int(
                st["stale_epoch_hits"] - svc0.get("stale_epoch_hits", 0))
        if self.admission is not None:
            self.admission.finalize(res)
        self.events.on_result(res)
        return res

    def queue_depth_total(self) -> Optional[float]:
        """Fleet pending-request backlog, or None when the admission
        axis is off (observers use this to decorate tick records)."""
        return None if self.admission is None \
            else self.admission.queue_depth()

    # ------------------------------------------------------------------

    def _measure(self, now: float, rps: Dict[str, float], res: SimResult):
        # O(1) reads off the cluster's incremental per-function totals
        sat_totals = {fn: self.cluster.sat_count(fn) for fn in self.specs}
        measure_cluster(now, self.cluster, self.specs, rps, sat_totals,
                        self.router, self.scheduler, self.gt, self.qos,
                        res,
                        slo=None if self.admission is None
                        else self.admission.slo)

    def _collect_sample(self):
        """Runtime training-sample collection (training nodes, §3/§6):
        measure one random busy node's functions at saturated load and add
        (features, label) pairs to the predictor's dataset.

        Under schema v1 only standard-shape nodes (matching the ground
        truth's profiling node) are sampled: on a heterogeneous fleet,
        labels from larger nodes would mix a different pressure scale
        into a feature space that cannot express node size.  Schema v2
        encodes the node shape, so every busy node is sampleable and the
        rows are measured against the *hosting* node's capacity.

        With ``cfg.online_retrain`` the rows go through the service's
        ``on_samples`` hook — the online retraining policy fires during
        the run, bumping the forest epoch and refreshing all capacity
        tables off the critical path."""
        svc = self._service
        v2 = svc is not None and svc.schema.version >= 2
        busy = [n for n in self.cluster.nodes.values()
                if any(s.n_sat > 0 for s in n.funcs.values())
                and (v2 or n.res == self.gt.node)]
        if not busy:
            return
        node = busy[self._rng.integers(len(busy))]
        coloc = node.colocation(self.specs)
        counts = {g: (float(s[1]), float(s[2])) for g, s in coloc.items()}
        node_res = node.res if v2 else None
        Xs, ys = [], []
        for fn, (spec, n_sat, n_cached) in coloc.items():
            if n_sat <= 0:
                continue
            if svc is not None:
                x = svc.feature_row(fn, n_sat, n_cached, counts, node_res)
            else:
                neigh = [(self.store.profile(self.specs[g]), ns, nc)
                         for g, (ns, nc) in counts.items() if g != fn]
                x = build_features(self.qos.solo(spec),
                                   self.store.profile(spec), n_sat,
                                   n_cached, neigh)
            y = self.gt.measure(spec, coloc, load_frac=1.0,
                                node_res=node_res)
            Xs.append(x)
            ys.append(y)
        if not Xs:
            return
        if svc is not None and self.cfg.online_retrain:
            if svc.on_samples(Xs, ys) and self.scheduler.accepts_service:
                # retrain fired: every table entry in the cluster was
                # computed by the old forest — refresh them all in one
                # coalesced drain, billed to the service's refresh
                # counters (background work, not the critical path).
                # Only table-driven schedulers (Jiagu) need this; Gsight
                # predicts per-schedule and never reads node.table.
                svc.refresh_tables(list(self.cluster.nodes.values()),
                                   self.scheduler.m_max)
        else:
            for x, yv in zip(Xs, ys):
                self.predictor.add_sample(x, yv, retrain=False)


def measure_cluster(now: float, cluster: Cluster,
                    specs: Dict[str, FunctionSpec],
                    rps: Dict[str, float], sat_totals: Dict[str, int],
                    router, scheduler: BaseScheduler, gt: GroundTruth,
                    qos: QoSStore, res: SimResult,
                    slo: Optional[Dict[str, str]] = None) -> None:
    """One cluster's measurement pass, shared by ``Simulation._measure``
    and the cell-sharded event core (per cell, with cell-local routers
    and traffic shares).

    Dirty-set scan: only nodes hosting a function with live traffic can
    produce a measurement (a ground-truth latency draw needs
    ``n_sat > 0`` *and* ``fn_rps > 1e-9``), so the loop walks the union
    of the cluster's hosting indexes over active functions, ascending
    node id — the exact node order (and therefore the exact ground-truth
    RNG call sequence) the legacy full scan produced, minus nodes whose
    iteration would have been a complete no-op.  Skipped nodes would
    only have received ``observe(node, ok=True)``, a no-op for every
    scheduler except those that *learn from idleness* — they set
    ``needs_idle_observe`` (Owl's safe-set promotion) and keep the full
    scan."""
    # stateful routers (LocalityRouter) plan cluster-wide shares
    # once per tick; the hook is optional so purely per-node
    # policies stay three-line classes
    begin_tick = getattr(router, "begin_tick", None)
    if begin_tick is not None:
        begin_tick(now, cluster, rps, sat_totals, specs)
    if scheduler.needs_idle_observe:
        nodes = list(cluster.nodes.values())
    else:
        active: set = set()
        for fn, fn_rps in rps.items():
            if fn_rps > 1e-9:
                active.update(cluster.hosting_ids(fn))
        nodes = [cluster.nodes[nid] for nid in sorted(active)]
    for node in nodes:
        coloc = node.colocation(specs)
        if not coloc:
            continue
        node_ok = True
        for fn, (spec, n_sat, _nc) in coloc.items():
            if n_sat <= 0:
                continue
            total_sat = max(sat_totals.get(fn, 0), 1)
            fn_rps = rps.get(fn, 0.0)
            if fn_rps <= 1e-9:
                continue
            # routing policy: how much of fn's traffic this node's
            # instances serve (default: the paper's equal split)
            per_inst_rps, reqs = router.route(
                spec, fn_rps, node, n_sat, total_sat)
            load_frac = per_inst_rps / spec.saturated_rps
            lat = gt.measure(spec, coloc, load_frac, node_res=node.res)
            res.requests += reqs
            res.per_fn_requests[fn] = \
                res.per_fn_requests.get(fn, 0.0) + reqs
            violated = lat > qos.qos(spec)
            if violated:
                res.violated_requests += reqs
                res.per_fn_violations[fn] = \
                    res.per_fn_violations.get(fn, 0.0) + reqs
                node_ok = False
            if slo is not None:
                # per-SLO-class accounting (admission axis only)
                cls = slo.get(fn)
                if cls is not None:
                    res.class_requests[cls] = \
                        res.class_requests.get(cls, 0.0) + reqs
                    if violated:
                        res.class_violations[cls] = \
                            res.class_violations.get(cls, 0.0) + reqs
        scheduler.observe(node, node_ok, now)


# ---------------------------------------------------------------------------
# Offline dataset generation (profiling/training nodes, pre-deployment)
# ---------------------------------------------------------------------------


def generate_dataset(specs: Dict[str, FunctionSpec], gt: GroundTruth,
                     store: ProfileStore, qos: QoSStore, n_samples: int,
                     seed: int = 0, max_kinds: int = 4, max_count: int = 24,
                     include_solo: bool = True,
                     budget_range: Tuple[float, float] = (0.25, 1.6),
                     schema=None,
                     node_shapes: Optional[Sequence[NodeResources]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Random colocation scenarios measured against the ground truth —
    what the training nodes accumulate before the model converges.

    ``include_solo`` additionally sweeps each function alone at
    m = 1..6 — the profiling-node measurements the paper's solo-run
    methodology produces; without them the forest extrapolates poorly at
    the uncontended corner and under-reports capacities.

    ``budget_range`` bounds the sampled requested-CPU packing (in units
    of node capacity).  The default spans under-packed to ~1.6x
    overcommitted — the capacity solver's decision region for the paper's
    six-function world.  Large Zipf-populated scenarios pack small-slot
    functions deeper, so their worlds train with a wider range (the
    forest extrapolates *flat* past its training ceiling and would
    otherwise under-predict exactly where overcommitting gets risky).

    ``schema``/``node_shapes`` select the feature-schema version and,
    for schema v2, the fleet's node shapes: every sampled colocation is
    hosted on one of the shapes (first = the standard profiling shape),
    its rows carry the normalized shape block, and its labels are
    measured against the *hosting* shape's capacity — the per-node-shape
    training rows that stop big nodes inheriting small-node capacities.
    The v1 default path is bit-identical to the pre-schema dataset."""
    sch = get_schema(schema)
    if sch.version >= 2:
        return _generate_dataset_shaped(
            sch, specs, gt, store, qos, n_samples, seed, max_kinds,
            max_count, include_solo, budget_range, node_shapes)
    rng = np.random.default_rng(seed)
    names = sorted(specs)
    X, y = [], []
    max_kinds = min(max_kinds, len(names))
    node = gt.node
    if include_solo:
        for fn in names:
            spec = specs[fn]
            m_hi = max(2, int(1.3 * node.cpu_mcores / spec.cpu_req))
            for m in range(1, m_hi + 1):
                coloc = {fn: (spec, float(m), 0.0)}
                if not gt.fits(coloc):
                    break
                X.append(build_features(qos.solo(spec), store.profile(spec),
                                        float(m), 0.0, []))
                y.append(gt.measure(spec, coloc, load_frac=1.0))
    while len(y) < n_samples:
        # Sample colocations the way real nodes are packed: a total
        # requested-CPU budget spanning under-packed to ~1.6x overcommitted
        # (the capacity solver's decision region), split across kinds.
        # Uniform per-function counts would put most training mass on
        # absurd densities and starve the boundary.
        kinds = rng.choice(names, size=rng.integers(1, max_kinds + 1),
                           replace=False)
        budget = rng.uniform(*budget_range) * node.cpu_mcores
        shares = rng.dirichlet(np.ones(len(kinds)))
        coloc = {}
        for k, share in zip(kinds, shares):
            n_sat = int(round(share * budget / specs[k].cpu_req))
            n_sat = min(max(n_sat, 1), max_count)
            n_cached = int(rng.integers(0, 3))
            coloc[k] = (specs[k], float(n_sat), float(n_cached))
        if not gt.fits(coloc):
            continue
        counts = {g: (c[1], c[2]) for g, c in coloc.items()}
        for fn in kinds:
            spec = specs[fn]
            neigh = [(store.profile(specs[g]), ns, nc)
                     for g, (ns, nc) in counts.items() if g != fn]
            X.append(build_features(qos.solo(spec), store.profile(spec),
                                    counts[fn][0], counts[fn][1], neigh))
            y.append(gt.measure(spec, coloc, load_frac=1.0))
            if len(y) >= n_samples:
                break
    return np.stack(X), np.asarray(y, np.float64)


def _generate_dataset_shaped(sch, specs: Dict[str, FunctionSpec],
                             gt: GroundTruth, store: ProfileStore,
                             qos: QoSStore, n_samples: int, seed: int,
                             max_kinds: int, max_count: int,
                             include_solo: bool,
                             budget_range: Tuple[float, float],
                             node_shapes: Optional[Sequence[NodeResources]]
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Schema-v2 dataset: per-node-shape training rows.

    Counts and packing budgets scale with the hosting shape's CPU
    relative to the standard shape (``shapes[0]``), so a 2x node trains
    on colocations twice as deep — exactly the region where its v2
    capacities must exceed the standard node's."""
    rng = np.random.default_rng(seed)
    names = sorted(specs)
    shapes: List[NodeResources] = list(node_shapes or [gt.node])
    ref_cpu = shapes[0].cpu_mcores
    X, y = [], []
    max_kinds = min(max_kinds, len(names))
    if include_solo:
        for shape in shapes:
            for fn in names:
                spec = specs[fn]
                m_hi = max(2, int(1.3 * shape.cpu_mcores / spec.cpu_req))
                m_hi = min(m_hi, 2 * max(
                    1, int(round(max_count * shape.cpu_mcores / ref_cpu))))
                # subsample deep sweeps: big shapes would otherwise
                # contribute O(100) interference-free rows per function
                # and drown the colocation samples the capacity
                # boundary is learned from
                ms = range(1, m_hi + 1) if m_hi <= 16 else sorted(
                    set(np.linspace(1, m_hi, 16).round().astype(int)))
                for m in ms:
                    coloc = {fn: (spec, float(m), 0.0)}
                    if not gt.fits(coloc, node_res=shape):
                        break
                    X.append(sch.build_row(
                        qos.solo(spec), store.profile(spec), float(m), 0.0,
                        [], node_res=shape))
                    y.append(gt.measure(spec, coloc, load_frac=1.0,
                                        node_res=shape))
    while len(y) < n_samples:
        shape = shapes[rng.integers(len(shapes))]
        cap_count = max(1, int(round(max_count * shape.cpu_mcores
                                     / ref_cpu)))
        kinds = rng.choice(names, size=rng.integers(1, max_kinds + 1),
                           replace=False)
        budget = rng.uniform(*budget_range) * shape.cpu_mcores
        shares = rng.dirichlet(np.ones(len(kinds)))
        coloc = {}
        for k, share in zip(kinds, shares):
            n_sat = int(round(share * budget / specs[k].cpu_req))
            n_sat = min(max(n_sat, 1), cap_count)
            n_cached = int(rng.integers(0, 3))
            coloc[k] = (specs[k], float(n_sat), float(n_cached))
        if not gt.fits(coloc, node_res=shape):
            continue
        counts = {g: (c[1], c[2]) for g, c in coloc.items()}
        for fn in kinds:
            spec = specs[fn]
            neigh = [(store.profile(specs[g]), ns, nc)
                     for g, (ns, nc) in counts.items() if g != fn]
            X.append(sch.build_row(qos.solo(spec), store.profile(spec),
                                   counts[fn][0], counts[fn][1], neigh,
                                   node_res=shape))
            y.append(gt.measure(spec, coloc, load_frac=1.0,
                                node_res=shape))
            if len(y) >= n_samples:
                break
    return np.stack(X), np.asarray(y, np.float64)
