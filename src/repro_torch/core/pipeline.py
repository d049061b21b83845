"""Composable scheduling-decision pipeline: filter -> score -> bind.

Jiagu's pre-decision scheduling works because prediction is decoupled
from placement (§4) — but until this module the *decision logic itself*
was monolithic: each scheduler hard-coded candidate enumeration,
admission rules, ordering, and deployment inside one ``schedule()``
body, so the platform registry could swap whole schedulers but nothing
inside one.  This module decomposes a placement decision into typed
stages that any policy can recombine:

  * ``PreDecision`` — a gate that consults capacity tables *before any
    per-request work* (the paper's pre-decision scheduling: Jiagu's
    fast path is one such gate, reusable by any table-driven policy),
  * ``NodeFilter``  — rejects a candidate with a *reason* (recorded in
    the decision trace),
  * ``NodeScorer``  — orders surviving candidates (higher is better;
    stable, so enumeration order breaks ties exactly like the legacy
    ``sorted(key=-x)`` loops),
  * ``Binder``      — commits instances to one node (and is the only
    stage allowed to run critical-path inference or mutate state),

composed by a ``SchedulingPipeline`` (a ``PreDecision`` gate, ordered
``CandidatePass``es, and a scale-out binder for fresh nodes).  Every
decision produces a ``DecisionTrace`` explaining the placement: which
candidates were filtered and why, the score terms, and the capacity
margin each binding consumed — emitted through the platform's
``on_schedule`` observer hook.

The four legacy schedulers are re-expressed as named stacks over the
same stages (``jiagu-pipeline``, ``gsight-pipeline``, ``k8s-pipeline``,
``owl-pipeline`` in the scheduler registry), gated by placement-parity
tests: stack and legacy ``schedule()`` must produce bit-identical
placements, density, QoS, and scheduling counters.  The dual-staged
scaling picks are stages too (``GreedyReleasePicker``,
``GreedyLogicalStartPicker``, ``TableBoundLogicalStartPicker``) —
``BaseScheduler`` delegates its ``ReleasePicker`` /
``LogicalStartPicker`` capabilities to swappable stage objects, so the
autoscaler's policies plug through the same surface
(``platform.register_stage`` / ``PlatformConfig.pipeline``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

from .cluster import Node
from .prediction_service import REFERENCE_NODE
from .scheduler import (FAST_PATH_MS, BaseScheduler, GsightScheduler,
                        JiaguScheduler, K8sScheduler, OwlScheduler,
                        Placement, make_gsight_scheduler,
                        register_scheduler)

#: bound on per-decision trace detail (reason *counts* are always
#: complete; per-node samples and score terms are capped so 512-node
#: per-instance schedulers don't allocate O(nodes x instances) records)
TRACE_SAMPLES = 8
TRACE_SCORES = 16
TRACE_TOP_SCORES = 4

#: DecisionTrace serialization schema.  v1 records (no
#: ``schema_version`` key) carried score terms only; v2 adds the
#: per-candidate raw feature vectors + chosen node that make JSONL
#: streams a reusable offline training dataset (``repro.policy``); v3
#: adds the admission context (pending-queue depth/age, SLO class) the
#: ``repro.admission`` controller stamps on every scale-up decision.
#: Readers must keep accepting versionless (v1) and v2 records — the
#: v3 fields default to zero/None, so old streams load unchanged.
TRACE_SCHEMA_VERSION = 3


# ---------------------------------------------------------------------------
# Decision traces
# ---------------------------------------------------------------------------


@dataclass
class TraceBinding:
    """One committed placement inside a decision: which stage bound how
    many instances where, at what cumulative latency, and — for
    capacity-driven stages — the predicted capacity and the headroom
    (capacity margin) available before this binding consumed it."""

    stage: str
    node_id: int
    count: int
    latency_ms: float
    capacity: Optional[int] = None
    room_before: Optional[int] = None


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


@dataclass
class DecisionTrace:
    """Why one scheduling decision placed what it placed.

    ``filtered`` aggregates rejection reasons (reason -> count, complete)
    while ``filtered_samples`` keeps the first few (node_id, reason)
    pairs; ``scored`` records the top-scored candidates per pass (capped
    at ``TRACE_SCORES`` entries).  ``to_dict`` is JSON-able, so traces
    round-trip through ``JsonlObserver`` artifacts."""

    scheduler: str
    fn: str
    now: float
    requested: int
    mode: str = "batched"          # or "per-instance"
    placed: int = 0
    failed: int = 0
    latency_ms: float = 0.0
    schema_version: int = TRACE_SCHEMA_VERSION
    pre_decision: List[TraceBinding] = field(default_factory=list)
    bindings: List[TraceBinding] = field(default_factory=list)
    filtered: Dict[str, int] = field(default_factory=dict)
    filtered_samples: List[Tuple[int, str]] = field(default_factory=list)
    scored: List[Tuple[str, int, Any]] = field(default_factory=list)
    #: per-candidate raw feature vectors captured at decision start
    #: (before any binding mutated the cluster): [(node_id, row), ...].
    #: Empty unless the scheduler opts into ``trace_features`` — the
    #: capture costs O(nodes) per decision and exists to feed
    #: ``repro.policy`` training, not routine observability.
    candidates: List[Tuple[int, List[float]]] = field(default_factory=list)
    #: node that received this decision's first binding (-1 when the
    #: decision failed outright) — the imitation-learning label
    chosen_node: int = -1
    #: admission context at decision time (schema v3) — pending-queue
    #: depth and oldest-request age for ``fn``, and its SLO class.
    #: Stamped by ``AdmissionController.stamp_trace``; zero/None when
    #: admission is off, so v2 consumers see only inert defaults.
    queue_depth: float = 0.0
    queue_age_s: float = 0.0
    slo_class: Optional[str] = None
    #: every node id any stage rejected during the decision (filters
    #: AND binder refusals — capacity solves, mem room).  Only
    #: populated under ``trace_features``: offline training masks these
    #: out, because a pointwise scorer cannot see binder feasibility
    #: and must not be penalized for ranking an infeasible node first
    #: (serving re-applies the same binder checks anyway).
    rejected: List[int] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["filtered_samples"] = [list(s) for s in self.filtered_samples]
        d["scored"] = [[p, n, _jsonable(s)] for p, n, s in self.scored]
        d["candidates"] = [[nid, list(row)] for nid, row in self.candidates]
        return d

    def summary(self) -> Dict[str, Any]:
        """Compact form for event streams: totals + reasons, no
        per-candidate detail — except the feature rows, which ride along
        when captured (they ARE the payload of a feature-tracing run)."""
        out = {
            "scheduler": self.scheduler, "fn": self.fn, "now": self.now,
            "requested": self.requested, "placed": self.placed,
            "failed": self.failed, "mode": self.mode,
            "latency_ms": round(self.latency_ms, 4),
            "schema_version": self.schema_version,
            "fast_bindings": len(self.pre_decision),
            "bindings": [[b.stage, b.node_id, b.count]
                         for b in self.bindings],
            "filtered": dict(self.filtered),
        }
        if self.slo_class is not None:
            out["queue_depth"] = round(self.queue_depth, 4)
            out["queue_age_s"] = round(self.queue_age_s, 4)
            out["slo_class"] = self.slo_class
        if self.candidates:
            out["candidates"] = [
                [nid, [round(float(v), 5) for v in row]]
                for nid, row in self.candidates]
            out["chosen_node"] = self.chosen_node
            out["rejected"] = sorted(set(self.rejected))
            out["scale_out"] = any(
                "scale-out" in b.stage for b in self.bindings)
        return out


# ---------------------------------------------------------------------------
# Stage protocols
# ---------------------------------------------------------------------------


@runtime_checkable
class NodeFilter(Protocol):
    """Rejects candidate nodes.  Returns a short reason string (recorded
    in the decision trace) or None to keep the node.  Must not mutate
    node or scheduler state."""

    def filter(self, ctx: "DecisionContext", node: Node) -> Optional[str]:
        ...


@runtime_checkable
class NodeScorer(Protocol):
    """Orders candidates: higher score binds first.  Scores may be any
    mutually comparable value (floats, tuples); sorting is stable, so
    ties keep cluster enumeration order — exactly the legacy
    ``sorted(key=-x)`` semantics."""

    def score(self, ctx: "DecisionContext", node: Node) -> Any:
        ...


@runtime_checkable
class Binder(Protocol):
    """Commits instances to one node; returns how many were placed
    (0 = rejected, with a traced reason).  The only stage allowed to
    run critical-path inference, bill scheduling time, or mutate
    cluster state."""

    def bind(self, ctx: "DecisionContext", node: Node) -> int:
        ...


@runtime_checkable
class PreDecision(Protocol):
    """Pre-decision gate: consume as much of the request as possible
    from already-computed capacity tables before any per-request work
    runs (the paper's pre-decision scheduling)."""

    def gate(self, ctx: "DecisionContext") -> None:
        ...


# ---------------------------------------------------------------------------
# Decision context
# ---------------------------------------------------------------------------


class DecisionContext:
    """Mutable state of one ``schedule(fn, count, now)`` decision as it
    flows through the pipeline.  Stages read candidates and commit
    placements through it; it keeps the latency/metrics accounting
    bit-identical to the legacy schedulers."""

    __slots__ = ("sched", "cluster", "metrics", "fn", "count", "now",
                 "remaining", "decision_ms", "placements", "trace",
                 "_mem_used")

    def __init__(self, sched: BaseScheduler, fn: str, count: int,
                 now: float, trace: Optional[DecisionTrace]):
        self.sched = sched
        self.cluster = sched.cluster
        self.metrics = sched.metrics
        self.fn = fn
        self.count = count
        self.now = now
        self.remaining = count
        self.decision_ms = 0.0
        self.placements: List[Placement] = []
        self.trace = trace
        # per-decision memo of node.mem_used: filters/scorers/binders
        # re-ask for the same node's headroom many times per decision
        # (every pass, every per-instance re-run) while its counts only
        # change through place(), which invalidates the entry
        self._mem_used: Dict[int, float] = {}

    @property
    def spec(self):
        return self.cluster.specs[self.fn]

    def mem_room(self, node: Node) -> int:
        used = self._mem_used.get(node.id)
        if used is None:
            used = self._mem_used[node.id] = \
                node.mem_used(self.cluster.specs)
        spec = self.cluster.specs[self.fn]
        return max(0, int((node.res.mem_mb - used) // spec.mem_req))

    def add_ms(self, ms: float) -> None:
        self.decision_ms += ms

    def reject(self, node: Node, reason: str) -> None:
        t = self.trace
        if t is None:
            return
        t.filtered[reason] = t.filtered.get(reason, 0) + 1
        if len(t.filtered_samples) < TRACE_SAMPLES:
            t.filtered_samples.append((node.id, reason))
        if self.sched.trace_features:
            t.rejected.append(node.id)

    def place(self, node: Node, k: int, stage: str, *,
              capacity: Optional[int] = None,
              room_before: Optional[int] = None,
              pre: bool = False) -> None:
        """Commit ``k`` instances of ``fn`` to ``node`` at the current
        cumulative decision latency (the legacy ``place()`` closure)."""
        node.deploy(self.fn, k)
        self._mem_used.pop(node.id, None)   # memoized headroom is stale
        self.placements.append(Placement(node.id, k, self.decision_ms))
        self.remaining -= k
        self.metrics.instances_placed += k
        self.sched.on_place(node, k, self.now, self.decision_ms)
        t = self.trace
        if t is not None:
            t.placed += k
            rec = TraceBinding(stage, node.id, k, self.decision_ms,
                               capacity, room_before)
            (t.pre_decision if pre else t.bindings).append(rec)


# ---------------------------------------------------------------------------
# Candidate features (the repro.policy training input schema)
# ---------------------------------------------------------------------------

#: fixed-width per-candidate feature layout, version-locked to
#: ``TRACE_SCHEMA_VERSION``: training datasets, stored policies and the
#: serving-time scorer all key off this tuple, so a layout change must
#: bump the trace schema
CANDIDATE_FEATURES = (
    "has_fn",             # node already hosts the function
    "fn_n_sat",           # its saturated instances of fn
    "fn_n_cached",        # its cached instances of fn
    "n_instances",        # total instances on the node
    "n_functions",        # distinct live functions on the node
    "mem_room",           # instances of fn the free memory still fits
    "cpu_requested_frac",  # requested CPU / node CPU (overcommit depth)
    "mem_used_frac",      # used memory / node memory
    "table_capacity",     # capacity-table entry for fn (-1 = absent)
    "table_fresh",        # 1 when that entry is fresh
    "table_room",         # entry.capacity - n_sat - n_cached (-1 absent)
    "cpu_norm",           # node CPU vs the reference profiling shape
    "mem_norm",           # node memory vs the reference shape
    "requested",          # instances this decision is placing
)


def candidate_feature_row(ctx: DecisionContext,
                          node: Node) -> List[float]:
    """One candidate node's raw feature vector for the decision in
    ``ctx`` — the row DecisionTrace JSONL records carry (schema v2) and
    the learned scorer consumes at serving time.  Read-only: the same
    cluster state the filters/scorers see, captured before any binding
    mutates it."""
    specs = ctx.cluster.specs
    st = node.funcs.get(ctx.fn)
    n_sat = float(st.n_sat) if st is not None else 0.0
    n_cached = float(st.n_cached) if st is not None else 0.0
    entry = node.table.get(ctx.fn)
    cap = float(entry.capacity) if entry is not None else -1.0
    fresh = 1.0 if entry is not None and entry.fresh else 0.0
    room = (entry.capacity - n_sat - n_cached) \
        if entry is not None else -1.0
    return [
        1.0 if st is not None and st.total > 0 else 0.0,
        n_sat,
        n_cached,
        float(node.n_instances()),
        float(sum(1 for s in node.funcs.values() if s.total > 0)),
        float(ctx.mem_room(node)),
        node.cpu_requested(specs) / node.res.cpu_mcores,
        node.mem_used(specs) / node.res.mem_mb,
        cap,
        fresh,
        float(room),
        node.res.cpu_mcores / REFERENCE_NODE.cpu_mcores,
        node.res.mem_mb / REFERENCE_NODE.mem_mb,
        float(ctx.count),
    ]


# ---------------------------------------------------------------------------
# Candidate passes + the pipeline
# ---------------------------------------------------------------------------


def all_nodes(ctx: DecisionContext) -> Iterable[Node]:
    return ctx.cluster.nodes.values()


def nodes_with_fn(ctx: DecisionContext) -> Iterable[Node]:
    return ctx.cluster.nodes_with(ctx.fn)


@dataclass
class CandidatePass:
    """One filter -> score -> bind sweep over a candidate source.

    ``max_candidates`` truncates *after* scoring (Gsight's top-k
    fan-out); binders applied in score order until the pass places (per
    -instance mode) or the request drains (batched mode)."""

    name: str
    binder: Binder
    filters: Sequence[NodeFilter] = ()
    scorer: Optional[NodeScorer] = None
    source: Callable[[DecisionContext], Iterable[Node]] = all_nodes
    max_candidates: Optional[int] = None

    def candidates(self, ctx: DecisionContext) -> List[Node]:
        keep: List[Node] = []
        for node in self.source(ctx):
            reason = None
            for f in self.filters:
                reason = f.filter(ctx, node)
                if reason is not None:
                    break
            if reason is not None:
                ctx.reject(node, reason)
                continue
            keep.append(node)
        if self.scorer is not None:
            scorer = self.scorer
            # batching scorers (the learned policy's jitted forward)
            # score the whole surviving candidate set in one call;
            # plain scorers stay one-node functions
            batch = getattr(scorer, "score_batch", None)
            scores = batch(ctx, keep) if batch is not None \
                else [scorer.score(ctx, n) for n in keep]
            # stable descending order: ties keep enumeration order,
            # exactly the legacy sorted(key=-x) semantics
            order = sorted(range(len(keep)), key=scores.__getitem__,
                           reverse=True)
            keep = [keep[i] for i in order]
            t = ctx.trace
            if t is not None and len(t.scored) < TRACE_SCORES:
                for rank, i in enumerate(order[:TRACE_TOP_SCORES]):
                    if len(t.scored) >= TRACE_SCORES:
                        break
                    t.scored.append((self.name, keep[rank].id,
                                     scores[i]))
        if self.max_candidates is not None:
            keep = keep[: self.max_candidates]
        return keep


@dataclass
class SchedulingPipeline:
    """A complete decision policy: optional pre-decision gate, ordered
    candidate passes, and a scale-out binder for fresh nodes.

    ``per_instance=False`` (batched, Jiagu-style) drains the whole
    request through each pass in turn and accounts one decision;
    ``per_instance=True`` (K8s/Owl/Gsight-style) re-runs the passes for
    every instance, re-enumerating and re-scoring candidates each time,
    and accounts one decision per instance — both reproduce the legacy
    schedulers' metric granularity exactly."""

    passes: List[CandidatePass]
    scale_out: Binder
    pre_decision: Optional[PreDecision] = None
    per_instance: bool = False

    def run(self, sched: BaseScheduler, fn: str, count: int,
            now: float) -> List[Placement]:
        trace = DecisionTrace(
            sched.name, fn, now, count,
            mode="per-instance" if self.per_instance else "batched") \
            if sched.trace_decisions else None
        ctx = DecisionContext(sched, fn, count, now, trace)
        if trace is not None and sched.trace_features:
            # snapshot every node's raw feature row BEFORE any stage
            # mutates the cluster: this is the training input the
            # decision was actually made against (repro.policy)
            trace.candidates = [
                (node.id, candidate_feature_row(ctx, node))
                for node in ctx.cluster.nodes.values()]
        if self.per_instance:
            self._run_per_instance(ctx)
        else:
            self._run_batched(ctx)
        if trace is not None:
            first = trace.pre_decision[0] if trace.pre_decision else \
                trace.bindings[0] if trace.bindings else None
            trace.chosen_node = first.node_id if first is not None else -1
            sched.last_trace = trace
        return ctx.placements

    # -- batched (Jiagu-style): one decision for the whole request -------

    def _run_batched(self, ctx: DecisionContext) -> None:
        m = ctx.metrics
        if self.pre_decision is not None and ctx.remaining > 0:
            self.pre_decision.gate(ctx)
        for p in self.passes:
            if ctx.remaining <= 0:
                break
            for node in p.candidates(ctx):
                if ctx.remaining <= 0:
                    break
                p.binder.bind(ctx, node)
        while ctx.remaining > 0:
            node = ctx.sched._new_node()
            if self.scale_out.bind(ctx, node) <= 0:
                m.failed += ctx.remaining
                if ctx.trace is not None:
                    ctx.trace.failed = ctx.remaining
                break
        m.decisions += 1
        m.sched_latencies.append(ctx.decision_ms)
        m.sched_time_ms += ctx.decision_ms
        if ctx.trace is not None:
            ctx.trace.latency_ms += ctx.decision_ms

    # -- per-instance (K8s/Owl/Gsight-style) -----------------------------

    def _run_per_instance(self, ctx: DecisionContext) -> None:
        m = ctx.metrics
        total_ms = 0.0
        while ctx.remaining > 0:
            ctx.decision_ms = 0.0
            bound = False
            for p in self.passes:
                for node in p.candidates(ctx):
                    if p.binder.bind(ctx, node) > 0:
                        bound = True
                        break
                if bound:
                    break
            if not bound:
                # legacy semantics: a fresh node always absorbs the
                # instance (no capacity refusal on the per-instance
                # baselines)
                self.scale_out.bind(ctx, ctx.sched._new_node())
            m.decisions += 1
            m.sched_latencies.append(ctx.decision_ms)
            m.sched_time_ms += ctx.decision_ms
            total_ms += ctx.decision_ms
        if ctx.trace is not None:
            ctx.trace.latency_ms += total_ms


class PipelineHostMixin:
    """Turns any ``BaseScheduler`` subclass into a pipeline host:
    ``schedule()`` runs the composed ``SchedulingPipeline`` instead of
    a monolithic body.  Subclasses implement ``build_pipeline()`` (and
    may override ``on_place`` for post-placement bookkeeping, e.g.
    Jiagu's async capacity-update queueing)."""

    _pipeline: Optional[SchedulingPipeline] = None

    @property
    def pipeline(self) -> SchedulingPipeline:
        if self._pipeline is None:
            self._pipeline = self.build_pipeline()
        return self._pipeline

    def build_pipeline(self) -> SchedulingPipeline:
        raise NotImplementedError

    def schedule(self, fn: str, count: int, now: float) -> List[Placement]:
        return self.pipeline.run(self, fn, count, now)


# ---------------------------------------------------------------------------
# Reusable stages: Jiagu's capacity-table lookup
# ---------------------------------------------------------------------------


class CapacityTableGate:
    """Jiagu's fast path as a ``PreDecision`` gate: place co-arriving
    instances on nodes whose *fresh* capacity-table entries still show
    headroom, at table-lookup cost (``FAST_PATH_MS``), before any
    critical-path inference.  Optional ``filters`` let derived policies
    (harvesting's QoS cooldown) veto gate candidates."""

    name = "capacity-table"

    def __init__(self, filters: Sequence[NodeFilter] = ()):
        self.filters = tuple(filters)

    def gate(self, ctx: DecisionContext) -> None:
        fn = ctx.fn
        for node in sorted(ctx.cluster.nodes_with(fn),
                           key=lambda n: -n.funcs[fn].n_sat):
            if ctx.remaining <= 0:
                break
            vetoed = False
            for f in self.filters:
                reason = f.filter(ctx, node)
                if reason is not None:
                    ctx.reject(node, reason)
                    vetoed = True
                    break
            if vetoed:
                continue
            entry = node.table.get(fn)
            if entry is None or not entry.fresh:
                ctx.reject(node, "stale-table")
                continue
            st = node.funcs[fn]
            room = min(entry.capacity - st.n_sat - st.n_cached,
                       ctx.mem_room(node))
            if room <= 0:
                ctx.reject(node, "no-table-headroom")
                continue
            k = min(ctx.remaining, room)
            ctx.add_ms(FAST_PATH_MS)
            ctx.place(node, k, self.name, capacity=entry.capacity,
                      room_before=room, pre=True)
            ctx.metrics.fast += 1


class StaleTableFilter:
    """Keep only nodes whose capacity entry for fn is absent or stale
    (fresh entries were already drained by the pre-decision gate)."""

    name = "stale-table"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        entry = node.table.get(ctx.fn)
        if entry is not None and entry.fresh:
            return "fresh-table"
        return None


class NotRunningFilter:
    """Keep only nodes not currently running fn (the slow path's
    spread-to-other-nodes sweep)."""

    name = "not-running"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        st = node.funcs.get(ctx.fn)
        if st is not None and st.total > 0:
            return "already-running"
        return None


class MemRoomFilter:
    """Reject nodes with no (non-overcommitted) memory headroom."""

    name = "mem-room"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        if ctx.mem_room(node) <= 0:
            return "no-mem-room"
        return None


class InstanceCountScorer:
    """Most-packed first (the legacy ``-n_instances()`` orderings)."""

    name = "instance-count"

    def score(self, ctx: DecisionContext, node: Node) -> float:
        return node.n_instances()


class JiaguSlowBinder:
    """Jiagu's slow path for one node: critical-path capacity solve
    (billed), place up to the predicted headroom."""

    name = "jiagu-slow"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        if ctx.mem_room(node) <= 0:
            ctx.reject(node, "no-mem-room")
            return 0
        cap, ms = ctx.sched._slow_capacity(node, ctx.fn, ctx.remaining)
        ctx.add_ms(ms)
        st = node.state(ctx.fn)
        room = min(cap - st.n_sat - st.n_cached, ctx.mem_room(node))
        if room <= 0:
            ctx.reject(node, "capacity-exhausted")
            return 0
        k = min(ctx.remaining, room)
        ctx.place(node, k, self.name, capacity=cap, room_before=room)
        ctx.metrics.slow += 1
        return k


class JiaguScaleOutBinder:
    """Jiagu's cluster scale-out: solve the fresh node's capacity
    (billed to the slow path), refuse only when even an empty node
    cannot host the function."""

    name = "jiagu-scale-out"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        cap, ms = ctx.sched._slow_capacity(node, ctx.fn, ctx.remaining)
        ctx.add_ms(ms)
        ctx.metrics.slow += 1
        room = min(max(cap, 1), ctx.mem_room(node))
        if room <= 0:
            ctx.reject(node, "scale-out-infeasible")
            return 0
        k = min(ctx.remaining, room)
        ctx.place(node, k, self.name, capacity=cap, room_before=room)
        return k


# ---------------------------------------------------------------------------
# Reusable stages: Gsight's per-request prediction
# ---------------------------------------------------------------------------


class WarmAffinityScorer:
    """Nodes already running fn first, most-packed first within each
    group (Gsight's candidate ordering)."""

    name = "warm-affinity"

    def score(self, ctx: DecisionContext, node: Node) -> Tuple[bool, int]:
        return (ctx.fn in node.funcs, node.n_instances())


class GsightAdmitBinder:
    """Per-request prediction on the critical path: one inference pass
    over the node's whole colocation (per-instance granularity) admits
    or rejects the placement."""

    name = "gsight-admit"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        if ctx.mem_room(node) <= 0:
            ctx.reject(node, "no-mem-room")
            return 0
        ok, ms = ctx.sched._check_node(node, ctx.fn)
        ctx.add_ms(ms)
        ctx.metrics.slow += 1
        if not ok:
            ctx.reject(node, "predicted-qos-violation")
            return 0
        ctx.place(node, 1, self.name)
        return 1


class GsightScaleOutBinder:
    """Fresh-node fallback: still pays the prediction (the legacy
    accounting), then deploys regardless — an empty node is the best
    available option."""

    name = "gsight-scale-out"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        _ok, ms = ctx.sched._check_node(node, ctx.fn)
        ctx.add_ms(ms)
        ctx.metrics.slow += 1
        ctx.place(node, 1, self.name)
        return 1


# ---------------------------------------------------------------------------
# Reusable stages: requested-resource packing (K8s) + Owl's grouping
# ---------------------------------------------------------------------------


class RequestedFitFilter:
    """Kubernetes admission: requested CPU and memory must fit without
    overcommitment."""

    name = "requested-fit"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        if not ctx.sched._fits(node, ctx.spec):
            return "requested-overcommit"
        return None


class RequestedCpuScorer:
    """Most-allocated first (default kube-scheduler bin-packing-ish)."""

    name = "requested-cpu"

    def score(self, ctx: DecisionContext, node: Node) -> float:
        return node.cpu_requested(ctx.cluster.specs)


class DeployOneBinder:
    """Model-free deployment of a single instance at table-lookup cost
    (K8s and Owl placements)."""

    name = "deploy-one"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        ctx.add_ms(FAST_PATH_MS)
        ctx.place(node, 1, self.name)
        ctx.metrics.fast += 1
        return 1


class OwlSafeComboFilter:
    """Owl pass 1: only colocation combos *observed* safe (and at most
    two functions per node — the paper's stated limitation)."""

    name = "owl-safe-combo"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        sched = ctx.sched
        combo = sched._combo_after(node, ctx.fn)
        if len(combo) > 2:
            return "combo-limit"
        if ctx.mem_room(node) <= 0:
            return "no-mem-room"
        key = sched._key(combo)
        if key in sched.safe and key not in sched.unsafe:
            return None
        return "unproven-combo"


class OwlExploreFilter:
    """Owl pass 2: explore unknown combos within requested resources
    (never combos observed unsafe)."""

    name = "owl-explore"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        sched = ctx.sched
        combo = sched._combo_after(node, ctx.fn)
        if len(combo) > 2:
            return "combo-limit"
        if sched._key(combo) in sched.unsafe:
            return "observed-unsafe"
        if not sched._fits_requested(node, ctx.spec):
            return "requested-overcommit"
        return None


# ---------------------------------------------------------------------------
# Dual-staged scaling picks as stages (platform.ReleasePicker /
# platform.LogicalStartPicker implementations)
# ---------------------------------------------------------------------------


class GreedyReleasePicker:
    """Default ``ReleasePicker`` stage: drain least-loaded nodes first
    so released capacity concentrates (and empty servers can be
    returned).  Subclasses reorder candidacy via ``sort_key`` without
    re-implementing the drain."""

    name = "greedy"

    def __init__(self, scheduler: BaseScheduler):
        self.sched = scheduler

    def sort_key(self, node: Node):
        return node.n_instances()

    def pick_release_nodes(self, fn: str, k: int) -> List[Tuple[Node, int]]:
        picks = []
        for node in sorted(self.sched.cluster.nodes_with(fn),
                           key=self.sort_key):
            if k <= 0:
                break
            take = min(k, node.funcs[fn].n_sat)
            if take > 0:
                picks.append((node, take))
                k -= take
        return picks


class BreachAwareReleasePicker(GreedyReleasePicker):
    """Release stage that drains QoS-breached (cooling-down) nodes
    first — most recent breach first — then falls back to the greedy
    least-loaded order.  The harvesting scheduler's QoS-margin release
    goes through this stage."""

    name = "breach-aware"

    def sort_key(self, node: Node):
        return (-self.sched.qos_cooldown_until(node),
                node.n_instances())


class GreedyLogicalStartPicker:
    """Default ``LogicalStartPicker`` stage: re-saturate cached
    instances most-cached-first (<1 ms re-routes instead of real cold
    starts for any scheduler that opts into dual-staged scaling)."""

    name = "greedy"

    def __init__(self, scheduler: BaseScheduler):
        self.sched = scheduler

    def pick_logical_start_nodes(self, fn: str, k: int
                                 ) -> List[Tuple[Node, int]]:
        picks = []
        nodes = sorted((n for n in self.sched.cluster.nodes_with(fn)
                        if n.funcs[fn].n_cached > 0),
                       key=lambda n: -n.funcs[fn].n_cached)
        for node in nodes:
            if k <= 0:
                break
            take = min(k, node.funcs[fn].n_cached)
            picks.append((node, take))
            k -= take
        return picks


class TableBoundLogicalStartPicker:
    """Capacity-table-bound logical starts (Jiagu): re-saturate cached
    instances only where the table says the node can absorb them.
    Subclasses narrow candidacy via ``eligible`` (harvesting skips
    nodes in QoS cooldown) without re-implementing the pick."""

    name = "table-bound"

    def __init__(self, scheduler: BaseScheduler):
        self.sched = scheduler

    def eligible(self, node: Node) -> bool:
        return True

    def pick_logical_start_nodes(self, fn: str, k: int
                                 ) -> List[Tuple[Node, int]]:
        picks = []
        nodes = sorted((n for n in self.sched.cluster.nodes_with(fn)
                        if n.funcs[fn].n_cached > 0),
                       key=lambda n: -n.funcs[fn].n_cached)
        for node in nodes:
            if k <= 0:
                break
            if not self.eligible(node):
                continue
            st = node.funcs[fn]
            entry = node.table.get(fn)
            cap = entry.capacity if entry else st.n_sat + st.n_cached
            absorb = min(st.n_cached, max(cap - st.n_sat, 0))
            if absorb <= 0:
                continue
            take = min(k, absorb)
            picks.append((node, take))
            k -= take
        return picks


# ---------------------------------------------------------------------------
# The four legacy schedulers, re-expressed as pipeline stacks
# ---------------------------------------------------------------------------


class PipelineJiaguScheduler(PipelineHostMixin, JiaguScheduler):
    """Jiagu as a stack: capacity-table ``PreDecision`` gate, a
    stale-table sweep over the function's nodes, a most-packed-first
    spread over nodes not yet running it, and capacity-checked
    scale-out.  Placement-parity-gated against ``JiaguScheduler``."""

    name = "jiagu-pipeline"

    def build_pipeline(self) -> SchedulingPipeline:
        slow = JiaguSlowBinder()
        return SchedulingPipeline(
            pre_decision=CapacityTableGate(),
            passes=[
                CandidatePass("slow-stale", slow,
                              filters=(StaleTableFilter(),),
                              source=nodes_with_fn),
                CandidatePass("slow-spread", slow,
                              filters=(NotRunningFilter(),),
                              scorer=InstanceCountScorer()),
            ],
            scale_out=JiaguScaleOutBinder())

    def on_place(self, node: Node, k: int, now: float,
                 latency_ms: float) -> None:
        self._queue_update(node, now + latency_ms / 1e3)


class PipelineGsightScheduler(PipelineHostMixin, GsightScheduler):
    """Gsight as a stack: warm-affinity top-k candidates, per-request
    prediction as the admission binder."""

    name = "gsight-pipeline"

    def build_pipeline(self) -> SchedulingPipeline:
        return SchedulingPipeline(
            passes=[CandidatePass("admit", GsightAdmitBinder(),
                                  scorer=WarmAffinityScorer(),
                                  max_candidates=self.max_candidates)],
            scale_out=GsightScaleOutBinder(),
            per_instance=True)


class PipelineK8sScheduler(PipelineHostMixin, K8sScheduler):
    """Kubernetes as a stack: requested-fit filter, most-allocated
    scorer, model-free binder."""

    name = "k8s-pipeline"

    def build_pipeline(self) -> SchedulingPipeline:
        return SchedulingPipeline(
            passes=[CandidatePass("binpack", DeployOneBinder(),
                                  filters=(RequestedFitFilter(),),
                                  scorer=RequestedCpuScorer())],
            scale_out=DeployOneBinder(),
            per_instance=True)


class PipelineOwlScheduler(PipelineHostMixin, OwlScheduler):
    """Owl as a stack: known-safe historical combos first, then
    exploration within requested resources."""

    name = "owl-pipeline"

    def build_pipeline(self) -> SchedulingPipeline:
        deploy = DeployOneBinder()
        return SchedulingPipeline(
            passes=[
                CandidatePass("known-safe", deploy,
                              filters=(OwlSafeComboFilter(),),
                              scorer=InstanceCountScorer()),
                CandidatePass("explore", deploy,
                              filters=(OwlExploreFilter(),),
                              scorer=InstanceCountScorer()),
            ],
            scale_out=deploy,
            per_instance=True)


register_scheduler(
    "jiagu-pipeline",
    lambda ctx: PipelineJiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                                       ctx.predictor, m_max=ctx.m_max),
    needs_predictor=True, dual_staged_default=True)
register_scheduler(
    "gsight-pipeline",
    lambda ctx: make_gsight_scheduler(ctx, PipelineGsightScheduler),
    needs_predictor=True)
register_scheduler(
    "k8s-pipeline",
    lambda ctx: PipelineK8sScheduler(ctx.cluster, ctx.store, ctx.qos))
register_scheduler(
    "owl-pipeline",
    lambda ctx: PipelineOwlScheduler(ctx.cluster, ctx.store, ctx.qos))


__all__ = [
    "TRACE_SCHEMA_VERSION", "CANDIDATE_FEATURES",
    "candidate_feature_row",
    "DecisionTrace", "TraceBinding", "DecisionContext",
    "NodeFilter", "NodeScorer", "Binder", "PreDecision",
    "CandidatePass", "SchedulingPipeline", "PipelineHostMixin",
    "all_nodes", "nodes_with_fn",
    "CapacityTableGate", "StaleTableFilter", "NotRunningFilter",
    "MemRoomFilter", "InstanceCountScorer", "JiaguSlowBinder",
    "JiaguScaleOutBinder", "WarmAffinityScorer", "GsightAdmitBinder",
    "GsightScaleOutBinder", "RequestedFitFilter", "RequestedCpuScorer",
    "DeployOneBinder", "OwlSafeComboFilter", "OwlExploreFilter",
    "GreedyReleasePicker", "BreachAwareReleasePicker",
    "GreedyLogicalStartPicker", "TableBoundLogicalStartPicker",
    "PipelineJiaguScheduler", "PipelineGsightScheduler",
    "PipelineK8sScheduler", "PipelineOwlScheduler",
]
