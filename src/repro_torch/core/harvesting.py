"""Freyr-style harvesting scheduler, built entirely from the pipeline
surface (PAPERS: "Accelerating Serverless Computing by Harvesting Idle
Resources").

The policy, decomposed into pipeline stages:

  * **Pre-decision** — the same capacity-table gate Jiagu uses: fresh
    table headroom absorbs co-arriving instances at lookup cost, vetoed
    on nodes currently in QoS cooldown (``QosCooldownFilter``).
  * **Score** — ``IdleHeadroomScorer``: candidates ranked by predicted
    *idle headroom* from the ``PredictionService`` (capacity-table
    entry, else a zero-cost service cache hint), falling back to
    requested-CPU slack where no prediction exists.  Harvesting fills
    the most under-used machines first — the opposite of Jiagu's
    most-packed spread — converting idle capacity into placements.
  * **Bind** — ``HarvestBinder``: a critical-path capacity solve (same
    accounting as Jiagu's slow path) bounds the harvest;
    ``harvest_headroom`` scales how much of the predicted capacity may
    be claimed (1.0 = exactly the predicted bound, <1 conservative,
    >1 deliberate overcommit for burst absorption).
  * **Release on QoS-margin breach** — a runtime QoS violation on a
    node (``observe``) puts it in cooldown and releases recently
    harvested instances through the ``ReleasePicker`` stage hook
    (``BreachAwareReleasePicker`` drains the breached node first);
    released instances become *cached* (dual-staged semantics: a later
    rise re-saturates them elsewhere in <1 ms) and are evicted by the
    scheduler's own keep-alive ledger if the load never returns.

Registered as ``"harvesting"`` — runnable from a pure
``PlatformConfig`` manifest dict and part of the ``repro.platform``
smoke, where its QoS-violation rate must not regress versus the
K8s no-overcommit baseline on the burst-storm scenario.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .capacity import M_MAX_DEFAULT, QoSStore
from .cluster import Cluster, Node
from .pipeline import (BreachAwareReleasePicker, CandidatePass,
                       CapacityTableGate, DecisionContext, MemRoomFilter,
                       PipelineHostMixin, SchedulingPipeline,
                       TableBoundLogicalStartPicker)
from .prediction_service import PredictionService
from .predictor import PerfPredictor
from .profiles import ProfileStore
from .scheduler import JiaguScheduler, register_scheduler

#: fraction of a breached node's saturated instances released per breach
RELEASE_FRAC = 0.25
#: keep-alive of QoS-released (cached) instances before real eviction
RELEASED_KEEPALIVE_S = 60.0


class QosCooldownFilter:
    """Reject nodes still cooling down from a QoS-margin breach — the
    pipeline must not immediately re-harvest a machine it just
    relieved."""

    name = "qos-cooldown"

    def filter(self, ctx: DecisionContext, node: Node) -> Optional[str]:
        if ctx.sched.qos_cooldown_until(node) > ctx.now:
            return "qos-cooldown"
        return None


class IdleHeadroomScorer:
    """Predicted idle headroom of a node for fn, highest first.

    Prefers prediction-backed estimates (fresh-or-stale table entry,
    else a zero-cost ``PredictionService`` cache hint) over the
    requested-CPU fallback: ``(known, headroom)`` tuples sort
    prediction-known nodes ahead, so harvesting chases *predicted*
    idle capacity and only falls back to requested-resource slack on
    never-solved nodes."""

    name = "idle-headroom"

    def score(self, ctx: DecisionContext, node: Node
              ) -> Tuple[int, float]:
        sched = ctx.sched
        cap: Optional[int] = None
        entry = node.table.get(ctx.fn)
        if entry is not None:
            cap = entry.capacity
        elif sched.engine is not None:
            cap = sched.engine.capacity_hint(
                sched._coloc_counts(node), ctx.fn, node_res=node.res)
        if cap is not None:
            st = node.funcs.get(ctx.fn)
            used = st.total if st is not None else 0
            return (1, float(cap - used))
        free = node.res.cpu_mcores \
            - node.cpu_requested(ctx.cluster.specs)
        return (0, free / max(ctx.spec.cpu_req, 1e-9))


class HarvestBinder:
    """Solve the node's capacity on the critical path (Jiagu slow-path
    accounting) and harvest up to ``harvest_headroom`` of it."""

    name = "harvest"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        sched = ctx.sched
        cap, ms = sched._slow_capacity(node, ctx.fn, ctx.remaining)
        ctx.add_ms(ms)
        st = node.state(ctx.fn)
        bound = int(cap * sched.harvest_bound(ctx.fn))
        room = min(bound - st.n_sat - st.n_cached, ctx.mem_room(node))
        if room <= 0:
            ctx.reject(node, "no-idle-headroom")
            return 0
        k = min(ctx.remaining, room)
        ctx.place(node, k, self.name, capacity=cap, room_before=room)
        ctx.metrics.slow += 1
        return k


class CooldownLogicalStartPicker(TableBoundLogicalStartPicker):
    """Table-bound logical starts that skip nodes in QoS cooldown: a
    just-breached machine must not be re-saturated the next tick (its
    cached instances re-route elsewhere or the pipeline places fresh
    capacity instead)."""

    name = "cooldown-table-bound"

    def eligible(self, node: Node) -> bool:
        # harvesting tracks the tick clock in _now
        now = getattr(self.sched, "_now", 0.0)
        return self.sched.qos_cooldown_until(node) <= now


class HarvestScaleOutBinder:
    """Scale-out under the harvest bound: a fresh node's capacity is
    all idle headroom, and only ``harvest_headroom`` of it may be
    claimed (minimum one instance, so scale-out always progresses)."""

    name = "harvest-scale-out"

    def bind(self, ctx: DecisionContext, node: Node) -> int:
        sched = ctx.sched
        cap, ms = sched._slow_capacity(node, ctx.fn, ctx.remaining)
        ctx.add_ms(ms)
        ctx.metrics.slow += 1
        bound = max(int(cap * sched.harvest_bound(ctx.fn)), 1)
        room = min(bound, ctx.mem_room(node))
        if room <= 0:
            ctx.reject(node, "scale-out-infeasible")
            return 0
        k = min(ctx.remaining, room)
        ctx.place(node, k, self.name, capacity=cap, room_before=room)
        return k


class HarvestingScheduler(PipelineHostMixin, JiaguScheduler):
    """Idle-resource harvesting over the decision pipeline; shares
    Jiagu's prediction machinery (async table updates, batched service
    solving, dual-staged pickers) but places by idle headroom and
    gives harvested capacity back on QoS-margin breach."""

    name = "harvesting"

    def __init__(self, cluster: Cluster, store: ProfileStore,
                 qos: QoSStore, predictor: PerfPredictor,
                 m_max: int = M_MAX_DEFAULT,
                 engine: Optional[PredictionService] = None,
                 harvest_headroom: float = 0.85,
                 qos_release_cooldown_s: float = 30.0):
        super().__init__(cluster, store, qos, predictor, m_max=m_max,
                         engine=engine)
        self.harvest_headroom = harvest_headroom
        #: per-function harvest bounds, maintained by the vertical
        #: resizer (``repro.admission``): a best-effort function running
        #: at a shrunken cpu share frees real headroom, so its bound may
        #: exceed the global scalar (up to the capacity-table solve).
        #: Empty == every function uses ``harvest_headroom``, which is
        #: the admission-off parity configuration.
        self.harvest_bounds: Dict[str, float] = {}
        self.cooldown_s = qos_release_cooldown_s
        self.release_stage = BreachAwareReleasePicker(self)
        self.logical_start_stage = CooldownLogicalStartPicker(self)
        self._cooldown_until: Dict[int, float] = {}
        self._now = 0.0
        # standalone fallback only: QoS-released cached instances
        # awaiting keep-alive eviction as (due_time, node_id, fn,
        # count).  With an assembled control plane the releases go
        # through ``release_ledger.note_release`` (the autoscaler's own
        # keep-alive ledger) instead, so eviction accounting, on_scale
        # events, and migration all treat them like any other cached
        # instance — this deque is used only when no autoscaler exists.
        self._released: Deque[List] = deque()
        self.qos_released = 0        # instances released on breach
        self.qos_breaches = 0        # distinct breach events handled

    def harvest_bound(self, fn: str) -> float:
        """Harvest headroom for ``fn``: its vertical-resize bound when
        one exists, the global scalar otherwise."""
        return self.harvest_bounds.get(fn, self.harvest_headroom)

    # -- the stack --------------------------------------------------------

    def build_pipeline(self) -> SchedulingPipeline:
        cooldown = QosCooldownFilter()
        return SchedulingPipeline(
            pre_decision=CapacityTableGate(filters=(cooldown,)),
            passes=[CandidatePass(
                "harvest", HarvestBinder(),
                filters=(cooldown, MemRoomFilter()),
                scorer=IdleHeadroomScorer())],
            scale_out=HarvestScaleOutBinder())

    def on_place(self, node: Node, k: int, now: float,
                 latency_ms: float) -> None:
        self._queue_update(node, now + latency_ms / 1e3)

    # -- QoS-margin breach: release through the ReleasePicker stage ------

    def qos_cooldown_until(self, node: Node) -> float:
        return self._cooldown_until.get(node.id, -math.inf)

    def observe(self, node: Node, ok: bool, now: float):
        if ok:
            return
        already_cooling = now < self.qos_cooldown_until(node)
        self._cooldown_until[node.id] = now + self.cooldown_s
        if already_cooling:
            return   # one release per breach event, not per tick
        sat_fns = [(s.n_sat, g) for g, s in node.funcs.items()
                   if s.n_sat > 0]
        if not sat_fns:
            return
        _, fn = max(sat_fns)
        k = max(1, int(round(node.funcs[fn].n_sat * RELEASE_FRAC)))
        self.qos_breaches += 1
        for target, take in self.release_stage.pick_release_nodes(fn, k):
            got = target.release(fn, take)
            if got <= 0:
                continue
            self.qos_released += got
            # the autoscaler declines when it runs traditional keep-
            # alive (its ledger sweep would never evict the entry)
            if self.release_ledger is None or \
                    not self.release_ledger.note_release(fn, target,
                                                         got, now):
                self._released.append(
                    [now + RELEASED_KEEPALIVE_S, target.id, fn, got])
            # released capacity can only have grown: queue a background
            # table refresh (Jiagu §5 semantics)
            self.notify_change(target, now)

    def has_pending_work(self) -> bool:
        return bool(self._released) or super().has_pending_work()

    def on_tick(self, now: float):
        self._now = now
        super().on_tick(now)
        # standalone fallback: keep-alive eviction of QoS-released
        # instances the load never re-claimed (empty whenever the
        # autoscaler's ledger is wired in)
        while self._released and self._released[0][0] <= now:
            _, node_id, fn, k = self._released.popleft()
            node = self.cluster.nodes.get(node_id)
            if node is None:
                continue
            got = node.evict_cached(fn, k)
            if got:
                self.notify_change(node, now)


register_scheduler(
    "harvesting",
    lambda ctx: HarvestingScheduler(
        ctx.cluster, ctx.store, ctx.qos, ctx.predictor, m_max=ctx.m_max,
        harvest_headroom=ctx.harvest_headroom,
        qos_release_cooldown_s=ctx.qos_release_cooldown_s),
    needs_predictor=True, dual_staged_default=True)


__all__ = ["HarvestingScheduler", "QosCooldownFilter",
           "IdleHeadroomScorer", "HarvestBinder",
           "HarvestScaleOutBinder", "CooldownLogicalStartPicker"]
