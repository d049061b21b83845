"""Cell-sharded, event-driven simulation core — 10k-node studies at
sub-linear per-node cost.

The legacy ``Simulation`` is one global tick loop: every tick visits
every spec in the autoscaler and every node in ``_measure``.  This
module partitions the fleet into **cells** — each owning its own
cluster slice, scheduler, autoscaler and ``PredictionService`` — and
drives them with an event-driven per-cell loop:

  * **Cross-cell routing** (``CellRouter``): a per-tick share plan
    generalizing ``LocalityRouter``'s waterfill one level up — a
    function's traffic prefers its warmest, least-contended *cells*
    (capped at ``load_cap`` of their saturated throughput) and spills
    the remainder proportionally; functions with no placements anywhere
    are assigned a deterministic home cell (crc32 — stable across
    processes, unlike builtin ``hash``).  With one cell the plan is an
    identity passthrough, which is what makes ``cells=1`` bit-exact.
  * **Event kinds** driving a cell's work between load changes: load
    arrivals (a function's cell share going positive), drop transitions
    (share hitting zero arms the release timer), autoscaler **wakes**
    (a per-cell heap of release-timer and keep-alive-ledger expiries,
    from ``Autoscaler.next_wake``), and **dirty marks** (out-of-band
    releases via ``Autoscaler.on_fn_dirty``).  A cell with no due
    functions, no pending scheduler work and clean migrate/reap indexes
    costs a few dict checks per tick.
  * **Dirty-set measurement** (``simulator.measure_cluster``): only
    nodes hosting functions with live traffic are measured, in the
    exact node order (and ground-truth RNG sequence) of the legacy full
    scan.  The dirty-set path is exact whenever the scheduler does not
    learn from idle-node observations (``needs_idle_observe`` — Owl
    keeps the full scan).
  * **Capacity exchange** (``CapacityExchange``): freshly solved
    capacities gossip to sibling cells' services (epoch-checked), so a
    colocation pattern solved in one cell is cache-warm fleet-wide —
    the cell-level replacement for the global capacity table.

``cells=1`` reproduces the legacy ``Simulation`` bit-for-bit (density,
QoS, scheduling and scaling counters) — gated by
``tests/test_cells.py`` and the ``cells_parity`` metric in
``BENCH_scaling.json``.
"""
from __future__ import annotations

import heapq
import math
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .autoscaler import Autoscaler, ScalingMetrics
from .capacity import QoSStore
from .cluster import Cluster, Node
from .events import EventHub
from .interference import GroundTruth
from .profiles import FunctionSpec, ProfileStore
from .predictor import PerfPredictor, build_features
from .scheduler import BaseScheduler, SchedMetrics
from .simulator import SimConfig, SimResult, measure_cluster
from .traces import Trace
from ..telemetry.spans import NULL_TRACER


class Cell:
    """One shard of the control plane: a cluster slice plus the
    scheduler/autoscaler/router that own it, and the event state
    (wake heap, dirty functions, previous active set) the event loop
    drives it with."""

    def __init__(self, cell_id: int, cluster: Cluster,
                 scheduler: BaseScheduler, autoscaler: Autoscaler,
                 router=None):
        self.id = cell_id
        self.cluster = cluster
        self.scheduler = scheduler
        self.autoscaler = autoscaler
        self.router = router
        #: functions touched out-of-band since their last visit
        #: (scheduler-initiated releases entering the keep-alive ledger)
        self.dirty: Set[str] = set()
        #: the previous tick's active set — the difference yields the
        #: drop-transition event that arms the release timer
        self.prev_active: Set[str] = set()
        self._wakes: List[Tuple[float, str]] = []
        autoscaler.on_fn_dirty = self.dirty.add

    def push_wake(self, t: float, fn: str) -> None:
        heapq.heappush(self._wakes, (t, fn))

    def pop_due_wakes(self, now: float) -> Set[str]:
        due: Set[str] = set()
        while self._wakes and self._wakes[0][0] <= now:
            due.add(heapq.heappop(self._wakes)[1])
        return due


class CellRouter:
    """Per-tick cross-cell traffic shares, one waterfill level above
    ``LocalityRouter``: cells hosting a function's saturated instances
    are ordered by contention (foreign instances per own saturated
    instance), loaded up to ``load_cap`` of their saturated throughput,
    and overload is spread proportionally to instance counts — so the
    per-cell shares sum to the function's RPS exactly.  Cold functions
    (no placements anywhere) go whole to a deterministic home cell.

    With a single cell ``split`` returns the global RPS dict untouched:
    no float division ever runs, which is what keeps ``cells=1``
    bit-identical to the legacy loop."""

    def __init__(self, cells: Sequence[Cell], load_cap: float = 0.85):
        self.cells = list(cells)
        self.load_cap = load_cap

    def home(self, fn: str) -> int:
        return zlib.crc32(fn.encode()) % len(self.cells)

    def split(self, rps: Dict[str, float],
              specs: Dict[str, FunctionSpec]) -> List[Dict[str, float]]:
        cells = self.cells
        if len(cells) == 1:
            return [rps]
        shares: List[Dict[str, float]] = [{} for _ in cells]
        inst_totals = [c.cluster.total_instances() for c in cells]
        for fn, fn_rps in rps.items():
            if fn_rps <= 1e-9:
                continue
            sats = [c.cluster.sat_count(fn) for c in cells]
            total_sat = sum(sats)
            if total_sat == 0:
                shares[self.home(fn)][fn] = fn_rps
                continue
            spec = specs[fn]

            def contention(i: int) -> float:
                own = sats[i] + cells[i].cluster.cached_count(fn)
                return (inst_totals[i] - own) / max(sats[i], 1)

            order = sorted((i for i in range(len(cells)) if sats[i] > 0),
                           key=lambda i: (contention(i), i))
            remaining = fn_rps
            take_by: Dict[int, float] = {}
            for i in order:
                take = min(remaining, sats[i] * spec.saturated_rps
                           * self.load_cap)
                take_by[i] = take
                remaining -= take
            if remaining > 1e-9:
                for i in order:
                    take_by[i] += remaining * sats[i] / total_sat
            for i, take in take_by.items():
                if take > 1e-12:
                    shares[i][fn] = take
        return shares


class CapacityExchange:
    """Cell-level capacity gossip: every capacity one cell's
    ``PredictionService`` solves is offered to every sibling service
    (``accept_exchange`` — epoch-checked, silently dropped across a
    retrain boundary), replacing the global capacity table the legacy
    single-service world shared for free."""

    def __init__(self):
        self.services: List = []
        self.published = 0
        self.fanout = 0

    def join(self, service) -> None:
        self.services.append(service)
        service.exchange = self

    def publish(self, src, key, epoch: int, cap: int) -> None:
        self.published += 1
        for svc in self.services:
            if svc is not src:
                svc.accept_exchange(key, epoch, cap)
                self.fanout += 1


class _FleetView:
    """Read-only duck-type of ``Cluster`` over every cell (observers
    read ``sim.cluster.nodes`` / ``total_instances``)."""

    def __init__(self, cells: Sequence[Cell]):
        self._cells = cells

    @property
    def nodes(self) -> Dict[int, Node]:
        out: Dict[int, Node] = {}
        for c in self._cells:
            out.update(c.cluster.nodes)
        return out

    def total_instances(self) -> int:
        return sum(c.cluster.total_instances() for c in self._cells)


class CellSimulation:
    """The event-driven run loop over a list of ``Cell``s — the same
    contract as ``Simulation.run`` (one ``SimResult``, observer hooks,
    span tracing), with per-cell scheduling work gated on due events.

    Per tick: split traffic across cells (``CellRouter``) -> per cell,
    compute the due set (active ∪ drop-transitions ∪ due wakes ∪ dirty)
    and run scheduler/autoscaler only when something is due or
    migrate/reap indexes are dirty -> dirty-set measurement per cell ->
    sample collection / accounting exactly like the legacy loop."""

    def __init__(self, cells: Sequence[Cell],
                 specs: Dict[str, FunctionSpec], trace: Trace,
                 ground_truth: GroundTruth, store: ProfileStore,
                 qos: QoSStore, predictor: Optional[PerfPredictor] = None,
                 cfg: Optional[SimConfig] = None, *,
                 cell_router: Optional[CellRouter] = None,
                 events: Optional[EventHub] = None,
                 exchange: Optional[CapacityExchange] = None):
        self.cells = list(cells)
        self.specs = specs
        self.trace = trace
        self.gt = ground_truth
        self.store = store
        self.qos = qos
        self.predictor = predictor
        self.cfg = cfg or SimConfig()
        self.cell_router = cell_router or CellRouter(self.cells)
        self.events = events or EventHub()
        self.exchange = exchange
        self.tracer = NULL_TRACER
        self._rng = np.random.default_rng(self.cfg.seed)
        self._spec_index = {fn: i for i, fn in enumerate(specs)}
        self._fleet = self.cells[0].cluster if len(self.cells) == 1 \
            else _FleetView(self.cells)
        #: cell-ticks where scheduling was skipped entirely (idle cell)
        self.idle_cell_ticks = 0
        self.cell_ticks = 0

    # -- Simulation-compatible surface ---------------------------------

    @property
    def cluster(self):
        return self._fleet

    @property
    def scheduler(self) -> BaseScheduler:
        return self.cells[0].scheduler

    @property
    def autoscaler(self) -> Autoscaler:
        return self.cells[0].autoscaler

    @property
    def router(self):
        return self.cells[0].router

    @property
    def _service(self):
        return self.cells[0].scheduler.prediction_service

    def schedulers(self) -> List[BaseScheduler]:
        """Every cell's scheduler — platform-level wiring (decision
        traces, picker-stage overrides) must reach all of them, not
        just the representative ``scheduler`` property."""
        return [c.scheduler for c in self.cells]

    def services(self) -> List:
        """Every cell's PredictionService (None entries dropped)."""
        return self._services()

    def _services(self) -> List:
        out = []
        for c in self.cells:
            svc = c.scheduler.prediction_service
            if svc is not None:
                out.append(svc)
        return out

    # ------------------------------------------------------------------

    def run(self, duration_s: Optional[int] = None) -> SimResult:
        T = duration_s or self.trace.duration_s
        res = SimResult(name=self.cells[0].scheduler.name, ticks=T)
        #: observers read the accumulating result mid-run (tick records
        #: carry cumulative QoS counters for offline outcome labelling)
        self.live_result = res
        services = self._services()
        svc0 = [s.stats.snapshot() for s in services]
        for t in range(T):
            now = float(t)
            rps = {fn: self.trace.at(fn, t) for fn in self.trace.rps}
            shares = self.cell_router.split(rps, self.specs)
            with self.tracer.span("schedule") as sp:
                if sp is not None:
                    d0 = sum(c.scheduler.metrics.decisions
                             for c in self.cells)
                    p0 = sum(c.scheduler.metrics.instances_placed
                             for c in self.cells)
                for cell, cell_rps in zip(self.cells, shares):
                    self._tick_cell(cell, now, cell_rps)
                if sp is not None:
                    sp.attrs["now"] = now
                    sp.attrs["decisions"] = sum(
                        c.scheduler.metrics.decisions
                        for c in self.cells) - d0
                    sp.attrs["placed"] = sum(
                        c.scheduler.metrics.instances_placed
                        for c in self.cells) - p0
            for cell, cell_rps in zip(self.cells, shares):
                self._measure_cell(cell, now, cell_rps, res)
            if (self.cfg.collect_samples and self.predictor is not None
                    and t % self.cfg.sample_every_s == 0):
                self._collect_sample()
            inst = sum(c.cluster.total_instances() for c in self.cells)
            nodes = sum(len(c.cluster.nodes) for c in self.cells)
            res.instance_seconds += inst
            res.node_seconds += nodes
            res.nodes_peak = max(res.nodes_peak, nodes)
            res.density_series.append(inst / nodes if nodes else 0.0)
            self.events.on_tick(now, self)
        res.sched = self._merged_sched()
        res.scaling = self._merged_scaling()
        if self.predictor is not None:
            res.inference_rows = self.predictor.inference_count
            res.inference_calls = self.predictor.inference_calls
            res.mean_inference_ms = self.predictor.mean_inference_ms
        if services:
            for s, s0 in zip(services, svc0):
                st = s.stats.snapshot()
                res.retrains += int(st["retrains"]
                                    - s0.get("retrains", 0))
                res.retrain_time_s += \
                    st["retrain_time_s"] - s0.get("retrain_time_s", 0.0)
                res.refresh_rows += \
                    int(st["refresh_rows"] - s0.get("refresh_rows", 0))
                res.refresh_time_s += \
                    st["refresh_time_s"] - s0.get("refresh_time_s", 0.0)
                res.stale_epoch_hits += int(
                    st["stale_epoch_hits"]
                    - s0.get("stale_epoch_hits", 0))
        for cell in self.cells:
            adm = cell.autoscaler.admission
            if adm is not None:
                adm.finalize(res)
        self.events.on_result(res)
        return res

    def queue_depth_total(self) -> Optional[float]:
        """Fleet-wide pending-queue depth, or None when admission is off
        (mirrors ``Simulation.queue_depth_total``)."""
        depths = [cell.autoscaler.admission.queue_depth()
                  for cell in self.cells
                  if cell.autoscaler.admission is not None]
        return sum(depths) if depths else None

    # ------------------------------------------------------------------

    def _tick_cell(self, cell: Cell, now: float,
                   cell_rps: Dict[str, float]) -> None:
        """One cell's scheduling pass: visit only *due* functions.

        Due = functions with live traffic this tick, functions whose
        traffic just dropped to zero (the legacy loop's
        ``_below_since[fn] = now`` arming tick), functions with an
        expired wake (release timer / keep-alive ledger head), and
        functions dirtied out-of-band.  A skipped function's
        ``_tick_fn`` is provably a no-op: zero expected instances, no
        armed timer, no ledger entries due."""
        self.cell_ticks += 1
        active = {fn for fn, v in cell_rps.items() if v > 1e-9}
        adm = cell.autoscaler.admission
        if adm is not None:
            # admission phase 1 (per-cell queues): arrivals enter the
            # cell's bounded queues; the autoscaler sees the backlog-
            # derived signal, and functions with pending backlog stay
            # due even when their instantaneous share dropped to zero
            cell_rps = adm.enqueue(now, cell_rps, cell.cluster)
            active = active | adm.pending_fns()
        due = active | (cell.prev_active - active)
        due |= cell.pop_due_wakes(now)
        if cell.dirty:
            due |= cell.dirty
            cell.dirty.clear()
        cell.prev_active = active
        cl = cell.cluster
        sched = cell.scheduler
        if due or sched.has_pending_work():
            sched.on_tick(now)
        if due or cl._node_cached or cl._maybe_empty:
            order = sorted(due, key=self._spec_index.__getitem__)
            cell.autoscaler.tick(now, cell_rps, fns=order)
            for fn in order:
                wake = cell.autoscaler.next_wake(fn)
                if wake is not None:
                    cell.push_wake(wake, fn)
        else:
            self.idle_cell_ticks += 1

    def _measure_cell(self, cell: Cell, now: float,
                      cell_rps: Dict[str, float], res: SimResult) -> None:
        adm = cell.autoscaler.admission
        if adm is not None:
            # admission phase 2: the cell's backlog drains into its
            # just-scaled slice; measurement routes served traffic
            cell_rps = adm.drain(now, cell.cluster, res)
        if not cell.prev_active and not cell.scheduler.needs_idle_observe:
            return      # no live traffic: nothing measurable, no-op observes
        sat_totals = {fn: cell.cluster.sat_count(fn)
                      for fn in cell.prev_active} \
            if not cell.scheduler.needs_idle_observe \
            else {fn: cell.cluster.sat_count(fn) for fn in self.specs}
        measure_cluster(now, cell.cluster, self.specs, cell_rps,
                        sat_totals, cell.router, cell.scheduler,
                        self.gt, self.qos, res,
                        slo=None if adm is None else adm.slo)

    def _collect_sample(self) -> None:
        """Mirror of ``Simulation._collect_sample`` over the fleet:
        busy nodes are enumerated cell by cell (ascending cell id, node
        id within — the legacy enumeration order at ``cells=1``), one
        is drawn from this simulation's own RNG stream, and its rows go
        through the *owning* cell's service."""
        svc0 = self._service
        v2 = svc0 is not None and svc0.schema.version >= 2
        busy: List[Node] = []
        owners: List[Cell] = []
        for cell in self.cells:
            for n in cell.cluster.nodes.values():
                if any(s.n_sat > 0 for s in n.funcs.values()) \
                        and (v2 or n.res == self.gt.node):
                    busy.append(n)
                    owners.append(cell)
        if not busy:
            return
        pick = int(self._rng.integers(len(busy)))
        node, owner = busy[pick], owners[pick]
        svc = owner.scheduler.prediction_service
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
            if svc.on_samples(Xs, ys):
                # retrain fired on the shared forest: every cell's
                # tables were computed by the old epoch — refresh each
                # cell through its own service
                for c in self.cells:
                    s = c.scheduler.prediction_service
                    if s is not None and c.scheduler.accepts_service:
                        s.refresh_tables(list(c.cluster.nodes.values()),
                                         c.scheduler.m_max)
        else:
            for x, yv in zip(Xs, ys):
                self.predictor.add_sample(x, yv, retrain=False)

    # -- metric merging -------------------------------------------------

    def _merged_sched(self) -> SchedMetrics:
        if len(self.cells) == 1:
            return self.cells[0].scheduler.metrics
        out = SchedMetrics()
        for c in self.cells:
            m = c.scheduler.metrics
            out.decisions += m.decisions
            out.instances_placed += m.instances_placed
            out.fast += m.fast
            out.slow += m.slow
            out.failed += m.failed
            out.sched_time_ms += m.sched_time_ms
            out.sched_latencies.extend(m.sched_latencies)
            out.critical_inference_rows += m.critical_inference_rows
            out.critical_inference_calls += m.critical_inference_calls
            out.async_inference_rows += m.async_inference_rows
            out.async_updates += m.async_updates
        return out

    def _merged_scaling(self) -> ScalingMetrics:
        if len(self.cells) == 1:
            return self.cells[0].autoscaler.metrics
        out = ScalingMetrics()
        for c in self.cells:
            m = c.autoscaler.metrics
            out.real_cold_starts += m.real_cold_starts
            out.logical_cold_starts += m.logical_cold_starts
            out.blocked_logical += m.blocked_logical
            out.migrations += m.migrations
            out.releases += m.releases
            out.evictions += m.evictions
            out.cold_start_ms.extend(m.cold_start_ms)
        return out


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def cell_scenario_simulation(scenario, scheduler: str = "jiagu", *,
                             n_cells: int = 4,
                             world=None,
                             router_factory=None,
                             cell_load_cap: float = 0.85,
                             exchange: bool = True,
                             max_nodes: Optional[int] = None,
                             events: Optional[EventHub] = None,
                             **build_kw) -> CellSimulation:
    """Assemble a ``CellSimulation`` for a scenario: the fleet's node
    budget splits evenly across ``n_cells`` cells, each wired exactly
    like ``scenario_simulation`` wires one simulation (same scheduler
    registry, autoscaler config, service attachment and schema
    validation — reused via ``build_simulation`` per cell, against the
    shared world).  ``router_factory`` builds one per-cell router
    (default: the paper's equal split); ``build_kw`` passes through to
    ``build_simulation`` (release_s, m_max, use_engine, ...)."""
    from .scenarios import build_simulation, scenario_world, \
        scenario_simulation, scheduler_entry  # late: avoid import cycle

    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    if world is None:
        world = scenario_world(scenario,
                               schema_version=build_kw.get(
                                   "schema_version") or 1)
    if n_cells == 1:
        # the parity configuration: one cell, one cluster, the exact
        # legacy assembly — CellSimulation drives it event-style
        sim = scenario_simulation(scenario, scheduler, world=world,
                                  max_nodes=max_nodes, events=events,
                                  **build_kw)
        cells = [Cell(0, sim.cluster, sim.scheduler, sim.autoscaler,
                      router=sim.router)]
        return CellSimulation(cells, sim.specs, sim.trace, sim.gt,
                              sim.store, sim.qos,
                              predictor=sim.predictor, cfg=sim.cfg,
                              events=sim.events)

    pred = world.predictor \
        if scheduler_entry(scheduler).needs_predictor else None
    total_max = max_nodes or max(4 * scenario.target_nodes, 64)
    per_cell_max = max(1, math.ceil(total_max / n_cells))
    build_kw = dict(build_kw)
    build_kw.pop("schema_version", None)
    cells: List[Cell] = []
    for i in range(n_cells):
        router = router_factory() if router_factory is not None else None
        sim = build_simulation(
            scenario.specs, scenario.trace,
            scenario.build_cluster(per_cell_max),
            world.gt, world.store, world.qos, scheduler, pred,
            schema_version=world.schema_version, router=router,
            events=events, **build_kw)
        cells.append(Cell(i, sim.cluster, sim.scheduler, sim.autoscaler,
                          router=sim.router))
    ex = None
    if exchange:
        ex = CapacityExchange()
        for cell in cells:
            svc = cell.scheduler.prediction_service
            if svc is not None:
                ex.join(svc)
    cfg = SimConfig(seed=build_kw.get("sim_seed", 0),
                    schema_version=world.schema_version,
                    collect_samples=build_kw.get("collect_samples", False),
                    online_retrain=build_kw.get("online_retrain", False),
                    retrain_every=build_kw.get("retrain_every"))
    if build_kw.get("sample_every_s") is not None:
        cfg.sample_every_s = build_kw["sample_every_s"]
    return CellSimulation(
        cells, scenario.specs, scenario.trace, world.gt, world.store,
        world.qos, predictor=pred, cfg=cfg,
        cell_router=CellRouter(cells, load_cap=cell_load_cap),
        events=events, exchange=ex)


__all__ = ["Cell", "CellRouter", "CapacityExchange", "CellSimulation",
           "cell_scenario_simulation"]
