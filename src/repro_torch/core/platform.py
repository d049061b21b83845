"""``repro_torch.platform`` — the unified control-plane API (the port
of ``repro.core.platform``).

Jiagu's core claim is architectural: prediction, scheduling, and scaling
are decoupled stages cooperating through narrow interfaces (pre-decision
capacity tables §4, dual-staged scaling §5).  This module is that
architecture as an API:

  * **Capability protocols** — the autoscaler and simulator consume
    their collaborators through typed capabilities (``CapacityProvider``,
    ``ReleasePicker``, ``LogicalStartPicker``, ``Router``), never
    through concrete class identity, so an RL scheduler, a harvesting
    scaler, or a locality-aware router plugs in without touching the
    run loop.
  * **One validated config tree** — ``PlatformConfig`` (cluster /
    scenario / scheduler / scaling / prediction / simulation sections)
    with a strict ``to_dict``/``from_dict`` round trip, so benchmark
    manifests are plain JSON-able dicts and every schema/engine
    consistency rule fires at construction, not mid-run.
  * **Name-based registries** — schedulers, scenario kinds, trace
    programs and routers are selected by string
    (``register_scheduler`` / ``register_scenario`` / ``register_trace``
    / ``register_router``), so benchmarks, examples and manifests never
    import concrete classes.
  * **The facade** — ``Platform.build(scenario=..., config=...)``
    assembles the world (ground truth, profiles, trained forest),
    cluster, scheduler, autoscaler and simulation, wires the observer
    hub (``on_tick`` / ``on_schedule`` / ``on_scale`` / ``on_retrain``)
    and returns a runnable ``Platform``; ``run()`` drives the tick loop.

``Simulation``, ``build_simulation`` and ``scenario_simulation`` remain
as thin shims over the same machinery, so the legacy/engine/service
parity gates run unchanged.

The port runs the predictor on the card unless the manifest asks
otherwise: ``prediction.engine`` is one of ``INFERENCE_ENGINES``
(numpy / torch / cuda; None keeps the predictor's default, the CUDA
kernels) and ``prediction.device`` names where the torch and cuda
engines and the learned scorer run (None: the card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Protocol, Tuple, Union, runtime_checkable)

import torch

from .capacity import M_MAX_DEFAULT
from .cluster import Cluster, Node
from .events import EventHub, JsonlObserver, Observer
from .interference import NodeResources
from .prediction_service import INFERENCE_ENGINES, get_schema
from .profiles import FunctionSpec
from .registry import Registry
from .scheduler import (BaseScheduler, SchedulerBuildContext,
                        SchedulerEntry, build_scheduler,
                        register_scheduler, registered_schedulers,
                        scheduler_entry)
from .scenarios import (NodeClass, Scenario, ScenarioWorld,
                        get_scenario_builder, make_scenario,
                        register_scenario, registered_scenarios,
                        scenario_simulation, scenario_world)
from .cells import (CapacityExchange, Cell, CellRouter, CellSimulation,
                    cell_scenario_simulation)
from .simulator import (EqualSplitRouter, LocalityRouter, SimResult,
                        Simulation)
from .traces import get_trace, register_trace, registered_traces
# importing these modules registers the pipeline-stacked scheduler
# variants and the harvesting scheduler with the scheduler registry
from .pipeline import (Binder, CandidatePass, DecisionContext,
                       DecisionTrace, GreedyLogicalStartPicker,
                       GreedyReleasePicker, NodeFilter, NodeScorer,
                       PipelineHostMixin, PreDecision,
                       SchedulingPipeline, TableBoundLogicalStartPicker,
                       TraceBinding)
from .pipeline import BreachAwareReleasePicker
from .harvesting import CooldownLogicalStartPicker, HarvestingScheduler
# importing the policy stage registers the "learned" scheduler stack
from ..policy.stage import LearnedScheduler, LearnedScorer
from ..admission import ADMIT_STAGES, RELEASE_STAGES
from ..telemetry import Telemetry, publish_result


class PlatformConfigError(ValueError):
    """A ``PlatformConfig`` failed construction-time validation."""


# ---------------------------------------------------------------------------
# Capability protocols
# ---------------------------------------------------------------------------


@runtime_checkable
class CapacityProvider(Protocol):
    """Best-known capacity of a function on a node — what the
    autoscaler's migration targeting and consolidation consume.  The
    default (``autoscaler.SchedulerCapacityProvider``) reads the node's
    capacity table, then falls back to a zero-cost prediction-service
    cache hint; None means "unknown", and callers must never run
    inference to find out (migration is not a critical path)."""

    def node_capacity(self, node: Node, fn: str) -> Optional[int]:
        ...


@runtime_checkable
class ReleasePicker(Protocol):
    """Which (node, count) pairs to drain when dual-staged scaling
    releases excess instances (or traditional keep-alive evicts them).
    ``BaseScheduler`` provides the greedy least-loaded default."""

    def pick_release_nodes(self, fn: str, k: int) -> List[Tuple[Node, int]]:
        ...


@runtime_checkable
class LogicalStartPicker(Protocol):
    """Which cached instances to re-saturate (<1 ms logical cold
    starts) when load rises.  ``BaseScheduler`` provides a greedy
    most-cached-first default so *any* scheduler that opts into
    dual-staged scaling benefits; ``JiaguScheduler`` overrides it to
    absorb only up to the capacity table's bound."""

    def pick_logical_start_nodes(self, fn: str, k: int
                                 ) -> List[Tuple[Node, int]]:
        ...


@runtime_checkable
class Router(Protocol):
    """Per-tick load routing policy: how much of a function's traffic a
    node's saturated instances serve.  Returns
    ``(per_instance_rps, requests_routed_to_node)``; the default is the
    paper's equal split (``simulator.EqualSplitRouter``)."""

    def route(self, spec: FunctionSpec, fn_rps: float, node: Node,
              n_sat: float, total_sat: int) -> Tuple[float, float]:
        ...


# ---------------------------------------------------------------------------
# Router registry
# ---------------------------------------------------------------------------

_ROUTERS = Registry("router")


def register_router(name: str, factory: Optional[Callable[[], Router]]
                    = None, *, overwrite: bool = False):
    """Register a ``Router`` factory under ``name`` (usable as a class
    decorator)."""
    return _ROUTERS.register(name, factory, overwrite=overwrite)


def get_router(name: str) -> Callable[[], Router]:
    return _ROUTERS.get(name)


def registered_routers() -> List[str]:
    return _ROUTERS.names()


register_router("equal-split", EqualSplitRouter)
register_router("locality", LocalityRouter)


# ---------------------------------------------------------------------------
# Pipeline-stage registry (release / logical-start picker policies and
# any custom filter/scorer/binder a plugin wants selectable by name)
# ---------------------------------------------------------------------------

_STAGES = Registry("pipeline stage")


def _stage_key(kind: str, name: str) -> str:
    return f"{kind}:{name}"


def register_stage(kind: str, name: str, factory=None, *,
                   overwrite: bool = False):
    """Register a pipeline-stage factory under ``(kind, name)``.

    ``kind`` groups stages by protocol ("release", "logical-start",
    "filter", "scorer", "binder", ...); factories take the owning
    scheduler and return the stage object, so config manifests can
    select picker policies by string (``PlatformConfig.pipeline``)."""
    return _STAGES.register(_stage_key(kind, name), factory,
                            overwrite=overwrite)


def get_stage(kind: str, name: str):
    return _STAGES.get(_stage_key(kind, name))


def registered_stages(kind: Optional[str] = None) -> List[str]:
    names = _STAGES.names()
    if kind is None:
        return names
    prefix = f"{kind}:"
    return [n[len(prefix):] for n in names if n.startswith(prefix)]


register_stage("release", "greedy", GreedyReleasePicker)
register_stage("release", "breach-aware", BreachAwareReleasePicker)
register_stage("logical-start", "greedy", GreedyLogicalStartPicker)
register_stage("logical-start", "table-bound",
               TableBoundLogicalStartPicker)
register_stage("logical-start", "cooldown-table-bound",
               CooldownLogicalStartPicker)
# a scorer serves on its scheduler's forest's device (the manifest's
# prediction.device when Platform.build trained the world)
register_stage("scorer", "learned", lambda sched: LearnedScorer(
    device=sched.predictor.model.device
    if sched.predictor is not None else None))

# admission-pipeline stages (``repro.admission``): the controller owns
# the authoritative name -> class dicts; re-registering them here makes
# them discoverable/validatable through the same registry as picker
# stages (``registered_stages("admit")`` etc.)
for _name, _cls in ADMIT_STAGES.items():
    register_stage("admit", _name, _cls)
for _name, _cls in RELEASE_STAGES.items():
    register_stage("queue-release", _name, _cls)


# ---------------------------------------------------------------------------
# The config tree
# ---------------------------------------------------------------------------


@dataclass
class NodeClassConfig:
    """One server shape of the fleet mix, in manifest form."""

    name: str = "std"
    cpu_mcores: float = 48_000.0
    mem_mb: float = 131_072.0
    mem_bw_gbps: float = 68.0
    llc_mb: float = 60.0
    weight: int = 1

    def to_node_class(self) -> NodeClass:
        return NodeClass(self.name, NodeResources(
            cpu_mcores=self.cpu_mcores, mem_mb=self.mem_mb,
            mem_bw_gbps=self.mem_bw_gbps, llc_mb=self.llc_mb),
            weight=self.weight)


@dataclass
class ClusterSection:
    """Fleet topology.  ``node_classes=None`` uses the scenario default
    (heterogeneous std+large mix, or std-only with
    ``heterogeneous=False``); an explicit list overrides it."""

    node_classes: Optional[List[NodeClassConfig]] = None
    heterogeneous: bool = True
    max_nodes: Optional[int] = None

    def to_node_classes(self) -> Optional[List[NodeClass]]:
        if self.node_classes is None:
            return None
        return [nc.to_node_class() for nc in self.node_classes]


@dataclass
class ScenarioSection:
    """World description: population + trace program + scale."""

    kind: str = "burst-storm"
    n_functions: int = 24
    duration_s: int = 600
    target_nodes: int = 64
    seed: int = 0
    #: population seed, decoupled from the trace seed (None -> ``seed``)
    spec_seed: Optional[int] = None
    zipf_s: float = 1.2
    utilization: float = 0.8
    #: passthrough to the registered trace builder (``coherence=`` for
    #: burst storms, ``path=`` for replayed CSV dumps, ...)
    trace_kw: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerSection:
    name: str = "jiagu"
    m_max: int = M_MAX_DEFAULT
    max_candidates: int = 4      # gsight-style candidate fan-out
    #: harvesting: fraction of predicted capacity claimable (1.0 =
    #: exactly the predicted bound; >1 deliberate overcommit)
    harvest_headroom: float = 0.85
    #: harvesting: seconds a QoS-breached node is exempt from
    #: harvesting / re-saturation after its release
    qos_release_cooldown_s: float = 30.0


@dataclass
class ScalingSection:
    release_s: float = 45.0
    keepalive_s: float = 60.0
    init_ms: float = 8.4         # cfork container init; docker: 85.5
    #: None -> the scheduler registry's per-scheduler default (dual for
    #: Jiagu, traditional keep-alive for baselines); an explicit bool
    #: forces the mode for any scheduler
    dual_staged: Optional[bool] = None
    migrate: bool = True


@dataclass
class PredictionSection:
    schema_version: int = 1
    n_train: int = 2000
    n_trees: int = 24
    max_depth: int = 8
    #: RFR inference engine override (numpy / torch / cuda); None keeps
    #: the predictor's default (cuda)
    engine: Optional[str] = None
    #: where the torch / cuda engines and the learned scorer run: a
    #: torch device name, None for the card (the only way a manifest
    #: asks for the CPU).  A prebuilt world keeps its predictor's own.
    device: Optional[str] = None
    online_retrain: bool = False
    retrain_every: Optional[int] = None
    #: schema v2: learn the per-shape QoS margin from per-shape
    #: validation error instead of the fixed shape_margin formula
    learned_shape_margin: bool = False


@dataclass
class PipelineSection:
    """Decision-pipeline knobs: trace recording and named stage
    overrides for the dual-staged scaling picks (resolved through the
    ``register_stage`` registry, applied to whatever scheduler the
    manifest selects).

    ``decision_traces=None`` (default) records traces only when the
    platform is built with observers — traces exist to be consumed
    through ``on_schedule``, and observer-less runs shouldn't pay the
    bookkeeping; an explicit bool forces recording on or off."""

    decision_traces: Optional[bool] = None
    release_picker: Optional[str] = None       # stage registry name
    logical_start_picker: Optional[str] = None  # stage registry name
    #: additionally snapshot per-candidate raw feature vectors + the
    #: chosen node into every trace (``repro.policy`` dataset
    #: collection; implies ``decision_traces``).  O(nodes) per
    #: decision, so off by default.
    trace_features: bool = False


@dataclass
class PolicySection:
    """Learned-scorer serving (``repro.policy``): where to load trained
    weights from and how they track retrains.

    ``store=None`` (default) leaves the ``"learned"`` stack on its
    built-in heuristic — buildable with no artifact on disk; ``epoch``
    pins a stored epoch (None loads the latest); ``hot_swap`` wires a
    PredictionService retrain listener that reloads/re-tags the scorer
    synchronously with every epoch bump, keeping stale-epoch serves at
    zero."""

    store: Optional[str] = None
    epoch: Optional[int] = None
    hot_swap: bool = True


@dataclass
class TelemetrySection:
    """Unified metrics/trace layer (``repro.telemetry``).

    ``metrics=None`` (default) attaches the ``MetricsObserver`` +
    registry only when the platform is built with observers — like
    decision traces, telemetry exists to be consumed, and bare runs
    shouldn't pay for it; an explicit bool forces it either way.
    ``spans=None`` follows the resolved metrics setting; when on, a
    ``SpanTracer`` is handed to the simulator and prediction service
    and every closed span fans out through ``EventHub.on_span``.
    ``histogram_bins`` sizes the bucketed export in
    ``Platform.metrics_snapshot()`` (0 = summary stats only)."""

    metrics: Optional[bool] = None
    spans: Optional[bool] = None
    histogram_bins: int = 0


@dataclass
class SimulationSection:
    #: None -> the SimConfig default (the PredictionService path);
    #: False forces the legacy per-node reference oracle
    use_capacity_engine: Optional[bool] = None
    collect_samples: bool = False
    sample_every_s: Optional[int] = None
    seed: int = 0
    router: str = "equal-split"


@dataclass
class CellsSection:
    """Sharded control plane (``core/cells.py``): ``count > 1``
    partitions the fleet into that many cells, each with its own
    cluster slice, scheduler, autoscaler and PredictionService, driven
    by the event-driven per-cell loop with cross-cell traffic shares
    (``CellRouter``).  ``count = 1`` (default) keeps the legacy
    single-loop assembly — bit-identical results, held by the tests."""

    count: int = 1
    #: cross-cell waterfill cap: fraction of a cell's saturated
    #: throughput loaded before traffic spills to the next cell
    load_cap: float = 0.85
    #: capacity gossip between cell services (solved capacities are
    #: published to sibling caches, epoch-checked)
    exchange: bool = True


@dataclass
class AdmissionSection:
    """Queue-backed admission, SLO classes and vertical scaling
    (``repro.admission``).  Default-off: ``enabled=False`` builds the
    exact pre-admission control plane (no controller object exists),
    which the admission-off bit-parity gates pin down.  Field names
    mirror ``admission.AdmissionConfig`` one-to-one."""

    enabled: bool = False
    #: per-function cpu-reservation resize driving the harvesting
    #: scheduler's per-function harvest bounds
    vertical: bool = False
    #: autoscaler input: "queue" = backlog-derived (depth + drain
    #: target, KEDA-style), "rps" = instantaneous arrivals (the
    #: horizontal-only benchmark arm)
    signal: str = "queue"
    #: fraction of the population tagged best-effort (deterministic
    #: hash tag, no RNG stream consumed)
    best_effort_frac: float = 0.5
    slo_seed: int = 0
    #: queue bound, in seconds of peak-held arrival rate
    queue_cap_s: float = 8.0
    #: backlog catch-up horizon the "queue" signal targets
    target_drain_s: float = 2.0
    #: per-class queue-delay budgets (delay beyond = violation)
    lc_delay_budget_s: float = 0.25
    be_delay_budget_s: float = 8.0
    #: backlog catch-up provisioning cap, in multiples of the
    #: peak-held arrival rate
    catch_up_mult: float = 1.5
    #: admit/release stage names (``registered_stages("admit")`` /
    #: ``registered_stages("queue-release")``)
    admit: str = "bounded-fifo"
    queue_release: str = "greedy"
    #: vertical-resize floor for a best-effort function's cpu share
    min_share: float = 0.5
    resize_every_s: float = 15.0


_SECTIONS = {
    "cluster": ClusterSection,
    "scenario": ScenarioSection,
    "scheduler": SchedulerSection,
    "scaling": ScalingSection,
    "prediction": PredictionSection,
    "pipeline": PipelineSection,
    "policy": PolicySection,
    "simulation": SimulationSection,
    "telemetry": TelemetrySection,
    "cells": CellsSection,
    "admission": AdmissionSection,
}


def _load_section(cls, data, where: str):
    if data is None:
        return cls()
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise PlatformConfigError(
            f"{where}: expected a dict, got {type(data).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise PlatformConfigError(
            f"{where}: unknown keys {unknown} (known: {sorted(known)})")
    kw = dict(data)
    if cls is ClusterSection and kw.get("node_classes") is not None:
        kw["node_classes"] = [
            nc if isinstance(nc, NodeClassConfig)
            else _load_section(NodeClassConfig, nc,
                               f"{where}.node_classes[{i}]")
            for i, nc in enumerate(kw["node_classes"])]
    if cls is ScenarioSection and kw.get("trace_kw") is not None:
        kw["trace_kw"] = dict(kw["trace_kw"])
    return cls(**kw)


@dataclass
class PlatformConfig:
    """The whole control plane as one validated, serializable tree.

    ``from_dict`` is strict (unknown sections/keys raise
    ``PlatformConfigError``) and ``from_dict(to_dict(cfg)) == cfg``, so
    benchmark manifests round-trip losslessly through JSON."""

    cluster: ClusterSection = field(default_factory=ClusterSection)
    scenario: ScenarioSection = field(default_factory=ScenarioSection)
    scheduler: SchedulerSection = field(default_factory=SchedulerSection)
    scaling: ScalingSection = field(default_factory=ScalingSection)
    prediction: PredictionSection = field(default_factory=PredictionSection)
    pipeline: PipelineSection = field(default_factory=PipelineSection)
    policy: PolicySection = field(default_factory=PolicySection)
    simulation: SimulationSection = field(default_factory=SimulationSection)
    telemetry: TelemetrySection = field(default_factory=TelemetrySection)
    cells: CellsSection = field(default_factory=CellsSection)
    admission: AdmissionSection = field(default_factory=AdmissionSection)

    # -- (de)serialization ------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """Plain nested dicts (JSON-able; ``from_dict`` inverts it)."""
        return {name: dataclasses.asdict(getattr(self, name))
                for name in _SECTIONS}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PlatformConfig":
        if not isinstance(data, dict):
            raise PlatformConfigError(
                f"manifest: expected a dict, got {type(data).__name__}")
        unknown = sorted(set(data) - set(_SECTIONS))
        if unknown:
            raise PlatformConfigError(
                f"manifest: unknown sections {unknown} "
                f"(known: {sorted(_SECTIONS)})")
        return cls(**{name: _load_section(scls, data.get(name), name)
                      for name, scls in _SECTIONS.items()})

    @classmethod
    def coerce(cls, config: Union["PlatformConfig", Dict[str, Any], None]
               ) -> "PlatformConfig":
        if config is None:
            return cls()
        if isinstance(config, cls):
            return config
        return cls.from_dict(config)

    # -- construction-time validation -------------------------------------

    def validate(self) -> "PlatformConfig":
        """Every schema/engine/scheduler consistency rule, checked before
        anything is built (these used to surface as scattered
        ``Simulation.__init__`` raises mid-assembly)."""
        sc, p, sim = self.scenario, self.prediction, self.simulation
        entry = scheduler_entry(self.scheduler.name)   # unknown -> raises
        get_scenario_builder(sc.kind)                  # unknown -> raises
        get_router(sim.router)                         # unknown -> raises
        get_schema(p.schema_version)                   # unknown -> raises
        if self.pipeline.release_picker is not None:
            get_stage("release", self.pipeline.release_picker)
        if self.pipeline.logical_start_picker is not None:
            get_stage("logical-start", self.pipeline.logical_start_picker)
        if self.policy.epoch is not None and self.policy.store is None:
            raise PlatformConfigError(
                "policy.epoch pins a stored policy but policy.store is "
                "unset; point it at a PolicyStore directory")
        if self.pipeline.decision_traces is False \
                and self.pipeline.trace_features:
            raise PlatformConfigError(
                "pipeline.trace_features captures per-candidate rows "
                "into decision traces; it cannot be combined with "
                "decision_traces=False")
        if p.learned_shape_margin and p.schema_version == 1:
            raise PlatformConfigError(
                "prediction.learned_shape_margin needs the node-shape-"
                "aware feature schema (schema_version >= 2); v1 rows "
                "carry no shape block to learn margins from")
        if self.scheduler.harvest_headroom <= 0:
            raise PlatformConfigError(
                "scheduler.harvest_headroom must be positive (fraction "
                "of predicted capacity claimable; 1.0 = the full bound)")
        if self.scheduler.qos_release_cooldown_s < 0:
            raise PlatformConfigError(
                "scheduler.qos_release_cooldown_s must be >= 0")
        if sc.n_functions <= 0 or sc.duration_s <= 0 \
                or sc.target_nodes <= 0:
            raise PlatformConfigError(
                "scenario: n_functions, duration_s and target_nodes must "
                "be positive")
        if p.engine is not None and p.engine not in INFERENCE_ENGINES:
            raise PlatformConfigError(
                f"prediction.engine {p.engine!r} unknown "
                f"(have {INFERENCE_ENGINES})")
        if p.device is not None:
            try:
                torch.device(p.device)
            except (RuntimeError, TypeError) as e:
                raise PlatformConfigError(
                    f"prediction.device {p.device!r}: {e}") from None
        if p.schema_version != 1 and sim.use_capacity_engine is False:
            raise PlatformConfigError(
                "prediction.schema_version >= 2 requires the "
                "PredictionService path; the legacy per-node solver "
                "(simulation.use_capacity_engine=False) only speaks the "
                "v1 feature layout")
        if p.online_retrain and sim.use_capacity_engine is False:
            raise PlatformConfigError(
                "prediction.online_retrain requires a PredictionService "
                "(simulation.use_capacity_engine=False selects the "
                "legacy path, which has no on_samples retraining loop)")
        if p.online_retrain and not sim.collect_samples:
            raise PlatformConfigError(
                "prediction.online_retrain needs runtime samples: set "
                "simulation.collect_samples=True")
        if not entry.needs_predictor and (p.schema_version != 1
                                          or p.online_retrain):
            backed = [n for n in registered_schedulers()
                      if scheduler_entry(n).needs_predictor]
            raise PlatformConfigError(
                f"scheduler {entry.name!r} runs without a predictor; "
                f"schema v2 / online retraining need a prediction-backed "
                f"scheduler ({backed})")
        if self.cells.count < 1:
            raise PlatformConfigError(
                f"cells.count must be >= 1, got {self.cells.count}")
        if not 0 < self.cells.load_cap <= 1:
            raise PlatformConfigError(
                f"cells.load_cap must be in (0, 1], got "
                f"{self.cells.load_cap}")
        adm = self.admission
        if adm.vertical and not adm.enabled:
            raise PlatformConfigError(
                "admission.vertical needs the admission controller; "
                "set admission.enabled=True")
        if adm.signal not in ("queue", "rps"):
            raise PlatformConfigError(
                f"admission.signal must be 'queue' or 'rps', got "
                f"{adm.signal!r}")
        if not 0 <= adm.best_effort_frac <= 1:
            raise PlatformConfigError(
                f"admission.best_effort_frac must be in [0, 1], got "
                f"{adm.best_effort_frac}")
        if adm.queue_cap_s <= 0 or adm.target_drain_s <= 0 \
                or adm.lc_delay_budget_s <= 0 \
                or adm.be_delay_budget_s <= 0 or adm.resize_every_s <= 0:
            raise PlatformConfigError(
                "admission: queue_cap_s, target_drain_s, the delay "
                "budgets and resize_every_s must all be positive")
        if not 0 < adm.min_share <= 1:
            raise PlatformConfigError(
                f"admission.min_share must be in (0, 1], got "
                f"{adm.min_share}")
        get_stage("admit", adm.admit)                  # unknown -> raises
        get_stage("queue-release", adm.queue_release)  # unknown -> raises
        return self


def scenario_from_config(cfg: PlatformConfig) -> Scenario:
    """Build just the ``Scenario`` a config describes (the same call
    ``Platform.build`` makes) — lets benchmarks stage scenario/world
    construction outside their timers while still driving everything
    from one manifest."""
    sc = cfg.scenario
    return make_scenario(
        sc.kind, n_functions=sc.n_functions, duration_s=sc.duration_s,
        target_nodes=sc.target_nodes, seed=sc.seed,
        spec_seed=sc.spec_seed, zipf_s=sc.zipf_s,
        heterogeneous=cfg.cluster.heterogeneous,
        node_classes=cfg.cluster.to_node_classes(),
        utilization=sc.utilization, **sc.trace_kw)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


class Platform:
    """A fully assembled control plane: config + scenario + world +
    simulation + observer hub.  Construct with ``Platform.build``."""

    def __init__(self, config: PlatformConfig, scenario: Scenario,
                 world: ScenarioWorld,
                 simulation: Union[Simulation, CellSimulation],
                 hub: EventHub, telemetry: Optional[Telemetry] = None):
        self.config = config
        self.scenario = scenario
        self.world = world
        self.simulation = simulation
        self.hub = hub
        self.telemetry = telemetry
        self.result: Optional[SimResult] = None

    # -- component access --------------------------------------------------

    @property
    def scheduler(self) -> BaseScheduler:
        return self.simulation.scheduler

    @property
    def autoscaler(self):
        return self.simulation.autoscaler

    @property
    def cluster(self) -> Cluster:
        return self.simulation.cluster

    @property
    def service(self):
        """The scheduler's PredictionService (None on the legacy path)."""
        return self.scheduler.prediction_service

    @property
    def router(self) -> Router:
        return self.simulation.router

    # -- observers ----------------------------------------------------------

    def add_observer(self, obs: Observer) -> Observer:
        return self.hub.add(obs)

    def remove_observer(self, obs: Observer) -> None:
        self.hub.remove(obs)

    # -- run ----------------------------------------------------------------

    def run(self, duration_s: Optional[int] = None) -> SimResult:
        self.result = self.simulation.run(duration_s)
        if self.telemetry is not None:
            publish_result(
                self.telemetry.registry, self.result,
                engine_stats=self.service.stats.snapshot()
                if self.service is not None else None)
        return self.result

    def metrics_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The telemetry registry's JSON-able snapshot ({} when the
        platform was built without telemetry)."""
        if self.telemetry is None:
            return {}
        return self.telemetry.snapshot(self.config.telemetry.histogram_bins)

    def span_summary(self) -> List[Dict[str, Any]]:
        """Per-span-name aggregate wall-clock rows ([] without spans)."""
        if self.telemetry is None:
            return []
        return self.telemetry.span_summary()

    def to_manifest(self) -> Dict[str, Any]:
        """The config tree as a plain dict (``PlatformConfig.to_dict``)."""
        return self.config.to_dict()

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, scenario: Union[Scenario, str, None] = None,
              config: Union[PlatformConfig, Dict[str, Any], None] = None,
              *, world: Optional[ScenarioWorld] = None,
              router: Optional[Router] = None,
              observers: Iterable[Observer] = ()) -> "Platform":
        """Assemble a runnable platform.

        ``config`` may be a ``PlatformConfig`` or a plain manifest dict
        (validated strictly); ``scenario`` overrides the config's
        scenario section with a prebuilt ``Scenario`` (or a kind
        string).  ``world`` reuses a prebuilt ``ScenarioWorld`` (its
        feature schema must match the config's); ``router``/
        ``observers`` plug the routing policy and observer hooks.  All
        schema/engine consistency validation happens here, before any
        component exists."""
        cfg = PlatformConfig.coerce(config)
        if isinstance(scenario, str):
            cfg = dataclasses.replace(
                cfg, scenario=dataclasses.replace(cfg.scenario,
                                                  kind=scenario))
            scenario = None
        cfg.validate()
        sc, p, sim_cfg = cfg.scenario, cfg.prediction, cfg.simulation
        hub = EventHub(observers)
        if scenario is None:
            scenario = scenario_from_config(cfg)
        if world is None:
            # the world's predictor is built on the manifest's engine and
            # device: the port's default engine runs on the card, so a
            # CPU or numpy build must say so before the forest exists
            engine_kw = {} if p.engine is None else {"engine": p.engine}
            world = scenario_world(
                scenario, n_train=p.n_train, n_trees=p.n_trees,
                max_depth=p.max_depth, schema_version=p.schema_version,
                device=p.device, **engine_kw)
        elif world.schema_version != p.schema_version:
            raise PlatformConfigError(
                f"mismatched service schema: the prebuilt world speaks "
                f"schema v{world.schema_version} but the config requests "
                f"v{p.schema_version}; rebuild the world or align "
                f"prediction.schema_version")
        build_kw = dict(
            release_s=cfg.scaling.release_s,
            keepalive_s=cfg.scaling.keepalive_s,
            init_ms=cfg.scaling.init_ms, migrate=cfg.scaling.migrate,
            m_max=cfg.scheduler.m_max,
            max_candidates=cfg.scheduler.max_candidates,
            use_engine=sim_cfg.use_capacity_engine,
            collect_samples=sim_cfg.collect_samples,
            online_retrain=p.online_retrain,
            retrain_every=p.retrain_every,
            sample_every_s=sim_cfg.sample_every_s,
            sim_seed=sim_cfg.seed,
            dual_staged=cfg.scaling.dual_staged,
            learned_shape_margin=p.learned_shape_margin,
            harvest_headroom=cfg.scheduler.harvest_headroom,
            qos_release_cooldown_s=cfg.scheduler.qos_release_cooldown_s,
            admission=cfg.admission if cfg.admission.enabled else None)
        if cfg.cells.count > 1:
            if router is not None:
                raise PlatformConfigError(
                    "cells.count > 1 builds one router per cell; select "
                    "the policy by name via simulation.router instead of "
                    "passing a router instance")
            simulation: Union[Simulation, CellSimulation] = \
                cell_scenario_simulation(
                    scenario, cfg.scheduler.name,
                    n_cells=cfg.cells.count, world=world,
                    router_factory=get_router(sim_cfg.router),
                    cell_load_cap=cfg.cells.load_cap,
                    exchange=cfg.cells.exchange,
                    max_nodes=cfg.cluster.max_nodes, events=hub,
                    **build_kw)
        else:
            simulation = scenario_simulation(
                scenario, cfg.scheduler.name, world=world,
                max_nodes=cfg.cluster.max_nodes,
                router=router or get_router(sim_cfg.router)(),
                events=hub, **build_kw)
        services = simulation.services() \
            if isinstance(simulation, CellSimulation) else \
            [s for s in (simulation.scheduler.prediction_service,)
             if s is not None]
        for service in services:
            if p.engine is not None:
                service.set_engine(p.engine)
            service.add_retrain_listener(hub.on_retrain)
        # telemetry section: registry + observer + span tracer.  The
        # None default resolves against the *external* observers, so a
        # bare build stays uninstrumented and the parity gates hold.
        tel = cfg.telemetry
        want_metrics = tel.metrics if tel.metrics is not None \
            else bool(hub.observers)
        want_spans = tel.spans if tel.spans is not None else want_metrics
        telemetry: Optional[Telemetry] = None
        if want_metrics or want_spans:
            telemetry = Telemetry.create(
                metrics=want_metrics, spans=want_spans,
                emit=hub.on_span if want_spans else None)
            if telemetry.observer is not None:
                hub.add(telemetry.observer)
            if want_spans:
                simulation.tracer = telemetry.tracer
                for service in services:
                    service.tracer = telemetry.tracer
        # pipeline section: trace toggle + named picker-stage overrides
        # (applied to every cell's scheduler on the sharded path)
        scheds = simulation.schedulers() \
            if isinstance(simulation, CellSimulation) \
            else [simulation.scheduler]
        pl = cfg.pipeline
        for sched in scheds:
            sched.trace_decisions = pl.decision_traces \
                if pl.decision_traces is not None else bool(hub.observers)
            if pl.trace_features:
                # dataset collection: feature capture needs the traces
                # it annotates
                sched.trace_decisions = True
                sched.trace_features = True
            if pl.release_picker is not None:
                sched.release_stage = \
                    get_stage("release", pl.release_picker)(sched)
            if pl.logical_start_picker is not None:
                sched.logical_start_stage = \
                    get_stage("logical-start", pl.logical_start_picker)(sched)
        # policy section: install stored weights into any learned
        # scorer and keep its epoch tag in lockstep with the service's
        # (the listener runs inside the same synchronous retrain call
        # that bumps the epoch — zero stale-epoch serves)
        pol = cfg.policy
        learned = [s for s in scheds
                   if getattr(s, "learned_scorer", None) is not None]
        if learned:
            params = None
            if pol.store is not None:
                from ..policy.store import PolicyStore
                params, _meta = PolicyStore(pol.store).load(
                    epoch=pol.epoch)
            for s in learned:
                s.learned_scorer.device = p.device
                svc = s.prediction_service
                epoch0 = svc.epoch if svc is not None else 0
                if params is not None:
                    s.learned_scorer.swap(params, epoch0)
                else:
                    s.learned_scorer.expect(epoch0)
                if pol.hot_swap and svc is not None:
                    def _resync(service, scorer=s.learned_scorer,
                                store=pol.store, pin=pol.epoch):
                        p = scorer.policy
                        if store is not None and pin is None:
                            from ..policy.store import PolicyStore
                            try:
                                p, _ = PolicyStore(store).load()
                            except FileNotFoundError:
                                p = scorer.policy
                        if p is not None:
                            scorer.swap(p, service.epoch)
                        else:
                            scorer.expect(service.epoch)
                    svc.add_retrain_listener(_resync)
        return cls(cfg, scenario, world, simulation, hub,
                   telemetry=telemetry)


# ---------------------------------------------------------------------------
# Smoke: every registered scheduler from pure config dicts
# ---------------------------------------------------------------------------


def smoke(duration_s: int = 30, verbose: bool = True
          ) -> Dict[str, SimResult]:
    """Build every registered scheduler against one scenario from pure
    manifest dicts and run ``duration_s`` ticks — what
    ``python -m repro_torch.platform`` runs, on the card.  Raises if any build or
    run fails or runs short.  The scenario and trained world come from
    the first manifest and are shared across schedulers (they differ
    only in the scheduler section; retraining the forest per scheduler
    would quadruple the smoke's cost for nothing)."""
    results: Dict[str, SimResult] = {}
    scenario = world = None
    for name in registered_schedulers():
        manifest = {
            "scenario": {"kind": "burst-storm", "n_functions": 4,
                         "duration_s": duration_s, "target_nodes": 8,
                         "seed": 0},
            "scheduler": {"name": name},
            "prediction": {"n_train": 300, "n_trees": 8},
        }
        plat = Platform.build(scenario=scenario, config=manifest,
                              world=world)
        scenario, world = plat.scenario, plat.world
        # every scheduler faces the identical measurement-noise stream
        # (the shared world's ground truth draws from a stateful RNG;
        # without the reset, results would depend on run order and the
        # harvesting-vs-k8s QoS gate below would compare different
        # noise)
        world.gt.reseed()
        res = plat.run()
        if res.ticks != duration_s:
            raise RuntimeError(
                f"platform smoke: {name} ran {res.ticks}/{duration_s} "
                f"ticks")
        results[name] = res
        if verbose:
            print(f"# platform-smoke {name}: density={res.density:.2f} "
                  f"qos={res.qos_violation_rate:.4f} "
                  f"peak_nodes={res.nodes_peak}", flush=True)
    # harvesting gate: claiming idle headroom must not regress QoS
    # versus the no-overcommit K8s baseline on the burst-storm scenario
    harv, k8s = results.get("harvesting"), results.get("k8s")
    if harv is not None and k8s is not None \
            and harv.qos_violation_rate > k8s.qos_violation_rate + 1e-9:
        raise RuntimeError(
            f"platform smoke: harvesting QoS violation rate "
            f"{harv.qos_violation_rate:.4f} regressed versus the K8s "
            f"baseline's {k8s.qos_violation_rate:.4f}")
    if verbose:
        print(f"# platform-smoke: {len(results)} schedulers x 1 scenario "
              f"x {duration_s} ticks => PASS")
    return results


__all__ = [
    # facade + config
    "Platform", "PlatformConfig", "PlatformConfigError",
    "ClusterSection", "ScenarioSection", "SchedulerSection",
    "ScalingSection", "PredictionSection", "PipelineSection",
    "PolicySection", "SimulationSection", "TelemetrySection",
    "NodeClassConfig", "CellsSection", "AdmissionSection",
    # sharded control plane
    "Cell", "CellRouter", "CellSimulation", "CapacityExchange",
    "cell_scenario_simulation",
    # telemetry
    "Telemetry", "publish_result",
    # capability protocols
    "CapacityProvider", "ReleasePicker", "LogicalStartPicker", "Router",
    # decision pipeline
    "NodeFilter", "NodeScorer", "Binder", "PreDecision",
    "DecisionContext", "DecisionTrace", "TraceBinding",
    "CandidatePass", "SchedulingPipeline", "PipelineHostMixin",
    "HarvestingScheduler", "LearnedScheduler", "LearnedScorer",
    # observers
    "Observer", "EventHub", "JsonlObserver",
    # registries
    "register_scheduler", "registered_schedulers", "scheduler_entry",
    "build_scheduler", "SchedulerEntry", "SchedulerBuildContext",
    "register_scenario", "registered_scenarios", "get_scenario_builder",
    "register_trace", "registered_traces", "get_trace",
    "register_router", "registered_routers", "get_router",
    "register_stage", "registered_stages", "get_stage",
    # defaults + helpers
    "EqualSplitRouter", "LocalityRouter", "scenario_from_config",
    "GreedyReleasePicker", "GreedyLogicalStartPicker",
    "TableBoundLogicalStartPicker", "BreachAwareReleasePicker",
    "CooldownLogicalStartPicker",
    # smoke
    "smoke",
]
