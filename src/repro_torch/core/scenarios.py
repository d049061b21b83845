"""Cluster-scale scenarios: topology x population x trace program.

The paper evaluates on a homogeneous 24-node testbed with six functions
and four same-shaped traces.  The CapacityEngine (PR 1) makes 512-node
simulation affordable; this module supplies the *worlds* to run at that
scale.  A ``Scenario`` composes:

  * **cluster topology** — a weighted mix of ``NodeClass`` shapes
    (heterogeneous fleets: standard profiling-node-shaped servers plus
    larger ones; ``Cluster.res_pool`` cycles the mix deterministically),
  * **function population** — a synthetic population whose request share
    follows a skewed Zipf popularity law (a few hot functions, a long
    tail — the Azure-style population shape), and
  * **trace program** — one of the generators in ``traces``: correlated
    burst storms, migrating diurnal peaks, heavy-tailed cold-start
    churn, the sparse-invocation long tail, or the paper's real-world
    shape — scaled so mean load fills a target node count.

``scenario_simulation`` assembles the full stack (ground truth, profile
store, predictor trained on profiling-node data, scheduler, autoscaler)
for a scenario, so benchmarks and tests build 64-512-node studies from
one call.  The predictor is always trained against the *standard* node
class — the paper's profiling nodes are one shape; capacity predictions
on bigger nodes are conservative (pressures only drop with node size),
which is the safe direction for QoS.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .autoscaler import Autoscaler, ScalingConfig
from .capacity import M_MAX_DEFAULT, QoSStore
from .cluster import Cluster
from .events import EventHub
from .interference import GroundTruth, NodeResources
from .predictor import PerfPredictor
from .profiles import FunctionSpec, ProfileStore, synthetic_functions
from .registry import Registry
from .scheduler import (SchedulerBuildContext, build_scheduler,
                        scheduler_entry)
from .simulator import SimConfig, Simulation, generate_dataset
from .traces import (Trace, azure_sparse_trace, burst_storm_trace,
                     coldstart_churn_trace, diurnal_shift_trace,
                     realworld_trace, replay_trace)


@dataclass(frozen=True)
class NodeClass:
    """One server shape in the fleet mix."""

    name: str
    res: NodeResources
    weight: int = 1         # relative share of the fleet


#: standard node = the paper's testbed shape = the profiling-node shape
STANDARD_NODE = NodeClass("std", NodeResources(), weight=3)
#: double-size node (2x every capacity) — predictions made against the
#: standard shape are conservative here, never optimistic
LARGE_NODE = NodeClass("large", NodeResources(
    cpu_mcores=96_000.0, mem_mb=262_144.0, mem_bw_gbps=136.0,
    llc_mb=120.0), weight=1)

#: the generated scenario kinds (the large-cluster study sweeps these);
#: the full registry — including ``replay`` and anything user-registered
#: — is ``registered_scenarios()``
SCENARIO_KINDS = ("burst-storm", "diurnal-shift", "coldstart-churn",
                  "azure-sparse", "realworld")


# ---------------------------------------------------------------------------
# Scenario-kind registry (the repro.platform name-based selection)
# ---------------------------------------------------------------------------

_SCENARIOS = Registry("scenario kind")


def register_scenario(kind: str, trace_builder=None, *,
                      overwrite: bool = False):
    """Register a scenario kind: a trace-program builder with the
    ``(fn_names, duration_s=..., seed=..., scale_rps=..., **kw)``
    signature, selectable by name from ``make_scenario`` and
    ``PlatformConfig`` manifests.  Usable as a decorator."""
    return _SCENARIOS.register(kind, trace_builder, overwrite=overwrite)


def get_scenario_builder(kind: str):
    return _SCENARIOS.get(kind)


def registered_scenarios() -> List[str]:
    return _SCENARIOS.names()


for _kind, _builder in (("burst-storm", burst_storm_trace),
                        ("diurnal-shift", diurnal_shift_trace),
                        ("coldstart-churn", coldstart_churn_trace),
                        ("azure-sparse", azure_sparse_trace),
                        ("realworld", realworld_trace)):
    register_scenario(_kind, _builder)
del _kind, _builder


@register_scenario("replay")
def replay_scenario_trace(fn_names: Sequence[str], duration_s: int = 3600,
                          seed: int = 0,
                          scale_rps: Optional[Dict[str, float]] = None,
                          *, path=None, name: Optional[str] = None
                          ) -> Trace:
    """Feed a real invocation dump (``traces.replay_trace`` CSV format)
    through the scenario machinery: the recorded per-function series are
    assigned to the synthetic population (seed-permuted, cycling when
    the population outnumbers the recording), normalized to unit mean so
    the population's Zipf popularity shares (``scale_rps``) and the
    ``scale_trace_to_nodes`` cluster-size rescale stay meaningful, and
    tiled/clamped to ``duration_s``.  Pass the CSV via
    ``make_scenario("replay", ..., path=...)`` (the ``trace_kw``
    passthrough) — so Azure/Huawei-style dumps run in the large-cluster
    suite exactly like the generated trace programs."""
    if path is None:
        raise ValueError("replay scenario requires path=<csv> "
                         "(make_scenario trace_kw)")
    src = replay_trace(path)
    recorded = [src.rps[k] for k in sorted(src.rps)]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(recorded))
    out: Dict[str, np.ndarray] = {}
    for i, fn in enumerate(fn_names):
        base = recorded[order[i % len(recorded)]]
        mean = float(base.mean())
        shape = base / mean if mean > 0 else base
        series = np.resize(shape, duration_s)  # tile/clamp to duration
        out[fn] = series * float((scale_rps or {}).get(fn, 1.0))
    return Trace(name or f"replay-{src.name}-seed{seed}", out, duration_s)


@dataclass
class Scenario:
    """A complete simulation world description (topology + population +
    trace), ready to be built into a ``Simulation``."""

    name: str
    kind: str
    specs: Dict[str, FunctionSpec]
    trace: Trace
    node_classes: List[NodeClass]
    target_nodes: int
    seed: int = 0

    def res_pool(self) -> List[NodeResources]:
        """Deterministic weighted node-shape cycle for ``Cluster``."""
        pool: List[NodeResources] = []
        for cls in self.node_classes:
            pool.extend([cls.res] * max(int(cls.weight), 1))
        return pool

    def build_cluster(self, max_nodes: Optional[int] = None) -> Cluster:
        return Cluster(self.specs, max_nodes=max_nodes or
                       max(4 * self.target_nodes, 64),
                       res_pool=self.res_pool())

    @property
    def standard_res(self) -> NodeResources:
        return self.node_classes[0].res


# ---------------------------------------------------------------------------
# Population: Zipf-skewed request shares
# ---------------------------------------------------------------------------


def zipf_weights(n: int, s: float = 1.2, seed: int = 0) -> np.ndarray:
    """Normalized Zipf popularity over a shuffled rank assignment (so the
    hot functions are not always the lexicographically first ones)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** -s
    w /= w.sum()
    rng = np.random.default_rng(seed)
    return w[rng.permutation(n)]


def scenario_functions(n_functions: int, seed: int = 0
                       ) -> Dict[str, FunctionSpec]:
    """Function population for the large-cluster scenarios.

    Mirrors the paper's Fig-4 observation — users over-provision heavily,
    so *requested*-resource packing (the K8s baseline) leaves large true
    headroom on every channel.  Differs from ``synthetic_functions`` (the
    Fig-15 scalability family) in its per-slot bandwidth/cache footprints:
    those sit near the node's interference knee already at requested
    packing, which leaves no safe overcommit room and makes a density
    study read as pure QoS noise.  Here footprints are sized so requested
    packing is safe (interference multiplier ~1.0-1.1) and ~1.5-2x that
    density crosses the QoS headroom — the calibration invariant of
    ``interference.NodeResources``."""
    rng = np.random.default_rng(seed + 17)
    out: Dict[str, FunctionSpec] = {}
    for i in range(n_functions):
        name = f"sfn{i:03d}"
        cpu_req = float(rng.choice([1000.0, 2000.0, 2000.0, 4000.0]))
        slots = cpu_req / 1000.0
        out[name] = FunctionSpec(
            name=name,
            cpu_req=cpu_req,
            mem_req=float(rng.choice([512.0, 1024.0, 2048.0])),
            saturated_rps=float(rng.uniform(8, 60)),
            exec_ms=float(rng.uniform(10, 80)),
            cpu_work=float(rng.uniform(0.22, 0.5)),
            mem_work=float(rng.uniform(0.3, 0.7)),
            bw_demand=slots * float(rng.uniform(0.2, 0.75)),
            cache_mb=slots * float(rng.uniform(0.3, 1.1)),
            cpu_sens=float(rng.uniform(0.7, 1.5)),
            bw_sens=float(rng.uniform(0.7, 1.5)),
            cache_sens=float(rng.uniform(0.7, 1.5)),
        )
    return out


# ---------------------------------------------------------------------------
# Scaling a trace program to a target cluster size
# ---------------------------------------------------------------------------


def expected_mean_nodes(trace: Trace, specs: Dict[str, FunctionSpec],
                        node_cpu_mcores: float) -> float:
    """Mean requested-CPU demand of the trace, in nodes (the K8s packing
    yardstick: instances hold their *requested* cores)."""
    mcores = 0.0
    for fn, series in trace.rps.items():
        spec = specs[fn]
        mean_inst = float(np.mean(series)) / spec.saturated_rps
        mcores += mean_inst * spec.cpu_req
    return mcores / max(node_cpu_mcores, 1e-9)


def scale_trace_to_nodes(trace: Trace, specs: Dict[str, FunctionSpec],
                         target_nodes: int,
                         node_classes: Sequence[NodeClass],
                         utilization: float = 0.8) -> Trace:
    """Uniformly rescale every function's RPS so the trace's mean
    requested-CPU demand fills ``utilization`` of ``target_nodes`` mean-
    shaped nodes.  Peak demand then overshoots the target (bursts), which
    is the point — the elastic pool must breathe around it."""
    tot_w = sum(max(int(c.weight), 1) for c in node_classes)
    mean_cpu = sum(c.res.cpu_mcores * max(int(c.weight), 1)
                   for c in node_classes) / max(tot_w, 1)
    demand = expected_mean_nodes(trace, specs, mean_cpu)
    factor = target_nodes * utilization / max(demand, 1e-9)
    return Trace(trace.name,
                 {fn: series * factor for fn, series in trace.rps.items()},
                 trace.duration_s)


# ---------------------------------------------------------------------------
# Scenario construction
# ---------------------------------------------------------------------------


def make_scenario(kind: str, *, specs: Optional[Dict[str, FunctionSpec]]
                  = None, n_functions: int = 24, duration_s: int = 600,
                  target_nodes: int = 64, seed: int = 0,
                  spec_seed: Optional[int] = None,
                  zipf_s: float = 1.2, heterogeneous: bool = True,
                  node_classes: Optional[Sequence[NodeClass]] = None,
                  utilization: float = 0.8,
                  name: Optional[str] = None, **trace_kw) -> Scenario:
    """Build one scenario: Zipf-popular population + `kind` trace program
    (any registered scenario kind) scaled to `target_nodes`, on a (by
    default heterogeneous) fleet.

    ``spec_seed`` decouples the function population's seed from the
    trace seed (defaults to ``seed``); ``node_classes`` overrides the
    ``heterogeneous`` std/large default with an explicit topology mix.
    ``trace_kw`` passes through to the trace generator (e.g.
    ``coherence=`` for burst storms, ``n_regions=`` for diurnal shift,
    ``path=`` for replayed CSV dumps).
    """
    builder = get_scenario_builder(kind)
    if specs is None:
        specs = scenario_functions(
            n_functions, seed=seed if spec_seed is None else spec_seed)
    names = sorted(specs)
    # skewed popularity -> per-function peak RPS shares; normalized to a
    # mean of 1 so the global rescale below sets the absolute level
    w = zipf_weights(len(names), s=zipf_s, seed=seed + 1)
    scale_rps = {fn: float(len(names) * wi) for fn, wi in zip(names, w)}
    trace = builder(names, duration_s=duration_s, seed=seed,
                    scale_rps=scale_rps, **trace_kw)
    classes = list(node_classes) if node_classes else (
        [STANDARD_NODE, LARGE_NODE] if heterogeneous else [STANDARD_NODE])
    trace = scale_trace_to_nodes(trace, specs, target_nodes, classes,
                                 utilization)
    return Scenario(name or f"{kind}-n{target_nodes}-seed{seed}", kind,
                    specs, trace, classes, target_nodes, seed)


def scenario_suite(kinds: Sequence[str] = SCENARIO_KINDS, **kw
                   ) -> List[Scenario]:
    """One scenario per kind, sharing population and topology settings."""
    return [make_scenario(kind, **kw) for kind in kinds]


# ---------------------------------------------------------------------------
# World / simulation assembly
# ---------------------------------------------------------------------------


@dataclass
class ScenarioWorld:
    """The observable + hidden state shared by every system run on one
    scenario (ground truth keyed to the standard node class)."""

    scenario: Scenario
    gt: GroundTruth
    store: ProfileStore
    qos: QoSStore
    predictor: PerfPredictor
    schema_version: int = 1


def scenario_world(scenario: Scenario, *, n_train: int = 2000,
                   n_trees: int = 24, max_depth: int = 8,
                   seed: Optional[int] = None,
                   schema_version: int = 1, engine: str = "cuda",
                   device=None) -> ScenarioWorld:
    """Ground truth + profiles + a predictor trained offline on
    profiling/training-node data.

    Training colocations span more kinds and a deeper packing budget
    than the six-function paper world's defaults: Zipf-populated
    scenarios routinely pack 6+ kinds and >1.6x requested CPU onto a
    node, and the forest extrapolates flat (optimistically) past its
    training ceiling — exactly where overcommitting breaks QoS.

    ``schema_version=1`` trains the legacy node-shape-blind vector on
    standard-shape rows only (predictions on bigger nodes stay
    conservative — the parity oracle); ``schema_version=2`` emits
    per-node-shape rows over the scenario's ``NodeClass`` mix so the
    forest resolves node size.

    ``engine``/``device`` select the predictor's inference engine and
    where it runs (the hand-written kernels on the card by default)."""
    s = scenario.seed if seed is None else seed
    gt = GroundTruth(node=scenario.standard_res, seed=s)
    store = ProfileStore(seed=s)
    qos = QoSStore(store, gt)
    pred = PerfPredictor(n_trees=n_trees, max_depth=max_depth, seed=s,
                         engine=engine, device=device)
    shapes = [cls.res for cls in scenario.node_classes] \
        if schema_version >= 2 else None
    X, y = generate_dataset(
        scenario.specs, gt, store, qos, n_train, seed=s + 2,
        max_kinds=min(8, len(scenario.specs)), max_count=30,
        budget_range=(0.25, 2.4), schema=schema_version,
        node_shapes=shapes)
    pred.add_dataset(X, y)
    return ScenarioWorld(scenario, gt, store, qos, pred, schema_version)


def build_simulation(specs: Dict[str, FunctionSpec], trace: Trace,
                     cluster: Cluster, gt: GroundTruth,
                     store: ProfileStore, qos: QoSStore,
                     scheduler: str = "jiagu",
                     predictor: Optional[PerfPredictor] = None, *,
                     dual: bool = True, release_s: float = 45.0,
                     keepalive_s: float = 60.0, init_ms: float = 8.4,
                     migrate: bool = True, m_max: int = M_MAX_DEFAULT,
                     use_engine: Optional[bool] = None,
                     collect_samples: bool = False,
                     schema_version: int = 1,
                     online_retrain: bool = False,
                     retrain_every: Optional[int] = None,
                     sample_every_s: Optional[int] = None,
                     dual_staged: Optional[bool] = None,
                     max_candidates: int = 4,
                     sim_seed: int = 0,
                     router=None,
                     learned_shape_margin: bool = False,
                     harvest_headroom: float = 0.85,
                     qos_release_cooldown_s: float = 30.0,
                     admission=None,
                     events: Optional[EventHub] = None) -> Simulation:
    """The one scheduler-dispatch/autoscaler/SimConfig assembly, shared
    by ``scenario_simulation``, ``platform.Platform.build`` and
    ``benchmarks.common.make_sim``.  Schedulers come from the name-based
    registry (``scheduler.register_scheduler``), so any registered
    policy is selectable by string.

    ``use_engine=None`` keeps the ``SimConfig`` default (the
    PredictionService path); ``False`` forces the legacy per-node
    reference path — the A/B knob the parity harness flips.
    ``schema_version`` selects the feature schema of the attached
    service (the predictor must be trained on matching rows) and
    ``online_retrain``/``retrain_every`` arm the in-run incremental
    retraining loop.  ``dual_staged=None`` applies the registry's
    per-scheduler default (dual-staged for Jiagu, traditional
    keep-alive for the baselines, gated by ``dual``); an explicit bool
    forces it for any scheduler — the greedy picker defaults make the
    release / logical-cold-start machinery meaningful for all of them.
    ``router``/``events`` plug the routing policy and observer hub.
    ``admission`` takes an ``AdmissionConfig`` (or any object with its
    fields, e.g. the platform's ``AdmissionSection``) and attaches an
    ``AdmissionController`` to the simulation and autoscaler; ``None``
    — the default — builds the exact pre-admission control plane.
    """
    entry = scheduler_entry(scheduler)
    sched = build_scheduler(scheduler, SchedulerBuildContext(
        cluster=cluster, store=store, qos=qos, specs=specs,
        predictor=predictor, m_max=m_max, max_candidates=max_candidates,
        schema_version=schema_version, retrain_every=retrain_every,
        learned_shape_margin=learned_shape_margin,
        harvest_headroom=harvest_headroom,
        qos_release_cooldown_s=qos_release_cooldown_s))
    if dual_staged is None:
        dual_staged = dual and entry.dual_staged_default
    aut = Autoscaler(cluster, sched, ScalingConfig(
        release_s=release_s, keepalive_s=keepalive_s,
        dual_staged=dual_staged, init_ms=init_ms,
        migrate=migrate), events=events)
    # scheduler-initiated releases (harvesting's QoS-breach give-back)
    # enter the autoscaler's keep-alive ledger instead of a private one
    sched.release_ledger = aut
    cfg = SimConfig(collect_samples=collect_samples, seed=sim_seed,
                    schema_version=schema_version,
                    online_retrain=online_retrain,
                    retrain_every=retrain_every,
                    learned_shape_margin=learned_shape_margin)
    if sample_every_s is not None:
        cfg.sample_every_s = sample_every_s
    if use_engine is not None:
        cfg.use_capacity_engine = use_engine
    sim = Simulation(specs, trace, sched, aut, gt, store, qos,
                     predictor=predictor, cfg=cfg, router=router,
                     events=events)
    if admission is not None:
        # late import: core stays importable without the admission
        # package on the path, and admission-off builds never touch it
        from ..admission import AdmissionConfig, AdmissionController
        adm_cfg = admission if isinstance(admission, AdmissionConfig) \
            else AdmissionConfig(**{
                f.name: getattr(admission, f.name)
                for f in dataclasses.fields(AdmissionConfig)
                if hasattr(admission, f.name)})
        ctl = AdmissionController(specs, adm_cfg, store=store)
        sim.admission = ctl
        # the autoscaler drives the end-of-tick vertical pass and
        # stamps decision traces with queue context (schema v3)
        aut.admission = ctl
    return sim


def scenario_simulation(scenario: Scenario, scheduler: str = "jiagu", *,
                        world: Optional[ScenarioWorld] = None,
                        dual: bool = True, release_s: float = 45.0,
                        keepalive_s: float = 60.0, init_ms: float = 8.4,
                        migrate: bool = True, m_max: int = M_MAX_DEFAULT,
                        use_engine: Optional[bool] = None,
                        collect_samples: bool = False,
                        online_retrain: bool = False,
                        retrain_every: Optional[int] = None,
                        sample_every_s: Optional[int] = None,
                        n_train: int = 2000, n_trees: int = 24,
                        schema_version: Optional[int] = None,
                        max_nodes: Optional[int] = None,
                        dual_staged: Optional[bool] = None,
                        max_candidates: int = 4,
                        sim_seed: int = 0,
                        router=None,
                        learned_shape_margin: bool = False,
                        harvest_headroom: float = 0.85,
                        qos_release_cooldown_s: float = 30.0,
                        admission=None,
                        events: Optional[EventHub] = None) -> Simulation:
    """Assemble a full Simulation for `scenario` (world built on demand,
    heterogeneous elastic cluster from the scenario's node classes).

    The feature schema follows the world's (a v2-trained forest must see
    v2 rows); pass ``schema_version`` only when building the world here.
    """
    if world is None:
        world = scenario_world(scenario, n_train=n_train, n_trees=n_trees,
                               schema_version=schema_version or 1)
    elif schema_version not in (None, world.schema_version):
        raise ValueError(
            f"schema_version={schema_version} conflicts with the prebuilt "
            f"world's schema v{world.schema_version}; rebuild the world "
            f"with scenario_world(..., schema_version={schema_version})")
    pred = world.predictor \
        if scheduler_entry(scheduler).needs_predictor else None
    return build_simulation(
        scenario.specs, scenario.trace, scenario.build_cluster(max_nodes),
        world.gt, world.store, world.qos, scheduler, pred, dual=dual,
        release_s=release_s, keepalive_s=keepalive_s, init_ms=init_ms,
        migrate=migrate, m_max=m_max, use_engine=use_engine,
        collect_samples=collect_samples, online_retrain=online_retrain,
        retrain_every=retrain_every, sample_every_s=sample_every_s,
        schema_version=world.schema_version, dual_staged=dual_staged,
        max_candidates=max_candidates, sim_seed=sim_seed,
        router=router, learned_shape_margin=learned_shape_margin,
        harvest_headroom=harvest_headroom,
        qos_release_cooldown_s=qos_release_cooldown_s,
        admission=admission, events=events)
