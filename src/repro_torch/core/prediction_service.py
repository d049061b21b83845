"""Unified prediction service: one pipeline behind every prediction
entry point.

Before this module, the prediction pipeline was duplicated across the
stack: ``capacity.capacity_of`` built feature rows in Python loops,
``capacity_engine.CapacityEngine`` re-implemented the same assembly
vectorized, ``GsightScheduler`` and ``simulator._collect_sample`` each
had their own ``build_features`` call sites, and the feature layout was
a hard-coded 31-vector that could not express node size — so capacities
on big nodes of a heterogeneous fleet silently inherited small-node
predictions (conservative, never optimistic, but systematically wasteful).

``PredictionService`` owns the whole pipeline:

  * the **forest** (a ``PerfPredictor``) and its inference engine
    selection (``engine={"numpy","torch","cuda"}``, the last routed
    through the hand-written kernels of ``kernels.rfr_inference``),
  * a versioned **FeatureSchema** — v1 is the legacy 31-dim vector
    (bit-identical to ``predictor.build_features``; the parity oracle),
    v2 appends normalized node-shape features (cpu_mcores, mem_mb of the
    *hosting* node) so one forest serves heterogeneous fleets,
  * **batched capacity solving** — the coalesced / cached / vectorized
    machinery grown in PR 1 (``CapacityEngine`` is now an alias of this
    class): one ``predict_many`` pass per drain round, canonical
    colocation-signature cache, chunked early-exit m-sweep,
  * **epoch / retrain bookkeeping** — cache entries are tagged with the
    forest epoch; ``on_samples()`` ingests runtime measurements and
    applies the online retraining policy, bumping the epoch and clearing
    the cache so a post-retrain lookup can never serve a pre-retrain
    capacity (``stats.stale_epoch_hits`` counts any entry whose tag
    mismatches the current epoch — it must stay 0, and the large-cluster
    ``--retrain-online`` benchmark asserts it).

``JiaguScheduler``, ``GsightScheduler``, ``update_capacity_table``, the
autoscaler's capacity hints, and the simulator's runtime sample
collection are all thin clients of this service.

Bit-compatibility contract (schema v1): assembled rows replicate
``build_features`` float64 op-for-op (same accumulation order), so
service capacities are identical to the legacy per-node results — the
parity tests and the 24->512-node benchmark both assert it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .capacity import M_MAX_DEFAULT, QoSStore
from .cluster import CapEntry, Node
from .interference import NodeResources
from .predictor import (INFERENCE_ENGINES, N_FEATURES, PerfPredictor,
                        RandomForestRegressor, build_features)
from .profiles import N_PROFILE, FunctionSpec, ProfileStore
from ..telemetry.spans import NULL_TRACER

# v1 feature layout (see predictor.build_features)
_SOLO = 0
_PROF = slice(1, 1 + N_PROFILE)
_NSAT = 1 + N_PROFILE
_NCACHED = 2 + N_PROFILE
_AGG = slice(3 + N_PROFILE, 3 + 2 * N_PROFILE)
_TOTSAT = 3 + 2 * N_PROFILE
_TOTCACHED = 4 + 2 * N_PROFILE

#: the reference (profiling-node) shape node-size features normalize to
REFERENCE_NODE = NodeResources()
N_SHAPE_FEATURES = 2   # normalized (cpu_mcores, mem_mb) of the host node

#: capacity-drain strategies: "host" is the chunked early-exit m-sweep
#: (numpy rows shipped to the predictor once per chunk round), "device"
#: the fused single-pass sweep (one padded scenario tensor, one
#: ``rfr_sweep_op`` launch, capacities gathered device-side)
DRAIN_MODES = ("host", "device")

Coloc = Dict[str, Tuple[float, float]]
SigKey = Tuple


# ---------------------------------------------------------------------------
# Versioned feature schema
# ---------------------------------------------------------------------------


class FeatureSchema:
    """Versioned feature-vector layout shared by every prediction entry
    point (capacity solving, per-schedule inference, runtime training
    rows, offline dataset generation).

      * **v1** — the paper's 31-dim function-granularity vector, built
        by ``predictor.build_features``.  Node-shape-blind: predictions
        made for the profiling-node shape apply to every node (the
        conservative legacy behaviour, kept as the parity oracle).
      * **v2** — node-shape-aware.  Two changes, both *normalized to
        the reference profiling-node shape*:

          1. every count/pressure column (the target's own sat/cached
             counts, the concurrency-weighted aggregate profile, and the
             node totals) is scaled by ``ref_cpu / host_cpu`` — a
             colocation on a 2x node reads half the pressure, which
             matches how the interference channels (cpu, bandwidth,
             cache) dilute with node capacity and keeps rows from
             differently-sized nodes on one latency manifold (appending
             raw shape columns alone leaves same-pressure rows from
             different shapes aliased, and raw counts at mismatched
             ranges hand the trees spurious shape-correlated splits —
             both make the forest optimistic in pockets);
          2. ``N_SHAPE_FEATURES`` trailing columns carry the hosting
             node's (cpu_mcores, mem_mb) normalized to the reference
             shape — (2.0, 2.0) for a 2x node, (1.0, 1.0) standard —
             so residual shape effects stay resolvable.

        Trained with per-node-shape rows, the forest then resolves that
        a given colocation pressures a big node less — big nodes stop
        inheriting small-node capacities.  On the reference shape both
        changes are identities, so v2 rows for standard nodes carry the
        exact v1 prefix.
    """

    def __init__(self, version: int):
        if version not in (1, 2):
            raise ValueError(f"unknown feature-schema version {version!r}")
        self.version = version
        self.n_shape = 0 if version == 1 else N_SHAPE_FEATURES
        self.n_features = N_FEATURES + self.n_shape

    # -- node-shape block -------------------------------------------------

    def shape_features(self, node_res: Optional[NodeResources] = None
                       ) -> np.ndarray:
        """The trailing shape block as float64 (empty for v1)."""
        if self.version == 1:
            return np.empty(0, np.float64)
        nr = node_res or REFERENCE_NODE
        return np.array([nr.cpu_mcores / REFERENCE_NODE.cpu_mcores,
                         nr.mem_mb / REFERENCE_NODE.mem_mb], np.float64)

    def pressure_scale(self, node_res: Optional[NodeResources] = None
                       ) -> float:
        """Scale of the node-level pressure block relative to the
        reference shape (1.0 for v1 and for the reference node)."""
        if self.version == 1 or node_res is None:
            return 1.0
        return REFERENCE_NODE.cpu_mcores / node_res.cpu_mcores

    def shape_key(self, node_res: Optional[NodeResources],
                  quant: float = 4.0) -> Tuple[float, ...]:
        """Quantized shape block for cache signatures (empty for v1, so
        v1 signatures stay exactly the PR-1 ``coloc_signature`` keys)."""
        if self.version == 1:
            return ()
        q = max(quant, 1e-9)
        return tuple(round(float(v) * q) / q
                     for v in self.shape_features(node_res))

    # -- row assembly -----------------------------------------------------

    def build_row(self, solo_lat: float, profile: np.ndarray, n_sat: float,
                  n_cached: float,
                  neighbors: Sequence[Tuple[np.ndarray, float, float]],
                  node_res: Optional[NodeResources] = None) -> np.ndarray:
        """One feature row.  v1 delegates to ``build_features`` verbatim
        (bit-identical); v2 rescales the node-level pressure block to
        the hosting shape and appends the normalized shape columns."""
        base = build_features(solo_lat, profile, n_sat, n_cached, neighbors)
        if self.version == 1:
            return base
        row = base.astype(np.float64)
        scale = self.pressure_scale(node_res)
        if scale != 1.0:
            row[_NSAT] *= scale
            row[_NCACHED] *= scale
            row[_AGG] *= scale
            row[_TOTSAT] *= scale
            row[_TOTCACHED] *= scale
        return np.concatenate(
            [row, self.shape_features(node_res)]).astype(np.float32)

    def __repr__(self) -> str:
        return f"FeatureSchema(v{self.version}, {self.n_features} features)"

    def __eq__(self, other) -> bool:
        return isinstance(other, FeatureSchema) and \
            other.version == self.version

    def __hash__(self) -> int:
        return hash(("FeatureSchema", self.version))


SCHEMA_V1 = FeatureSchema(1)
SCHEMA_V2 = FeatureSchema(2)


def get_schema(schema: Union[int, FeatureSchema, None]) -> FeatureSchema:
    """Normalize an ``int`` version / schema object / None to a schema."""
    if schema is None:
        return SCHEMA_V1
    if isinstance(schema, FeatureSchema):
        return schema
    return {1: SCHEMA_V1, 2: SCHEMA_V2}.get(schema) or FeatureSchema(schema)


# ---------------------------------------------------------------------------
# Solver configuration / telemetry
# ---------------------------------------------------------------------------


@dataclass
class EngineConfig:
    m_max: int = M_MAX_DEFAULT
    cache: bool = True
    early_exit: bool = True       # chunked m-sweep vs full legacy sweep
    chunk_init: int = 4           # first chunk of the m-sweep
    chunk_growth: int = 2         # geometric growth of later chunks
    quant: float = 4.0            # signature quantization steps per unit
    max_cache_entries: int = 65536
    # online retraining policy: retrain after this many on_samples() rows
    # (None -> the predictor's own retrain_every)
    retrain_every: Optional[int] = None
    # Schema-v2 QoS safety margins: capacities must clear
    # QoS / (1 + base + shape*distance), distance = |host/ref cpu - 1|.
    # v2 predictions are boundary-accurate (v1's node-shape blindness
    # made it accidentally conservative, absorbing forest noise for
    # free), so v2 supplies the slack explicitly: a flat base margin on
    # every shape plus a term growing with shape-extrapolation distance
    # (profiling data is densest at the reference shape).  0 disables.
    qos_margin_base: float = 0.06
    shape_margin: float = 0.08
    # learn the per-shape margin from per-shape validation error over
    # the accumulated dataset instead of the fixed shape_margin/unit
    # formula (schema v2 only; recomputed every forest epoch; shapes
    # with no validation rows fall back to the fixed formula)
    learned_shape_margin: bool = False
    margin_quantile: float = 0.9   # validation-error quantile per shape
    margin_cap: float = 0.5        # learned margins are clamped to
    #                                [qos_margin_base, margin_cap]
    # capacity-drain strategy: "host" (chunked early-exit m-sweep) or
    # "device" (fused single-pass sweep on the forest's device, see
    # solve_many)
    drain: str = "host"

    def __post_init__(self):
        if self.chunk_init < 1:
            raise ValueError(
                f"chunk_init must be >= 1 (got {self.chunk_init}): an "
                "empty first chunk never advances the m-sweep, so "
                "solve_many's drain loop would spin forever")
        if self.chunk_growth < 1:
            raise ValueError(
                f"chunk_growth must be >= 1 (got {self.chunk_growth}): "
                "shrinking chunks decay to empty before m_max and the "
                "drain loop never terminates")
        if self.max_cache_entries < 1:
            raise ValueError("max_cache_entries must be >= 1 "
                             f"(got {self.max_cache_entries})")
        if self.drain not in DRAIN_MODES:
            raise ValueError(f"unknown drain mode {self.drain!r} "
                             f"(have {DRAIN_MODES})")


@dataclass
class EngineStats:
    solves: int = 0               # scenarios requested
    unique_solves: int = 0        # scenarios actually solved
    cache_hits: int = 0
    coalesced_dupes: int = 0      # same-signature scenarios within a drain
    rows_built: int = 0
    predict_calls: int = 0        # batched rounds issued to the predictor
    cache_epochs: int = 0         # times the cache was cleared (retrain)
    stale_epoch_hits: int = 0     # epoch-tag mismatches served (MUST be 0)
    retrains: int = 0             # on_samples()-triggered retrains
    retrain_time_s: float = 0.0   # forest refit wall time (background)
    refresh_rows: int = 0         # post-retrain table-refresh rows
    refresh_time_s: float = 0.0   # post-retrain table-refresh wall time

    def snapshot(self) -> Dict[str, float]:
        return dict(self.__dict__)


def coloc_signature(coloc: Coloc, fn: str, m_max: int,
                    quant: float = 4.0) -> SigKey:
    """Canonical cache key for 'capacity of `fn` among `coloc`'.

    The target's own counts are excluded (the m-sweep replaces them, as
    in ``capacity_of``); neighbor counts are quantized to 1/quant steps
    and sorted, so the key is a true multiset signature — two nodes with
    the same colocation mix share one solve.
    """
    q = max(quant, 1e-9)
    sig = tuple(sorted(
        (g, round(ns * q) / q, round(nc * q) / q)
        for g, (ns, nc) in coloc.items() if g != fn and ns + nc > 0))
    return (fn, int(m_max), sig)


# ---------------------------------------------------------------------------
# Vectorized scenario assembly + chunked sweep state
# ---------------------------------------------------------------------------


class _Template:
    """Precomputed per-scenario constants for vectorized row assembly.

    Rows for one m, in legacy order: [target@m, neighbor_1, ...].  Every
    float64 accumulation mirrors build_features exactly:

      target agg   = prof_f*m  then += prof_g*ns_g   (coloc order)
      neighbor agg = (prof_g*ns_g + sum_{h!=g} prof_h*ns_h) + prof_f*m

    Schema v2 appends the (constant per scenario) normalized node-shape
    block as trailing columns; v1 layouts are bit-identical to PR 1.
    """

    def __init__(self, store: ProfileStore, qos: QoSStore,
                 specs: Dict[str, FunctionSpec], coloc: Coloc, fn: str,
                 schema: Optional[FeatureSchema] = None,
                 node_res: Optional[NodeResources] = None,
                 bound_scale: float = 1.0):
        self.schema = schema or SCHEMA_V1
        self.shape = self.schema.shape_features(node_res)
        self.pressure_scale = self.schema.pressure_scale(node_res)
        self.bound_scale = bound_scale
        spec = specs[fn]
        self.prof_f = store.profile(spec)
        self.solo_f = qos.solo(spec)
        self.qos_f = qos.qos(spec)
        names = [g for g, (ns, nc) in coloc.items()
                 if g != fn and ns + nc > 0]
        counts = {g: coloc[g] for g in names}
        self.neigh: List[Tuple[float, float, np.ndarray, float, float]] = []
        contribs = {g: store.profile(specs[g]) * counts[g][0] for g in names}
        for g in names:
            ns, nc = counts[g]
            gspec = specs[g]
            # base_agg: prof_g*ns_g then += prof_h*ns_h for h != g in order
            base = store.profile(gspec) * ns
            for h in names:
                if h != g:
                    base = base + contribs[h]
            self.neigh.append((ns, nc, store.profile(gspec),
                               qos.solo(gspec), qos.qos(gspec), base))
        self.contribs = [contribs[g] for g in names]
        self.tot_sat_base = float(sum(c[0] for c in counts.values()))
        self.tot_cached_base = float(sum(c[1] for c in counts.values()))
        self.rows_per_m = 1 + len(self.neigh)
        self.bounds_per_m = np.asarray(
            [self.qos_f] + [nb[4] for nb in self.neigh]) * self.bound_scale

    def build(self, ms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Feature matrix + QoS bounds for concurrencies `ms` (ascending).
        Returns (len(ms)*rows_per_m, n_features) float32 and bounds."""
        c = len(ms)
        R = self.rows_per_m
        msf = ms.astype(np.float64)
        X = np.empty((c, R, self.schema.n_features), np.float64)
        # target rows: n_sat = m, n_cached = 0
        X[:, 0, _SOLO] = self.solo_f
        X[:, 0, _PROF] = self.prof_f
        X[:, 0, _NSAT] = msf
        X[:, 0, _NCACHED] = 0.0
        agg_t = msf[:, None] * self.prof_f
        for contrib in self.contribs:
            agg_t = agg_t + contrib
        X[:, 0, _AGG] = agg_t
        X[:, 0, _TOTSAT] = msf + self.tot_sat_base
        X[:, 0, _TOTCACHED] = self.tot_cached_base
        # neighbor rows: fn@m is their last-added neighbor
        for j, (ns, nc, prof_g, solo_g, _qos_g, base) in \
                enumerate(self.neigh):
            r = j + 1
            X[:, r, _SOLO] = solo_g
            X[:, r, _PROF] = prof_g
            X[:, r, _NSAT] = ns
            X[:, r, _NCACHED] = nc
            X[:, r, _AGG] = base + msf[:, None] * self.prof_f
            X[:, r, _TOTSAT] = self.tot_sat_base + msf
            X[:, r, _TOTCACHED] = self.tot_cached_base
        if self.schema.n_shape:
            X[:, :, N_FEATURES:] = self.shape
        out = X.reshape(c * R, self.schema.n_features).astype(np.float32)
        if self.schema.n_shape and self.pressure_scale != 1.0:
            # scale AFTER the float32 cast of the base block, mirroring
            # build_row (float32 base -> float64 * scale -> float32), so
            # solver rows are bitwise identical to training/per-schedule
            # rows for every node shape, not just power-of-two ratios
            for cols in (_NSAT, _NCACHED, _AGG, _TOTSAT, _TOTCACHED):
                out[:, cols] = (out[:, cols].astype(np.float64)
                                * self.pressure_scale).astype(np.float32)
        bounds = np.tile(self.bounds_per_m, c)
        return out, bounds


class _Solve:
    """State machine for one unique scenario's chunked m-sweep."""

    def __init__(self, tmpl: _Template, m_max: int):
        self.tmpl = tmpl
        self.m_max = m_max
        self.next_m = 1
        self.capacity = 0
        self.rows = 0
        self.done = m_max <= 0

    def take_chunk(self, size: int) -> np.ndarray:
        hi = min(self.next_m + size - 1, self.m_max)
        ms = np.arange(self.next_m, hi + 1)
        self.next_m = hi + 1
        return ms

    def absorb(self, ms: np.ndarray, ok: np.ndarray):
        """ok: (len(ms)*rows_per_m,) bool — pass/fail per feature row."""
        per_m = self.tmpl.rows_per_m
        blocks = ok.reshape(len(ms), per_m)
        for i, m in enumerate(ms):
            if blocks[i].all():
                self.capacity = int(m)
            else:
                self.done = True
                return
        if self.next_m > self.m_max:
            self.done = True


# Internal query form: (coloc, fn, m_max, node_res)
_Query = Tuple[Coloc, str, int, Optional[NodeResources]]


class PredictionService:
    """Owns the forest, the feature schema, batched capacity solving, the
    colocation-signature cache, and epoch/retrain bookkeeping; see module
    docstring.  ``CapacityEngine`` is an alias of this class."""

    def __init__(self, predictor: PerfPredictor, store: ProfileStore,
                 qos: QoSStore, specs: Dict[str, FunctionSpec],
                 cfg: Optional[EngineConfig] = None, *,
                 schema: Union[int, FeatureSchema, None] = None,
                 engine: Optional[str] = None,
                 drain: Optional[str] = None):
        self.predictor = predictor
        self.store = store
        self.qos = qos
        self.specs = specs
        self.cfg = cfg or EngineConfig()
        if drain is not None:
            # keyword override without mutating a caller-shared config
            self.cfg = replace(self.cfg, drain=drain)
        self.schema = get_schema(schema)
        if engine is not None:
            self.set_engine(engine)
        self.stats = EngineStats()
        #: span tracer for retrain / capacity-solve sections (no-op by
        #: default; ``Platform.build`` swaps in a real one when
        #: telemetry is enabled)
        self.tracer = NULL_TRACER
        self._cache: Dict[SigKey, Tuple[int, int]] = {}  # key -> (epoch, cap)
        # device-resident signature cache: solved capacities live in one
        # growing device vector; repeat signatures resolve as a gather
        self._dev_slots: Dict[SigKey, int] = {}          # key -> slot index
        self._dev_caps: Optional[torch.Tensor] = None    # (n_slots,) int32
        self._epoch = predictor.retrain_count
        self._pending_samples = 0
        self._retrain_listeners: List = []
        # learned per-shape QoS margins (shape_key -> margin); cached
        # per forest epoch when cfg.learned_shape_margin.  Learned
        # eagerly here and after each retrain so the probe-forest fit
        # never lands on a scheduling critical path.
        self._shape_margins: Optional[Dict[Tuple[float, ...], float]] = None
        #: cross-cell capacity exchange (``cells.CapacityExchange``):
        #: when joined, every freshly solved capacity is published so
        #: sibling cells' services can serve it cache-warm.  None (the
        #: default) is zero-overhead.
        self.exchange = None
        if self.cfg.learned_shape_margin and predictor.fitted:
            self.shape_margins()

    # -- inference engine selection --------------------------------------

    def set_engine(self, name: str):
        """Select the RFR inference engine for every prediction issued
        through this service (one of ``INFERENCE_ENGINES``: numpy /
        torch / cuda, the last routing through the hand-written
        ``kernels.rfr_inference`` kernels).  The predictor validates the
        name and its device."""
        self.predictor.engine = name

    @property
    def inference_engine(self) -> str:
        return self.predictor.engine

    @property
    def epoch(self) -> int:
        """Current forest epoch (bumped by every retrain)."""
        return self._epoch

    # -- feature assembly (the build_features client surface) -------------

    def feature_row(self, fn: str, n_sat: float, n_cached: float,
                    coloc: Optional[Coloc] = None,
                    node_res: Optional[NodeResources] = None) -> np.ndarray:
        """One schema row for `fn` at (n_sat, n_cached) among `coloc`
        (which may include fn itself; fn's entry is excluded from the
        neighbor block) hosted on a ``node_res``-shaped node."""
        spec = self.specs[fn]
        neigh = [(self.store.profile(self.specs[g]), ns, nc)
                 for g, (ns, nc) in (coloc or {}).items()
                 if g != fn and ns + nc > 0]
        return self.schema.build_row(self.qos.solo(spec),
                                     self.store.profile(spec), n_sat,
                                     n_cached, neigh, node_res)

    def rows_for_coloc(self, coloc: Coloc,
                       node_res: Optional[NodeResources] = None
                       ) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """One row + QoS bound per function in `coloc` (dict order).

        Bounds carry the schema-v2 safety margin (``qos_bound_scale``),
        so per-schedule admission checks (Gsight) apply the same slack
        as the capacity solver."""
        scale = self.qos_bound_scale(node_res)
        names, rows, bounds = [], [], []
        for g, (ns, nc) in coloc.items():
            if ns + nc <= 0:
                continue
            names.append(g)
            rows.append(self.feature_row(g, ns, nc, coloc, node_res))
            bounds.append(self.qos.qos(self.specs[g]) * scale)
        return names, (np.stack(rows) if rows
                       else np.empty((0, self.schema.n_features),
                                     np.float32)), np.asarray(bounds)

    # -- prediction -------------------------------------------------------

    def predict(self, X: np.ndarray) -> np.ndarray:
        """One batched inference through the selected engine."""
        return self.predictor.predict(X)

    def predict_many(self, Xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        return self.predictor.predict_many(Xs)

    # -- cache / epoch ----------------------------------------------------

    def _check_epoch(self):
        if self.predictor.retrain_count != self._epoch:
            self.invalidate()
            self._epoch = self.predictor.retrain_count

    def invalidate(self):
        """Drop every cached capacity (predictor retrained, or external
        state the signatures cannot see has changed)."""
        if self._cache:
            self._cache.clear()
        self._dev_slots.clear()
        self._dev_caps = None
        self._shape_margins = None   # re-learn against the new forest
        self.stats.cache_epochs += 1

    def signature(self, coloc: Coloc, fn: str,
                  m_max: Optional[int] = None,
                  node_res: Optional[NodeResources] = None) -> SigKey:
        key = coloc_signature(coloc, fn, m_max or self.cfg.m_max,
                              self.cfg.quant)
        shape = self.schema.shape_key(node_res, self.cfg.quant)
        return key + (shape,) if shape else key

    def _cache_get(self, key: SigKey) -> Optional[int]:
        """Epoch-checked cache lookup.  An entry tagged with a different
        epoch than the current forest must never be served: it is counted
        (``stale_epoch_hits`` — asserted 0 by the retrain benchmarks,
        since ``invalidate`` clears eagerly) and dropped."""
        ent = self._cache.get(key)
        if ent is None:
            return None
        epoch, cap = ent
        if epoch != self._epoch:
            self.stats.stale_epoch_hits += 1
            del self._cache[key]
            return None
        return cap

    def _cache_put(self, key: SigKey, cap: int):
        """Insert one solved capacity, evicting oldest-first (dict
        insertion order) at ``max_cache_entries`` — the wholesale
        ``clear()`` this replaces dropped every warm entry the moment
        the bound was hit, triggering a cluster-wide re-solve storm."""
        if not self.cfg.cache:
            return
        if key not in self._cache:
            while len(self._cache) >= self.cfg.max_cache_entries:
                self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (self._epoch, cap)
        if self.exchange is not None:
            self.exchange.publish(self, key, self._epoch, cap)

    def accept_exchange(self, key: SigKey, epoch: int, cap: int):
        """Receive a capacity solved by a sibling cell's service.  Only
        same-epoch entries are accepted (all cells share one forest, so
        epochs agree except transiently around a retrain) and the entry
        lands without re-publishing."""
        if not self.cfg.cache or epoch != self._epoch:
            return
        if key not in self._cache:
            while len(self._cache) >= self.cfg.max_cache_entries:
                self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (epoch, cap)

    def shape_margins(self) -> Dict[Tuple[float, ...], float]:
        """Per-shape QoS margins learned from per-shape *validation*
        error (``cfg.learned_shape_margin``).

        A deterministic 1-in-4 holdout of the accumulated dataset is
        scored against a **probe forest** fit on the remaining rows
        (same hyperparameters as the serving forest) — the serving
        forest trains on everything, so scoring the holdout with it
        would report biased-low in-sample residuals and hand poorly-
        extrapolated shapes margins that are too tight.  Holdout rows
        are grouped by their quantized shape block (the same keys the
        signature cache uses) and each shape's margin is the
        ``margin_quantile`` of its relative error, clamped to
        [qos_margin_base, margin_cap].  Called eagerly on construction
        and after every ``retrain()`` — the probe fit is background
        work, billed with retraining; ``qos_bound_scale`` only ever
        *reads* the cached result (after an external ``invalidate``
        the fixed formula applies until the next retrain re-learns),
        so the fit can never land on a scheduling critical path."""
        if self._shape_margins is not None:
            return self._shape_margins
        margins: Dict[Tuple[float, ...], float] = {}
        X, y = self.predictor.dataset()
        if self.schema.version >= 2 and len(y) >= 8 \
                and X.shape[1] == self.schema.n_features:
            idx = np.arange(len(y))
            val = idx[3::4]              # deterministic 1-in-4 holdout
            train = np.setdiff1d(idx, val)
            Xv, yv = X[val], y[val]
            model = self.predictor.model
            probe = RandomForestRegressor(
                model.n_trees, model.max_depth,
                model.min_samples_leaf, seed=model.seed + 1)
            yt = y[train]
            if self.predictor.log_target:
                yt = np.log(np.maximum(yt, 1e-6))
            probe.fit(X[train], yt)
            pred = probe.predict(Xv)
            if self.predictor.log_target:
                pred = np.exp(pred)
            rel = np.abs(pred - yv) / np.maximum(yv, 1e-9)
            q = max(self.cfg.quant, 1e-9)
            keys = [tuple(round(float(v) * q) / q for v in row)
                    for row in Xv[:, N_FEATURES:]]
            groups: Dict[Tuple[float, ...], List[float]] = {}
            for key, err in zip(keys, rel):
                groups.setdefault(key, []).append(float(err))
            for key, errs in groups.items():
                m = float(np.quantile(np.asarray(errs),
                                      self.cfg.margin_quantile))
                margins[key] = min(max(m, self.cfg.qos_margin_base),
                                   self.cfg.margin_cap)
        self._shape_margins = margins
        return margins

    def qos_bound_scale(self, node_res: Optional[NodeResources] = None
                        ) -> float:
        """Schema-v2 QoS tightening (1.0 under v1 — the parity paths
        are untouched): flat base margin + shape-extrapolation term,
        or — with ``cfg.learned_shape_margin`` — the margin learned
        from that shape's validation error (fixed formula as the
        fallback for shapes with no validation rows)."""
        if self.schema.version == 1:
            return 1.0
        # cached margins only: a lazy recompute here would put the
        # probe-forest fit inside a scheduling-latency timing window
        if self.cfg.learned_shape_margin and self._shape_margins:
            learned = self._shape_margins.get(
                self.schema.shape_key(node_res, self.cfg.quant))
            if learned is not None:
                return 1.0 / (1.0 + learned)
        margin = self.cfg.qos_margin_base
        if node_res is not None and self.cfg.shape_margin:
            r = node_res.cpu_mcores / REFERENCE_NODE.cpu_mcores
            margin += self.cfg.shape_margin * abs(r - 1.0)
        return 1.0 / (1.0 + margin)

    def capacity_hint(self, coloc: Coloc, fn: str,
                      m_max: Optional[int] = None,
                      node_res: Optional[NodeResources] = None
                      ) -> Optional[int]:
        """Cached capacity for this colocation, or None.  Never runs
        inference — safe on any non-critical decision path (migration
        targeting, consolidation)."""
        self._check_epoch()
        return self._cache_get(self.signature(coloc, fn, m_max, node_res))

    # -- solving ----------------------------------------------------------

    def capacity(self, coloc: Coloc, fn: str, m_max: Optional[int] = None,
                 node_res: Optional[NodeResources] = None
                 ) -> Tuple[int, int]:
        """Capacity of `fn` under `coloc` on a ``node_res``-shaped node;
        returns (capacity, rows_built).  Same contract as
        ``capacity.capacity_of`` (cache hits bill 0 rows)."""
        return self.solve_many(
            [(coloc, fn, m_max or self.cfg.m_max, node_res)])[0]

    def solve_many(self, queries: Sequence[Tuple]
                   ) -> List[Tuple[int, int]]:
        """Solve many (coloc, fn, m_max[, node_res]) scenarios with
        coalesced batched inference.  Duplicate signatures within the
        batch are solved once; rows are billed to the first occurrence
        only.

        ``cfg.drain`` selects the strategy: the chunked host m-sweep
        below, or the device-resident fused sweep
        (``_solve_many_device``) — one padded scenario tensor, one
        kernel pass, no per-chunk host round trips."""
        norm: List[_Query] = [q if len(q) == 4 else (*q, None)
                              for q in queries]
        self._check_epoch()
        self.stats.solves += len(norm)
        if self.cfg.drain == "device":
            return self._solve_many_device(norm)
        results: List[Optional[Tuple[int, int]]] = [None] * len(norm)
        unique: Dict[SigKey, _Solve] = {}
        assignment: List[Optional[SigKey]] = [None] * len(norm)
        for i, (coloc, fn, m_max, node_res) in enumerate(norm):
            key = self.signature(coloc, fn, m_max, node_res)
            if self.cfg.cache:
                cap = self._cache_get(key)
                if cap is not None:
                    results[i] = (cap, 0)
                    self.stats.cache_hits += 1
                    continue
            if key in unique:
                self.stats.coalesced_dupes += 1
            else:
                unique[key] = _Solve(
                    _Template(self.store, self.qos, self.specs, coloc, fn,
                              self.schema, node_res,
                              self.qos_bound_scale(node_res)), m_max)
                self.stats.unique_solves += 1
            assignment[i] = key

        active = [s for s in unique.values() if not s.done]
        size = self.cfg.chunk_init if self.cfg.early_exit else \
            max((s.m_max for s in active), default=1)
        while active:
            batch = []
            for s in active:
                ms = s.take_chunk(size)
                X, bounds = s.tmpl.build(ms)
                s.rows += len(X)
                batch.append((s, ms, X, bounds))
            self.stats.rows_built += sum(len(b[2]) for b in batch)
            preds = self.predictor.predict_many([b[2] for b in batch])
            self.stats.predict_calls += 1
            for (s, ms, _X, bounds), p in zip(batch, preds):
                s.absorb(ms, p <= bounds)
            active = [s for s in active if not s.done]
            size *= self.cfg.chunk_growth

        for key, s in unique.items():
            self._cache_put(key, s.capacity)
        billed: set = set()
        for i, key in enumerate(assignment):
            if key is None:
                continue
            s = unique[key]
            results[i] = (s.capacity, 0 if key in billed else s.rows)
            billed.add(key)
        return results  # type: ignore[return-value]

    # -- device-resident drain (the fused m-sweep) ------------------------

    def _solve_many_device(self, norm: List[_Query]
                           ) -> List[Tuple[int, int]]:
        """Device-resident capacity solving: the whole drain's candidate
        feature matrix is assembled as ONE padded (S, M, R, F) tensor
        and the full m-sweep runs in a single fused forest pass
        (``kernels.ops.rfr_sweep_op``) that returns max-admissible m per
        scenario — no host round-trip per chunk, host work O(unique
        signatures) instead of O(nodes x chunk rounds).

        Row assembly stays in the float64 numpy ``_Template.build`` —
        the solver's bit-compatibility contract (device rows are the
        host oracle's rows, so capacity tables are bit-identical by
        construction); everything after the one transfer — forest
        descent, QoS comparison, the running all-pass reduction over m,
        and cached-capacity resolution (a gather over the device-side
        capacity vector keyed by colocation signature) — runs on the
        forest's device.  ``predictor.engine == "cuda"`` routes to the
        fused CUDA kernel, anything else to the plain PyTorch sweep."""
        from ..kernels import ops

        t0 = time.perf_counter()
        n = len(norm)
        if n == 0:
            return []
        persist = self.cfg.cache
        # next free slot = device-vector length, NOT len(_dev_slots):
        # re-solves (host entry evicted) overwrite their slot and leave
        # an orphan element behind, so the dict can run shorter than
        # the vector — handing out len(_dev_slots) would collide
        base = int(self._dev_caps.shape[0]) \
            if persist and self._dev_caps is not None else 0
        # key -> (template, m_max, slot, first query index)
        new: Dict[SigKey, Tuple[_Template, int, int, int]] = {}
        slot_ids = np.zeros(n, np.int64)
        first_rows = [0] * n
        for i, (coloc, fn, m_max, node_res) in enumerate(norm):
            key = self.signature(coloc, fn, m_max, node_res)
            if persist:
                slot = self._dev_slots.get(key)
                if slot is not None and self._cache_get(key) is not None:
                    slot_ids[i] = slot
                    self.stats.cache_hits += 1
                    continue
            ent = new.get(key)
            if ent is not None:
                self.stats.coalesced_dupes += 1
                slot_ids[i] = ent[2]
                continue
            tmpl = _Template(self.store, self.qos, self.specs, coloc, fn,
                             self.schema, node_res,
                             self.qos_bound_scale(node_res))
            slot = base + len(new)
            new[key] = (tmpl, m_max, slot, i)
            slot_ids[i] = slot
            first_rows[i] = max(m_max, 0) * tmpl.rows_per_m
            self.stats.unique_solves += 1

        caps_new = None
        if new:
            with self.tracer.span("device_sweep", stats=self.stats) as sp:
                F = self.schema.n_features
                S = len(new)
                Mp = max(max(mm for _t, mm, _s, _i in new.values()), 1)
                Rp = max(t.rows_per_m for t, _mm, _s, _i in new.values())
                X = np.zeros((S, Mp, Rp, F), np.float32)
                # +inf bound = padded row, passes; -inf = past this
                # scenario's own m_max, fails (capacity capped there)
                B = np.full((S, Mp, Rp), np.inf, np.float32)
                rows_built = 0
                for j, (tmpl, mm, _slot, _i) in enumerate(new.values()):
                    R = tmpl.rows_per_m
                    if mm > 0:
                        rows, bounds = tmpl.build(np.arange(1, mm + 1))
                        X[j, :mm, :R, :] = rows.reshape(mm, R, F)
                        B[j, :mm, :R] = bounds.reshape(mm, R)
                    B[j, max(mm, 0):, :] = -np.inf
                    rows_built += max(mm, 0) * R
                feat, thr, leaf = self.predictor.model.device_arrays()
                dev = feat.device
                caps_new = ops.rfr_sweep_op(
                    torch.from_numpy(X).to(dev), torch.from_numpy(B).to(dev),
                    feat, thr, leaf,
                    use_kernel=(self.predictor.engine == "cuda"),
                    log_target=self.predictor.log_target)
                self.stats.rows_built += rows_built
                self.stats.predict_calls += 1
                if sp is not None:
                    sp.attrs["scenarios"] = S
                    sp.attrs["rows"] = rows_built
                    sp.attrs["padded_shape"] = [S, Mp, Rp, F]
            if persist:
                self._dev_caps = caps_new if self._dev_caps is None \
                    else torch.cat([self._dev_caps, caps_new])

        # resolve every query with one device-side gather
        all_caps = self._dev_caps if persist else caps_new
        caps_host = all_caps.index_select(
            0, torch.from_numpy(slot_ids).to(all_caps.device)).cpu().numpy()
        if persist:
            for key, (_t, _mm, slot, i) in new.items():
                self._dev_slots[key] = slot
                self._cache_put(key, int(caps_host[i]))
            self._dev_evict()
        if new:
            self.predictor.record_inference(
                rows_built, time.perf_counter() - t0)
        return [(int(caps_host[i]), first_rows[i]) for i in range(n)]

    def _dev_evict(self):
        """Bound the device capacity vector like the host cache: drop
        oldest slots past ``max_cache_entries`` and compact the
        survivors with one gather."""
        excess = len(self._dev_slots) - self.cfg.max_cache_entries
        if excess <= 0:
            return
        keep = list(self._dev_slots)[excess:]
        idx = torch.tensor([self._dev_slots[k] for k in keep],
                           dtype=torch.long, device=self._dev_caps.device)
        self._dev_caps = self._dev_caps.index_select(0, idx)
        self._dev_slots = {k: i for i, k in enumerate(keep)}

    # -- node-level API (the async-update path) ---------------------------

    def node_coloc(self, node: Node) -> Coloc:
        return {g: (float(s.n_sat), float(s.n_cached))
                for g, s in node.funcs.items() if s.total > 0}

    def update_node(self, node: Node, m_max: Optional[int] = None) -> int:
        return self.update_nodes([node], m_max)

    def update_nodes(self, nodes: Sequence[Node],
                     m_max: Optional[int] = None) -> int:
        """Recompute every capacity-table entry of every node in one
        coalesced drain (node-shape-aware under schema v2).  Returns
        total inference rows billed."""
        with self.tracer.span("capacity_solve", stats=self.stats) as sp:
            mm = m_max or self.cfg.m_max
            queries: List[_Query] = []
            owners: List[Tuple[Node, str]] = []
            for node in nodes:
                coloc = self.node_coloc(node)
                for fn in coloc:
                    queries.append((coloc, fn, mm, node.res))
                    owners.append((node, fn))
            total_rows = 0
            for (node, fn), (cap, rows) in zip(owners,
                                               self.solve_many(queries)):
                node.table[fn] = CapEntry(capacity=cap, fresh=True)
                total_rows += rows
            if sp is not None:
                sp.attrs["nodes"] = len(nodes)
                sp.attrs["rows"] = total_rows
        return total_rows

    # -- online retraining (the runtime dataset-maintenance loop) ---------

    def on_samples(self, X: Sequence[np.ndarray], y: Sequence[float],
                   retrain: Optional[bool] = None) -> bool:
        """Ingest runtime (features, label) measurements and apply the
        online retraining policy.

        ``retrain=None`` retrains once ``cfg.retrain_every`` (default:
        the predictor's own ``retrain_every``) samples accumulated since
        the last retrain; True forces one; False only accumulates.
        Returns whether a retrain fired (callers then refresh capacity
        tables off the critical path via ``refresh_tables``)."""
        for xi, yi in zip(X, y):
            self.predictor.add_sample(xi, yi, retrain=False)
        self._pending_samples += len(y)
        if retrain is None:
            every = self.cfg.retrain_every \
                if self.cfg.retrain_every is not None \
                else self.predictor.retrain_every
            retrain = self._pending_samples >= every
        if retrain:
            self.retrain()
            return True
        return False

    def retrain(self):
        """Refit the forest on the full accumulated dataset; bumps the
        epoch and eagerly clears the signature cache so no post-retrain
        lookup can see a pre-retrain capacity.  Wall time is billed to
        ``stats.retrain_time_s`` (background work, never the scheduling
        critical path)."""
        with self.tracer.span("retrain", stats=self.stats) as sp:
            t0 = time.perf_counter()
            self.predictor.retrain()
            self._check_epoch()     # epoch bump -> invalidate()
            if self.cfg.learned_shape_margin:
                # re-learn margins against the new forest now
                # (background, billed with the retrain) rather than
                # lazily on the next capacity solve
                self.shape_margins()
            self.stats.retrain_time_s += time.perf_counter() - t0
            self.stats.retrains += 1
            self._pending_samples = 0
            if sp is not None:
                sp.attrs["epoch"] = self._epoch
                sp.attrs["samples"] = self.predictor.n_samples
        for cb in self._retrain_listeners:
            cb(self)

    def add_retrain_listener(self, cb) -> None:
        """Register ``cb(service)`` to fire after every retrain (forest
        refit + epoch bump + cache clear) — the platform's ``on_retrain``
        observer hook subscribes here."""
        self._retrain_listeners.append(cb)

    def refresh_tables(self, nodes: Sequence[Node],
                       m_max: Optional[int] = None) -> int:
        """Post-retrain capacity-table refresh over `nodes`, billed
        separately (``stats.refresh_rows`` / ``refresh_time_s``) so the
        retrain benchmarks can report table-refresh cost apart from both
        retraining and scheduling-critical-path inference."""
        t0 = time.perf_counter()
        rows = self.update_nodes(nodes, m_max)
        self.stats.refresh_time_s += time.perf_counter() - t0
        self.stats.refresh_rows += rows
        return rows


#: PR-1 name for the service's batched-capacity surface; kept as a true
#: alias (one class, no wrapper) so ``repro.engine.CapacityEngine`` and
#: every existing call site keep working.
CapacityEngine = PredictionService
