"""Capacity calculation (paper Fig. 7) and the QoS store.

The capacity of function f on a node is the largest m such that, with m
saturated instances of f and the current saturated counts of every
neighbor, *every* colocated function's predicted latency still meets its
QoS.  All (m, colocated-function) scenarios are assembled into one feature
matrix and scored in a single batched inference — the paper's "once"
inference-cost accounting (its Fig. 17-b shows batching 100 inputs costs
~2 ms extra).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import Node
from .predictor import PerfPredictor, build_features
from .profiles import FunctionSpec, ProfileStore

QOS_MULT = 1.2         # QoS = 120% of interference-free saturated tail lat.
M_MAX_DEFAULT = 24     # capacity search bound per (node, function)


@dataclass
class QoSStore:
    """Provider-established QoS targets (paper §3): multiple of the
    monitored solo saturated tail latency."""

    store: ProfileStore
    ground_truth: object
    mult: float = QOS_MULT

    def solo(self, spec: FunctionSpec) -> float:
        return self.store.solo_latency(spec, self.ground_truth)

    def qos(self, spec: FunctionSpec) -> float:
        return self.mult * self.solo(spec)


def _neighbor_feats(store: ProfileStore,
                    specs: Dict[str, FunctionSpec],
                    coloc: Dict[str, Tuple[float, float]],
                    exclude: str) -> List[Tuple[np.ndarray, float, float]]:
    return [(store.profile(specs[g]), ns, nc)
            for g, (ns, nc) in coloc.items() if g != exclude and ns + nc > 0]


def capacity_of(predictor: PerfPredictor, store: ProfileStore,
                qos: QoSStore, specs: Dict[str, FunctionSpec],
                coloc: Dict[str, Tuple[float, float]], fn: str,
                m_max: int = M_MAX_DEFAULT) -> Tuple[int, int]:
    """Capacity of `fn` under colocation `coloc` ({name: (n_sat, n_cached)};
    fn's own current counts, if present, are ignored — m replaces them).

    Returns (capacity, n_feature_rows) — the row count feeds the
    inference-cost accounting.  One predictor.predict call total.
    """
    spec = specs[fn]
    prof_f = store.profile(spec)
    solo_f = qos.solo(spec)
    others = {g: v for g, v in coloc.items() if g != fn}

    rows: List[np.ndarray] = []
    qos_bounds: List[float] = []
    for m in range(1, m_max + 1):
        # target fn itself at concurrency m
        neigh = _neighbor_feats(store, specs, others, exclude=fn)
        rows.append(build_features(solo_f, prof_f, m, 0.0, neigh))
        qos_bounds.append(qos.qos(spec))
        # every neighbor under fn@m
        for g, (ns, nc) in others.items():
            if ns + nc <= 0:
                continue
            gspec = specs[g]
            neigh_g = _neighbor_feats(store, specs, {**others, fn: (m, 0.0)},
                                      exclude=g)
            rows.append(build_features(qos.solo(gspec), store.profile(gspec),
                                       ns, nc, neigh_g))
            qos_bounds.append(qos.qos(gspec))

    X = np.stack(rows)
    pred = predictor.predict(X)
    ok = pred <= np.asarray(qos_bounds)

    per_m = len(ok) // m_max
    capacity = 0
    for m in range(1, m_max + 1):
        sl = ok[(m - 1) * per_m: m * per_m]
        if sl.all():
            capacity = m
        else:
            break
    return capacity, len(rows)


def update_capacity_table(predictor: PerfPredictor, store: ProfileStore,
                          qos: QoSStore, specs: Dict[str, FunctionSpec],
                          node: Node, m_max: int = M_MAX_DEFAULT,
                          engine=None) -> int:
    """Recompute every entry of a node's capacity table (the asynchronous
    update).  Returns the number of inference rows used.

    When a ``PredictionService`` is supplied via ``engine`` the solve is
    delegated to it (cached + coalesced + vectorized + node-shape-aware
    under schema v2); the per-function loop below is the schema-v1
    reference oracle the service's parity gates are tested against."""
    if engine is not None:
        return engine.update_node(node, m_max)
    from .cluster import CapEntry
    coloc = {g: (float(s.n_sat), float(s.n_cached))
             for g, s in node.funcs.items() if s.total > 0}
    total_rows = 0
    for fn in list(coloc):
        cap, rows = capacity_of(predictor, store, qos, specs, coloc, fn,
                                m_max)
        node.table[fn] = CapEntry(capacity=cap, fresh=True)
        total_rows += rows
    return total_rows
