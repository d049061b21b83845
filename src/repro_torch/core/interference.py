"""Ground-truth performance model (the "real cluster").

The paper measures real P90 latencies on a 24-node OpenFaaS cluster; on
this CPU container the cluster is simulated, so *something* must decide
what latency a function experiences under colocation.  This module is that
ground truth.  It is intentionally:

  * nonlinear (convex queueing-style terms, saturating caps),
  * multi-resource (CPU oversubscription, memory-bandwidth contention,
    LLC cache pressure — the three classic interference channels),
  * heterogeneous (per-function sensitivities), and
  * hidden from the scheduler — the RFR predictor is trained on *samples*
    of (colocation -> latency) pairs and graded against fresh samples, so
    prediction error in the benchmarks is honest generalization error.

Latency model for function i on a node with saturated instance counts
{n_j} of functions {j}:

    lat_i = solo_i * (1 + s_i^cpu * g(rho_cpu) + s_i^bw * g(rho_bw)
                        + s_i^$ * cache_term) * load_term(u_i)

where rho_* are node-level demand/capacity ratios of *actual* usage
(cached instances contribute only a small residual footprint — the basis
of dual-staged scaling's win), g is a convex soft-queueing curve and
cache_term grows once combined working sets spill the LLC.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np

from .profiles import FunctionSpec


@dataclass(frozen=True)
class NodeResources:
    """One worker node (paper testbed: Xeon E5-2650, 48 HT cores, 128 GB).

    Calibration invariant (matches the paper's Fig 13 world): packing by
    *requested* resources (the K8s baseline) must be safe — interference
    multiplier ~1.0-1.1 — while ~1.5-2x that density pushes past the QoS
    headroom.  The capacity solver then lands between the two."""

    cpu_mcores: float = 48_000.0
    mem_mb: float = 131_072.0
    mem_bw_gbps: float = 68.0     # 4-channel DDR4-2133
    llc_mb: float = 60.0          # 2 sockets x 30 MB
    # residual footprint of a cached (drained) instance
    cached_residual: float = 0.06


def _queue(rho: float, knee: float = 0.55, cap: float = 6.0) -> float:
    """Convex soft-queueing curve: ~0 below the knee, grows like
    rho^2/(1-rho) above it, capped (the node never literally deadlocks)."""
    if rho <= knee:
        return 0.02 * rho
    x = min(rho, 0.98)
    val = 0.02 * knee + (x - knee) ** 2 / max(1.0 - x, 0.02)
    return min(val, cap)


class GroundTruth:
    """Oracle latencies.  Only the simulator may call this; the scheduler
    must go through the predictor."""

    def __init__(self, node: NodeResources | None = None, seed: int = 1234):
        self.node = node or NodeResources()
        self._rng = np.random.default_rng(seed)

    def reseed(self, seed: int = 1234) -> None:
        """Reset the measurement-noise stream.  A/B consumers that share
        one world across sequential runs (the platform smoke) call this
        so every arm faces the identical noise, instead of run-order-
        dependent draws."""
        self._rng = np.random.default_rng(seed)

    # -- node-level pressures ------------------------------------------

    def _pressures(self, colocation: Mapping[str, Tuple[FunctionSpec, float,
                                                        float]],
                   node_res: NodeResources | None = None):
        """colocation: name -> (spec, n_saturated, n_cached).

        ``node_res`` overrides the default node shape — the heterogeneous-
        fleet path, where pressures are relative to the *hosting* node's
        capacity (a 2x node halves every rho for the same colocation)."""
        nd = node_res or self.node
        cpu = bw = cache = mem = 0.0
        for spec, n_sat, n_cached in colocation.values():
            resid = nd.cached_residual * n_cached
            cpu += spec.cpu_req * spec.cpu_work * (n_sat + resid)
            bw += spec.bw_demand * (n_sat + resid)
            cache += spec.cache_mb * (n_sat + resid)
            mem += spec.mem_req * spec.mem_work * (n_sat + n_cached)
        return (cpu / nd.cpu_mcores, bw / nd.mem_bw_gbps,
                cache / nd.llc_mb, mem / nd.mem_mb)

    # -- latencies -------------------------------------------------------

    def solo_latency(self, fn: FunctionSpec) -> float:
        """P90 latency of a saturated, interference-free instance."""
        return fn.exec_ms * 1.30  # P90/mean ratio for a loaded server

    def latency(self, fn: FunctionSpec,
                colocation: Mapping[str, Tuple[FunctionSpec, float, float]],
                load_frac: float = 1.0,
                node_res: NodeResources | None = None) -> float:
        """P90 latency of `fn`'s instances on a node with `colocation`
        (which must include fn itself)."""
        rho_cpu, rho_bw, rho_cache, _ = self._pressures(colocation, node_res)
        cpu_term = fn.cpu_sens * _queue(rho_cpu)
        bw_term = fn.bw_sens * _queue(rho_bw, knee=0.55)
        # LLC only hurts once combined working sets actually spill it
        spill = max(0.0, rho_cache - 1.0)
        cache_term = fn.cache_sens * min(1.2 * spill * spill, 2.5)
        mult = 1.0 + cpu_term + bw_term + cache_term
        load_term = 0.75 + 0.25 * min(max(load_frac, 0.0), 1.2) ** 2
        return self.solo_latency(fn) * mult * load_term

    def measure(self, fn: FunctionSpec,
                colocation: Mapping[str, Tuple[FunctionSpec, float, float]],
                load_frac: float = 1.0, noise: float = 0.04,
                node_res: NodeResources | None = None) -> float:
        """A *measurement* of the latency — ground truth + measurement
        noise.  This is what training samples and QoS monitoring see."""
        lat = self.latency(fn, colocation, load_frac, node_res)
        return float(lat * (1.0 + self._rng.normal(0.0, noise)))

    def fits(self, colocation: Mapping[str, Tuple[FunctionSpec, float,
                                                  float]],
             node_res: NodeResources | None = None) -> bool:
        """Hard feasibility: memory is not overcommittable."""
        _, _, _, rho_mem = self._pressures(colocation, node_res)
        return rho_mem <= 1.0
