"""Fault tolerance for 1000+-node runs: straggler detection, heartbeat
watchdog, elastic mesh re-planning, and failure injection for tests (a
copy of ``repro.distributed.fault_tolerance``, which is pure Python but
for ``make_elastic_mesh``; that one builds a JAX mesh and waits for the
port's ``DeviceMesh`` slice).

The control flow these implement (exercised end-to-end by
``launch/train.py`` and tests/test_fault_tolerance.py):

  train loop -> heartbeat every step -> watchdog flags a hang
             -> straggler detector flags slow hosts (EWMA z-score)
             -> on failure: pick a new mesh from surviving devices
                (`plan_elastic_mesh`), restore the step-atomic checkpoint
                with reshard-on-load, continue.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------


@dataclass
class StragglerDetector:
    """Per-host step-time EWMA + variance; flags hosts > k sigma slower
    than the fleet.  On a real deployment each host reports its step wall
    time through the coordination service; here hosts are ranks in a dict.
    """

    alpha: float = 0.1
    k_sigma: float = 3.0
    min_samples: int = 8
    mean: Dict[int, float] = field(default_factory=dict)
    var: Dict[int, float] = field(default_factory=dict)
    n: Dict[int, int] = field(default_factory=dict)

    def record(self, host: int, step_s: float):
        m = self.mean.get(host, step_s)
        v = self.var.get(host, 0.0)
        d = step_s - m
        m += self.alpha * d
        v = (1 - self.alpha) * (v + self.alpha * d * d)
        self.mean[host], self.var[host] = m, v
        self.n[host] = self.n.get(host, 0) + 1

    def fleet_stats(self) -> Tuple[float, float]:
        """Robust location/scale (median + scaled MAD): a straggler must
        not contaminate the statistics used to flag it."""
        ms = sorted(m for h, m in self.mean.items()
                    if self.n.get(h, 0) >= self.min_samples)
        if not ms:
            return 0.0, 0.0
        med = ms[len(ms) // 2]
        mad = sorted(abs(x - med) for x in ms)[len(ms) // 2]
        return med, 1.4826 * mad

    def stragglers(self) -> List[int]:
        med, sd = self.fleet_stats()
        if med <= 0:
            return []
        floor = 0.05 * med  # guard against zero-variance fleets
        return [h for h, m in self.mean.items()
                if self.n.get(h, 0) >= self.min_samples
                and m > med + self.k_sigma * max(sd, floor)]


# ---------------------------------------------------------------------------
# Heartbeat watchdog
# ---------------------------------------------------------------------------


class Watchdog:
    """Deadline-based hang detection: the training loop calls
    ``beat(step)``; anyone can ask ``stalled()``.  No threads — the check
    is pulled from the supervisory loop (or a cron on a real cluster)."""

    def __init__(self, timeout_s: float = 300.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = clock()
        self.last_step = -1

    def beat(self, step: int):
        self._last = self._clock()
        self.last_step = step

    def stalled(self) -> bool:
        return (self._clock() - self._last) > self.timeout_s


# ---------------------------------------------------------------------------
# Elastic mesh planning
# ---------------------------------------------------------------------------


def plan_elastic_mesh(n_devices: int, model_parallel: int = 16,
                      pod_size: int = 256) -> Tuple[Tuple[int, ...],
                                                    Tuple[str, ...]]:
    """Largest usable (pod, data, model) grid from surviving devices.

    Keeps the model axis intact (TP degree is a property of the sharded
    weights' layout), shrinks data/pod: after losing nodes we drop to the
    largest data multiple that still divides the fleet.  Returns
    (shape, axis_names).
    """
    if n_devices < model_parallel:
        # degenerate fleet: single-axis data mesh
        return (n_devices, 1), ("data", "model")
    usable_pods = n_devices // pod_size
    if usable_pods >= 2:
        data = pod_size // model_parallel
        return (usable_pods, data, model_parallel), ("pod", "data", "model")
    data = n_devices // model_parallel
    return (data, model_parallel), ("data", "model")


# ---------------------------------------------------------------------------
# Failure injection (tests / chaos drills)
# ---------------------------------------------------------------------------


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically kill the training loop at `fail_at_step` (once)."""

    fail_at_step: int = -1
    fired: bool = False

    def maybe_fail(self, step: int):
        if not self.fired and 0 <= self.fail_at_step == step:
            self.fired = True
            raise InjectedFailure(f"injected failure at step {step}")
