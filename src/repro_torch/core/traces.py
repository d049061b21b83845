"""Invocation traces (paper §7.1) and the large-cluster scenario programs.

Four generated "real-world-like" trace sets with the statistical shape of
the Huawei Cloud production traces described in the paper and in SHEPHERD/
Azure analyses: diurnal base + random-walk drift + Poisson bursts + quiet
valleys; per-minute CV is high (short-interval unpredictability) while the
long-horizon pattern is moderate — exactly the regime where prewarming
prediction fails and dual-staged scaling wins.

Also the two extreme traces of §7.2: ``timer`` (fixed-frequency single
function — best case, all fast path) and ``flip`` (concurrency oscillates
0 <-> 1 — worst case, every schedule is a slow path).

Beyond the paper's four same-shaped sets, the large-cluster scenario suite
(``repro.core.scenarios``) draws on four additional regimes:

  * ``burst_storm_trace``   — correlated cross-function spikes: global
    storm events hit a random coherent subset of functions at once, the
    flash-crowd case where per-function prewarming prediction is blind.
  * ``diurnal_shift_trace`` — regional peak migration: functions belong
    to regions whose diurnal peaks drift across the trace, so yesterday's
    placement is always stale.
  * ``coldstart_churn_trace`` — heavy-tailed on/off churn (Pareto gaps):
    functions sit idle past any keep-alive horizon, then burst — the
    cold-start-dominated long tail.
  * ``azure_sparse_trace``  — Azure-Functions-like population: a few hot
    functions carry most load while a Zipf long tail is invoked sparsely
    (most functions see well under one request per minute).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .registry import Registry


@dataclass
class Trace:
    """Per-function RPS time series at 1 s resolution."""

    name: str
    rps: Dict[str, np.ndarray]   # function name -> (T,) float array
    duration_s: int

    def at(self, fn: str, t: int) -> float:
        """RPS of `fn` at second `t`; out-of-range `t` clamps to the
        trace's first/last second, unknown functions raise KeyError."""
        if fn not in self.rps:
            raise KeyError(
                f"function {fn!r} not in trace {self.name!r} "
                f"(has {sorted(self.rps)})")
        return float(self.rps[fn][min(max(t, 0), self.duration_s - 1)])


def realworld_trace(fn_names: List[str], duration_s: int = 3600,
                    seed: int = 0, scale_rps: Dict[str, float] | None = None,
                    name: str | None = None) -> Trace:
    """One trace set: each function gets an independent pattern whose mean
    concurrency varies between ~1 and ~20 instances."""
    rng = np.random.default_rng(seed)
    t = np.arange(duration_s, dtype=np.float64)
    out = {}
    for i, fn in enumerate(fn_names):
        base = rng.uniform(0.3, 1.0)
        period = rng.uniform(900, 2400)
        phase = rng.uniform(0, 2 * math.pi)
        diurnal = 0.5 * (1 + np.sin(2 * math.pi * t / period + phase))
        # random-walk drift, smoothed
        steps = rng.normal(0, 0.04, duration_s)
        walk = np.cumsum(steps)
        walk = (walk - walk.min()) / max(float(np.ptp(walk)), 1e-9)
        # bursts: Poisson arrivals of 30-120 s spikes, 2-6x amplitude
        burst = np.zeros(duration_s)
        n_bursts = rng.poisson(duration_s / 600)
        for _ in range(n_bursts):
            s = rng.integers(0, duration_s)
            w = int(rng.uniform(30, 120))
            amp = rng.uniform(1.5, 5.0)
            e = min(s + w, duration_s)
            ramp = np.linspace(1, 0, e - s) ** 0.5
            burst[s:e] = np.maximum(burst[s:e], amp * ramp)
        # quiet valleys (load -> near zero)
        quiet = np.ones(duration_s)
        for _ in range(rng.poisson(duration_s / 1200)):
            s = rng.integers(0, duration_s)
            w = int(rng.uniform(60, 240))
            quiet[s:min(s + w, duration_s)] = rng.uniform(0.02, 0.15)
        shape = (0.35 * diurnal + 0.35 * walk + 0.3 * base) * (1 + burst)
        shape = shape * quiet
        # per-second jitter (high short-interval CV)
        shape = shape * rng.lognormal(0, 0.25, duration_s)
        peak = (scale_rps or {}).get(fn, rng.uniform(40, 400))
        out[fn] = np.clip(shape * peak, 0.0, None)
    return Trace(name or f"trace-seed{seed}", out, duration_s)


def realworld_suite(fn_names: List[str], duration_s: int = 3600,
                    n_traces: int = 4) -> List[Trace]:
    """The paper's four real-world trace sets (different regions/seeds)."""
    return [realworld_trace(fn_names, duration_s, seed=100 + 7 * i,
                            name=f"Trace {chr(65 + i)}")
            for i in range(n_traces)]


def timer_trace(fn: str, duration_s: int = 600, period_s: int = 60,
                rps_per_inst: float = 20.0, n_inst: int = 4) -> Trace:
    """Best case (§7.2): one function scaled at a fixed frequency —
    alternates between n_inst and n_inst+2 instances every period."""
    rps = np.zeros(duration_s)
    for t in range(duration_s):
        k = (t // period_s) % 2
        rps[t] = rps_per_inst * (n_inst + 2 * k) * 0.95
    return Trace("timer", {fn: rps}, duration_s)


def burst_storm_trace(fn_names: List[str], duration_s: int = 3600,
                      seed: int = 0, scale_rps: Dict[str, float] | None = None,
                      storms_per_hour: float = 10.0, coherence: float = 0.6,
                      name: str | None = None) -> Trace:
    """Correlated cross-function spike storms.

    A quiet per-function base load is punctured by cluster-wide storm
    events at Poisson times; each storm recruits a random ``coherence``
    fraction of the population simultaneously with a 3-8x spike.  Unlike
    ``realworld_trace`` (independent per-function bursts), the spikes are
    *correlated*, so the scheduler faces synchronized scale-up demand —
    the flash-crowd regime where short-interval prediction fails.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(duration_s, dtype=np.float64)
    base = {}
    for fn in fn_names:
        level = rng.uniform(0.15, 0.45)
        period = rng.uniform(1200, 3000)
        phase = rng.uniform(0, 2 * math.pi)
        base[fn] = level * (0.8 + 0.2 * np.sin(2 * math.pi * t / period
                                               + phase))
    n_storms = max(1, int(rng.poisson(storms_per_hour * duration_s / 3600)))
    storm = {fn: np.zeros(duration_s) for fn in fn_names}
    for _ in range(n_storms):
        s = int(rng.integers(0, duration_s))
        w = int(rng.uniform(20, 90))
        e = min(s + w, duration_s)
        amp = rng.uniform(3.0, 8.0)
        envelope = amp * np.linspace(1, 0, e - s) ** 0.7
        hit = rng.random(len(fn_names)) < coherence
        if not hit.any():
            hit[rng.integers(len(fn_names))] = True
        for fn, h in zip(fn_names, hit):
            if h:
                storm[fn][s:e] = np.maximum(storm[fn][s:e], envelope)
    out = {}
    for fn in fn_names:
        shape = base[fn] * (1 + storm[fn])
        shape = shape * rng.lognormal(0, 0.2, duration_s)
        peak = (scale_rps or {}).get(fn, rng.uniform(40, 400))
        out[fn] = np.clip(shape * peak, 0.0, None)
    return Trace(name or f"burst-storm-seed{seed}", out, duration_s)


def diurnal_shift_trace(fn_names: List[str], duration_s: int = 3600,
                        seed: int = 0,
                        scale_rps: Dict[str, float] | None = None,
                        n_regions: int = 3, period_s: float = 1800.0,
                        shift_frac: float = 1.0,
                        name: str | None = None) -> Trace:
    """Regional peak migration.

    Functions are assigned round-robin to ``n_regions`` regions whose
    diurnal peaks start out of phase and *drift* by ``shift_frac`` full
    periods over the trace (peak time migrating between regions, the
    follow-the-sun load pattern).  Placement tuned for one region's peak
    is systematically wrong an hour later.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(duration_s, dtype=np.float64)
    n_regions = max(1, min(n_regions, len(fn_names)))
    # drifting phase: peak center moves shift_frac periods over the trace
    drift = 2 * math.pi * shift_frac * t / max(duration_s, 1)
    regional = []
    for r in range(n_regions):
        phase0 = 2 * math.pi * r / n_regions
        act = np.sin(2 * math.pi * t / period_s + phase0 + drift)
        # sharpen into a peaked activity bump, floor at a quiet baseline
        regional.append(0.08 + np.maximum(act, 0.0) ** 2)
    out = {}
    for i, fn in enumerate(fn_names):
        shape = regional[i % n_regions] * rng.uniform(0.8, 1.2)
        shape = shape * rng.lognormal(0, 0.15, duration_s)
        peak = (scale_rps or {}).get(fn, rng.uniform(40, 400))
        out[fn] = np.clip(shape * peak, 0.0, None)
    return Trace(name or f"diurnal-shift-seed{seed}", out, duration_s)


def coldstart_churn_trace(fn_names: List[str], duration_s: int = 3600,
                          seed: int = 0,
                          scale_rps: Dict[str, float] | None = None,
                          pareto_shape: float = 1.1, off_min_s: float = 30.0,
                          on_s: Tuple[float, float] = (5.0, 30.0),
                          name: str | None = None) -> Trace:
    """Heavy-tailed on/off churn — the cold-start-dominated regime.

    Each function alternates OFF gaps drawn from a Pareto distribution
    (shape ~1.1: infinite-variance heavy tail, so many gaps outlast any
    keep-alive window) and short ON bursts at a one-to-few-instance load.
    Capacity-table entries and cached instances are constantly evicted
    before the next arrival — sustained slow-path and cold-start pressure.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for fn in fn_names:
        series = np.zeros(duration_s)
        level = rng.uniform(0.6, 1.4)
        t = float(rng.uniform(0, off_min_s))   # staggered first burst
        while t < duration_s:
            w = rng.uniform(*on_s)
            s, e = int(t), min(int(t + w), duration_s)
            series[s:e] = level * rng.uniform(0.7, 1.3)
            t += w
            t += off_min_s * float(rng.pareto(pareto_shape) + 1.0)
        peak = (scale_rps or {}).get(fn, rng.uniform(10, 60))
        out[fn] = np.clip(series * peak, 0.0, None)
    return Trace(name or f"coldstart-churn-seed{seed}", out, duration_s)


def azure_sparse_trace(fn_names: List[str], duration_s: int = 3600,
                       seed: int = 0,
                       scale_rps: Dict[str, float] | None = None,
                       hot_frac: float = 0.1, zipf_s: float = 1.5,
                       name: str | None = None) -> Trace:
    """Azure-Functions-like sparse-invocation long tail.

    A ``hot_frac`` head of the population carries smooth diurnal load;
    the remaining tail is invoked sparsely — isolated few-second episodes
    at Poisson times whose rates follow a Zipf law over the tail ranks,
    so most tail functions see well under one invocation per minute and
    their per-second series is almost entirely zero.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(duration_s, dtype=np.float64)
    n_hot = max(1, int(round(hot_frac * len(fn_names))))
    out = {}
    for i, fn in enumerate(fn_names):
        if i < n_hot:
            period = rng.uniform(1500, 3600)
            phase = rng.uniform(0, 2 * math.pi)
            shape = (0.45 + 0.35 * np.sin(2 * math.pi * t / period + phase)
                     ) * rng.lognormal(0, 0.2, duration_s)
            peak = (scale_rps or {}).get(fn, rng.uniform(80, 400))
            out[fn] = np.clip(shape * peak, 0.0, None)
            continue
        rank = i - n_hot + 1
        # mean invocation episodes per hour, Zipf-decaying down the tail
        rate_per_hour = 30.0 / rank ** zipf_s + 0.2
        series = np.zeros(duration_s)
        n_events = rng.poisson(rate_per_hour * duration_s / 3600)
        peak = (scale_rps or {}).get(fn, rng.uniform(3, 15))
        for _ in range(n_events):
            s = int(rng.integers(0, duration_s))
            e = min(s + int(rng.uniform(2, 8)), duration_s)
            series[s:e] = peak * rng.uniform(0.5, 1.0)
        out[fn] = series
    return Trace(name or f"azure-sparse-seed{seed}", out, duration_s)


def replay_trace(path, name: str | None = None,
                 duration_s: int | None = None) -> Trace:
    """Replay a real invocation dump behind the same ``Trace`` interface.

    Reads an Azure/Huawei-style CSV with ``fn,timestamp,rps`` rows
    (timestamp in seconds, absolute or relative; a header line and
    ``#`` comments are skipped).  Timestamps are normalized to the
    earliest entry and bucketed at 1 s resolution; multiple records of
    one function landing in the same second accumulate.  Functions keep
    zero RPS outside their recorded entries, exactly like the sparse
    generated traces.
    """
    import os
    entries: List[Tuple[str, float, float]] = []
    first_data_line = True
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 3:
                raise ValueError(
                    f"{path}:{i + 1}: expected 'fn,timestamp,rps', "
                    f"got {line!r}")
            try:
                ts, rps = float(parts[1]), float(parts[2])
            except ValueError:
                if first_data_line:      # tolerated header line (only)
                    first_data_line = False
                    continue
                raise ValueError(
                    f"{path}:{i + 1}: non-numeric timestamp/rps "
                    f"in {line!r}")
            first_data_line = False
            if not (math.isfinite(ts) and math.isfinite(rps)):
                raise ValueError(
                    f"{path}:{i + 1}: non-finite timestamp/rps "
                    f"in {line!r}")
            if rps < 0:
                raise ValueError(f"{path}:{i + 1}: negative rps {rps}")
            entries.append((parts[0], ts, rps))
    if not entries:
        raise ValueError(f"{path}: no trace entries")
    t0 = math.floor(min(ts for _, ts, _r in entries))
    T = duration_s or int(math.floor(max(ts for _, ts, _r in entries)
                                     - t0)) + 1
    out: Dict[str, np.ndarray] = {}
    for fn, ts, rps in entries:
        series = out.setdefault(fn, np.zeros(T))
        sec = int(ts - t0)
        if 0 <= sec < T:
            series[sec] += rps
    return Trace(name or os.path.splitext(os.path.basename(str(path)))[0],
                 out, T)


# ---------------------------------------------------------------------------
# Trace registry (the repro.platform name-based component selection)
# ---------------------------------------------------------------------------

_TRACES = Registry("trace")


def register_trace(name: str, builder=None, *, overwrite: bool = False):
    """Register a trace generator under ``name`` so benchmarks and
    examples select it by string.  Usable as a decorator:
    ``@register_trace("my-trace")``."""
    return _TRACES.register(name, builder, overwrite=overwrite)


def get_trace(name: str):
    return _TRACES.get(name)


def registered_traces() -> List[str]:
    return _TRACES.names()


def flip_trace(fns: List[str], duration_s: int = 600,
               period_s: int = 30, rps: float = 5.0) -> Trace:
    """Worst case (§7.2): each function's concurrency flips 0 <-> 1 so the
    capacity-table entry is evicted before every arrival -> all slow path.
    Functions flip out of phase so every arrival lands on a node whose
    table no longer has the entry."""
    out = {}
    for i, fn in enumerate(fns):
        series = np.zeros(duration_s)
        for t in range(duration_s):
            on = ((t + i * period_s // max(len(fns), 1)) // period_s) % 2
            series[t] = rps * on
        out[fn] = series
    return Trace("flip", out, duration_s)


for _name, _builder in (("realworld", realworld_trace),
                        ("burst-storm", burst_storm_trace),
                        ("diurnal-shift", diurnal_shift_trace),
                        ("coldstart-churn", coldstart_churn_trace),
                        ("azure-sparse", azure_sparse_trace),
                        ("timer", timer_trace),
                        ("flip", flip_trace),
                        ("replay", replay_trace)):
    register_trace(_name, _builder)
del _name, _builder
