"""Jiagu end-to-end serving: the paper's control plane scheduling REAL
model replicas (gemma2 + mamba2), driven by a fluctuating request trace
— the port's twin of ``examples/serve_cluster.py``.  Dual-staged scaling
releases/revives replicas as load moves; every completion is a real
greedy decode.

``--scenario`` swaps the default sinusoidal offered load for any
registered scenario trace program (``repro_torch.platform`` scenario
registry: correlated burst storms, migrating diurnal peaks,
heavy-tailed cold-start churn, the Azure-like sparse tail, or a
``replay`` of a real CSV dump via ``--trace-csv``), normalized to
smoke-scale request rates.

  PYTHONPATH=src python -m repro_torch.launch.serve_cluster \\
      [--seconds 60] [--scenario burst-storm] [--device cpu]
      [--scenario replay --trace-csv tests/data/sample_trace.csv]

``main`` serves the smoke configs, as the example does, on the card
unless ``--device`` names another.  ``run`` takes engines that are
already built, so a caller can serve the published configs through the
same loop.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from ..platform import get_scenario_builder, registered_scenarios

ARCHS = ("gemma2-2b", "mamba2-2.7b")
#: the example's engines: 2 replicas of 2 slots with caches of 96
SLOTS, MAX_LEN, REPLICAS = 2, 96, 2
PROMPT_LEN = 12
MAX_NEW = 4


def offered_load(scenario: str, archs, seconds: int, seed: int = 0,
                 peak: float = 3.5, **trace_kw):
    """Per-arch Poisson-rate series from a registered scenario trace
    program.

    One global normalization (the hottest arch's hottest second offers
    ``peak`` requests) so the cross-arch load skew the scenario
    generators produce is preserved; None for the default sinusoid."""
    if scenario == "sinusoid":
        return None
    gen = get_scenario_builder(scenario)
    tr = gen(list(archs), duration_s=seconds, seed=seed,
             scale_rps={a: 1.0 for a in archs}, **trace_kw)
    hi = max(float(tr.rps[a].max()) for a in archs)
    factor = peak / hi if hi > 0 else 1.0
    return {a: tr.rps[a] * factor for a in archs}


def smoke_engines(device=None):
    """The example's engines: each arch's smoke config on random weights
    from a generator seeded 0 on `device` (the card unless the caller
    names another), REPLICAS instances of SLOTS slots."""
    import torch
    from ..configs import get_smoke_config
    from ..core.predictor import resolve_device
    from ..models import model as model_lib
    from ..serving.engine import ServingEngine
    dev = resolve_device(device)
    engines = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        eng = ServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                            device=dev)
        eng.scale_up(REPLICAS)
        engines[arch] = eng
    return engines


def run(engines: Dict[str, "ServingEngine"], seconds: int,
        release_after: int, load: Optional[Dict[str, np.ndarray]],
        rng: np.random.Generator) -> Dict[str, dict]:
    """`seconds` ticks of offered load over `engines` (arch -> engine, in
    the order they are served) with the queue-pressure dual-staged loop:
    a logical start when requests queue and a cached instance exists, a
    release after `release_after` ticks of low load.  `load` is an
    ``offered_load`` series, or None for the sinusoid.  Prints a status
    line every 10 ticks and each arch's closing line; returns, per arch,
    its logical starts, releases and the served requests."""
    from ..serving.engine import Request
    rid = 0
    low_ticks = {a: 0 for a in engines}
    stats = {a: dict(logical=0, released=0) for a in engines}

    for t in range(seconds):
        for arch, eng in engines.items():
            cfg = eng.cfg
            if load is not None:
                lam = float(load[arch][t])
            else:
                # sinusoidal offered load, out of phase per arch
                lam = 1.5 + 1.4 * np.sin(t / 5.0
                                         + (0 if arch < "m" else 2.5))
            for _ in range(rng.poisson(max(lam, 0.05))):
                eng.submit(Request(rid=rid, prompt=rng.integers(
                    0, cfg.vocab_size, PROMPT_LEN).astype(np.int32),
                    max_new=MAX_NEW))
                rid += 1
            # dual-staged autoscaling on queue pressure
            busy = sum(i.n_active() for i in eng.instances.values())
            cap = eng.n_saturated() * eng.slots
            if eng.queue and eng.n_saturated() < len(eng.instances):
                got = eng.logical_start(1)       # <1 ms re-route
                stats[arch]["logical"] += got
                low_ticks[arch] = 0
            elif busy < cap // 2 and not eng.queue:
                low_ticks[arch] += 1
                if low_ticks[arch] >= release_after and \
                        eng.n_saturated() > 1:
                    eng.release(1)
                    stats[arch]["released"] += 1
                    low_ticks[arch] = 0
            else:
                low_ticks[arch] = 0
            eng.tick()
        if t % 10 == 0:
            line = " | ".join(
                f"{a}: sat={e.n_saturated()}/{len(e.instances)} "
                f"q={len(e.queue)} done={len(e.done)}"
                for a, e in engines.items())
            print(f"t={t:3d}  {line}", flush=True)

    for arch, eng in engines.items():
        done = eng.drain()
        lats = [r.latency_ms for r in done]
        p90 = float(np.percentile(lats, 90)) if lats else 0.0
        s = stats[arch]
        s["served"] = list(done)
        print(f"{arch}: {len(done)} requests served, p90 {p90:.0f} ms, "
              f"{s['released']} releases, {s['logical']} logical cold "
              f"starts (0 real cold starts after warmup)")
    return stats


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--release-after", type=int, default=6,
                    help="ticks of low load before releasing a replica")
    ap.add_argument("--scenario", default="sinusoid",
                    choices=["sinusoid"] + registered_scenarios(),
                    help="offered-load program (default: sinusoid)")
    ap.add_argument("--trace-csv", default=None,
                    help="CSV dump for --scenario replay "
                         "(fn,timestamp,rps rows)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the replicas (default: the card)")
    args = ap.parse_args(argv)
    trace_kw = {}
    if args.scenario == "replay":
        if not args.trace_csv:
            ap.error("--scenario replay requires --trace-csv")
        trace_kw["path"] = args.trace_csv

    engines = smoke_engines(args.device)
    rng = np.random.default_rng(args.seed)
    load = offered_load(args.scenario, list(engines), args.seconds,
                        seed=args.seed, **trace_kw)
    return run(engines, args.seconds, args.release_after, load, rng)


if __name__ == "__main__":
    main()
