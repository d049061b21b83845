"""Quickstart, the port's twin of ``examples/quickstart.py``: the public
API in four steps, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

1. pick an architecture config      (repro_torch.configs)
2. train a smoke-scale variant      (repro_torch.launch.train)
3. serve it with continuous batching (repro_torch.serving)
4. schedule replicas with Jiagu     (repro_torch.core)

``run`` returns what each step printed (the losses, the served
requests, the scheduler's metrics) so that a caller can hold it.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

ARCH = "gemma2-2b"
TRAIN_STEPS = 20
N_REQUESTS = 4


def run(device=None) -> dict:
    from ..configs.base import (InputShape, get_config, get_smoke_config,
                                list_archs)
    from ..core.predictor import resolve_device
    from ..serving.engine import Request, ServingEngine
    from .train import train_loop
    dev = resolve_device(device)

    # -- 1. configs ----------------------------------------------------------
    print("assigned architectures:", ", ".join(list_archs()))
    full = get_config(ARCH)
    print(f"{ARCH}: {full.n_layers}L d={full.d_model} "
          f"params={full.param_count() / 1e9:.2f}B")
    cfg = get_smoke_config(ARCH)        # laptop-scale, same block pattern

    # -- 2. train a few steps (one device: the example's (1, 1) mesh) -------
    shape = InputShape("quickstart", 128, 4, "train")
    state, losses = train_loop(cfg, shape, steps=TRAIN_STEPS, log_every=5,
                               device=dev)
    print(f"trained {TRAIN_STEPS} steps: loss {losses[0]:.2f} -> "
          f"{losses[-1]:.2f}")

    # -- 3. serve it -----------------------------------------------------------
    eng = ServingEngine(cfg, state["params"], slots=2, max_len=128,
                        device=dev)
    eng.scale_up(2)
    rng = np.random.default_rng(0)
    for i in range(N_REQUESTS):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 16).astype(np.int32), max_new=8))
    done = eng.drain()
    print(f"served {len(done)} requests; sample completion: "
          f"{done[0].tokens}")

    # -- 4. Jiagu-schedule replicas -----------------------------------------
    from ..core import (Cluster, GroundTruth, JiaguScheduler, PerfPredictor,
                        ProfileStore, QoSStore, arch_functions,
                        generate_dataset)
    specs = arch_functions()             # one serving function per arch
    gt = GroundTruth(seed=0)
    store = ProfileStore(seed=0)
    qos = QoSStore(store, gt)
    pred = PerfPredictor(n_trees=16, max_depth=8, seed=0,
                         engine="cuda" if dev.type == "cuda" else "torch",
                         device=dev)
    X, y = generate_dataset(specs, gt, store, qos, 800, seed=1)
    pred.add_dataset(X, y)

    cluster = Cluster(specs)
    sched = JiaguScheduler(cluster, store, qos, pred)
    fn = f"serve-{ARCH}"
    sched.schedule(fn, 3, now=0.0)            # slow path: predict capacity
    sched.on_tick(1.0)                        # async capacity-table update
    placements = sched.schedule(fn, 2, now=2.0)   # fast path: table lookup
    m = sched.metrics
    print(f"scheduled 5 replicas: fast={m.fast} slow={m.slow} "
          f"mean latency {m.mean_latency_ms:.2f} ms")
    return {"losses": losses, "served": done, "placements": placements,
            "metrics": m}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
