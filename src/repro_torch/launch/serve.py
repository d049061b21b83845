"""Serving driver: Jiagu control plane over the 10 architecture serving
functions (replica scheduling simulation at cluster scale; port of
``repro.launch.serve``).  ``launch/serve_cluster.py`` serves real model
replicas under the same control plane.

  PYTHONPATH=src python -m repro_torch.launch.serve [--seconds 600] \\
      [--scheduler jiagu|gsight|owl|k8s] [--release 45] [--no-dual] \\
      [--engine cuda|torch|numpy] [--device cpu]

The predictor's inference runs on the card by default (engine ``cuda``,
the forest kernel); ``--engine torch --device cpu`` runs the kernel's
plain version on the host and ``--engine numpy`` the numpy oracle.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..core.predictor import INFERENCE_ENGINES
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=600)
    ap.add_argument("--scheduler", default="jiagu",
                    choices=["jiagu", "gsight", "owl", "k8s"])
    ap.add_argument("--release", type=float, default=45.0)
    ap.add_argument("--keepalive", type=float, default=60.0)
    ap.add_argument("--no-dual", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="cuda", choices=INFERENCE_ENGINES,
                    help="the predictor's inference engine")
    ap.add_argument("--device", default=None,
                    help="the predictor's device (default: the card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """One simulation of the trace under `args`; returns the SimResult."""
    from ..core import (Autoscaler, Cluster, GroundTruth, GsightScheduler,
                        JiaguScheduler, K8sScheduler, OwlScheduler,
                        PerfPredictor, ProfileStore, QoSStore,
                        ScalingConfig, SimConfig, Simulation,
                        arch_functions, generate_dataset, realworld_trace)

    specs = arch_functions()
    gt = GroundTruth(seed=args.seed)
    store = ProfileStore(seed=args.seed)
    qos = QoSStore(store, gt)
    pred = PerfPredictor(n_trees=24, max_depth=8, seed=args.seed,
                         engine=args.engine, device=args.device)
    X, y = generate_dataset(specs, gt, store, qos, 1500, seed=args.seed + 1)
    pred.add_dataset(X, y)

    cluster = Cluster(specs)
    sched = {"jiagu": lambda: JiaguScheduler(cluster, store, qos, pred),
             "gsight": lambda: GsightScheduler(cluster, store, qos, pred),
             "owl": lambda: OwlScheduler(cluster, store, qos),
             "k8s": lambda: K8sScheduler(cluster, store, qos)}[
        args.scheduler]()
    aut = Autoscaler(cluster, sched, ScalingConfig(
        release_s=args.release, keepalive_s=args.keepalive,
        dual_staged=not args.no_dual and args.scheduler == "jiagu"))
    trace = realworld_trace(sorted(specs), duration_s=args.seconds,
                            seed=args.seed + 7)
    sim = Simulation(specs, trace, sched, aut, gt, store, qos,
                     predictor=pred, cfg=SimConfig(collect_samples=True))
    return sim.run()


def report(args: argparse.Namespace, res) -> None:
    """The reference's four outcome lines."""
    s = res.sched
    print(f"scheduler={args.scheduler} dual={not args.no_dual}")
    print(f"density: {res.density:.2f} instances/node | QoS violations: "
          f"{100 * res.qos_violation_rate:.2f}%")
    print(f"scheduling: {s.decisions} decisions, fast={s.fast} "
          f"slow={s.slow}, mean latency {s.mean_latency_ms:.3f} ms")
    if res.scaling:
        sc = res.scaling
        print(f"scaling: {sc.real_cold_starts} real / "
              f"{sc.logical_cold_starts} logical cold starts, "
              f"{sc.releases} releases, {sc.migrations} migrations, "
              f"mean cold start {sc.mean_cold_start_ms:.2f} ms")


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    report(args, run(args))


if __name__ == "__main__":
    main()
