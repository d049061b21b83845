#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (each one failing makes the script exit non-zero):

  0. the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` and print the build time and what
     ptxas reports;
  1. each kernel against its plain PyTorch version on the card:
     ``rfr_forest_apply`` with the Jiagu world's forest and random
     forests of 64 trees at depth 8 and 10 (the global-memory path) at
     N = 1, 255, 256, 257, 200000 (max abs error <= 1e-6 on predictions
     around 1 — an f32 mean of at most 64 leaves — and bitwise equal to
     the numpy host oracle); ``rfr_capacity_sweep`` exactly equal, both
     ``log_target`` values, random +-inf bounds, M = 16 and 40; each
     timed with CUDA events (median of 20) beside its plain version;
  2. a capacity drain over 4,096 nodes from a 24-pattern pool
     (m_max = 16): the device drain on the CUDA kernel and the host
     drain on numpy must give identical capacity tables;
  3. the main path: burst-storm, 24 functions, 180 s, 1,024 target
     nodes, seed 0, the Jiagu scheduler, run (a) on the numpy engine
     with the host drain (the oracle), (b) on the CUDA engine with the
     host drain, (c) on the CUDA engine with the device drain.  (b) and
     (c) must equal (a) in every outcome that does not read the wall
     clock, and each kernel must have launched during its run;
  4. one JSON line describing both kernels, then the device line.

Exits non-zero and prints no result when there is no CUDA card or the
port is not beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/rfr_inference.cu"
#: the TPU kernels these replace (def lines)
REPLACES = {"rfr_forest_apply": "src/repro/kernels/rfr_inference.py:72",
            "rfr_capacity_sweep": "src/repro/kernels/rfr_inference.py:130"}
#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PRED_TOL = 1e-6
SCENARIO = dict(n_functions=24, duration_s=180, target_nodes=1024, seed=0)
DRAIN_NODES = 4096
DRAIN_M_MAX = 16
N_PATTERNS = 24


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise PhaseFailed(what)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def forest_bytes(feat) -> int:
    t, nn = feat.shape
    return t * nn * 8 + t * (nn + 1) * 4


def bound(nbytes: float, ops: float):
    """Least time on an H100 SXM, ms, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forest_bound(n: int, f: int, feat):
    t, nn = feat.shape
    depth = (nn + 1).bit_length() - 1
    # inputs read once, output written once; per (row, tree) D compares
    # and one add, per row one divide
    return bound(n * f * 4 + forest_bytes(feat) + n * 4,
                 n * t * (depth + 1) + n)


def sweep_bound(shape, feat, log_target: bool):
    s, m, r, f = shape
    t, nn = feat.shape
    depth = (nn + 1).bit_length() - 1
    rows = s * m * r
    per_row = t * (depth + 1) + 1 + 1 + (1 if log_target else 0)
    return bound(rows * f * 4 + rows * 4 + forest_bytes(feat) + s * 4,
                 rows * per_row)


def hold_forest(x, feat, thr, leaf):
    """rfr_forest_apply against its plain version on these inputs, and
    both timed: (max abs error, kernel ms, plain ms, bound ms, bound by)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_forest_apply
    got = rfr_forest_apply(x, feat, thr, leaf)
    plain = ref.rfr_forest_ref(x, feat, thr, leaf)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err <= PRED_TOL, f"rfr_forest_apply N={x.shape[0]}: {err}")
    return (err, time_ms(lambda: rfr_forest_apply(x, feat, thr, leaf)),
            time_ms(lambda: ref.rfr_forest_ref(x, feat, thr, leaf)),
            *forest_bound(x.shape[0], x.shape[1], feat))


def hold_sweep(x, bounds, feat, thr, leaf, log_target):
    """rfr_capacity_sweep against its plain version (exactly) on these
    inputs, and both timed, as ``hold_forest``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_capacity_sweep
    args = (x, bounds, feat, thr, leaf)
    got = rfr_capacity_sweep(*args, log_target=log_target)
    plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err == 0, f"rfr_capacity_sweep {tuple(x.shape)}: {err}")
    return (err,
            time_ms(lambda: rfr_capacity_sweep(*args,
                                               log_target=log_target)),
            time_ms(lambda: ref.rfr_capacity_sweep_ref(
                *args, log_target=log_target)),
            *sweep_bound(tuple(x.shape), feat, log_target))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def outcome(res, sim) -> dict:
    """Every outcome of a run that does not read the wall clock."""
    s, c = res.sched, res.scaling
    return {
        "density": res.density,
        "qos_violation_rate": res.qos_violation_rate,
        "requests": res.requests,
        "violated_requests": res.violated_requests,
        "nodes_peak": res.nodes_peak,
        "sched": (s.decisions, s.fast, s.slow, s.failed, s.instances_placed),
        "scaling": (c.real_cold_starts, c.logical_cold_starts, c.releases,
                    c.evictions, c.migrations),
        # node ids come from a process-wide counter: compare in id order
        "tables": [sorted((fn, e.capacity)
                          for fn, e in sim.cluster.nodes[i].table.items())
                   for i in sorted(sim.cluster.nodes)],
    }


def device_drain_jiagu(ctx):
    """Jiagu with a device-drain PredictionService already attached (the
    Simulation keeps a service it finds instead of attaching its own)."""
    import repro_torch.core as core
    sched = core.JiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                                ctx.predictor, m_max=ctx.m_max)
    sched.attach_service(core.PredictionService(
        ctx.predictor, ctx.store, ctx.qos, ctx.specs,
        core.EngineConfig(m_max=ctx.m_max, retrain_every=ctx.retrain_every,
                          learned_shape_margin=ctx.learned_shape_margin,
                          drain="device"),
        schema=ctx.schema_version))
    return sched


class Recorder:
    """Keeps the largest inputs each kernel wrapper was given, so the
    kernels can be checked and timed at the shapes the main path used.
    Wraps the names ``kernels.ops`` calls; the wrappers still count their
    own launches."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = (ops.rfr_forest_apply, ops.rfr_capacity_sweep)
        self.forest = None      # (x, feat, thr, leaf)
        self.sweep = None       # (x, bounds, feat, thr, leaf, log_target)
        self.forest_calls = []
        self.sweep_calls = []
        apply_fn, sweep_fn = self.orig

        def rec_apply(x, feat, thr, leaf):
            self.forest_calls.append(x.shape[0])
            if x.is_cuda and (self.forest is None
                              or x.shape[0] > self.forest[0].shape[0]):
                self.forest = (x.clone(), feat, thr, leaf)
            return apply_fn(x, feat, thr, leaf)

        def rec_sweep(x, bounds, feat, thr, leaf, *, log_target=False):
            self.sweep_calls.append(tuple(x.shape))
            if x.is_cuda and (self.sweep is None
                              or x.numel() > self.sweep[0].numel()):
                self.sweep = (x.clone(), bounds.clone(), feat, thr, leaf,
                              log_target)
            return sweep_fn(x, bounds, feat, thr, leaf,
                            log_target=log_target)

        ops.rfr_forest_apply, ops.rfr_capacity_sweep = rec_apply, rec_sweep

    def close(self):
        self.ops.rfr_forest_apply, self.ops.rfr_capacity_sweep = self.orig


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase0 build: {time.perf_counter() - t0:.2f} s "
          f"(compiled: {built or 'none, cached'})")
    for line in _build.build_log("rfr_inference").splitlines():
        if "Used" in line or "spill" in line:
            print(f"phase0 ptxas: {line.strip()}")
    _build.load("rfr_inference")


def _random_forest(rng, t, depth, f):
    nn = (1 << depth) - 1
    return (rng.integers(0, f, (t, nn)).astype("int32"),
            rng.standard_normal((t, nn)).astype("float32"),
            rng.standard_normal((t, nn + 1)).astype("float32"))


def phase1_kernels(world):
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                                   rfr_forest_apply)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = world.predictor.model.arrays
    X_world, _ = world.predictor.dataset()
    forests = [("world T=24 D=8", (a.feat, a.thr, a.leaf), X_world.shape[1]),
               ("random T=64 D=8", _random_forest(rng, 64, 8, 31), 31),
               ("random T=64 D=10", _random_forest(rng, 64, 10, 31), 31)]
    timings = {}
    for name, arrays, f in forests:
        oracle = core.RandomForestRegressor(device=dev).load_arrays(*arrays)
        fo = oracle.device_arrays()
        for n in (1, 255, 256, 257, 200_000):
            if name.startswith("world"):
                x = X_world[rng.integers(0, len(X_world), n)]
            else:
                x = rng.standard_normal((n, f)).astype(np.float32)
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            got = rfr_forest_apply(xt, *fo)
            plain = ref.rfr_forest_ref(xt, *fo)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            bitwise = np.array_equal(got.cpu().numpy(),
                                     oracle.predict(x, engine="numpy"))
            print(f"phase1 rfr_forest_apply {name} N={n}: max_abs_err="
                  f"{err:.3g} numpy_bitwise={bitwise}")
            check(err <= PRED_TOL, f"rfr_forest_apply {name} N={n}: {err}")
            check(bitwise, f"rfr_forest_apply {name} N={n} != numpy")
            if n == 200_000:
                k = time_ms(lambda: rfr_forest_apply(xt, *fo))
                p = time_ms(lambda: ref.rfr_forest_ref(xt, *fo))
                b, by = forest_bound(n, f, fo[0])
                timings[f"rfr_forest_apply {name} N={n}"] = (k, p, b, by)

    world_fo = core.RandomForestRegressor(device=dev).load_arrays(
        a.feat, a.thr, a.leaf).device_arrays()
    for m in (16, 40):
        s, r, f = 1000, 4, X_world.shape[1]
        x = X_world[rng.integers(0, len(X_world), s * m * r)]
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        pred = ref.rfr_forest_ref(xt, *world_fo).cpu().numpy()
        for log_target in (False, True):
            p = np.exp(pred) if log_target else pred
            bounds = (p * rng.uniform(0.97, 1.03, p.shape)).astype(
                np.float32).reshape(s, m, r)
            for i in range(s):
                bounds[i, :, int(rng.integers(1, r + 1)):] = np.inf
                bounds[i, int(rng.integers(0, m + 1)):, :] = -np.inf
            xs = xt.reshape(s, m, r, f)
            bt = torch.from_numpy(bounds).to(dev)
            got = rfr_capacity_sweep(xs, bt, *world_fo,
                                     log_target=log_target)
            plain = ref.rfr_capacity_sweep_ref(xs, bt, *world_fo,
                                               log_target=log_target)
            torch.cuda.synchronize()
            same = torch.equal(got, plain)
            print(f"phase1 rfr_capacity_sweep world S={s} M={m} R={r} "
                  f"log_target={log_target}: equal={same} "
                  f"mean_capacity={float(got.float().mean()):.3f}")
            check(same, f"rfr_capacity_sweep M={m} log={log_target}")
            if m == 16 and log_target:
                k = time_ms(lambda: rfr_capacity_sweep(
                    xs, bt, *world_fo, log_target=True))
                pl = time_ms(lambda: ref.rfr_capacity_sweep_ref(
                    xs, bt, *world_fo, log_target=True))
                b, by = sweep_bound(tuple(xs.shape), world_fo[0], True)
                timings[f"rfr_capacity_sweep world S={s} M={m} R={r}"] = (
                    k, pl, b, by)
    for key, (k, p, b, by) in timings.items():
        print(f"phase1 time {key}: kernel {k:.4f} ms, plain {p:.4f} ms, "
              f"bound {b:.5f} ms ({by})")


def _pattern_nodes(specs, n_nodes: int, seed: int):
    """Nodes drawn from a fixed pool of colocation patterns, as a fleet
    of a few dozen archetypes looks."""
    import numpy as np
    from repro_torch.core.cluster import Node
    from repro_torch.core.interference import NodeResources
    rng = np.random.default_rng(seed)
    names = sorted(specs)
    pool = []
    for _ in range(N_PATTERNS):
        pat = {}
        for g in rng.choice(names, size=int(rng.integers(1, 4)),
                            replace=False):
            pat[g] = (int(rng.integers(1, 6)), int(rng.integers(0, 3)))
        pool.append(pat)
    nodes = []
    for _ in range(n_nodes):
        node = Node(NodeResources())
        for g, (ns, nc) in pool[rng.integers(len(pool))].items():
            node.state(g).n_sat = ns
            node.state(g).n_cached = nc
        nodes.append(node)
    return nodes


def phase2_drain(world):
    import torch
    import repro_torch.core as core

    def tables(nodes):
        out = [sorted((fn, e.capacity) for fn, e in n.table.items())
               for n in nodes]
        for n in nodes:
            n.table.clear()
        return out

    nodes = _pattern_nodes(world.scenario.specs, DRAIN_NODES, DRAIN_NODES)
    args = (world.predictor, world.store, world.qos, world.scenario.specs)
    host = core.PredictionService(*args, core.EngineConfig(m_max=DRAIN_M_MAX),
                                  engine="numpy")
    t0 = time.perf_counter()
    host.update_nodes(nodes)
    host_s = time.perf_counter() - t0
    want = tables(nodes)
    dev = core.PredictionService(
        *args, core.EngineConfig(m_max=DRAIN_M_MAX, drain="device"),
        engine="cuda")
    rec = Recorder()
    try:
        t0 = time.perf_counter()
        dev.update_nodes(nodes)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    finally:
        rec.close()
    got = tables(nodes)
    st = dev.stats
    print(f"phase2 drain {DRAIN_NODES} nodes m_max={DRAIN_M_MAX}: "
          f"S={st.unique_solves} rows={st.rows_built} "
          f"device {dev_s * 1e3:.2f} ms, numpy host {host_s * 1e3:.2f} ms "
          f"(host rows {host.stats.rows_built}), tables_equal={got == want}")
    check(got == want, "phase 2: device-drain tables differ from numpy")
    check(rec.sweep is not None, "phase 2 never reached the sweep kernel")
    _err, k, p, b, by = hold_sweep(*rec.sweep)
    print(f"phase2 time rfr_capacity_sweep {tuple(rec.sweep[0].shape)}: "
          f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {b:.6f} ms ({by})")


def _main_path_sim(label: str, engine: str, drain: str):
    """A fresh world (the ground truth's noise RNG is stateful) and the
    main path's Simulation on it; returns (sim, world build seconds)."""
    import repro_torch.core as core
    scn = core.make_scenario("burst-storm", **SCENARIO)
    t0 = time.perf_counter()
    world = core.scenario_world(scn, engine=engine)
    build_s = time.perf_counter() - t0
    name = "jiagu" if drain == "host" else "jiagu-device-drain"
    sim = core.scenario_simulation(scn, name, world=world)
    check(sim.scheduler.prediction_service.cfg.drain == drain,
          f"run {label}: service drain is not {drain}")
    return sim, build_s


def _run(label: str, engine: str, drain: str):
    import torch
    from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                                   rfr_forest_apply,
                                                   reset_launches)
    sim, build_s = _main_path_sim(label, engine, drain)
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rfr_forest_apply": rfr_forest_apply.launches,
                "rfr_capacity_sweep": rfr_capacity_sweep.launches}
    out = outcome(res, sim)
    print(f"phase3 run ({label}) engine={engine} drain={drain}: world "
          f"{build_s:.2f} s, run {run_s:.2f} s, density "
          f"{out['density']!r}, qos_violation_rate "
          f"{out['qos_violation_rate']!r}, nodes_peak {out['nodes_peak']}, "
          f"sched {out['sched']}, scaling {out['scaling']}, inference "
          f"calls {res.inference_calls} rows {res.inference_rows}, "
          f"mean_inference_ms {res.mean_inference_ms:.4f}, "
          f"launches {launches}")
    return out, launches


def phase3_main_path():
    import repro_torch.core as core
    core.register_scheduler("jiagu-device-drain", device_drain_jiagu,
                            needs_predictor=True, dual_staged_default=True,
                            overwrite=True)
    oracle, _ = _run("a", "numpy", "host")
    rec = Recorder()
    try:
        host_cuda, l_b = _run("b", "cuda", "host")
        dev_cuda, l_c = _run("c", "cuda", "device")
    finally:
        rec.close()
    for label, got in (("b", host_cuda), ("c", dev_cuda)):
        diff = [k for k in oracle if got[k] != oracle[k]]
        n_tables = sum(x != y for x, y in zip(got["tables"],
                                               oracle["tables"]))
        print(f"phase3 run ({label}) vs oracle (a): differing fields "
              f"{diff or 'none'}; nodes with differing tables {n_tables} "
              f"of {len(oracle['tables'])}")
        check(not diff, f"run ({label}) differs from the oracle in {diff}")
    check(l_b["rfr_forest_apply"] > 0, "run (b) never launched the forest "
          "kernel")
    check(l_c["rfr_capacity_sweep"] > 0, "run (c) never launched the sweep "
          "kernel")
    fc = sorted(rec.forest_calls)
    sc = rec.sweep_calls
    print(f"phase3 shapes: forest calls {len(fc)}, N median "
          f"{fc[len(fc) // 2] if fc else 0} max {fc[-1] if fc else 0}; "
          f"sweep calls {len(sc)}, largest {max(sc, key=lambda s: s[0] * s[1] * s[2]) if sc else None}")
    return rec, l_b, l_c


def device_share(label: str, engine: str, drain: str):
    """The main path once more under torch.profiler, device activity
    only: the device's busy time (kernels and copies, from CUPTI) over
    the run's wall time, and the largest device entries.  A measurement
    only; prints "not measured" when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim, _ = _main_path_sim(label, engine, drain)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    if busy_s <= 0:
        print(f"phase3 device ({label}): busy share not measured (the "
              "profiler recorded no device time)")
        return
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    print(f"phase3 device ({label}) engine={engine} drain={drain}, "
          f"profiled run {wall:.2f} s: device busy {busy_s:.4f} s, idle "
          f"share {1 - busy_s / wall:.4f}; largest: " + "; ".join(
              f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f}"
              f" ms" for e in top))


def main_path_kernels(rec, l_b, l_c):
    """Both kernels against their plain versions on the largest inputs
    the main path gave them, timed; the kernels JSON entries.  The
    forest kernel is also timed at the median call's row count."""
    check(rec.forest is not None and rec.sweep is not None,
          "main path left no kernel inputs on the card")
    x, feat, thr, leaf = rec.forest
    err_f, ms_f, pms_f, b_f, by_f = hold_forest(x, feat, thr, leaf)
    n_med = sorted(rec.forest_calls)[len(rec.forest_calls) // 2]
    _e, ms_m, pms_m, b_m, _by = hold_forest(x[:n_med], feat, thr, leaf)
    xs = rec.sweep[0]
    err_s, ms_s, pms_s, b_s, by_s = hold_sweep(*rec.sweep)
    print(f"main-path shapes: rfr_forest_apply N={x.shape[0]} F="
          f"{x.shape[1]}: kernel {ms_f:.4f} ms, plain {pms_f:.4f} ms, "
          f"bound {b_f:.6f} ms; median call N={n_med}: kernel {ms_m:.4f} "
          f"ms, plain {pms_m:.4f} ms, bound {b_m:.6f} ms; "
          f"rfr_capacity_sweep {tuple(xs.shape)}: kernel {ms_s:.4f} ms, "
          f"plain {pms_s:.4f} ms, bound {b_s:.6f} ms")
    return [
        {"name": "rfr_forest_apply", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_forest_apply"],
         "launches": l_b["rfr_forest_apply"], "max_abs_err": err_f,
         "ms": ms_f, "plain_ms": pms_f, "bound_ms": b_f, "bound_by": by_f,
         "library_ms": None, "shape": list(x.shape)},
        {"name": "rfr_capacity_sweep", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_capacity_sweep"],
         "launches": l_c["rfr_capacity_sweep"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": pms_s, "bound_ms": b_s, "bound_by": by_s,
         "library_ms": None, "shape": list(xs.shape)},
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core as core
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    try:
        phase0_build()
        scn = core.make_scenario("burst-storm", **SCENARIO)
        world = core.scenario_world(scn, engine="numpy")
        phase1_kernels(world)
        phase2_drain(world)
        rec, l_b, l_c = phase3_main_path()
        kernels = main_path_kernels(rec, l_b, l_c)
        device_share("b", "cuda", "host")
        device_share("c", "cuda", "device")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
