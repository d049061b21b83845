#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (each one failing makes the script exit non-zero):

  0. the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once)
     and print the build time and what ptxas reports;
  1. each forest kernel against its plain PyTorch version on the card:
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
  3. the control plane's main path: burst-storm, 24 functions, 180 s,
     1,024 target nodes, seed 0, the Jiagu scheduler, run (a) on the
     numpy engine with the host drain (the oracle), (b) on the CUDA
     engine with the host drain, (c) on the CUDA engine with the device
     drain.  (b) and (c) must equal (a) in every outcome that does not
     read the wall clock, and each kernel must have launched during its
     run; then (b) and (c) once more under the profiler;
  4. the LM kernels against their plain versions on the card:
     ``flash_attention`` at recurrentgemma-2b's serving shapes (10 query
     heads, 1 kv head, D = 256, local window 2,048, S = 512, 1,000,
     2,048, 3,000, bf16 and f32; tolerance f32 1e-5, bf16 2e-2
     relative) and at small shapes for the global, chunked, softcap and
     non-causal masks; ``rglru_scan`` exactly equal at (1, 3000, 2560)
     with and without h0 and at (4, 1000, 2560); each timed beside its
     plain version, and attention beside ``scaled_dot_product_attention``
     with the same boolean mask;
  5. serving recurrentgemma-2b at its published width (random weights
     from a seeded generator): one ServingEngine instance, 4 slots,
     max_len 4,096, 8 requests (prompts of 512, 1,000, 2,048 and 3,000
     tokens, two each, 16 new tokens).  Every prefill must launch 8
     flash and 18 scan kernels; the same requests through the plain
     versions must give prefill logits within 2e-2 of the largest
     |logit|, and the same first token wherever the top-2 margin is
     above that;
  6. one JSON line describing all four kernels, then the device line.

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
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "rfr_inference.cu"
#: the TPU kernels these replace (def lines)
REPLACES = {"rfr_forest_apply": "src/repro/kernels/rfr_inference.py:72",
            "rfr_capacity_sweep": "src/repro/kernels/rfr_inference.py:130",
            "flash_attention": "src/repro/kernels/flash_attention.py:77",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:39"}
#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside tensor cores,
#: bf16 dense tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: flash attention against its plain version: f32 1e-5 (online against
#: materialised softmax, other summation order); bf16 2e-2 relative (the
#: kernel rounds p to bf16 before P.V, the plain version keeps it f32)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: recurrentgemma-2b's local layers: MQA, head dim 256, window 2,048
SERVE_ARCH = "recurrentgemma-2b"
SERVE_PROMPTS = (512, 1000, 2048, 3000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 4, 4096, 16
#: phase 5, kernels against plain on the whole model in bf16: the
#: prefill's last-position logits within 2e-2 of the largest |logit|,
#: and each recurrent layer's final state within 2e-2 in norm
LOGIT_TOL = 2e-2
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


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time on an H100 SXM, ms, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
    built = _build.build_all()      # one nvcc per source, all at once
    print(f"phase0 build: {time.perf_counter() - t0:.2f} s "
          f"(compiled: {built or 'none, cached'})")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"phase0 ptxas {name}: {line.strip()}")
        _build.load(name)


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


# ---------------------------------------------------------------------------
# phases 4 and 5: the LM kernels and serving recurrentgemma-2b
# ---------------------------------------------------------------------------


def flash_bound(bh: int, bh_kv: int, s: int, d: int, dtype, pairs: int):
    """q, k, v read once and o written once; 4*D operations (two
    multiply-adds, for q.k and p.v) per query-key pair the mask keeps, at
    the peak rate for the inputs' type."""
    import torch
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * bh + 2 * bh_kv) * s * d * esize
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(nbytes, 4 * bh * d * pairs, peak)


def hold_flash(q, k, v, kw, with_library: bool):
    """flash_attention on (BH, S, D) tensors against its plain version
    (k and v repeated, materialised softmax), both timed; the library
    yardstick is scaled_dot_product_attention with the same boolean mask.
    Returns a dict of the measurements."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    bh, s, d = q.shape
    group = bh // k.shape[0]

    def plain():
        return ref.flash_attention_ref(q, k.repeat_interleave(group, 0),
                                       v.repeat_interleave(group, 0), **kw)

    got = flash_attention(q, k, v, **kw)
    want = plain()
    torch.cuda.synchronize()
    dt = str(q.dtype).split(".")[-1]
    tol = ATTN_TOL[dt]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    check(bool((diff <= tol + tol * want.float().abs()).all()),
          f"flash_attention S={s} {dt} {kw}: max_abs_err {err}")
    mask = ref.attention_mask(s, kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    pairs = int(mask.sum())
    out = {"max_abs_err": err, "pairs": pairs}
    if with_library:
        out["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw))
        out["plain_ms"] = time_ms(plain)
        q4 = q.view(1, bh, s, d)
        k4 = k.view(1, -1, s, d).expand(1, bh, s, d)
        v4 = v.view(1, -1, s, d).expand(1, bh, s, d)
        out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask))
        out["bound_ms"], out["bound_by"] = flash_bound(
            bh, k.shape[0], s, d, q.dtype, pairs)
    return out


def hold_scan(a, b, h0):
    """rglru_scan against its plain version (exactly), both timed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan
    got = rglru_scan(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0, f"rglru_scan {tuple(a.shape)} h0={h0 is not None}: "
          f"{err}")
    n = a.numel()
    nbytes = 3 * n * 4 + (0 if h0 is None else h0.numel() * 4)
    b_ms, by = bound(nbytes, 2 * n)
    return {"max_abs_err": err, "ms": time_ms(lambda: rglru_scan(a, b, h0)),
            "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, b, h0),
                                reps=5),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def phase4_lm_kernels():
    """Both LM kernels against their plain versions on the card: flash
    attention at the serving shapes (B = 1, 10 query heads, 1 kv head,
    D = 256, local window 2,048) and at small shapes for the other masks;
    the scan at the serving widths.  Returns the measurements of the
    largest serving shapes, for the kernels line."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    serve = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in SERVE_PROMPTS:
            q, k, v = randn(10, s, 256, dtype=dtype), \
                randn(1, s, 256, dtype=dtype), randn(1, s, 256, dtype=dtype)
            kw = dict(causal=True, kind="local", window=2048)
            m = hold_flash(q, k, v, kw, with_library=True)
            dt = str(dtype).split(".")[-1]
            print(f"phase4 flash_attention BH=10 G=10 S={s} D=256 local "
                  f"2048 {dt}: max_abs_err {m['max_abs_err']:.3g}, kernel "
                  f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, sdpa "
                  f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
                  f"({m['bound_by']}), pairs {m['pairs']}")
            if s == max(SERVE_PROMPTS) and dtype == torch.bfloat16:
                serve["flash_attention"] = dict(m, shape=[10, s, 256])
    for dtype in (torch.bfloat16, torch.float32):
        for kw in (dict(causal=True, kind="global"),
                   dict(causal=True, kind="chunked", window=128),
                   dict(causal=True, kind="global", softcap=50.0),
                   dict(causal=False, kind="global"),
                   dict(causal=False, kind="local", window=96)):
            scale = 8.0 if kw.get("softcap") else 1.0
            q = randn(8, 333, 64, dtype=dtype) * scale
            k = randn(4, 333, 64, dtype=dtype) * scale
            v = randn(4, 333, 64, dtype=dtype)
            m = hold_flash(q, k, v, kw, with_library=False)
            print(f"phase4 flash_attention BH=8 G=2 S=333 D=64 {kw} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err "
                  f"{m['max_abs_err']:.3g}")
    for (bsz, s, w), with_h0 in (((1, 3000, 2560), False),
                                 ((1, 3000, 2560), True),
                                 ((4, 1000, 2560), False)):
        a = torch.rand((bsz, s, w), generator=gen, device=dev) * 0.5 + 0.5
        b = randn(bsz, s, w)
        h0 = randn(bsz, w) if with_h0 else None
        m = hold_scan(a, b, h0)
        print(f"phase4 rglru_scan ({bsz}, {s}, {w}) h0={with_h0}: "
              f"max_abs_err {m['max_abs_err']}, kernel {m['ms']:.4f} ms, "
              f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
              f"({m['bound_by']})")
        if (bsz, s, with_h0) == (1, 3000, False):
            serve["rglru_scan"] = dict(m, shape=[bsz, s, w])
    return serve


class PrefillRecorder:
    """Keeps each prefill's last-position logits and its recurrent
    layers' final states h (on the host, f32), in the order the engine
    admits requests.  Wraps the name the serving engine calls."""

    def __init__(self):
        from repro_torch.models import model as model_lib
        self.mod = model_lib
        self.orig = model_lib.prefill
        self.logits = []
        self.states = []

        def rec(*args, **kw):
            logits, cache = self.orig(*args, **kw)
            self.logits.append(logits[0].float().cpu())
            self.states.append([c["h"][0].float().cpu() for c in cache
                                if "h" in c])
            return logits, cache

        model_lib.prefill = rec

    def close(self):
        self.mod.prefill = self.orig


def _serve(cfg, params, prompts, use_kernel: bool):
    """One engine, one instance, every prompt submitted at once and
    drained; returns (requests, prefill logits, launches, seconds, peak
    bytes)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, use_kernel=use_kernel)
    eng.scale_up(1)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p.copy(), SERVE_MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = PrefillRecorder()
    flash_attention.launches = rglru_scan.launches = 0
    try:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    launches = {"flash_attention": flash_attention.launches,
                "rglru_scan": rglru_scan.launches}
    return (sorted(done, key=lambda r: r.rid), rec, launches, wall,
            torch.cuda.max_memory_allocated())


def profile_serving(cfg, params, prompt):
    """One prefill of `prompt` into a fresh instance and one decode step,
    under torch.profiler (host and device activity): wall time, device
    busy share, and the largest entries by device and by host time.  A
    measurement only; prints "not measured" without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request, ServingInstance
    inst = ServingInstance(cfg, params, slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    for label, run in (("prefill", lambda: inst.admit(
            Request(0, prompt.copy(), SERVE_MAX_NEW))),
                       ("decode step", inst.step)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = prof.key_averages()
        dev = [e for e in rows if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        if busy <= 0:
            print(f"phase5 profile {label}: device time not measured")
            continue
        top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
        host = [e for e in rows if e.device_type == DeviceType.CPU]
        top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
        print(f"phase5 profile {label} (prompt {len(prompt)}, profiled "
              f"{wall * 1e3:.1f} ms): device busy {busy * 1e3:.2f} ms, "
              f"idle share {1 - busy / wall:.4f}; {len(host)} host op "
              f"kinds, {sum(e.count for e in host)} host op calls")
        print("phase5 profile   device: " + "; ".join(
            f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} "
            f"ms" for e in top_dev))
        print("phase5 profile   host: " + "; ".join(
            f"{e.key[:32]} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
            for e in top_host))


def phase5_serving():
    """recurrentgemma-2b at its published width on the card, random
    weights from a seeded generator: one ServingEngine instance (4 slots,
    max_len 4,096) serves 8 requests, with the kernels and then with
    their plain versions; the prefills' logits must agree."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(SERVE_ARCH)
    kinds = cfg.layer_kinds()
    n_local, n_rec = kinds.count("local"), kinds.count("recurrent")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"phase5 {SERVE_ARCH}: {cfg.param_count():,} parameters "
          f"(f32, computed in {cfg.dtype}), {n_local} local + {n_rec} "
          f"recurrent layers, init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS for _ in range(2)]
    # warm-up (cuBLAS handles, the kernels' first launch), not counted
    warm = ServingEngine(cfg, params, slots=1, max_len=SERVE_MAX_LEN)
    warm.scale_up(1)
    warm.submit(Request(-1, prompts[0][:256].copy(), 2))
    warm.drain()
    del warm

    done, rec_k, launches, wall, peak = _serve(cfg, params, prompts, True)
    check(len(done) == len(prompts)
          and all(len(r.tokens) == SERVE_MAX_NEW for r in done),
          "phase 5: not every request finished with max_new tokens")
    want = {"flash_attention": n_local * len(prompts),
            "rglru_scan": n_rec * len(prompts)}
    print(f"phase5 launches (kernels run): {launches}, expected {want} "
          f"({n_local} flash and {n_rec} scans per prefill)")
    check(launches == want, f"phase 5 launches {launches} != {want}")
    prefill_ms = [1e3 * (r.t_first_token - r.t_admit) for r in done]
    for r, ms in zip(done, prefill_ms):
        print(f"phase5 request {r.rid}: prompt {len(r.prompt)}, prefill "
              f"{ms:.2f} ms, latency {r.latency_ms:.2f} ms, tokens "
              f"{r.tokens[:4]}...")
    n_dec = sum(len(r.tokens) - 1 for r in done)
    dec_s = wall - sum(prefill_ms) / 1e3
    print(f"phase5 drain {wall:.3f} s: prefill {sum(prefill_ms):.2f} ms "
          f"total, decode {n_dec} tokens in {dec_s:.3f} s = "
          f"{n_dec / dec_s:.2f} tokens/s (4 slots), peak memory "
          f"{peak / 2**30:.3f} GiB")

    profile_serving(cfg, params, prompts[-1])

    done_p, rec_p, launches_p, wall_p, _ = _serve(cfg, params, prompts,
                                                  False)
    check(launches_p == {"flash_attention": 0, "rglru_scan": 0},
          f"phase 5: the plain run launched kernels {launches_p}")
    check(len(rec_k.logits) == len(rec_p.logits) == len(prompts),
          "phase 5: a prefill was not recorded")
    worst, worst_h, n_checked = 0.0, 0.0, 0
    for i, (lk, lp) in enumerate(zip(rec_k.logits, rec_p.logits)):
        scale = float(lp.abs().max())
        err = float((lk - lp).abs().max())
        worst = max(worst, err / scale)
        top2 = torch.topk(lp, 2).values
        margin = float(top2[0] - top2[1])
        tol = LOGIT_TOL * scale
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"phase5 prefill {i} (prompt {len(prompts[i])}): logits "
              f"max_abs_err {err:.4f} of max |logit| {scale:.2f} "
              f"(tol {tol:.4f}); top-2 margin {margin:.4f}; first token "
              f"same={same}")
        check(err <= tol, f"phase 5 prefill {i}: logits differ by {err}")
        # the scan's output itself: each recurrent layer's final state,
        # relative in norm (the logits are dominated by the embedding)
        h_err = max(float((hk - hp).norm() / hp.norm())
                    for hk, hp in zip(rec_k.states[i], rec_p.states[i]))
        worst_h = max(worst_h, h_err)
        check(h_err <= LOGIT_TOL, f"phase 5 prefill {i}: recurrent states "
              f"differ by {h_err} in norm")
        if margin > tol:
            n_checked += 1
            check(same, f"phase 5 prefill {i}: first token differs")
    print(f"phase5 plain run: drain {wall_p:.3f} s; worst logits error "
          f"{worst:.5f} of max |logit|; worst recurrent-state error "
          f"{worst_h:.5f} in norm over {n_rec} layers; first token checked "
          f"on {n_checked} of {len(prompts)} prefills")
    return launches


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
        lm = phase4_lm_kernels()
        serve_launches = phase5_serving()
        for name in ("flash_attention", "rglru_scan"):
            m = lm[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": CSRC + name + ".cu", "replaces": REPLACES[name],
                "launches": serve_launches[name],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "shape": m["shape"]})
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
