#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (each one failing makes the script exit non-zero):

  0. the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once)
     and print the build time and what ptxas reports;
  1. the device time of an empty kernel launched through the forest
     library's ctypes path (the floor of every call); each forest kernel
     against its plain PyTorch version on the card: ``rfr_forest_apply``
     with the Jiagu world's forest and random forests of 64 trees at
     depth 8 and 10 (the global-memory path) at N = 1, 20, 255, 256, 257,
     9,372, 200,000 (max abs error <= 1e-6 on predictions around 1 — an
     f32 mean of at most 64 leaves — and bitwise equal to the numpy host
     oracle), the first forest kernel (one thread a row) held the same
     way and timed beside it at every N, the new one's device time no
     larger; ``rfr_capacity_sweep`` exactly equal, both
     ``log_target`` values, random +-inf bounds, M = 16 and 40, and with
     the device drain's padding (-inf rows past each scenario's m_max,
     +inf rows past its R, failures at m = 0) at M = 1, 24, 40 and
     T = 5, 24, 33, 130 (depth 6) and 64 (depth 10), and with m_max on
     a pass boundary over many scenarios, launched 20 times; each timed
     beside its plain version with CUDA events (median of 20; every
     kernel's ``ms`` is the host's and the device's time of a call, as the
     wrapper is called, and its ``device_ms`` the device's alone, of calls
     queued behind a device-side wait), the sweep's bound over the rows
     its inputs need (m at most the capacity, bound not -inf);
  2. a capacity drain over 4,096 nodes from a 24-pattern pool
     (m_max = 16): the device drain on the CUDA kernel and the host
     drain on numpy must give identical capacity tables; then the same
     over 1,024 nodes of worlds built from the diurnal-shift,
     azure-sparse and coldstart-churn traces at seeds 1-3 (the sweep's
     expf against numpy's float32 exp: a differing table is printed and
     fails);
  3. the control plane's main path: burst-storm, 24 functions, 180 s,
     1,024 target nodes, seed 0, the Jiagu scheduler, run (a) on the
     numpy engine with the host drain (the oracle), (b) on the CUDA
     engine with the host drain, (c) on the CUDA engine with the device
     drain.  (b) and (c) must equal (a) in every outcome that does not
     read the wall clock, and each kernel must have launched during its
     run; the sweep calls' shape distribution; both kernels timed at the
     largest and the median call shape of the run, the first forest
     kernel beside the new one; then (b) and (c) once more under the
     profiler, with the forest and sweep kernels' device time in all;
  4. the LM kernels against their plain versions on the card (the three
     path functions printed; every line names the kernel that ran, which must
     be the one ``path`` names): ``flash_attention`` at
     recurrentgemma-2b's serving shapes (10 query heads, 1 kv head,
     D = 256, local window 2,048, S = 512, 1,000, 2,048, 3,000), bf16 on
     the wgmma kernel and f32 on the 3xTF32 kernel, each no slower than
     sdpa in ``ms`` and ``device_ms``, with the CUDA-core kernel held and
     timed beside both (tolerance f32 1e-5 absolute plus 1e-5 relative,
     bf16 2^-6 relative plus 2^-8 of the softmax's average of |v|, so a
     kv tile dropped or added fails); f32 bounds at the TF32 rate, the
     CUDA cores' 67 TFLOP/s beside; at small shapes (BH 8, G 2, S 333)
     for the global, chunked, softcap and non-causal masks: D = 64 in
     bf16 and f32, D = 128 in bf16, and D = 32 in bf16 (the CUDA-core
     kernel, and f32 with a softcap), the f32 cases also printed against
     a float64 evaluation, with f32 softcap 20 and 50 (q, k scaled by 4
     and 8) at D = 64, 128, 256: the 3xTF32 kernel, the CUDA-core kernel
     and the plain version each against float64; ``rglru_scan`` on the
     TMA path exactly equal at (1, 3000, 2560) with and without h0 and at
     (4, 1000, 2560), as is the first scan kernel (one thread a channel),
     both timed, the TMA kernel's device time no larger than the first's;
     each timed beside its plain version, and attention beside ``scaled_dot_product_attention`` with
     the same boolean mask; ``ssd_scan`` at mamba2-2.7b's serving shapes
     (B = 1, 80 heads of 64, d_state 128, one B/C group, S = 512, 1,000,
     2,048, 3,001, bf16 on the wgmma kernel and f32 on the CUDA-core
     kernel, with and without h0) against its plain version at the
     kernels' chunk of 64 (f32: 1e-4 of the largest |y| and of the
     state's norm; bf16: 2e-2), the CUDA-core kernel held and timed
     beside the wgmma one, which must be no slower, and at S = 3,001
     ``ops.ssd_op`` in the model's layout timed beside the kernel alone
     (the transposes around the call);
  5. serving recurrentgemma-2b at its published width (random weights
     from a seeded generator): one ServingEngine instance, 4 slots,
     max_len 4,096, 8 requests (prompts of 512, 1,000, 2,048 and 3,000
     tokens, two each, 16 new tokens).  Every prefill must launch 8
     flash kernels, all on the tensor-core path, and 18 scan kernels, all
     on the TMA path;
     the profiled prefill prints its flash kernels' device time beside
     the CUDA-core kernel's phase-4 time, and its scan kernels' beside
     the first scan kernel's; the same requests through the plain
     versions must give prefill logits within 2e-2 of the largest
     |logit|, and the same first token wherever the top-2 margin is
     above that;
  6. serving mamba2-2.7b at its published width and depth (phase 5's
     model freed first): the same engine, 8 requests (prompts of 512,
     1,000, 2,048 and 3,001 tokens, two each; 3,001 is prime, so the
     kernel's last chunk is ragged), 16 new tokens.  Every prefill must
     launch 64 ``ssd_scan`` kernels, all on the wgmma path, and nothing
     else; the plain run's prefill logits, SSM states and first tokens
     are held to it as in phase 5, each layer's state error printed as a
     share of its limit;
  7. the platform facade (``repro_torch.platform``): (a) the port's
     ``smoke()`` on the card (every registered scheduler built from
     manifest dicts, 30 ticks, 8 target nodes), then the same manifests
     on engine "numpy", every scheduler's outcome equal and the
     harvesting-vs-k8s QoS gate of ``smoke()`` holding; (b) phase 3's
     scenario through ``Platform.build`` in 4 cells with admission on,
     one world shared and reseeded: jiagu on numpy (the oracle), jiagu
     on "cuda" (must launch the forest kernel) and the device-drain
     jiagu on "cuda" (must launch the sweep), equal in every outcome,
     the per-SLO-class violation rates and every node's table, with
     admission conservation within 1e-6; (c) the "learned" stack at the
     same size, one cell, its policy (the numpy init normalised over
     ``tests/data/policy_traces.jsonl``) installed from a PolicyStore in
     a temporary directory: every scored batch on the card within 1e-5
     of ``np_scores``, the same argmax wherever the top-2 margin exceeds
     that, no stale serve;
  8. the f32 flash path's times on a line of their own; one JSON line
     describing all five kernels (flash attention's entry is the bf16
     serving path's kernel, with the f32 path's under "f32"; the SSD
     scan's is the wgmma kernel, the RG-LRU scan's the TMA kernel; each
     redesigned kernel carries the first kernel's times beside its own),
     then the device line.

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
#: the source of each LM kernel's entry in the kernels line: the kernel
#: that serves it (flash attention in bf16 at D = 256, the SSD scan in
#: bf16 at P = 64, N = 128); the f32 attention kernel rides in flash
#: attention's entry under "f32"
SOURCES = {"flash_attention": "flash_attention_wgmma.cu",
           "flash_attention f32": "flash_attention_tf32.cu",
           "rglru_scan": "rglru_scan.cu", "ssd_scan": "ssd_scan_wgmma.cu"}
#: the TPU kernels these replace (def lines)
REPLACES = {"rfr_forest_apply": "src/repro/kernels/rfr_inference.py:72",
            "rfr_capacity_sweep": "src/repro/kernels/rfr_inference.py:130",
            "flash_attention": "src/repro/kernels/flash_attention.py:77",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:39",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65"}
#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside tensor cores,
#: bf16 and TF32 dense tensor-core rates.  The matrix products of f32
#: inputs (attention, the SSD scan) are bounded at the TF32 rate: a
#: kernel that computes them on the tensor cores at f32 accuracy (3xTF32)
#: can beat the CUDA cores' 67 TFLOP/s, so that figure is no bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
#: flash attention against its plain version, elementwise: f32 within
#: 1e-5 absolute plus 1e-5 relative (online against materialised
#: softmax, other summation order); bf16 within 2^-6 of |out| (two to four bf16 ulps:
#: the kernel and the plain version each round the output once) plus
#: 2^-8 of the same softmax's average of |v| (the kernel rounds each p to
#: bf16, a relative error of at most 2^-9, where the plain version keeps
#: p in f32).  At the serving shapes an output averages some 2,000 values
#: of |v| about 0.8 to |out| about 0.03, so one kv tile of 32 keys
#: dropped or added moves outputs by many times that
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -8)}
#: recurrentgemma-2b's local layers: MQA, head dim 256, window 2,048
SERVE_ARCH = "recurrentgemma-2b"
SERVE_PROMPTS = (512, 1000, 2048, 3000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 4, 4096, 16
#: phase 5, kernels against plain on the whole model in bf16: the
#: prefill's last-position logits within 2e-2 of the largest |logit|,
#: and each recurrent or SSM layer's final state within 2e-2 in norm
#: (phases 5 and 6)
LOGIT_TOL = 2e-2
#: mamba2-2.7b: 80 SSM heads of 64, d_state 128, one B/C group; the SSD
#: kernel against its plain version at the kernel's chunk: f32 1e-4 of
#: the largest |y| and of the state's norm (the same arithmetic summed in
#: other orders), bf16 2e-2 (both compute in f32 from the same bf16
#: values, y is rounded to bf16 once)
SSM_ARCH = "mamba2-2.7b"
SSM_PROMPTS = (512, 1000, 2048, 3001)
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: phase 2's second drain: device-drain capacity tables against the numpy
#: host drain on worlds of other traces and seeds (the sweep's expf and
#: numpy's float32 exp differ by an ulp on many inputs)
SETTLE_TRACES = ("diurnal-shift", "azure-sparse", "coldstart-churn")
SETTLE_SEEDS = (1, 2, 3)
SETTLE_NODES = 1024
PRED_TOL = 1e-6
#: phase 1's forest batch sizes: one row, the control plane's median call,
#: either side of a block of the first kernel (256 rows), its largest call,
#: and a large batch
FOREST_N = (1, 20, 255, 256, 257, 9372, 200_000)
#: GPU clock cycles of the wait a timed call is queued behind: about 2 ms
#: at the H100's 1.98 GHz boost clock, far above a kernel wrapper's host
#: time
QUEUE_CYCLES = 4_000_000
SCENARIO = dict(n_functions=24, duration_s=180, target_nodes=1024, seed=0)
#: phase 7 (b): the control plane's own size through Platform.build,
#: sharded into cells, admission on; per-function conservation of
#: admitted = served + dropped + queued within CONSERVATION_TOL
PLATFORM_CELLS = 4
CONSERVATION_TOL = 1e-6
#: phase 7 (c): the learned scorer's policy is the numpy init (hidden
#: width, seed) normalised over the checked-in decision traces, the
#: same dict the CPU tests serve; its scores on the card within
#: SCORE_TOL of np_scores (f32 products, TF32 off)
POLICY_TRACES = "tests/data/policy_traces.jsonl"
POLICY_HIDDEN, POLICY_SEED = 16, 3
SCORE_TOL = 1e-5
DRAIN_NODES = 4096
DRAIN_M_MAX = 16
N_PATTERNS = 24


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise PhaseFailed(what)


def time_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Median time of one call, by CUDA events, after a warm-up.

    By default the card idles while the host runs the call (a wrapper's
    checks, allocation, the ctypes call, the launch), so the time is the
    host's and the device's together, as a caller meets it: every
    kernel's ``ms``; a call of a few microseconds on the card reads some
    20-40 us.  With `queued` each call is enqueued behind a device-side
    wait of QUEUE_CYCLES, so the start event fires after the host has
    enqueued the whole call and the events time the device's work alone:
    every kernel's ``device_ms``.  A call whose host part outlasts the
    wait (a plain version's Python loop) reads its host time either
    way."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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


def sweep_rows(bounds, caps):
    """(rows the inputs need, padded rows): a scenario's capacity c is
    its first failing m (0-based), so the rows with m <= c decide it; of
    those, a row whose bound is -inf fails without a descent."""
    import torch
    s, m, r = bounds.shape
    m_idx = torch.arange(m, device=bounds.device)[None, :, None]
    upto = (m_idx <= caps.to(bounds.device)[:, None, None]).expand(s, m, r)
    return int((upto & (bounds != float("-inf"))).sum()), s * m * r


def sweep_bound(shape, feat, log_target: bool, rows: int):
    """The least time for the sweep over `rows` descended rows: each read
    once (features and bound), the forest read once, the capacities
    written once; per row T*(D+1) operations of the descent and mean, a
    compare, and the exp under log_target."""
    s, m, r, f = shape
    t, nn = feat.shape
    depth = (nn + 1).bit_length() - 1
    per_row = t * (depth + 1) + 1 + 1 + (1 if log_target else 0)
    return bound(rows * f * 4 + rows * 4 + forest_bytes(feat) + s * 4,
                 rows * per_row)


def v1_forest(x, feat, thr, leaf):
    """The first forest kernel of csrc/rfr_inference.cu (one thread a
    row) called directly, so that it can be held and timed beside the
    wrapper's; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build, ref
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    err = _build.load("rfr_inference").rfr_forest_apply_v1(
        x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], feat.shape[0],
        ref.forest_depth(feat), x.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rfr_forest_apply_v1")
    return out


def empty_launch_ms() -> float:
    """Device time of an empty kernel launched through the forest
    library's ctypes path, queued as every ``device_ms`` is: the floor
    no kernel call can pass."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load("rfr_inference")
    return time_ms(lambda: _build.check_launch(
        lib.rfr_empty(torch.cuda.current_stream().cuda_stream), "rfr_empty"),
        queued=True)


def hold_forest(x, feat, thr, leaf, want=None, plain_timed=True):
    """rfr_forest_apply against its plain version (and, given `want`,
    bitwise against the numpy oracle's predictions) on these inputs, the
    first kernel held beside it the same way; both kernels timed, the new
    one's device time no larger than the first's (the narrowest margin,
    at 200,000 rows of the depth-10 forest in device memory, was
    1.08-1.11x over four runs on an H100 80GB HBM3 at 700 W; every other
    shape 1.7x or more).  Returns a dict of the
    measurements (the plain version's time and the bound with
    `plain_timed`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_forest_apply
    what = f"rfr_forest_apply N={x.shape[0]} T={feat.shape[0]}"
    got = rfr_forest_apply(x, feat, thr, leaf)
    old = v1_forest(x, feat, thr, leaf)
    plain = ref.rfr_forest_ref(x, feat, thr, leaf)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    v1_err = float((old - plain).abs().max())
    check(err <= PRED_TOL and v1_err <= PRED_TOL,
          f"{what}: {err} (first kernel {v1_err})")
    out = {"max_abs_err": err, "v1_err": v1_err}
    if want is not None:
        out["numpy_bitwise"] = (np.array_equal(got.cpu().numpy(), want),
                                np.array_equal(old.cpu().numpy(), want))
        check(all(out["numpy_bitwise"]), f"{what} != numpy (new, first: "
              f"{out['numpy_bitwise']})")
    out["ms"] = time_ms(lambda: rfr_forest_apply(x, feat, thr, leaf))
    out["device_ms"] = time_ms(lambda: rfr_forest_apply(x, feat, thr, leaf),
                               queued=True)
    out["v1_ms"] = time_ms(lambda: v1_forest(x, feat, thr, leaf))
    out["v1_device_ms"] = time_ms(lambda: v1_forest(x, feat, thr, leaf),
                                  queued=True)
    check(out["device_ms"] <= out["v1_device_ms"],
          f"{what}: device {out['device_ms']:.4f} ms, slower than the first "
          f"kernel's {out['v1_device_ms']:.4f} ms")
    if plain_timed:
        out["plain_ms"] = time_ms(lambda: ref.rfr_forest_ref(x, feat, thr,
                                                             leaf))
        out["bound_ms"], out["bound_by"] = forest_bound(x.shape[0],
                                                        x.shape[1], feat)
    return out


def hold_sweep(x, bounds, feat, thr, leaf, log_target):
    """rfr_capacity_sweep against its plain version (exactly) on these
    inputs, and both timed: (max abs error, kernel ms, kernel device ms,
    plain ms, bound ms, bound by, rows needed, padded rows)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_capacity_sweep
    args = (x, bounds, feat, thr, leaf)
    got = rfr_capacity_sweep(*args, log_target=log_target)
    plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err == 0, f"rfr_capacity_sweep {tuple(x.shape)}: {err}")
    rows, padded = sweep_rows(bounds, plain)
    return (err,
            time_ms(lambda: rfr_capacity_sweep(*args,
                                               log_target=log_target)),
            time_ms(lambda: rfr_capacity_sweep(*args, log_target=log_target),
                    queued=True),
            time_ms(lambda: ref.rfr_capacity_sweep_ref(
                *args, log_target=log_target)),
            *sweep_bound(tuple(x.shape), feat, log_target, rows),
            rows, padded)


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
        # the admission axis (empty without a controller)
        "class_requests": dict(res.class_requests),
        "class_violation_rates": {k: v / res.class_requests[k]
                                  for k, v in res.class_violations.items()},
        "dropped_requests": res.dropped_requests,
        "queue_depth_peak": res.queue_depth_peak,
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
        self.sweep_by_shape = {}  # shape -> its first call's inputs
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
            shape = tuple(x.shape)
            self.sweep_calls.append(shape)
            if x.is_cuda and shape not in self.sweep_by_shape:
                self.sweep_by_shape[shape] = (x.clone(), bounds.clone(), feat,
                                              thr, leaf, log_target)
                if (self.sweep is None
                        or x.numel() > self.sweep[0].numel()):
                    self.sweep = self.sweep_by_shape[shape]
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
    from repro_torch.kernels.rfr_inference import (forest_path,
                                                   rfr_capacity_sweep)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = world.predictor.model.arrays
    X_world, _ = world.predictor.dataset()
    forests = [("world T=24 D=8", (a.feat, a.thr, a.leaf), X_world.shape[1]),
               ("random T=64 D=8", _random_forest(rng, 64, 8, 31), 31),
               ("random T=64 D=10", _random_forest(rng, 64, 10, 31), 31)]
    print(f"phase1 empty kernel through the same ctypes path: device "
          f"{empty_launch_ms():.4f} ms")
    timings = {}
    for name, arrays, f in forests:
        oracle = core.RandomForestRegressor(device=dev).load_arrays(*arrays)
        fo = oracle.device_arrays()
        where = forest_path(fo[0].shape[0], ref.forest_depth(fo[0]))
        for n in FOREST_N:
            if name.startswith("world"):
                x = X_world[rng.integers(0, len(X_world), n)]
            else:
                x = rng.standard_normal((n, f)).astype(np.float32)
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            m = hold_forest(xt, *fo, want=oracle.predict(x, engine="numpy"),
                            plain_timed=n == max(FOREST_N))
            print(f"phase1 rfr_forest_apply {name} ({where}) N={n}: "
                  f"max_abs_err={m['max_abs_err']:.3g} numpy_bitwise="
                  f"{m['numpy_bitwise'][0]} (first kernel "
                  f"{m['numpy_bitwise'][1]}), kernel {m['ms']:.4f} ms "
                  f"(device {m['device_ms']:.4f} ms), first kernel "
                  f"{m['v1_ms']:.4f} ms (device {m['v1_device_ms']:.4f} ms, "
                  f"{m['v1_device_ms'] / m['device_ms']:.2f}x the new)")
            if n == max(FOREST_N):
                timings[f"rfr_forest_apply {name} N={n}"] = (
                    m["ms"], m["device_ms"], m["plain_ms"], m["bound_ms"],
                    m["bound_by"])

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
                kd = time_ms(lambda: rfr_capacity_sweep(
                    xs, bt, *world_fo, log_target=True), queued=True)
                pl = time_ms(lambda: ref.rfr_capacity_sweep_ref(
                    xs, bt, *world_fo, log_target=True))
                rows, _ = sweep_rows(bt, plain)
                b, by = sweep_bound(tuple(xs.shape), world_fo[0], True, rows)
                timings[f"rfr_capacity_sweep world S={s} M={m} R={r}"] = (
                    k, kd, pl, b, by)
    phase1_padded_sweeps(rng, dev)
    for key, (k, kd, p, b, by) in timings.items():
        print(f"phase1 time {key}: kernel {k:.4f} ms (device {kd:.4f} ms), "
              f"plain {p:.4f} ms, bound {b:.5f} ms ({by})")


def phase1_padded_sweeps(rng, dev):
    """rfr_capacity_sweep with the device drain's padding, exactly equal
    to its plain version: -inf rows past each scenario's m_max, +inf rows
    past its R, a failure at m = 0 in every fifth scenario; T = 5 (the
    lanes' partial sums all 0), 24, 33 (a tail of one tree) and 130
    (numpy's pairwise split above 128 trees) at depth 6, and T = 64 at
    depth 10 (the forest read from device memory).  Then m_max on a pass
    boundary: a block takes 64 rows a pass, 8 values of m at R = 8, so
    m_max = 8 or 16 makes whole passes of -inf rows, which fail without a
    descent while the pass is under way; 4,096 scenarios, 20 launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_capacity_sweep
    s, r, f = 300, 8, 31
    for t, depth in ((5, 6), (24, 6), (33, 6), (130, 6), (64, 10)):
        forest = [torch.from_numpy(a).to(dev)
                  for a in _random_forest(rng, t, depth, f)]
        for m in (1, 24, 40):
            x = rng.standard_normal((s, m, r, f)).astype(np.float32)
            bounds = rng.uniform(-0.4, 0.8, (s, m, r)).astype(np.float32)
            for i in range(s):
                bounds[i, :, int(rng.integers(1, r + 1)):] = np.inf
                bounds[i, int(rng.integers(0, m + 1)):, :] = -np.inf
                if i % 5 == 0:
                    bounds[i, 0, 0] = -5.0
            args = (torch.from_numpy(x).to(dev),
                    torch.from_numpy(bounds).to(dev), *forest)
            for log_target in (False, True):
                got = rfr_capacity_sweep(*args, log_target=log_target)
                plain = ref.rfr_capacity_sweep_ref(*args,
                                                   log_target=log_target)
                torch.cuda.synchronize()
                same = torch.equal(got, plain)
                rows, padded = sweep_rows(args[1], plain)
                print(f"phase1 rfr_capacity_sweep padded T={t} D={depth} "
                      f"S={s} M={m} R={r} log_target={log_target}: "
                      f"equal={same}, rows needed {rows} of {padded}")
                check(same, f"rfr_capacity_sweep padded T={t} M={m} "
                      f"log={log_target}")
    s, m = 4096, 24
    forest = [torch.from_numpy(a).to(dev)
              for a in _random_forest(rng, 24, 8, f)]
    x = torch.from_numpy(rng.standard_normal((s, m, r, f)).astype(
        np.float32)).to(dev)
    bounds = rng.uniform(0.3, 1.5, (s, m, r)).astype(np.float32)
    bounds[0::2, 8:] = -np.inf
    bounds[1::2, 16:] = -np.inf
    early = np.arange(0, s, 7)
    bounds[early, rng.integers(0, 8, early.size),
           rng.integers(0, r, early.size)] = -1.0
    args = (x, torch.from_numpy(bounds).to(dev), *forest)
    plain = ref.rfr_capacity_sweep_ref(*args)
    same = sum(torch.equal(rfr_capacity_sweep(*args), plain)
               for _ in range(20))
    caps = torch.bincount(plain.long()).tolist()
    print(f"phase1 rfr_capacity_sweep m_max on a pass boundary S={s} M={m} "
          f"R={r} T=24 D=8: equal in {same} of 20 launches; capacities "
          f"{caps}")
    check(same == 20, "rfr_capacity_sweep with m_max on a pass boundary")


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


def _drains(world, nodes, m_max: int):
    """The nodes' capacity tables from the numpy host drain and from the
    device drain on the CUDA sweep kernel (each node's table as sorted
    (function, capacity) pairs, the nodes in order); returns (host
    tables, device tables, host service, device service, recorder of the
    sweep's inputs, host seconds, device seconds)."""
    import torch
    import repro_torch.core as core

    def tables():
        out = [sorted((fn, e.capacity) for fn, e in n.table.items())
               for n in nodes]
        for n in nodes:
            n.table.clear()
        return out

    args = (world.predictor, world.store, world.qos, world.scenario.specs)
    host = core.PredictionService(*args, core.EngineConfig(m_max=m_max),
                                  engine="numpy")
    t0 = time.perf_counter()
    host.update_nodes(nodes)
    host_s = time.perf_counter() - t0
    want = tables()
    dev = core.PredictionService(
        *args, core.EngineConfig(m_max=m_max, drain="device"),
        engine="cuda")
    rec = Recorder()
    try:
        t0 = time.perf_counter()
        dev.update_nodes(nodes)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    finally:
        rec.close()
    return want, tables(), host, dev, rec, host_s, dev_s


def phase2_drain(world):
    nodes = _pattern_nodes(world.scenario.specs, DRAIN_NODES, DRAIN_NODES)
    want, got, host, dev, rec, host_s, dev_s = _drains(world, nodes,
                                                       DRAIN_M_MAX)
    st = dev.stats
    print(f"phase2 drain {DRAIN_NODES} nodes m_max={DRAIN_M_MAX}: "
          f"S={st.unique_solves} rows={st.rows_built} "
          f"device {dev_s * 1e3:.2f} ms, numpy host {host_s * 1e3:.2f} ms "
          f"(host rows {host.stats.rows_built}), tables_equal={got == want}")
    check(got == want, "phase 2: device-drain tables differ from numpy")
    check(rec.sweep is not None, "phase 2 never reached the sweep kernel")
    _err, k, kd, p, b, by, rows, padded = hold_sweep(*rec.sweep)
    print(f"phase2 time rfr_capacity_sweep {tuple(rec.sweep[0].shape)}: "
          f"kernel {k:.4f} ms (device {kd:.4f} ms), "
          f"plain {p:.4f} ms, bound {b:.6f} ms ({by}) over the {rows} rows "
          f"the inputs need of {padded} padded")
    phase2_other_worlds()


def phase2_other_worlds():
    """Does the sweep's expf (the predictor's log target) ever flip a
    capacity where numpy's float32 exp decides it?  Device-drain tables
    against the numpy host drain on worlds of three more traces, three
    seeds each (SETTLE_NODES pattern nodes, m_max 16, each world's own
    forest); a table that differs is printed node by node with both
    capacities, and fails the phase."""
    import repro_torch.core as core
    for trace in SETTLE_TRACES:
        for seed in SETTLE_SEEDS:
            scn = core.make_scenario(trace, n_functions=24, duration_s=180,
                                     target_nodes=256, seed=seed)
            world = core.scenario_world(scn, engine="numpy")
            nodes = _pattern_nodes(world.scenario.specs, SETTLE_NODES, seed)
            want, got, _h, dev, rec, _hs, dev_s = _drains(world, nodes,
                                                          DRAIN_M_MAX)
            diff = [(i, w, g) for i, (w, g) in enumerate(zip(want, got))
                    if w != g]
            print(f"phase2 drain {trace} seed {seed}: {SETTLE_NODES} nodes, "
                  f"S={dev.stats.unique_solves} rows={dev.stats.rows_built} "
                  f"sweep launches {len(rec.sweep_calls)}, device "
                  f"{dev_s * 1e3:.2f} ms, tables_equal={not diff}")
            for i, w, g in diff[:10]:
                print(f"phase2   node {i}: numpy {w}, device {g}")
            check(rec.sweep is not None,
                  f"phase 2 {trace} seed {seed} never reached the sweep")
            check(not diff, f"phase 2 {trace} seed {seed}: {len(diff)} "
                  "device-drain tables differ from numpy")


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
    print(f"phase3 shapes: forest calls {len(fc)}, N median "
          f"{fc[len(fc) // 2] if fc else 0} max {fc[-1] if fc else 0}")
    print_sweep_shapes(rec.sweep_calls)
    return rec, l_b, l_c


def sweep_rank(shape) -> tuple:
    """Order of sweep call shapes: by padded rows S*M*R, then the shape."""
    return (shape[0] * shape[1] * shape[2], shape)


def print_sweep_shapes(calls):
    """The distribution of the sweep calls' (S, M, R, F) shapes."""
    from collections import Counter
    if not calls:
        print("phase3 sweep shapes: no calls")
        return
    n = len(calls)
    ranked = sorted(calls, key=sweep_rank)

    def pct(vals, q):
        vals = sorted(vals)
        return vals[min(n - 1, int(q * n))]

    def counts(axis):
        return dict(sorted(Counter(c[axis] for c in calls).items()))

    s_vals = [c[0] for c in calls]
    print(f"phase3 sweep shapes: {n} calls, {len(set(calls))} distinct; "
          f"median {ranked[n // 2]}, largest {ranked[-1]}; S p10 "
          f"{pct(s_vals, 0.1)} p50 {pct(s_vals, 0.5)} p90 {pct(s_vals, 0.9)} "
          f"max {max(s_vals)}; M {counts(1)}; R {counts(2)}; most common "
          f"{Counter(calls).most_common(5)}")


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
    for kernel in ("forest_apply_kernel", "capacity_sweep_kernel"):
        mine = [e for e in rows if kernel in e.key]
        if mine:
            print(f"phase3 device ({label}): {kernel} x"
                  f"{sum(e.count for e in mine)}, device "
                  f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} "
                  "ms in all")


def main_path_kernels(rec, l_b, l_c):
    """Both kernels against their plain versions on the largest inputs
    the main path gave them, timed; the kernels JSON entries.  The
    forest kernel is also timed at the median call's row count, the
    first forest kernel beside it at both."""
    check(rec.forest is not None and rec.sweep is not None,
          "main path left no kernel inputs on the card")
    x, feat, thr, leaf = rec.forest
    big = hold_forest(x, feat, thr, leaf)
    n_med = sorted(rec.forest_calls)[len(rec.forest_calls) // 2]
    med_f = hold_forest(x[:n_med], feat, thr, leaf)
    xs = rec.sweep[0]
    (err_s, ms_s, dms_s, pms_s, b_s, by_s, rows_s,
     pad_s) = hold_sweep(*rec.sweep)
    med = sorted(rec.sweep_calls, key=sweep_rank)[len(rec.sweep_calls) // 2]
    _e, ms_sm, dms_sm, pms_sm, b_sm, _by, rows_sm, pad_sm = hold_sweep(
        *rec.sweep_by_shape[med])
    for label, m, n in (("largest", big, x.shape[0]), ("median", med_f,
                                                          n_med)):
        print(f"main-path shapes: rfr_forest_apply {label} call N={n} F="
              f"{x.shape[1]}: kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f} ms), first kernel {m['v1_ms']:.4f} ms "
              f"(device {m['v1_device_ms']:.4f} ms), plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms")
    print(f"main-path shapes: rfr_capacity_sweep largest {tuple(xs.shape)}: "
          f"kernel {ms_s:.4f} ms (device {dms_s:.4f} ms), plain "
          f"{pms_s:.4f} ms, bound {b_s:.6f} ms ({by_s}; rows needed "
          f"{rows_s} of {pad_s} padded); median call {med}: kernel "
          f"{ms_sm:.4f} ms (device {dms_sm:.4f} ms), plain {pms_sm:.4f} ms, "
          f"bound {b_sm:.6f} ms (rows needed {rows_sm} of {pad_sm} padded)")
    return [
        {"name": "rfr_forest_apply", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_forest_apply"],
         "launches": l_b["rfr_forest_apply"],
         "max_abs_err": big["max_abs_err"], "ms": big["ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None,
         "shape": list(x.shape), "device_ms": big["device_ms"],
         "v1_ms": big["v1_ms"], "v1_device_ms": big["v1_device_ms"],
         "median_shape": [n_med, x.shape[1]], "median_ms": med_f["ms"],
         "median_device_ms": med_f["device_ms"],
         "median_v1_ms": med_f["v1_ms"],
         "median_v1_device_ms": med_f["v1_device_ms"],
         "median_bound_ms": med_f["bound_ms"]},
        {"name": "rfr_capacity_sweep", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_capacity_sweep"],
         "launches": l_c["rfr_capacity_sweep"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": pms_s, "bound_ms": b_s, "bound_by": by_s,
         "library_ms": None, "shape": list(xs.shape), "device_ms": dms_s,
         "median_shape": list(med), "median_ms": ms_sm,
         "median_device_ms": dms_sm},
    ]


# ---------------------------------------------------------------------------
# phases 4 and 5: the LM kernels and serving recurrentgemma-2b
# ---------------------------------------------------------------------------


def matmul_peak(dtype) -> float:
    """The card's dense tensor-core rate for products of `dtype` inputs:
    bf16, or TF32 for f32 (the rate an f32-accurate 3xTF32 kernel draws
    on; the CUDA cores' 67 TFLOP/s is printed beside as the old bound)."""
    import torch
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S


def flash_bound(bh: int, bh_kv: int, s: int, d: int, dtype, pairs: int,
                peak=None):
    """q, k, v read once and o written once; 4*D operations (two
    multiply-adds, for q.k and p.v) per query-key pair the mask keeps, at
    the tensor-core rate for the inputs' type (or `peak`)."""
    import torch
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * bh + 2 * bh_kv) * s * d * esize
    return bound(nbytes, 4 * bh * d * pairs, peak or matmul_peak(dtype))


def tf32_flash(q, k, v, kw):
    """The 3xTF32 kernel of csrc/flash_attention_tf32.cu called directly
    (f32, D in 64, 128, 256), also where the wrapper keeps the case on the
    CUDA-core kernel; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_attention_tf32")
    mask = (int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
            int(kw.get("window", 0)))
    splits = lib.flash_attention_tf32_splits(bh, s, d, *mask)
    part = torch.empty(splits * bh * s * (d + 2), device=q.device)
    err = lib.flash_attention_tf32_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part.data_ptr(), bh, s, d, bh // k.shape[0], *mask,
        float(kw.get("softcap", 0.0)), splits,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention (tf32, direct)")
    return out


def simt_flash(q, k, v, kw):
    """The CUDA-core kernel of csrc/flash_attention.cu called directly, so
    that it can be held and timed at shapes where the wrapper takes a
    tensor-core path; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    out = torch.empty_like(q)
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        bh // k.shape[0], int(q.dtype == torch.bfloat16),
        int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
        int(kw.get("window", 0)), float(kw.get("softcap", 0.0)),
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention (simt, direct)")
    return out


def hold_flash(q, k, v, kw, with_library: bool):
    """flash_attention on (BH, S, D) tensors against its plain version
    (k and v repeated, materialised softmax), both timed; the library
    yardstick is scaled_dot_product_attention with the same boolean mask.
    The wrapper must launch the kernel that ``path`` names; where that is
    a tensor-core kernel, the CUDA-core kernel is held and timed beside
    it.  Returns a dict of the measurements."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, path
    bh, s, d = q.shape
    group = bh // k.shape[0]
    dt = str(q.dtype).split(".")[-1]
    first, second = ATTN_TOL[dt]

    def plain(values=v):
        return ref.flash_attention_ref(q, k.repeat_interleave(group, 0),
                                       values.repeat_interleave(group, 0),
                                       **kw)

    def held(got, want, what):
        want = want.float()
        diff = (got.float() - want).abs()
        err = float(diff.max())
        if dt == "bfloat16":
            allowed = first * want.abs() + second * plain(v.abs()).float()
        else:
            allowed = first + second * want.abs()
        worst = float((diff / allowed).max())
        check(worst <= 1.0, f"flash_attention ({what}) S={s} D={d} {dt} "
              f"{kw}: max_abs_err {err}, the worst element at {worst:.3g} "
              f"of its allowance")
        return err, worst

    n0 = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, **kw)
    ran = [p for p, n in flash_attention.launches_by_path.items()
           if n != n0[p]]
    want = plain()
    torch.cuda.synchronize()
    want_path = path(q.dtype, d, kw.get("softcap", 0.0))
    check(ran == [want_path], f"flash_attention S={s} D={d} {dt}: "
          f"ran {ran}, path says {want_path}")
    err, worst = held(got, want, ran[0])
    mask = ref.attention_mask(s, kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    pairs = int(mask.sum())
    out = {"max_abs_err": err, "worst": worst, "pairs": pairs,
           "path": ran[0]}
    if ran[0] == "tf32":
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import KINDS
        out["kv_shares"] = _build.load(
            "flash_attention_tf32").flash_attention_tf32_splits(
                bh, s, d, int(kw.get("causal", True)),
                KINDS[kw.get("kind", "global")], int(kw.get("window", 0)))
    if with_library:
        out["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw))
        out["device_ms"] = time_ms(lambda: flash_attention(q, k, v, **kw),
                                   queued=True)
        if ran[0] != "simt":
            out["simt_err"], out["simt_worst"] = held(
                simt_flash(q, k, v, kw), want, "simt")
            out["simt_ms"] = time_ms(lambda: simt_flash(q, k, v, kw))
            out["simt_device_ms"] = time_ms(lambda: simt_flash(q, k, v, kw),
                                            queued=True)
        out["plain_ms"] = time_ms(plain)
        q4 = q.view(1, bh, s, d)
        k4 = k.view(1, -1, s, d).expand(1, bh, s, d)
        v4 = v.view(1, -1, s, d).expand(1, bh, s, d)

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

        out["library_ms"] = time_ms(library)
        out["library_device_ms"] = time_ms(library, queued=True)
        out["bound_ms"], out["bound_by"] = flash_bound(
            bh, k.shape[0], s, d, q.dtype, pairs)
        if q.dtype == torch.float32:
            out["cuda_core_bound_ms"], _ = flash_bound(
                bh, k.shape[0], s, d, q.dtype, pairs, F32_OPS_PER_S)
    return out


def f64_shares(q, k, v, kw) -> str:
    """f32 attention's worst element against the same function in
    float64, as a share of the f32 tolerance (1e-5 absolute plus 1e-5
    relative), for the 3xTF32 kernel (called directly where the wrapper
    would not take it), the CUDA-core kernel and the plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    group = q.shape[0] // k.shape[0]
    kr, vr = (a.double().repeat_interleave(group, 0) for a in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.double(), kr) / q.shape[-1] ** 0.5
    if kw.get("softcap"):
        s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
    mask = ref.attention_mask(q.shape[1], kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    s = torch.where(mask[None], s, torch.full_like(s, ref.NEG_INF))
    want = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vr)

    def share(got):
        return float(((got.double() - want).abs()
                      / (1e-5 + 1e-5 * want.abs())).max())

    plain = share(ref.flash_attention_ref(
        q, k.repeat_interleave(group, 0), v.repeat_interleave(group, 0),
        **kw))
    return (f"3xTF32 kernel {share(tf32_flash(q, k, v, kw)):.3g}, CUDA-core "
            f"kernel {share(simt_flash(q, k, v, kw)):.3g}, plain "
            f"{plain:.3g} of the tolerance")


def first_scan(a, b, h0):
    """The first kernel of csrc/rglru_scan.cu, one thread a channel,
    called directly so that it can be held and timed beside the
    wrapper's; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    bsz, s, w = a.shape
    out = torch.empty_like(a)
    lib = _build.load("rglru_scan")
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), bsz, s, w, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rglru_scan (first kernel)")
    return out


def hold_scan(a, b, h0):
    """rglru_scan against its plain version and the first kernel, each
    exactly; the wrapper must take the kernel ``path`` names, and on the
    TMA path its device time must be no larger than the first kernel's.
    All timed; returns a dict of the measurements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import path, rglru_scan
    what = f"rglru_scan {tuple(a.shape)} h0={h0 is not None}"
    n0 = dict(rglru_scan.launches_by_path)
    got = rglru_scan(a, b, h0)
    ran = [k for k, n in rglru_scan.launches_by_path.items() if n != n0[k]]
    want = ref.rglru_scan_ref(a, b, h0)
    first = first_scan(a, b, h0)
    torch.cuda.synchronize()
    check(ran == [path(*a.shape)], f"{what}: ran {ran}, path says "
          f"{path(*a.shape)}")
    err = float((got - want).abs().max())
    out = {"path": ran[0], "max_abs_err": err,
           "simt_err": float((first - want).abs().max())}
    check(err == 0 and out["simt_err"] == 0,
          f"{what}: max_abs_err {err}, first kernel {out['simt_err']}")
    n = a.numel()
    nbytes = 3 * n * 4 + (0 if h0 is None else h0.numel() * 4)
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * n)
    out["ms"] = time_ms(lambda: rglru_scan(a, b, h0))
    out["device_ms"] = time_ms(lambda: rglru_scan(a, b, h0), queued=True)
    out["simt_ms"] = time_ms(lambda: first_scan(a, b, h0))
    out["simt_device_ms"] = time_ms(lambda: first_scan(a, b, h0),
                                    queued=True)
    if ran[0] == "tma":
        check(out["device_ms"] <= out["simt_device_ms"],
              f"{what}: device {out['device_ms']:.4f} ms, slower than the "
              f"first kernel's {out['simt_device_ms']:.4f} ms")
    out["plain_ms"] = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), reps=5)
    out["library_ms"] = None
    return out


def ssd_bound(bsz: int, heads: int, groups: int, s: int, p: int, n: int,
              dtype, with_h0: bool, peak=None):
    """x and y, dA and dt, the grouped B and C read or written once, h0
    read and the final state written in f32; operations at the kernels'
    chunk of 64: 2N (C B^T) and 2P (M x) per row pair the causal mask
    keeps within a chunk, 2NP (C h^T) and 2NP (the state update) per
    row, at the tensor-core rate for the inputs' type (or `peak`)."""
    import torch
    from repro_torch.kernels.ssd_scan import CHUNK
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (esize * (2 * bsz * heads * s * p + 2 * bsz * groups * s * n)
              + 4 * 2 * bsz * heads * s
              + 4 * bsz * heads * p * n * (2 if with_h0 else 1))
    pairs = sum(c * (c + 1) // 2 for c in
                (min(CHUNK, s - c0) for c0 in range(0, s, CHUNK)))
    ops = bsz * heads * (2 * pairs * (n + p) + 4 * s * n * p)
    return bound(nbytes, ops, peak or matmul_peak(dtype))


def simt_ssd(x, dA, dt, Bm, Cm, h0):
    """The CUDA-core kernel of csrc/ssd_scan.cu called directly, so that it
    can be held and timed at shapes where the wrapper takes the
    tensor-core path; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    bsz, heads, s, p = x.shape
    groups, n = Bm.shape[1], Bm.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((bsz, heads, p, n), dtype=torch.float32, device=x.device)
    err = _build.load("ssd_scan").ssd_scan_fwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), bsz, heads, groups, s, p, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssd_scan (simt, direct)")
    return y, h


def hold_ssd(x, dA, dt, Bm, Cm, h0, timed: bool):
    """ssd_scan against its plain version at the kernels' chunk; the
    wrapper must launch the kernel that ``path`` names, and where that is
    the tensor-core kernel the CUDA-core kernel is held beside it.  With
    `timed`, each timed and the bound computed.  Returns a dict of the
    measurements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import CHUNK, path, ssd_scan

    def plain():
        return ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)

    bsz, heads, s, p = x.shape
    dt_name = str(x.dtype).split(".")[-1]
    what = f"ssd_scan S={s} {dt_name} h0={h0 is not None}"
    n0 = dict(ssd_scan.launches_by_path)
    y, h = ssd_scan(x, dA, dt, Bm, Cm, h0)
    ran = [k for k, n in ssd_scan.launches_by_path.items() if n != n0[k]]
    yp, hp = plain()
    torch.cuda.synchronize()
    want_path = path(x.dtype, p, Bm.shape[3])
    check(ran == [want_path], f"{what}: ran {ran}, path says {want_path}")
    tol = SSD_TOL[dt_name]
    y_scale = float(yp.float().abs().max())

    def held(y, h, kernel):
        err = float((y.float() - yp.float()).abs().max())
        h_err = float((h - hp).norm() / hp.norm())
        check(bool(torch.isfinite(y.float()).all()),
              f"{what} ({kernel}): y not finite")
        check(err <= tol * y_scale, f"{what} ({kernel}): max_abs_err {err} "
              f"of {y_scale}")
        check(h_err <= tol, f"{what} ({kernel}): state differs by {h_err} "
              "in norm")
        return err, h_err

    err, h_err = held(y, h, ran[0])
    out = {"max_abs_err": err, "y_scale": y_scale, "h_err": h_err,
           "path": ran[0]}
    if ran[0] != "simt":
        out["simt_err"], out["simt_h_err"] = held(
            *simt_ssd(x, dA, dt, Bm, Cm, h0), "simt")
    if timed:
        out["ms"] = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm, h0))
        out["device_ms"] = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm, h0),
                                   queued=True)
        if ran[0] != "simt":
            out["simt_ms"] = time_ms(lambda: simt_ssd(x, dA, dt, Bm, Cm, h0))
            out["simt_device_ms"] = time_ms(
                lambda: simt_ssd(x, dA, dt, Bm, Cm, h0), queued=True)
        out["plain_ms"] = time_ms(plain)
        out["library_ms"] = None
        shape = (bsz, heads, Bm.shape[1], s, p, Bm.shape[3], x.dtype,
                 h0 is not None)
        out["bound_ms"], out["bound_by"] = ssd_bound(*shape)
        if x.dtype == torch.float32:
            out["cuda_core_bound_ms"], _ = ssd_bound(*shape, F32_OPS_PER_S)
    return out


def ssd_layout_cost(x, dA, dt, Bm, Cm, A):
    """What the model's layout costs around the scan: ``ops.ssd_op`` on
    (B, S, H, .) tensors (its transposes to the kernel's layout and dA =
    dt A, then the kernel) against the kernel alone on tensors already
    in its layout; printed."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    xm, dtm = x.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous()
    Bmm, Cmm = Bm.transpose(1, 2).contiguous(), Cm.transpose(1, 2).contiguous()
    op = time_ms(lambda: ops.ssd_op(xm, dtm, A, Bmm, Cmm), queued=True)
    alone = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm), queued=True)
    print(f"phase4 ssd_scan layout S={x.shape[2]} {str(x.dtype)[6:]}: "
          f"ops.ssd_op in the model's layout device {op:.4f} ms, the "
          f"kernel alone {alone:.4f} ms: the transposes and dt A cost "
          f"{op - alone:.4f} ms a layer")


def phase4_lm_kernels():
    """The LM kernels against their plain versions on the card: flash
    attention at the serving shapes (B = 1, 10 query heads, 1 kv head,
    D = 256, local window 2,048) and at small shapes for the other masks;
    the RG-LRU scan at the serving widths; the SSD scan at mamba2-2.7b's
    serving shapes.  Returns the measurements of the largest serving
    shapes, for the kernels line."""
    import inspect
    import torch
    from repro_torch.kernels.flash_attention import path
    from repro_torch.kernels.rglru_scan import path as scan_path
    from repro_torch.kernels.ssd_scan import path as ssd_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for name, fn in (("flash_attention", path), ("rglru_scan", scan_path),
                     ("ssd_scan", ssd_path)):
        print(f"phase4 {name} chooses its kernel by its arguments alone:\n"
              + "".join(f"phase4 | {line}" for line in
                        inspect.getsourcelines(fn)[0]).rstrip())
    serve = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in SERVE_PROMPTS:
            q, k, v = randn(10, s, 256, dtype=dtype), \
                randn(1, s, 256, dtype=dtype), randn(1, s, 256, dtype=dtype)
            kw = dict(causal=True, kind="local", window=2048)
            m = hold_flash(q, k, v, kw, with_library=True)
            dt = str(dtype).split(".")[-1]
            simt = (f", simt kernel {m['simt_ms']:.4f} ms (device "
                    f"{m['simt_device_ms']:.4f} ms, max_abs_err "
                    f"{m['simt_err']:.3g}, {m['simt_worst']:.3g} of the "
                    "allowance)" if "simt_ms" in m else "")
            old_bound = (f"; at the CUDA cores' 67 TFLOP/s "
                         f"{m['cuda_core_bound_ms']:.5f} ms"
                         if "cuda_core_bound_ms" in m else "")
            shares = (f" ({m['kv_shares']} kv shares)" if "kv_shares" in m
                      else "")
            print(f"phase4 flash_attention BH=10 G=10 S={s} D=256 local "
                  f"2048 {dt} path={m['path']}{shares}: max_abs_err "
                  f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the "
                  f"allowance), kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms){simt}, plain "
                  f"{m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} ms "
                  f"(device {m['library_device_ms']:.4f} ms), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}{old_bound}), "
                  f"pairs {m['pairs']}")
            # both tensor-core paths serve these shapes and must not lose
            # to the library call in either measure
            want = "wgmma" if dtype == torch.bfloat16 else "tf32"
            check(m["path"] == want
                  and m["ms"] <= m["library_ms"]
                  and m["device_ms"] <= m["library_device_ms"],
                  f"flash_attention S={s} {dt}: path {m['path']}, "
                  f"{m['ms']:.4f} ms (device {m['device_ms']:.4f} ms) "
                  f"against sdpa {m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f} ms)")
            if s == max(SERVE_PROMPTS):
                key = ("flash_attention" if dtype == torch.bfloat16
                       else "flash_attention f32")
                serve[key] = dict(m, shape=[10, s, 256])
    masks = (dict(causal=True, kind="global"),
             dict(causal=True, kind="chunked", window=128),
             dict(causal=True, kind="global", softcap=50.0),
             dict(causal=False, kind="global"),
             dict(causal=False, kind="local", window=96))
    small = [(torch.bfloat16, 64, kw) for kw in masks]
    small += [(torch.float32, 64, kw) for kw in masks]
    small += [(torch.bfloat16, 128, kw) for kw in masks]
    small += [(torch.bfloat16, 32, masks[0])]
    for dtype, d, kw in small:
        scale = 8.0 if kw.get("softcap") else 1.0
        q = randn(8, 333, d, dtype=dtype) * scale
        k = randn(4, 333, d, dtype=dtype) * scale
        v = randn(4, 333, d, dtype=dtype)
        m = hold_flash(q, k, v, kw, with_library=False)
        exact = (", from float64: " + f64_shares(q, k, v, kw)
                 if dtype == torch.float32 else "")
        print(f"phase4 flash_attention BH=8 G=2 S=333 D={d} {kw} "
              f"{str(dtype).split('.')[-1]} path={m['path']}: max_abs_err "
              f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the allowance)"
              f"{exact}")
    # f32 with a softcap (scores of magnitude 16 and 64): the plain
    # version's own rounding is of the tolerance's size or above, which is
    # why path() keeps these on the CUDA-core kernel; the 3xTF32 kernel's
    # error beside it (printed, not held)
    for d in (64, 128, 256):
        for cap, scale in ((20.0, 4.0), (50.0, 8.0)):
            kw = dict(causal=True, kind="global", softcap=cap)
            q, k = randn(8, 333, d) * scale, randn(4, 333, d) * scale
            v = randn(4, 333, d)
            print(f"phase4 flash_attention BH=8 G=2 S=333 D={d} {kw} "
                  f"float32 x{scale:g}, from float64: "
                  f"{f64_shares(q, k, v, kw)}")
    for (bsz, s, w), with_h0 in (((1, 3000, 2560), False),
                                 ((1, 3000, 2560), True),
                                 ((4, 1000, 2560), False)):
        a = torch.rand((bsz, s, w), generator=gen, device=dev) * 0.5 + 0.5
        b = randn(bsz, s, w)
        h0 = randn(bsz, w) if with_h0 else None
        m = hold_scan(a, b, h0)
        print(f"phase4 rglru_scan ({bsz}, {s}, {w}) h0={with_h0} "
              f"path={m['path']}: max_abs_err {m['max_abs_err']} (first "
              f"kernel {m['simt_err']}), kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f} ms), first kernel "
              f"{m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} ms, "
              f"{m['simt_device_ms'] / m['device_ms']:.2f}x the new), plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
              f"({m['bound_by']})")
        check(m["path"] == "tma", f"rglru_scan ({bsz}, {s}, {w}): path "
              f"{m['path']}")
        if (bsz, s, with_h0) == (1, 3000, False):
            serve["rglru_scan"] = dict(m, shape=[bsz, s, w])
    heads, p, n = 80, 64, 128
    A = -torch.linspace(1.0, 16.0, heads, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        for s in SSM_PROMPTS:
            for with_h0 in (False, True):
                dt = torch.nn.functional.softplus(randn(1, heads, s) - 2.0)
                args = (randn(1, heads, s, p, dtype=dtype),
                        dt * A[None, :, None], dt,
                        randn(1, 1, s, n, dtype=dtype),
                        randn(1, 1, s, n, dtype=dtype),
                        randn(1, heads, p, n) if with_h0 else None)
                m = hold_ssd(*args, timed=not with_h0)
                dt_name = str(dtype).split(".")[-1]
                line = (f"phase4 ssd_scan B=1 H={heads} G=1 S={s} P={p} "
                        f"N={n} {dt_name} h0={with_h0} path={m['path']}: "
                        f"max_abs_err {m['max_abs_err']:.3g} of max |y| "
                        f"{m['y_scale']:.3g}, state err {m['h_err']:.3g} "
                        "in norm")
                if "simt_err" in m:
                    line += (f" (simt kernel: {m['simt_err']:.3g}, state "
                             f"{m['simt_h_err']:.3g})")
                if not with_h0:
                    line += (f", kernel {m['ms']:.4f} ms (device "
                             f"{m['device_ms']:.4f} ms)")
                    if "simt_ms" in m:
                        line += (f", simt kernel {m['simt_ms']:.4f} ms "
                                 f"(device {m['simt_device_ms']:.4f} ms, "
                                 f"{m['simt_device_ms'] / m['device_ms']:.2f}"
                                 "x the new)")
                    line += (f", plain {m['plain_ms']:.4f} ms, bound "
                             f"{m['bound_ms']:.5f} ms ({m['bound_by']}")
                    if "cuda_core_bound_ms" in m:
                        line += (f"; at the CUDA cores' 67 TFLOP/s "
                                 f"{m['cuda_core_bound_ms']:.5f} ms")
                    line += ")"
                print(line)
                if "simt_device_ms" in m:
                    check(m["device_ms"] <= m["simt_device_ms"],
                          f"ssd_scan S={s} {dt_name}: the tensor-core "
                          f"kernel {m['device_ms']:.4f} ms, slower than the "
                          f"CUDA-core kernel {m['simt_device_ms']:.4f} ms")
                if (s, dtype, with_h0) == (max(SSM_PROMPTS), torch.bfloat16,
                                           False):
                    serve["ssd_scan"] = dict(m, shape=[1, heads, s, p, n])
                    ssd_layout_cost(*args[:5], A)
    return serve


def lm_counts() -> dict:
    """The LM kernel wrappers' launch counts, each also by path
    ("flash_attention.wgmma", "rglru_scan.tma", "ssd_scan.simt", ...)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    counts = {"flash_attention": flash_attention.launches}
    for p, n in flash_attention.launches_by_path.items():
        counts[f"flash_attention.{p}"] = n
    counts["rglru_scan"] = rglru_scan.launches
    for p, n in rglru_scan.launches_by_path.items():
        counts[f"rglru_scan.{p}"] = n
    counts["ssd_scan"] = ssd_scan.launches
    for p, n in ssd_scan.launches_by_path.items():
        counts[f"ssd_scan.{p}"] = n
    return counts


def reset_lm_counts():
    import repro_torch.kernels.flash_attention as flash_module
    import repro_torch.kernels.rglru_scan as scan_module
    import repro_torch.kernels.ssd_scan as ssd_module
    for module in (flash_module, scan_module, ssd_module):
        module.reset_launches()


class PrefillRecorder:
    """Keeps each prefill's last-position logits, its recurrent or SSM
    layers' final states h (on the host, f32) and the LM kernels it
    launched, in the order the engine admits requests.  Wraps the name
    the serving engine calls."""

    def __init__(self):
        from repro_torch.models import model as model_lib
        self.mod = model_lib
        self.orig = model_lib.prefill
        self.logits = []
        self.states = []
        self.launches = []

        def rec(*args, **kw):
            n0 = lm_counts()
            logits, cache = self.orig(*args, **kw)
            self.launches.append({k: n - n0[k]
                                  for k, n in lm_counts().items()})
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
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, use_kernel=use_kernel)
    eng.scale_up(1)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p.copy(), SERVE_MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = PrefillRecorder()
    reset_lm_counts()
    try:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    launches = lm_counts()
    return (sorted(done, key=lambda r: r.rid), rec, launches, wall,
            torch.cuda.max_memory_allocated())


def profile_serving(cfg, params, prompt, phase: str, first_ms=None):
    """One prefill of `prompt` into a fresh instance and one decode step,
    under torch.profiler (host and device activity): wall time, device
    busy share, and the largest entries by device and by host time; the
    flash and RG-LRU scan kernels' device time in the prefill, each
    beside `first_ms[name]` (the first kernel's phase-4 device time at
    the same shape, times the launches) where given.  A measurement only;
    prints "not measured" without device time."""
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
            print(f"{phase} profile {label}: device time not measured")
            continue
        top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
        host = [e for e in rows if e.device_type == DeviceType.CPU]
        top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
        print(f"{phase} profile {label} (prompt {len(prompt)}, profiled "
              f"{wall * 1e3:.1f} ms): device busy {busy * 1e3:.2f} ms, "
              f"idle share {1 - busy / wall:.4f}; {len(host)} host op "
              f"kinds, {sum(e.count for e in host)} host op calls")
        print(f"{phase} profile   device: " + "; ".join(
            f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} "
            f"ms" for e in top_dev))
        print(f"{phase} profile   host: " + "; ".join(
            f"{e.key[:32]} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
            for e in top_host))
        if label == "prefill":
            # device time by the host op that launched it
            ops = sorted((e for e in host if e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)[:6]
            print(f"{phase} profile   device time by op: " + "; ".join(
                f"{e.key[:24]} x{e.count} "
                f"{e.self_device_time_total / 1e3:.2f} ms" for e in ops))
            ssd = [e for e in dev if "ssd_" in e.key]
            if ssd:
                print(f"{phase} profile   ssd: " + "; ".join(
                    f"{e.key[:40]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.2f} ms" for e in ssd))
        for name, key in (("flash", "flash"), ("scan", "rglru")):
            mine = [e for e in dev if key in e.key]
            if label != "prefill" or not mine:
                continue
            first = (first_ms or {}).get(name)
            ref_text = ("" if first is None else
                        f"; the first kernel at this shape in phase 4, "
                        f"times the launches: {first:.2f} ms")
            print(f"{phase} profile   {name}: " + "; ".join(
                f"{e.key[:40]} x{e.count}" for e in mine) + ", device "
                f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} "
                f"ms{ref_text}")


def serve_full_width(phase: str, arch: str, prompt_lengths, seed: int,
                     per_prefill: dict, layers_label: str, first_ms=None):
    """`arch` at its published width on the card, random f32 weights from
    a seeded generator, computed in the config's dtype: one
    ServingEngine instance (4 slots, max_len 4,096) serves two requests
    of each prompt length, with the kernels and then with their plain
    versions.  Each prefill must launch `per_prefill` kernels; the
    prefills' logits, final states and first tokens must agree.  Returns
    the kernels' launches in the kernels' run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine
    label = phase.replace("phase", "phase ")
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{phase} {arch}: {n_params:,} parameters (f32, computed in "
          f"{cfg.dtype}; the config's estimate {cfg.param_count():,}), "
          f"{cfg.n_layers} layers ({layers_label}), d_model {cfg.d_model}, "
          f"init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lengths for _ in range(2)]
    # warm-up (cuBLAS handles, the kernels' first launch), not counted
    warm = ServingEngine(cfg, params, slots=1, max_len=SERVE_MAX_LEN)
    warm.scale_up(1)
    warm.submit(Request(-1, prompts[0][:256].copy(), 2))
    warm.drain()
    del warm

    done, rec_k, launches, wall, peak = _serve(cfg, params, prompts, True)
    check(len(done) == len(prompts)
          and all(len(r.tokens) == SERVE_MAX_NEW for r in done),
          f"{label}: not every request finished with max_new tokens")
    want = {k: n * len(prompts) for k, n in per_prefill.items()}
    print(f"{phase} launches (kernels run): {launches}, expected {want} "
          f"({per_prefill} per prefill)")
    check(launches == want, f"{label} launches {launches} != {want}")
    check(rec_k.launches == [per_prefill] * len(prompts),
          f"{label}: launches per prefill {rec_k.launches}")
    prefill_ms = [1e3 * (r.t_first_token - r.t_admit) for r in done]
    for r, ms in zip(done, prefill_ms):
        print(f"{phase} request {r.rid}: prompt {len(r.prompt)}, prefill "
              f"{ms:.2f} ms, latency {r.latency_ms:.2f} ms, tokens "
              f"{r.tokens[:4]}...")
    n_dec = sum(len(r.tokens) - 1 for r in done)
    dec_s = wall - sum(prefill_ms) / 1e3
    print(f"{phase} drain {wall:.3f} s: prefill {sum(prefill_ms):.2f} ms "
          f"total, decode {n_dec} tokens in {dec_s:.3f} s = "
          f"{n_dec / dec_s:.2f} tokens/s (4 slots), peak memory "
          f"{peak / 2**30:.3f} GiB")

    profile_serving(cfg, params, prompts[-1], phase, first_ms)

    done_p, rec_p, launches_p, wall_p, _ = _serve(cfg, params, prompts,
                                                  False)
    check(not any(launches_p.values()),
          f"{label}: the plain run launched kernels {launches_p}")
    check(len(rec_k.logits) == len(rec_p.logits) == len(prompts),
          f"{label}: a prefill was not recorded")
    worst, worst_h, n_checked = 0.0, 0.0, 0
    for i, (lk, lp) in enumerate(zip(rec_k.logits, rec_p.logits)):
        check(bool(torch.isfinite(lk).all()),
              f"{label} prefill {i}: logits not finite")
        scale = float(lp.abs().max())
        err = float((lk - lp).abs().max())
        worst = max(worst, err / scale)
        top2 = torch.topk(lp, 2).values
        margin = float(top2[0] - top2[1])
        tol = LOGIT_TOL * scale
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"{phase} prefill {i} (prompt {len(prompts[i])}): logits "
              f"max_abs_err {err:.4f} of max |logit| {scale:.2f} "
              f"(tol {tol:.4f}); top-2 margin {margin:.4f}; first token "
              f"same={same}")
        check(err <= tol, f"{label} prefill {i}: logits differ by {err}")
        # the scan's output itself: each recurrent or SSM layer's final
        # state, relative in norm (the logits are dominated by the
        # embedding)
        h_err = max(float((hk - hp).norm() / hp.norm())
                    for hk, hp in zip(rec_k.states[i], rec_p.states[i]))
        worst_h = max(worst_h, h_err)
        check(h_err <= LOGIT_TOL, f"{label} prefill {i}: states differ by "
              f"{h_err} in norm")
        if margin > tol:
            n_checked += 1
            check(same, f"{label} prefill {i}: first token differs")
    # how the state error grows with depth: bf16 rounding of each layer's
    # output, which the two runs do at other places, adds up layer by layer
    n_layers = len(rec_k.states[0])
    by_depth = [max(float((rec_k.states[i][j] - rec_p.states[i][j]).norm()
                          / rec_p.states[i][j].norm())
                    for i in range(len(prompts))) for j in range(n_layers)]
    marks = sorted({0, n_layers // 4, n_layers // 2, n_layers - 1})
    print(f"{phase} state error by layer (worst over prefills): " + "; ".join(
        f"layer {j + 1} {by_depth[j]:.5f}" for j in marks))
    print(f"{phase} state error by layer as a share of the {LOGIT_TOL} "
          "limit, layers 1 to " f"{n_layers}: " + " ".join(
              f"{e / LOGIT_TOL:.3f}" for e in by_depth))
    print(f"{phase} plain run: drain {wall_p:.3f} s; worst logits error "
          f"{worst:.5f} of max |logit|; worst state error {worst_h:.5f} in "
          f"norm over {len(rec_k.states[0])} layers; first token checked "
          f"on {n_checked} of {len(prompts)} prefills")
    return launches


def _leaves(tree):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase5_serving(flash_first_ms: float, scan_first_ms: float):
    """recurrentgemma-2b: 8 flash launches per prefill, all on the
    tensor-core path (bf16, head dim 256), and 18 RG-LRU scans, all on
    the TMA path.  The first kernels' phase-4 device times at the longest
    prompt, times the launches, stand beside the profiled prefill's."""
    from repro_torch.configs import get_config
    kinds = get_config(SERVE_ARCH).layer_kinds()
    n_local, n_rec = kinds.count("local"), kinds.count("recurrent")
    return serve_full_width(
        "phase5", SERVE_ARCH, SERVE_PROMPTS, 5,
        {"flash_attention": n_local, "flash_attention.wgmma": n_local,
         "flash_attention.tf32": 0, "flash_attention.simt": 0,
         "rglru_scan": n_rec, "rglru_scan.tma": n_rec,
         "rglru_scan.simt": 0, "ssd_scan": 0, "ssd_scan.wgmma": 0,
         "ssd_scan.simt": 0},
        f"{n_local} local + {n_rec} recurrent",
        {"flash": n_local * flash_first_ms, "scan": n_rec * scan_first_ms})


def phase6_ssm_serving():
    """mamba2-2.7b, after phase 5's model is freed: 64 SSD scan launches
    per prefill, all on the tensor-core path (bf16, head dim 64, d_state
    128)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase6 before init: {torch.cuda.memory_allocated() / 2**30:.3f} "
          "GiB allocated")
    cfg = get_config(SSM_ARCH)
    n_ssm = cfg.layer_kinds().count("ssm")
    check(n_ssm == cfg.n_layers == 64 and cfg.d_model == 2560,
          f"phase 6: {SSM_ARCH} is {cfg.n_layers} layers ({n_ssm} SSM) of "
          f"{cfg.d_model}")
    return serve_full_width(
        "phase6", SSM_ARCH, SSM_PROMPTS, 6,
        {"flash_attention": 0, "flash_attention.wgmma": 0,
         "flash_attention.tf32": 0, "flash_attention.simt": 0,
         "rglru_scan": 0, "rglru_scan.tma": 0, "rglru_scan.simt": 0,
         "ssd_scan": n_ssm, "ssd_scan.wgmma": n_ssm, "ssd_scan.simt": 0},
        f"{n_ssm} SSM, {cfg.ssd.n_heads(cfg.d_model)} heads of "
        f"{cfg.ssd.head_dim}, d_state {cfg.ssd.d_state}")


# ---------------------------------------------------------------------------
# phase 7: the platform facade
# ---------------------------------------------------------------------------


def _launches() -> dict:
    from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                                   rfr_forest_apply)
    return {"rfr_forest_apply": rfr_forest_apply.launches,
            "rfr_capacity_sweep": rfr_capacity_sweep.launches}


def _controllers(sim) -> list:
    """A run's admission controllers, one per cell."""
    cells = getattr(sim, "cells", None)
    if cells is None:
        return [sim.admission]
    return [c.autoscaler.admission for c in cells]


def _differing(got: dict, want: dict) -> list:
    return [k for k in want if got[k] != want[k]]


def phase7_smoke():
    """(a) The port's smoke() (every registered scheduler from manifest
    dicts, 30 ticks, 8 target nodes) on the card, then the same
    manifests on engine "numpy": every scheduler's outcome equal.  Each
    run's launches are counted from 0 (the run is wrapped to read
    them); the numpy runs launch nothing."""
    import torch
    from repro_torch.core import platform as core_platform
    from repro_torch.kernels.rfr_inference import reset_launches
    cls = core_platform.Platform
    runs = []
    orig_run = cls.run

    def counted_run(self, duration_s=None):
        reset_launches()
        res = orig_run(self, duration_s)
        torch.cuda.synchronize()
        runs.append((self.config, outcome(res, self.simulation),
                     _launches()))
        return res

    cls.run = counted_run
    try:
        t0 = time.perf_counter()
        core_platform.smoke()
        wall_card = time.perf_counter() - t0
        card, runs = runs, []
        t0 = time.perf_counter()
        scenario = world = None
        for cfg, _out, _l in card:
            manifest = cfg.to_dict()
            check(manifest["prediction"]["engine"] is None,
                  "phase 7: smoke() set an engine")
            manifest["prediction"]["engine"] = "numpy"
            plat = cls.build(scenario=scenario, config=manifest,
                             world=world)
            scenario, world = plat.scenario, plat.world
            world.gt.reseed()
            plat.run()
        wall_numpy = time.perf_counter() - t0
    finally:
        cls.run = orig_run
    check(len(runs) == len(card) > 0, "phase 7: smoke runs missing")
    for (cfg, out, launches), (_c, want, l_np) in zip(card, runs):
        name = cfg.scheduler.name
        diff = _differing(out, want)
        print(f"phase7 smoke {name}: density {out['density']!r}, "
              f"qos_violation_rate {out['qos_violation_rate']!r}, sched "
              f"{out['sched']}, launches {launches}; engine numpy: "
              f"differing fields {diff or 'none'}")
        check(not diff, f"phase 7 smoke {name}: the card's run differs "
              f"from numpy in {diff}")
        check(not any(l_np.values()), f"phase 7 smoke {name}: the numpy "
              "run launched a kernel")
    total = {k: sum(l[k] for _c, _o, l in card) for k in card[0][2]}
    print(f"phase7 smoke: {len(card)} schedulers, card {wall_card:.2f} s, "
          f"numpy {wall_numpy:.2f} s, launches on the card {total}")
    check(total["rfr_forest_apply"] > 0,
          "phase 7 smoke never launched the forest kernel")


def phase7_control_plane():
    """(b) SCENARIO through Platform.build in PLATFORM_CELLS cells with
    admission on, on one shared world (reseeded before each run): b1
    jiagu on engine numpy (the oracle), b2 the same on engine "cuda",
    b3 jiagu-device-drain on "cuda".  b2 and b3 equal b1 in every
    outcome and every node's table; conservation within
    CONSERVATION_TOL; b2 launches the forest kernel, b3 the sweep."""
    import torch
    from repro_torch.core.platform import Platform
    from repro_torch.kernels.rfr_inference import reset_launches
    base = {"scenario": {"kind": "burst-storm", **SCENARIO},
            "cells": {"count": PLATFORM_CELLS},
            "admission": {"enabled": True}}
    runs = {}
    scenario = world = None
    for label, name, engine, drain in (
            ("b1", "jiagu", "numpy", "host"),
            ("b2", "jiagu", "cuda", "host"),
            ("b3", "jiagu-device-drain", "cuda", "device")):
        manifest = {**base, "scheduler": {"name": name},
                    "prediction": {"engine": engine}}
        t0 = time.perf_counter()
        plat = Platform.build(scenario=scenario, config=manifest,
                              world=world)
        build_s = time.perf_counter() - t0
        scenario, world = plat.scenario, plat.world
        sim = plat.simulation
        check(len(sim.cells) == PLATFORM_CELLS,
              f"phase 7 {label}: {len(sim.cells)} cells")
        check(all(s.cfg.drain == drain and s.inference_engine == engine
                  for s in sim.services()),
              f"phase 7 {label}: a cell's service is not {engine}/{drain}")
        world.gt.reseed()
        reset_launches()
        t0 = time.perf_counter()
        res = plat.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launches()
        out = outcome(res, sim)
        worst = max(c.conservation_error() for c in _controllers(sim))
        print(f"phase7 run ({label}) {name} engine={engine} drain={drain} "
              f"cells={PLATFORM_CELLS} admission on: build {build_s:.2f} s, "
              f"run {run_s:.2f} s, density {out['density']!r}, "
              f"qos_violation_rate {out['qos_violation_rate']!r}, "
              f"nodes_peak {out['nodes_peak']}, sched {out['sched']}, "
              f"scaling {out['scaling']}, class rates "
              f"{out['class_violation_rates']}, dropped "
              f"{out['dropped_requests']!r}, conservation error {worst:.3g}"
              f", launches {launches}")
        check(res.ticks == SCENARIO["duration_s"] and res.sched.decisions,
              f"phase 7 {label}: the run did not schedule")
        check(out["class_requests"], f"phase 7 {label}: admission idle")
        check(worst < CONSERVATION_TOL,
              f"phase 7 {label}: conservation error {worst}")
        runs[label] = (out, launches)
    oracle, l_b1 = runs["b1"]
    check(not any(l_b1.values()), "phase 7 b1 (numpy) launched a kernel")
    for label in ("b2", "b3"):
        got = runs[label][0]
        diff = _differing(got, oracle)
        n_tables = sum(x != y for x, y in zip(got["tables"],
                                               oracle["tables"]))
        print(f"phase7 run ({label}) vs oracle (b1): differing fields "
              f"{diff or 'none'}; nodes with differing tables {n_tables} "
              f"of {len(oracle['tables'])}")
        check(not diff, f"phase 7 {label} differs from b1 in {diff}")
    check(runs["b2"][1]["rfr_forest_apply"] > 0,
          "phase 7 b2 never launched the forest kernel")
    check(runs["b3"][1]["rfr_capacity_sweep"] > 0,
          "phase 7 b3 never launched the sweep kernel")
    return scenario, world, {label: l for label, (_o, l) in runs.items()}


def phase7_learned(scenario, world):
    """(c) The learned stack at SCENARIO's size, one cell, on the card:
    the policy installed from a PolicyStore in a temporary directory,
    each scored batch recorded and held to np_scores (SCORE_TOL, the
    same argmax wherever the top-2 margin exceeds it); no stale
    serve."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.platform import Platform
    from repro_torch.kernels.rfr_inference import reset_launches
    from repro_torch.policy import (PolicyStore, forward, init_params,
                                    load_traces, matrices, normalization,
                                    np_scores)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 7 (c): TF32 matmuls are on; the scores need full f32")
    ds = load_traces(str(ROOT / POLICY_TRACES))
    x_all, mask, _y = matrices(ds)
    policy = init_params(ds.n_features, POLICY_HIDDEN, POLICY_SEED)
    policy["mu"], policy["sd"] = normalization(x_all, mask)
    batches = []        # (rows, scores, host-inclusive seconds)
    with tempfile.TemporaryDirectory() as store:
        PolicyStore(store).save(policy, epoch=0, mode="init",
                                feature_names=ds.feature_names)
        plat = Platform.build(scenario=scenario, world=world, config={
            "scenario": {"kind": "burst-storm", **SCENARIO},
            "scheduler": {"name": "learned"},
            "prediction": {"engine": "cuda"}, "policy": {"store": store}})
        scorer = plat.scheduler.learned_scorer
        check(scorer.policy is not None
              and scorer._weights["w1"].is_cuda,
              "phase 7 (c): the policy is not on the card")
        inner = scorer.scores

        def recorded(rows):
            t0 = time.perf_counter()
            out = inner(rows)
            batches.append((rows, out, time.perf_counter() - t0))
            return out

        scorer.scores = recorded
        world.gt.reseed()
        reset_launches()
        t0 = time.perf_counter()
        res = plat.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = _launches()
    check(batches, "phase 7 (c): the learned scorer scored no batch")
    out = outcome(res, plat.simulation)
    worst, flips, clear, np_s = 0.0, 0, 0, []
    for rows, got, _s in batches:
        t0 = time.perf_counter()
        want = np_scores(policy, rows)
        np_s.append(time.perf_counter() - t0)
        worst = max(worst, float(np.abs(got - want).max()))
        if len(want) > 1:
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > SCORE_TOL:
                clear += 1
                flips += int(got.argmax() != want.argmax())
    n_rows = sum(len(r) for r, _g, _s in batches)
    # the forward alone at the median batch's rows, its input already on
    # the card: host and device, then the device's work alone
    rows = sorted((r for r, _g, _s in batches), key=len)[len(batches) // 2]
    x = torch.from_numpy(rows).cuda()
    fwd_ms = time_ms(lambda: forward(scorer._weights, x))
    fwd_dev_ms = time_ms(lambda: forward(scorer._weights, x), queued=True)
    print(f"phase7 learned: run {run_s:.2f} s, density {out['density']!r}, "
          f"qos_violation_rate {out['qos_violation_rate']!r}, nodes_peak "
          f"{out['nodes_peak']}, sched {out['sched']}, scaling "
          f"{out['scaling']}, launches {launches}; scorer "
          f"{scorer.stats.snapshot()}; {len(batches)} batches, {n_rows} "
          f"rows (largest {max(len(r) for r, _g, _s in batches)}"
          f"), worst |score - np_scores| {worst:.3g} (limit {SCORE_TOL}), "
          f"argmax differs in {flips} of {clear} batches with a top-2 "
          f"margin above it; per batch, median: card "
          f"{statistics.median(s for _r, _g, s in batches) * 1e3:.4f} ms "
          f"(host-inclusive), np_scores {statistics.median(np_s) * 1e3:.4f}"
          f" ms; forward alone at the median batch ({len(rows)} rows, on "
          f"the card): {fwd_ms:.4f} ms (device {fwd_dev_ms:.4f} ms)")
    check(worst <= SCORE_TOL, f"phase 7 (c): scores {worst} from numpy")
    check(flips == 0, f"phase 7 (c): argmax differs in {flips} batches")
    check(scorer.stats.stale_serves == 0, "phase 7 (c): stale serves")
    check(launches["rfr_forest_apply"] > 0,
          "phase 7 (c) never launched the forest kernel")
    return launches


def phase7_platform():
    phase7_smoke()
    scenario, world, launches = phase7_control_plane()
    launches["c"] = phase7_learned(scenario, world)
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
        serve_launches = phase5_serving(
            lm["flash_attention"]["simt_device_ms"],
            lm["rglru_scan"]["simt_device_ms"])
        ssm_launches = phase6_ssm_serving()
        platform_launches = phase7_platform()
        for name in ("flash_attention", "rglru_scan", "ssd_scan"):
            m = lm[name]
            launches = (ssm_launches if name == "ssd_scan"
                        else serve_launches)[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": CSRC + SOURCES[name], "replaces": REPLACES[name],
                "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "shape": m["shape"]})
            # the path that ran and, for the redesigned kernels, the
            # first kernel they replace on it, timed in this run
            for key in ("path", "simt_ms", "simt_device_ms"):
                if key in m:
                    kernels[-1][key] = m[key]
        # launches of each forest kernel in phase 7's runs (b2 and c
        # launch the forest kernel, b3 the sweep)
        for k in kernels[:2]:
            k["platform_launches"] = {
                label: l[k["name"]] for label, l in platform_launches.items()
                if label != "b1"}
        f32 = lm["flash_attention f32"]
        flash = next(k for k in kernels if k["name"] == "flash_attention")
        flash["f32"] = {
            "source": CSRC + SOURCES["flash_attention f32"],
            **{key: f32[key] for key in (
                "path", "shape", "max_abs_err", "ms", "device_ms",
                "simt_ms", "simt_device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "cuda_core_bound_ms")}}
        print(f"flash_attention f32 path={f32['path']} "
              f"({CSRC}{SOURCES['flash_attention f32']}) at {f32['shape']}: "
              f"kernel {f32['ms']:.4f} ms (device {f32['device_ms']:.4f} ms), "
              f"CUDA-core kernel {f32['simt_ms']:.4f} ms (device "
              f"{f32['simt_device_ms']:.4f} ms), plain {f32['plain_ms']:.4f} "
              f"ms, sdpa {f32['library_ms']:.4f} ms (device "
              f"{f32['library_device_ms']:.4f} ms), bound "
              f"{f32['bound_ms']:.5f} ms ({f32['bound_by']}, TF32 rate; "
              f"{f32['cuda_core_bound_ms']:.5f} ms at 67 TFLOP/s), "
              f"max_abs_err {f32['max_abs_err']:.3g}")
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
