"""The hand-written kernels and the slice on the card, against their
plain versions and the numpy host oracle.

This file imports neither jax nor the JAX package, so it runs where the
card is: ``PYTHONPATH=src python -m pytest -q tests/test_torch_on_card.py``.
The ``cuda_only`` tests skip themselves without a card.  Tolerances:
1e-6 on predictions against the plain version (an f32 mean of at most
200 leaves; both sum in numpy's pairwise order, so the difference is 0
unless the compiler reorders), exact against the numpy oracle and on
capacities."""
import math

import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.core.cluster import Node
from repro_torch.kernels import ref
from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                               rfr_forest_apply)

PRED_TOL = 1e-6


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("cuda_only: no CUDA card here")
    return torch.device("cuda")


def _forest(rng, T, depth, F):
    NN = (1 << depth) - 1
    feat = rng.integers(0, F, (T, NN)).astype(np.int32)
    thr = rng.standard_normal((T, NN)).astype(np.float32)
    leaf = rng.standard_normal((T, 1 << depth)).astype(np.float32)
    return feat, thr, leaf


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _numpy_mean_predict(x, feat, thr, leaf):
    T, NN = feat.shape
    depth = (NN + 1).bit_length() - 1
    N = x.shape[0]
    idx = np.zeros((N, T), np.int64)
    t_ids = np.arange(T)[None, :]
    for _ in range(depth):
        go = x[np.arange(N)[:, None], feat[t_ids, idx]] >= thr[t_ids, idx]
        idx = 2 * idx + 1 + go
    return leaf[t_ids, idx - NN].mean(axis=1).astype(np.float32)


def _sweep_case(seed, S, M, R, T, depth, F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, R, F)).astype(np.float32)
    feat, thr, leaf = _forest(rng, T, depth, F)
    bounds = rng.uniform(-0.6, 0.6, (S, M, R)).astype(np.float32)
    for s in range(S):
        bounds[s, :, int(rng.integers(1, R + 1)):] = np.inf
        bounds[s, int(rng.integers(0, M + 1)):, :] = -np.inf
    return x, bounds, feat, thr, leaf


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers compute with the plain versions and
    their launch counts stay where they were."""
    x, bounds, feat, thr, leaf = _sweep_case(1, 3, 4, 2, 4, 3, 5)
    n0 = rfr_forest_apply.launches, rfr_capacity_sweep.launches
    rfr_forest_apply(*_t(x.reshape(-1, 5), feat, thr, leaf))
    rfr_capacity_sweep(*_t(x, bounds, feat, thr, leaf))
    assert (rfr_forest_apply.launches, rfr_capacity_sweep.launches) == n0


@pytest.mark.cuda_only
@pytest.mark.parametrize("N,T,depth,F", [(1, 24, 8, 31), (257, 64, 8, 33),
                                         (1000, 64, 10, 31),
                                         (300, 200, 4, 9)])
def test_forest_kernel_matches_plain(N, T, depth, F):
    dev = _card()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, F)).astype(np.float32)
    forest = _forest(rng, T, depth, F)
    args = _t(x, *forest, device=dev)
    n0 = rfr_forest_apply.launches
    got = rfr_forest_apply(*args)
    plain = ref.rfr_forest_ref(*args)
    torch.cuda.synchronize()
    assert rfr_forest_apply.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=PRED_TOL, rtol=PRED_TOL)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _numpy_mean_predict(x, *forest))


def _first_forest_kernel(x, feat, thr, leaf):
    """The first forest kernel (one thread a row), called directly."""
    from repro_torch.kernels import _build
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    err = _build.load("rfr_inference").rfr_forest_apply_v1(
        x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], feat.shape[0],
        ref.forest_depth(feat), x.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rfr_forest_apply_v1")
    return out


@pytest.mark.cuda_only
@pytest.mark.parametrize("T,depth", [(5, 6), (24, 8), (33, 7), (130, 6),
                                     (64, 10)])
@pytest.mark.parametrize("N", [1, 20, 63, 64, 65, 9372, 200_000])
def test_lane_split_forest_kernel_is_numpy_bitwise(N, T, depth):
    """The lane-split forest kernel at batch sizes around its 64-row pass
    and the control plane's median (20) and largest (9,372) calls; T = 5
    (the lanes' partial sums all 0), 24, 33 (a tail of one tree), 130
    (numpy's pairwise split above 128 trees) in shared memory and 64
    trees of depth 10 from device memory: bitwise the numpy oracle and
    the first kernel, one launch a call."""
    dev = _card()
    rng = np.random.default_rng(N + 7 * T + depth)
    x = rng.standard_normal((N, 31)).astype(np.float32)
    forest = _forest(rng, T, depth, 31)
    args = _t(x, *forest, device=dev)
    n0 = rfr_forest_apply.launches
    got = rfr_forest_apply(*args)
    assert rfr_forest_apply.launches == n0 + 1
    first = _first_forest_kernel(*args)
    torch.cuda.synchronize()
    want = _numpy_mean_predict(x, *forest)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(first.cpu().numpy(), want)


@pytest.mark.cuda_only
def test_forest_kernel_reads_wide_rows_from_device_memory():
    """Rows too wide for two passes beside a 192 KiB forest (F = 200)
    are read from device memory, bitwise as narrow ones."""
    dev = _card()
    rng = np.random.default_rng(31)
    x = rng.standard_normal((300, 200)).astype(np.float32)
    forest = _forest(rng, 64, 8, 200)
    got = rfr_forest_apply(*_t(x, *forest, device=dev))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _numpy_mean_predict(x, *forest))


@pytest.mark.cuda_only
@pytest.mark.parametrize("log_target", [False, True])
@pytest.mark.parametrize("M", [6, 16, 40])
def test_sweep_kernel_matches_plain(M, log_target):
    dev = _card()
    args = _t(*_sweep_case(12, 300, M, 4, 24, 8, 31), device=dev)
    got = rfr_capacity_sweep(*args, log_target=log_target)
    plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda_only
@pytest.mark.parametrize("T", [5, 24, 33, 130])
@pytest.mark.parametrize("M", [1, 24, 40])
def test_sweep_kernel_with_drain_padding_matches_plain(M, T):
    """The device drain's padding: -inf rows past each scenario's m_max
    (the kernel fails them without a descent and stops there), +inf rows
    past its R (they still descend), and failures at m = 0; T = 5 (the
    lanes' partial sums all 0), 24, 33 (a tail of one tree) and 130
    (numpy's pairwise split above 128 trees)."""
    dev = _card()
    rng = np.random.default_rng(M * 1000 + T)
    S, R, F = 200, 6, 31
    x = rng.standard_normal((S, M, R, F)).astype(np.float32)
    feat, thr, leaf = _forest(rng, T, 6, F)
    bounds = rng.uniform(-0.4, 0.8, (S, M, R)).astype(np.float32)
    for s in range(S):
        m_max = int(rng.integers(0, M + 1))
        bounds[s, :, int(rng.integers(1, R + 1)):] = np.inf
        bounds[s, m_max:, :] = -np.inf
        if s % 4 == 0:
            bounds[s, 0, int(rng.integers(0, R))] = -10.0
    args = _t(x, bounds, feat, thr, leaf, device=dev)
    for log_target in (False, True):
        got = rfr_capacity_sweep(*args, log_target=log_target)
        plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda_only
@pytest.mark.parametrize("log_target", [False, True])
def test_sweep_kernel_m_max_on_a_pass_boundary_repeated(log_target):
    """A block takes 64 rows a pass, 8 values of m at R = 8, so m_max = 8
    or 16 makes a whole pass of -inf rows: they fail without a descent,
    lowering the scenario's first failure while the pass is under way.
    Every block must still leave the pass together.  Many scenarios a
    block and many launches in a row, each equal to the plain version."""
    dev = _card()
    rng = np.random.default_rng(31)
    S, M, R, F = 4096, 24, 8, 31
    x = rng.standard_normal((S, M, R, F)).astype(np.float32)
    feat, thr, leaf = _forest(rng, 24, 8, F)
    bounds = rng.uniform(0.3, 1.5, (S, M, R)).astype(np.float32)
    if log_target:
        bounds = np.exp(bounds)
    for s in range(S):
        bounds[s, (8, 16)[s % 2]:, :] = -np.inf
        if s % 7 == 0:
            bounds[s, int(rng.integers(0, 8)), int(rng.integers(0, R))] = -1.0
    args = _t(x, bounds, feat, thr, leaf, device=dev)
    plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
    want = plain.cpu().numpy()
    assert set(np.unique(want)) > {8, 16}
    for _ in range(50):
        got = rfr_capacity_sweep(*args, log_target=log_target)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda_only
def test_sweep_kernel_alternating_forest_sizes():
    """The launch plan is cached per shared-memory size: a forest needing
    more shared memory, then one needing less (still above the 48 KB
    default), then the larger again must all launch and agree."""
    dev = _card()
    rng = np.random.default_rng(21)
    x, bounds = _t(*_sweep_case(22, 64, 24, 4, 24, 8, 31)[:2], device=dev)
    forests = {t: _t(*_forest(rng, t, 8, 31), device=dev) for t in (64, 24)}
    for t in (64, 24, 64, 24):
        got = rfr_capacity_sweep(x, bounds, *forests[t])
        plain = ref.rfr_capacity_sweep_ref(x, bounds, *forests[t])
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda_only
def test_device_drain_on_card_matches_numpy_host():
    _card()
    specs = core.synthetic_functions(5, seed=2)
    gt = core.GroundTruth(seed=0)
    store = core.ProfileStore(seed=0)
    qos = core.QoSStore(store, gt)
    pred = core.PerfPredictor(n_trees=12, max_depth=7, seed=0,
                              engine="numpy")
    X, y = core.generate_dataset(specs, gt, store, qos, 700, seed=1)
    pred.add_dataset(X, y)
    rng = np.random.default_rng(17)
    names = sorted(specs)
    nodes = []
    for _ in range(256):
        node = Node(core.NodeResources())
        for g in rng.choice(names, size=int(rng.integers(1, 4)),
                            replace=False):
            node.state(g).n_sat = int(rng.integers(1, 5))
            node.state(g).n_cached = int(rng.integers(0, 3))
        nodes.append(node)
    host = core.CapacityEngine(pred, store, qos, specs,
                               core.EngineConfig(m_max=16))
    host.update_nodes(nodes)
    want = [sorted((fn, e.capacity) for fn, e in n.table.items())
            for n in nodes]
    for n in nodes:
        n.table.clear()
    pred.engine = "cuda"
    n0 = rfr_capacity_sweep.launches
    dev = core.CapacityEngine(pred, store, qos, specs,
                              core.EngineConfig(m_max=16, drain="device"))
    dev.update_nodes(nodes)
    assert rfr_capacity_sweep.launches == n0 + 1
    assert dev._dev_caps.is_cuda
    assert [sorted((fn, e.capacity) for fn, e in n.table.items())
            for n in nodes] == want


# ---------------------------------------------------------------------------
# The LM kernels: flash attention and the RG-LRU scan.  Tolerances: f32
# 1e-5 (the kernel's online softmax sums in another order than the plain
# version's materialised one); bf16 2e-2 relative (the kernel rounds p to
# bf16 before P.V, as the TPU kernel does; the plain version keeps p in
# f32); the scan exactly (both round a multiply, then an add, per step).
# ---------------------------------------------------------------------------

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _assert_bf16_attention_close(got, plain, plain_abs_v):
    """bf16 held to its own scale as well: within 2^-6 of |out| (the
    output rounded once on each side) plus 2^-8 of the softmax's average
    of |v| (the kernel rounds each p to bf16, the plain version keeps it
    f32), so a kv tile dropped or added fails where 2e-2 would not."""
    want = plain.float()
    allowed = 2.0 ** -6 * want.abs() + 2.0 ** -8 * plain_abs_v.float()
    worst = float(((got.float() - want).abs() / allowed).max())
    assert worst <= 1.0, f"worst element at {worst:.3g} of its allowance"


def _qkv(seed, B, S, Hq, Hkv, D, dtype, device, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda h: torch.from_numpy(
        (rng.standard_normal((B, S, h, D)) * scale).astype(np.float32)
    ).to(device=device, dtype=dtype)
    return mk(Hq), mk(Hkv), mk(Hkv)


def test_scratch_is_kept_per_stream_and_grown():
    """The wrappers' scratch: a call asking for no more than the buffer
    holds gets it back, a larger one grows it, another stream gets its
    own."""
    from repro_torch.kernels import _scratch
    dev = torch.device("cpu")
    a = _scratch.scratch(dev, 11, 1000)
    assert a.numel() >= 1000 and a.dtype == torch.uint8
    assert _scratch.scratch(dev, 11, 500).data_ptr() == a.data_ptr()
    b = _scratch.scratch(dev, 11, 5000)
    assert b.numel() >= 5000
    assert _scratch.scratch(dev, 11, 4000).data_ptr() == b.data_ptr()
    assert _scratch.scratch(dev, 12, 100).data_ptr() != b.data_ptr()


def test_lm_wrappers_on_cpu_launch_nothing():
    q, k, v = _qkv(0, 1, 40, 4, 2, 16, torch.float32, "cpu")
    a = torch.rand(2, 30, 8)
    n0 = flash_attention.launches, rglru_scan.launches, ssd_scan.launches
    by_path = dict(flash_attention.launches_by_path)
    scan_by_path = dict(rglru_scan.launches_by_path)
    ssd_by_path = dict(ssd_scan.launches_by_path)
    ops.attention_op(q, k, v, kind="local", window=8)
    # bf16 at head dim 64: the tensor-core path's shape, on CPU tensors
    ops.attention_op(*_qkv(1, 1, 40, 4, 2, 64, torch.bfloat16, "cpu"),
                     kind="local", window=8)
    # f32 at head dim 64: the 3xTF32 path's shape, on CPU tensors
    ops.attention_op(*_qkv(2, 1, 40, 4, 2, 64, torch.float32, "cpu"),
                     kind="local", window=8)
    ops.rglru_op(a, torch.randn(2, 30, 8), torch.randn(2, 8))
    ops.ssd_op(torch.randn(1, 30, 4, 8), torch.rand(1, 30, 4),
               -torch.rand(4), torch.randn(1, 30, 2, 16),
               torch.randn(1, 30, 2, 16))
    # bf16 at head dim 64, d_state 128: the SSD tensor-core path's shape
    ops.ssd_op(torch.randn(1, 30, 4, 64).bfloat16(), torch.rand(1, 30, 4),
               -torch.rand(4), torch.randn(1, 30, 1, 128).bfloat16(),
               torch.randn(1, 30, 1, 128).bfloat16())
    assert (flash_attention.launches, rglru_scan.launches,
            ssd_scan.launches) == n0
    assert flash_attention.launches_by_path == by_path
    assert rglru_scan.launches_by_path == scan_by_path
    assert ssd_scan.launches_by_path == ssd_by_path


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,window,causal,softcap", [
    ("global", 0, True, 0.0), ("local", 32, True, 0.0),
    ("chunked", 32, True, 0.0), ("global", 0, True, 20.0),
    ("global", 0, False, 0.0), ("local", 48, False, 0.0)])
@pytest.mark.parametrize("S", [64, 100, 257])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_kernel_matches_plain(D, S, kind, window, causal, softcap,
                                    dtype):
    """D = 64, 128 and 256 run a tensor-core kernel (bf16 the wgmma one,
    f32 the 3xTF32 one, its kv range split here: the grids are small), D =
    32 the CUDA-core kernel; the launch counts show which ran.  f32 with a
    softcap on the 3xTF32 kernel is held against the function evaluated in
    float64 (``_attention_f64``) at the same tolerance: at softcapped
    scores the plain f32 version's own rounding is of the tolerance's
    size, and that kernel forms its scores in double."""
    dev = _card()
    q, k, v = _qkv(S, 2, S, 4, 2, D, dtype, dev,
                   scale=4.0 if softcap else 1.0)
    kw = dict(causal=causal, kind=kind, window=window, softcap=softcap)
    n0 = flash_attention.launches
    by_path = dict(flash_attention.launches_by_path)
    got = ops.attention_op(q, k, v, **kw)
    plain = ops.attention_op(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    if D in (64, 128, 256):
        ran = "wgmma" if dtype == torch.bfloat16 else "tf32"
    else:
        ran = "simt"
    by_path[ran] += 1
    assert flash_attention.launches_by_path == by_path
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATTN_TOL[dtype]
    if ran == "tf32" and softcap:
        plain = _attention_f64(q, k, v, kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        _assert_bf16_attention_close(
            got, plain, ops.attention_op(q, k, v.abs(), use_kernel=False, **kw))


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1000, 2048, 512, 3000])
def test_flash_kernel_serving_shape(S, dtype):
    """recurrentgemma's local layers: MQA 10:1, head dim 256, window
    2,048; bf16 on the wgmma kernel, f32 on the 3xTF32 one (its kv range
    split at S = 512 and 1,000)."""
    dev = _card()
    q, k, v = _qkv(7, 1, S, 10, 1, 256, dtype, dev)
    kw = dict(causal=True, kind="local", window=2048)
    by_path = dict(flash_attention.launches_by_path)
    got = ops.attention_op(q, k, v, **kw)
    by_path["wgmma" if dtype == torch.bfloat16 else "tf32"] += 1
    assert flash_attention.launches_by_path == by_path
    plain = ops.attention_op(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        _assert_bf16_attention_close(
            got, plain, ops.attention_op(q, k, v.abs(), use_kernel=False, **kw))


def _attention_f64(q, k, v, kw):
    """Attention of (B, S, H, D) q and k, v in float64 (k and v repeated
    to q's heads): the witness of f32 with a softcap."""
    B, S, Hq, D = q.shape
    g = Hq // k.shape[2]
    qd, kd, vd = (a.double().transpose(1, 2) for a in (q, k, v))
    kd, vd = (a.repeat_interleave(g, 1) for a in (kd, vd))
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) / D ** 0.5
    if kw.get("softcap"):
        s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
    keep = ref.attention_mask(S, kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    s = torch.where(keep, s, torch.full_like(s, ref.NEG_INF))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                        vd).transpose(1, 2)


#: gemma2-2b's inputs: unscaled, and q, k, v times 4 (scores times 16,
#: so that the softcap of 50 bites)
GEMMA2_SCALES = pytest.mark.parametrize("scale", [1.0, 4.0],
                                        ids=["unscaled", "scores_x16"])


@pytest.mark.cuda_only
@GEMMA2_SCALES
@pytest.mark.parametrize("kind,window", [("local", 4096), ("global", 0)])
@pytest.mark.parametrize("S", [333, 3000, 3001, 4500])
def test_flash_kernel_gemma2_shape_with_softcap(S, kind, window, scale):
    """gemma2-2b's layers: 8 query heads over 4 kv heads (G 2), head dim
    256, a tanh softcap of 50 (from fast_tanh's ex2 and rcp steps), local
    attention in a window of 4,096 alternating with global, on unscaled
    inputs and on scores scaled by 16; bf16 on the wgmma kernel against
    its plain version at phase 4's bf16 tolerance.  S = 3,001 ends in a
    ragged q and kv tile; S = 4,500 is past the window."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    q, k, v = _qkv(S + len(kind), 1, S, 8, 4, 256, torch.bfloat16, dev,
                   scale=scale)
    kw = dict(causal=True, kind=kind, window=window, softcap=50.0)
    assert path(torch.bfloat16, 256, 50.0) == "wgmma"
    by_path = dict(flash_attention.launches_by_path)
    got = ops.attention_op(q, k, v, **kw)
    by_path["wgmma"] += 1
    assert flash_attention.launches_by_path == by_path
    plain = ops.attention_op(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_bf16_attention_close(
        got, plain, ops.attention_op(q, k, v.abs(), use_kernel=False, **kw))


def _mla_qkv(seed, BH, G, S, dtype, device, dqk=192, dv=128):
    rng = np.random.default_rng(seed)
    mk = lambda rows, d: torch.from_numpy(rng.standard_normal(
        (rows, S, d)).astype(np.float32)).to(device=device, dtype=dtype)
    return mk(BH, dqk), mk(BH // G, dqk), mk(BH // G, dv)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,window,causal", [
    ("global", 0, True), ("global", 0, False), ("local", 100, True),
    ("chunked", 128, True)])
@pytest.mark.parametrize("S,BH,G", [(333, 8, 1), (333, 8, 2), (64, 4, 1),
                                    (1000, 16, 1)])
def test_flash_kernel_at_mla_head_dims(S, BH, G, kind, window, causal,
                                       dtype):
    """MLA's shape: q and k of head dim 192, v of 128 (scale 1/sqrt(192)),
    ragged S: bf16 on the wgmma kernel, f32 on the 3xTF32 kernel (its kv
    range split at the small grids), each against its plain version; the
    output (BH, S, 128)."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    q, k, v = _mla_qkv(S + BH, BH, G, S, dtype, dev)
    kw = dict(causal=causal, kind=kind, window=window)
    want = "wgmma" if dtype == torch.bfloat16 else "tf32"
    assert path(dtype, 192, 0.0, 128) == want
    by_path = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, **kw)
    by_path[want] += 1
    assert flash_attention.launches_by_path == by_path
    group = BH // k.shape[0]
    kr, vr = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    plain = ref.flash_attention_ref(q, kr, vr, **kw)
    torch.cuda.synchronize()
    assert got.shape == (BH, S, 128) and got.dtype == dtype
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        _assert_bf16_attention_close(
            got, plain, ref.flash_attention_ref(q, kr, vr.abs(), **kw))


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_smoke_model_on_card_kernels_match_plain(dtype):
    """The deepseek smoke config with MLA's full head dims (128 + 64
    query / key columns, 128 value columns; 2 heads, latent 32), MoE on
    the sort dispatch: a prefill launches one flash kernel per layer, on
    the wgmma path in bf16 and the 3xTF32 path in f32, and its logits
    through the kernels match the plain versions' (f32 1e-4; bf16 2e-2
    of the largest |logit|), as do the decode steps after it."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    dev = _card()
    cfg = get_smoke_config("deepseek-v2-236b")
    cfg = cfg.replace(n_heads=2, n_kv_heads=2, head_dim=192, dtype=dtype,
                      mla=dataclasses.replace(
                          cfg.mla, q_lora_rank=32, kv_lora_rank=32,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128))
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 77))).to(dev)
    by_path = dict(flash_attention.launches_by_path)
    got, gc = model_lib.prefill(cfg, params, {"tokens": toks}, 96)
    by_path["wgmma" if dtype == "bfloat16" else "tf32"] += cfg.n_layers
    assert flash_attention.launches_by_path == by_path
    want, wc = model_lib.prefill(cfg, params, {"tokens": toks}, 96,
                                 use_kernel=False)
    tol = 1e-4 if dtype == "float32" else 2e-2 * float(want.abs().max())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=1e-4 if dtype == "float32" else 0)
    tok = want.argmax(-1)
    for i in range(3):
        pos = torch.full((1,), 77 + i, device=dev)
        got, gc = model_lib.decode_step(cfg, params, tok, pos, gc)
        want, wc = model_lib.decode_step(cfg, params, tok, pos, wc)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol,
                                   rtol=1e-4 if dtype == "float32" else 0)
        tok = want.argmax(-1)


@pytest.mark.cuda_only
@pytest.mark.parametrize("kind,window", [("global", 0), ("local", 100)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_f32_kernel_within_tolerance_of_float64(D, kind, window):
    """The 3xTF32 kernel against attention evaluated in float64 (the
    function itself, not the plain version's f32 rounding): within a
    tenth of the f32 tolerance (1e-6 absolute plus 1e-6 relative), where
    plain TF32 products (10 mantissa bits) would miss the tolerance
    itself."""
    dev = _card()
    rng = np.random.default_rng(D + window)
    mk = lambda rows: torch.from_numpy(
        rng.standard_normal((rows, 333, D)).astype(np.float32)).to(dev)
    q, k, v = mk(8), mk(4), mk(4)
    kw = dict(causal=True, kind=kind, window=window)
    by_path = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, **kw)
    by_path["tf32"] += 1
    assert flash_attention.launches_by_path == by_path
    kr, vr = (a.double().repeat_interleave(2, 0) for a in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.double(), kr) / D ** 0.5
    mask = ref.attention_mask(333, True, kind, window, dev)
    s = torch.where(mask[None], s, torch.full_like(s, ref.NEG_INF))
    want = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vr)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.cpu().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(2, 100, 96), (1, 3000, 2560),
                                   (4, 37, 130)])
def test_rglru_kernel_matches_plain(B, S, W, with_h0):
    dev = _card()
    rng = np.random.default_rng(S + W)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, W)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(
        np.float32)).to(dev)
    h0 = (torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
          .to(dev) if with_h0 else None)
    n0 = rglru_scan.launches
    got = ops.rglru_op(a, b, h0)
    plain = ops.rglru_op(a, b, h0, use_kernel=False)
    torch.cuda.synchronize()
    assert rglru_scan.launches == n0 + 1
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())


def _first_scan(a, b, h0):
    """The first kernel of csrc/rglru_scan.cu, one thread a channel,
    called directly (not counted in the wrapper's launches)."""
    from repro_torch.kernels import _build
    bsz, s, w = a.shape
    out = torch.empty_like(a)
    lib = _build.load("rglru_scan")
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), bsz, s, w, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rglru_scan (first kernel)")
    return out


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(1, 3000, 2560), (4, 1000, 2560),
                                   (1, 1, 2560), (2, 257, 48), (3, 65, 8),
                                   (1, 130, 2562)])
def test_rglru_tma_kernel_is_exactly_the_serial_loop(B, S, W, with_h0):
    """The scan on its path (TMA where W % 4 == 0; W = 2,562 on the first
    kernel) at the serving widths, one step, S not a multiple of the
    64-step stage and W not a multiple of the 32-channel tile: exactly the
    plain loop and the first kernel; one launch a call, on the path
    ``path`` names."""
    from repro_torch.kernels.rglru_scan import path
    dev = _card()
    rng = np.random.default_rng(B * S + W)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, W)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(
        np.float32)).to(dev)
    h0 = (torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
          .to(dev) if with_h0 else None)
    kernel = path(B, S, W)
    assert kernel == ("simt" if W % 4 else "tma")
    n0, by0 = rglru_scan.launches, dict(rglru_scan.launches_by_path)
    got = rglru_scan(a, b, h0)
    assert rglru_scan.launches == n0 + 1
    assert rglru_scan.launches_by_path[kernel] == by0[kernel] + 1
    want = ops.rglru_op(a, b, h0, use_kernel=False).cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(_first_scan(a, b, h0).cpu().numpy(), want)


@pytest.mark.cuda_only
def test_smoke_model_on_card_kernels_match_plain():
    """The recurrentgemma smoke model on the card: prefill through the
    kernels equals prefill through the plain versions (f32: 1e-4 on
    logits), and a prefill launches one flash kernel per local layer and
    one scan per recurrent layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    dev = _card()
    cfg = get_smoke_config("recurrentgemma-2b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 40))).to(dev)
    kinds = cfg.layer_kinds()
    n0 = flash_attention.launches, rglru_scan.launches
    got, _ = model_lib.prefill(cfg, params, {"tokens": toks}, 64)
    assert (flash_attention.launches - n0[0],
            rglru_scan.launches - n0[1]) == (kinds.count("local"),
                                             kinds.count("recurrent"))
    plain, _ = model_lib.prefill(cfg, params, {"tokens": toks}, 64,
                                 use_kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The SSD scan.  Tolerances, against the plain version at the kernel's
# chunk of 64 (the same arithmetic, summed in other orders): f32 1e-4 of
# the largest |y| and of the state's norm; bf16 2e-2 (both compute in f32
# from the same bf16 values; y is rounded to bf16 once).
# ---------------------------------------------------------------------------

from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import path as ssd_path  # noqa: E402

SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _ssd_kernel(dtype, P, N):
    """The kernel the SSD wrappers must launch: the tensor cores at P =
    64, N = 128 (bf16 "wgmma", f32 "tf32"), the CUDA cores elsewhere."""
    if (P, N) != (64, 128):
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32"


def _ssd_case(seed, B, H, G, S, P, N, dtype, with_h0, device):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dt)
    sp = lambda a: np.log1p(np.exp(a))
    dt = sp(rng.standard_normal((B, H, S)) - 2.0)
    A = -np.linspace(1.0, 16.0, H)
    return (t(rng.standard_normal((B, H, S, P)), dtype),
            t(dt * A[None, :, None]), t(dt),
            t(rng.standard_normal((B, G, S, N)), dtype),
            t(rng.standard_normal((B, G, S, N)), dtype),
            t(rng.standard_normal((B, H, P, N))) if with_h0 else None)


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N", [
    (2, 3, 3, 37, 8, 16),        # small, prime S: one ragged chunk
    (2, 4, 2, 200, 40, 100),     # grouped B/C, P and N off the tiles
    (1, 8, 1, 129, 64, 128),     # one row past two chunks
    (1, 80, 1, 3001, 64, 128),   # mamba2-2.7b's serving shape, prime S
    (2, 8, 2, 200, 64, 128),     # grouped B/C at the served widths
    (1, 4, 4, 64, 64, 128),      # G = H, one whole chunk
    (1, 6, 3, 1, 64, 128),       # one token
])
def test_ssd_kernel_matches_plain(B, H, G, S, P, N, dtype, with_h0):
    """At P = 64, N = 128 bf16 runs the wgmma kernel and f32 the 3xTF32
    one, everything else the CUDA-core kernel; the launch counts show
    which ran."""
    dev = _card()
    x, dA, dt, Bm, Cm, h0 = _ssd_case(S + N, B, H, G, S, P, N, dtype,
                                      with_h0, dev)
    n0 = ssd_scan.launches
    by_path = dict(ssd_scan.launches_by_path)
    y, h = ssd_scan(x, dA, dt, Bm, Cm, h0)
    yp, hp = ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1
    ran = _ssd_kernel(dtype, P, N)
    assert ssd_path(dtype, P, N) == ran
    by_path[ran] += 1
    assert ssd_scan.launches_by_path == by_path
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SSD_TOL[dtype]
    assert bool(torch.isfinite(y.float()).all())
    y_err = float((y.float() - yp.float()).abs().max())
    assert y_err <= tol * float(yp.float().abs().max())
    assert float((h - hp).norm()) <= tol * float(hp.norm())


@pytest.mark.cuda_only
def test_mamba_smoke_model_on_card_kernels_match_plain():
    """The mamba2 smoke model, two layers, on the card: prefill through
    the kernel equals prefill through the plain version (f32: 1e-4 on
    logits and states), one scan launched per layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    dev = _card()
    cfg = get_smoke_config("mamba2-2.7b").replace(n_layers=2)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 77))).to(dev)
    n0 = ssd_scan.launches
    got, cache = model_lib.prefill(cfg, params, {"tokens": toks}, 96)
    assert ssd_scan.launches - n0 == 2
    plain, pcache = model_lib.prefill(cfg, params, {"tokens": toks}, 96,
                                      use_kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    for c, pc in zip(cache, pcache):
        np.testing.assert_allclose(c["h"].cpu().numpy(),
                                   pc["h"].cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# The platform facade on the card: engine "cuda" against engine "numpy"
# on the same manifest, exactly; the learned scorer's scores within 1e-5
# of numpy's.
# ---------------------------------------------------------------------------


def _device_drain_jiagu(ctx):
    """Jiagu with a device-drain PredictionService already attached."""
    sched = core.JiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                                ctx.predictor, m_max=ctx.m_max)
    sched.attach_service(core.PredictionService(
        ctx.predictor, ctx.store, ctx.qos, ctx.specs,
        core.EngineConfig(m_max=ctx.m_max, retrain_every=ctx.retrain_every,
                          learned_shape_margin=ctx.learned_shape_margin,
                          drain="device"),
        schema=ctx.schema_version))
    return sched


def _outcome(res, sim):
    s, c = res.sched, res.scaling
    return (res.density, res.qos_violation_rate, res.requests,
            res.violated_requests, res.nodes_peak,
            (s.decisions, s.fast, s.slow, s.failed, s.instances_placed),
            (c.real_cold_starts, c.logical_cold_starts, c.releases,
             c.evictions, c.migrations),
            dict(res.class_requests), dict(res.class_violations),
            [sorted((fn, e.capacity)
                    for fn, e in sim.cluster.nodes[i].table.items())
             for i in sorted(sim.cluster.nodes)])


@pytest.mark.cuda_only
def test_platform_on_card_equals_numpy_and_launches_both_kernels():
    _card()
    from repro_torch.kernels.rfr_inference import reset_launches
    from repro_torch.platform import Platform, register_scheduler
    register_scheduler("jiagu-device-drain", _device_drain_jiagu,
                       needs_predictor=True, dual_staged_default=True,
                       overwrite=True)
    base = {"scenario": {"kind": "burst-storm", "n_functions": 8,
                         "duration_s": 60, "target_nodes": 64, "seed": 0},
            "prediction": {"n_train": 300, "n_trees": 8},
            "cells": {"count": 2}, "admission": {"enabled": True}}
    runs, world, scenario = {}, None, None
    for name, engine in (("jiagu", "numpy"), ("jiagu", "cuda"),
                         ("jiagu-device-drain", "cuda")):
        m = {**base, "scheduler": {"name": name},
             "prediction": {**base["prediction"], "engine": engine}}
        plat = Platform.build(scenario=scenario, config=m, world=world)
        scenario, world = plat.scenario, plat.world
        world.gt.reseed()
        reset_launches()
        res = plat.run()
        runs[name, engine] = (_outcome(res, plat.simulation),
                              rfr_forest_apply.launches,
                              rfr_capacity_sweep.launches)
    want, f0, s0 = runs["jiagu", "numpy"]
    assert (f0, s0) == (0, 0)
    got, f1, _s1 = runs["jiagu", "cuda"]
    assert got == want and f1 > 0
    got, _f2, s2 = runs["jiagu-device-drain", "cuda"]
    assert got == want and s2 > 0


@pytest.mark.cuda_only
def test_learned_scorer_on_card_matches_numpy():
    from repro_torch.policy import LearnedScorer, init_params, np_scores
    dev = _card()
    rng = np.random.default_rng(5)
    policy = init_params(14, 32, seed=1)
    policy["mu"] = rng.standard_normal(14).astype(np.float32)
    policy["sd"] = rng.uniform(0.5, 2.0, 14).astype(np.float32)
    scorer = LearnedScorer(policy, epoch=0)
    assert scorer._weights["w1"].device.type == dev.type
    for n in (1, 7, 64, 1025):
        rows = rng.standard_normal((n, 14)).astype(np.float32)
        np.testing.assert_allclose(scorer.scores(rows),
                                   np_scores(policy, rows), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The backward kernels.  Attention against its plain version
# (``ref.flash_attention_bwd_ref``, the same f32 formula summed in other
# orders): each gradient within 1e-5 of |want| plus 1e-4 of the tensor's
# largest |value| in f32; in bf16 within 2^-7 of |want| (the two f32 sums
# may round to neighbouring bf16 values) plus 1e-4 of the largest, so a
# key tile dropped or added fails.  bf16 at head dims 64, 128, 256 and
# MLA's (192, 128) runs on the tensor-core kernel (``bwd_path``
# "wgmma"), f32 there and at 96 on the 3xTF32 one ("tf32"), softcap or
# not, both reading the forward kernel's lse; other head dims on the
# first kernel ("simt").  The forward's lse against the
# plain one within LSE_TOL.  The
# RG-LRU scan's backward is exactly its serial reverse loop.
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import (  # noqa: E402
    LSE_BWD_PATHS, bwd_path, flash_attention_bwd, flash_attention_fn)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan_bwd, rglru_scan_fn)

BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
#: the tensor-core forwards' lse against the plain one, absolute: the
#: same f32 scores summed in another order (a few 1e-6 at softcapped
#: scores of tens); one key of a 2,048-key window dropped moves it by
#: ~5e-4
LSE_TOL = 1e-4


def _assert_grads_close(got, want, dtype, what=""):
    rel, of_max = BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        allowed = rel * w.abs() + of_max * float(w.abs().max())
        worst = float(((g - w).abs() / allowed).max())
        assert worst <= 1.0, f"{what} {name}: {worst:.3g} of its allowance"


def _bwd_case(seed, BH, G, S, D, dtype, dev, kw, scale=1.0):
    """(BH, S, D) q, o, dO and (BH / G, S, D) k, v on the card, and the
    lse; o is the forward kernel's output, the lse the forward's on the
    wgmma and tf32 backward paths (None on the simt one, which computes
    its own)."""
    rng = np.random.default_rng(seed)
    mk = lambda rows, s=1.0: torch.from_numpy(
        (rng.standard_normal((rows, S, D)) * s).astype(np.float32)).to(
            device=dev, dtype=dtype)
    q, k, v = mk(BH, scale), mk(BH // G, scale), mk(BH // G)
    do = mk(BH)
    if bwd_path(dtype, D, kw.get("softcap", 0.0)) in LSE_BWD_PATHS:
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    else:
        o, lse = flash_attention(q, k, v, **kw), None
    return q, k, v, o, do, lse


def _bwd_launch(q, k, v, o, do, lse, kw):
    """flash_attention_bwd, checking that it launched once, on the path
    ``bwd_path`` names."""
    kernel = bwd_path(q.dtype, q.shape[-1], kw.get("softcap", 0.0),
                      v.shape[-1])
    n0 = flash_attention_bwd.launches
    by0 = dict(flash_attention_bwd.launches_by_path)
    got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    assert flash_attention_bwd.launches_by_path == {
        p: n + (p == kernel) for p, n in by0.items()}
    return got


BWD_MASKS = [dict(causal=True, kind="global"),
             dict(causal=True, kind="local", window=32),
             dict(causal=True, kind="chunked", window=32),
             dict(causal=True, kind="global", softcap=20.0),
             dict(causal=False, kind="global"),
             dict(causal=False, kind="local", window=48)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("BH,G", [(4, 2), (10, 10)], ids=["gqa2", "mqa10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", BWD_MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("S", [37, 100, 257])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_bwd_kernel_matches_plain(D, S, kw, dtype, BH, G):
    """Ragged S (query rows and keys past S in the last tile), GQA 2:1
    and MQA 10:1 (dK and dV summed over the group's query heads; on the
    tensor-core paths split into shares), every mask; one launch a call,
    on its path: D = 16 on the first kernel, bf16 at D = 64, 128, 256 on
    the wgmma one and f32 there on the 3xTF32 one (softcap or not), both
    reading the forward's lse."""
    dev = _card()
    scale = 4.0 if kw.get("softcap") else 1.0
    q, k, v, o, do, lse = _bwd_case(D + S + G - 2, BH, G, S, D, dtype, dev,
                                    kw, scale)
    got = _bwd_launch(q, k, v, o, do, lse, kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(got, want, dtype, f"D={D} S={S} G={G} {kw}")


def _mla_bwd_case(seed, BH, G, S, dtype, dev, kw):
    """MLA's q, k (head dim 192), v, o and dO (128) on the card, o the
    forward kernel's and the lse the forward's on the wgmma and tf32
    backward paths (None on the simt one)."""
    q, k, v = _mla_qkv(seed, BH, G, S, dtype, dev)
    do = _mla_qkv(seed + 1, BH, 1, S, dtype, dev)[2]
    if bwd_path(dtype, 192, kw.get("softcap", 0.0), 128) in LSE_BWD_PATHS:
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    else:
        o, lse = flash_attention(q, k, v, **kw), None
    return q, k, v, o, do, lse


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", BWD_MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("S,BH,G", [(37, 4, 1), (333, 8, 2), (1000, 16, 1)])
def test_flash_bwd_kernel_at_mla_head_dims(S, BH, G, kw, dtype):
    """MLA's shape, q and k of head dim 192 and v of 128, ragged S, GQA
    2:1 and MHA, every mask: bf16 on the wgmma backward, f32 on the 3xTF32
    one, softcap or not (both reading the forward's lse), each within
    BWD_TOL of the plain version; dq (BH, S, 192), dk (BH / G, S, 192),
    dv (BH / G, S, 128); the tensor-core backwards bitwise the same over
    two calls."""
    dev = _card()
    want_path = "wgmma" if dtype == torch.bfloat16 else "tf32"
    assert bwd_path(dtype, 192, kw.get("softcap", 0.0), 128) == want_path
    q, k, v, o, do, lse = _mla_bwd_case(S + BH + G, BH, G, S, dtype, dev,
                                        kw)
    got = _bwd_launch(q, k, v, o, do, lse, kw)
    assert [tuple(g.shape) for g in got] == [(BH, S, 192),
                                             (BH // G, S, 192),
                                             (BH // G, S, 128)]
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(got, want, dtype, f"MLA S={S} G={G} {kw}")
    if want_path != "simt":
        again = _bwd_launch(q, k, v, o, do, lse, kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _mla_gradient_through_function(dtype, want_path):
    """A gradient through ``FlashAttentionFn`` at MLA's head dims: the
    forward writes the lse (saved beside q, k, v and o), the backward
    launches once, on `want_path`, and its gradients are the backward
    wrapper's on the saved lse; the same call without a gradient saves
    none."""
    dev = _card()
    kw = dict(causal=True, kind="global")
    q, k, v = _mla_qkv(5, 8, 1, 300, dtype, dev)
    do = _mla_qkv(6, 8, 1, 300, dtype, dev)[2]
    qg, kg, vg = (a.clone().requires_grad_(True) for a in (q, k, v))
    by0 = dict(flash_attention_bwd.launches_by_path)
    fwd0 = dict(flash_attention.launches_by_path)
    o = flash_attention_fn(qg, kg, vg, **kw)
    assert flash_attention.launches_by_path == {
        p: n + (p == want_path) for p, n in fwd0.items()}
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches_by_path == {
        p: n + (p == want_path) for p, n in by0.items()}
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    assert float((saved[4] - lse).abs().max()) <= LSE_TOL
    want = flash_attention_bwd(q, k, v, o.detach(), do, saved[4], **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _assert_grads_close(got, ref.flash_attention_bwd_ref(
        q, k, v, o.detach(), do, **kw), dtype, "MLA Function")
    with torch.no_grad():
        out = flash_attention_fn(q, k, v, **kw)
    assert out.grad_fn is None and torch.equal(out, o.detach())


@pytest.mark.cuda_only
def test_flash_gradient_at_mla_head_dims_takes_wgmma_and_reads_lse():
    """A bf16 gradient through ``FlashAttentionFn`` at MLA's head dims
    takes the wgmma kernels and reads the saved lse.  Nothing falls
    back."""
    _mla_gradient_through_function(torch.bfloat16, "wgmma")


@pytest.mark.cuda_only
def test_flash_gradient_at_mla_head_dims_f32_takes_tf32_and_reads_lse():
    """An f32 gradient through ``FlashAttentionFn`` at MLA's head dims
    takes the 3xTF32 kernels, forward and backward, and the backward
    reads the lse the forward saved.  Nothing falls back."""
    _mla_gradient_through_function(torch.float32, "tf32")


def _simt_direct(q, k, v, do, kw):
    """The CUDA-core forward and backward (``csrc/flash_attention.cu``,
    ``csrc/flash_attention_bwd.cu``) called directly in q's dtype, where
    the wrapper takes a tensor-core path (f32 at MLA's head dims, the
    3xTF32 kernels; bf16 at D 80, the wgmma ones): (o, (dq, dk, dv))."""
    from repro_torch.kernels import _build, _scratch
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    dv = v.shape[2]
    group = bh // k.shape[0]
    mask = (int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
            int(kw.get("window", 0)), float(kw.get("softcap", 0.0)))
    stream = _scratch.current_stream(q.device)
    o = q.new_empty((bh, s, dv))
    is_bf16 = int(q.dtype == torch.bfloat16)
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d, dv,
        group, is_bf16, *mask, stream)
    _build.check_launch(err, "flash_attention (simt, direct)")
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, bh, s), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        *(g.data_ptr() for g in grads), stats[0].data_ptr(),
        stats[1].data_ptr(), bh, s, d, dv, group, is_bf16, *mask, stream)
    _build.check_launch(err, "flash_attention_bwd (simt, direct)")
    return o, grads


@pytest.mark.cuda_only
@pytest.mark.parametrize("kw", BWD_MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("S,BH,G", [(37, 4, 1), (333, 8, 2)])
def test_cuda_core_kernels_held_at_f32_mla_head_dims(S, BH, G, kw):
    """The CUDA-core forward and backward, which the wrapper no longer
    takes at f32 (192, 128), called directly at every mask:
    the output within ATTN_TOL and each gradient within BWD_TOL of the
    plain versions, and no wrapper launch counted."""
    dev = _card()
    q, k, v = _mla_qkv(S + BH + 7, BH, G, S, torch.float32, dev)
    do = _mla_qkv(S + BH + 8, BH, 1, S, torch.float32, dev)[2]
    n0 = flash_attention.launches, flash_attention_bwd.launches
    o, grads = _simt_direct(q, k, v, do, kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0
    kr, vr = (a.repeat_interleave(G, 0) for a in (k, v))
    plain = ref.flash_attention_ref(q, kr, vr, **kw)
    tol = ATTN_TOL[torch.float32]
    np.testing.assert_allclose(o.cpu().numpy(), plain.cpu().numpy(),
                               atol=tol, rtol=tol)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(grads, want, torch.float32,
                        f"simt MLA S={S} G={G} {kw}")


@pytest.mark.cuda_only
@pytest.mark.parametrize("kw", BWD_MASKS + [
    dict(causal=True, kind="local", window=2048, softcap=50.0)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_forward_lse_matches_plain(D, kw):
    """The bf16 forward's lse (written only when asked) against the plain
    one, and the output the same with and without it."""
    dev = _card()
    scale = 8.0 if kw.get("softcap") else 1.0
    q, k, v = (t.transpose(1, 2).reshape(-1, 300, D).contiguous() for t in
               _qkv(D, 1, 300, 10, 1, D, torch.bfloat16, dev, scale))
    n0 = flash_attention.launches_by_path["wgmma"]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    plain = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["wgmma"] == n0 + 2
    assert torch.equal(out, plain)
    want = ref.flash_attention_lse_ref(q, k, **kw)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= LSE_TOL


def _wgmma_splits(q, v, kw) -> int:
    """The kv shares the wgmma forward cuts each q tile's kv range into
    for these inputs on this card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    return _build.load(
        "flash_attention_wgmma").flash_attention_wgmma_splits(
            q.shape[0], q.shape[1], q.shape[2], v.shape[2],
            int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
            int(kw.get("window", 0)))


@pytest.mark.cuda_only
@pytest.mark.parametrize("kw", [
    dict(causal=True, kind="local", window=2048),
    dict(causal=True, kind="local", window=2048, softcap=50.0),
    dict(causal=True, kind="chunked", window=128),
    dict(causal=False, kind="global")],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("BH,G,S,D,Dv", [
    (10, 10, 512, 256, 256), (10, 10, 1000, 256, 256), (2, 1, 301, 128, 128),
    (2, 2, 300, 64, 64), (4, 1, 257, 80, 80), (2, 2, 333, 192, 128)])
def test_flash_kernel_kv_split_joins_shares(BH, G, S, D, Dv, kw):
    """Grids that leave the card's block slots empty (recurrentgemma-2b's
    10 heads at S 512 and 1,000, and small ones at every head dim of the
    wgmma path) split each q tile's kv range into more than one share;
    the join writes o and the lse: against the plain versions, the same
    output with and without the lse, two calls bitwise equal, and the
    backward from the joined lse against its plain version, bitwise over
    two calls."""
    dev = _card()
    rng = np.random.default_rng(S + D + BH)
    mk = lambda rows, d: torch.from_numpy(
        rng.standard_normal((rows, S, d)).astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    q, k, v = mk(BH, D), mk(BH // G, D), mk(BH // G, Dv)
    assert _wgmma_splits(q, v, kw) > 1
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    kr, vr = (a.repeat_interleave(G, 0) for a in (k, v))
    _assert_bf16_attention_close(
        out, ref.flash_attention_ref(q, kr, vr, **kw),
        ref.flash_attention_ref(q, kr, vr.abs(), **kw))
    assert float((lse - ref.flash_attention_lse_ref(q, k, **kw)).abs()
                 .max()) <= LSE_TOL
    do = mk(BH, Dv)
    first = _bwd_launch(q, k, v, out, do, lse, kw)
    second = _bwd_launch(q, k, v, out, do, lse, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _assert_grads_close(first, ref.flash_attention_bwd_ref(
        q, k, v, out, do, **kw), torch.bfloat16, f"S={S} D={D} {kw}")


@pytest.mark.cuda_only
@GEMMA2_SCALES
@pytest.mark.parametrize("kind,window", [("local", 4096), ("global", 0)])
@pytest.mark.parametrize("S", [3000, 3001])
def test_flash_gemma2_shape_lse_and_bwd_with_softcap(S, kind, window,
                                                     scale):
    """gemma2-2b's shape as it trains (8 query heads over 4 kv heads, head
    dim 256, softcap 50, S 3,000 and a ragged 3,001, local 4,096 and
    global, unscaled and scores scaled by 16): the forward's lse against
    the plain one (its output the same without it), the backward against
    its plain version at BWD_TOL, bitwise over two calls."""
    dev = _card()
    kw = dict(causal=True, kind=kind, window=window, softcap=50.0)
    q, k, v, o, do, lse = _bwd_case(S + int(scale), 8, 2, S, 256,
                                    torch.bfloat16, dev, kw, scale)
    assert torch.equal(o, flash_attention(q, k, v, **kw))
    assert float((lse - ref.flash_attention_lse_ref(q, k, **kw)).abs()
                 .max()) <= LSE_TOL
    first = _bwd_launch(q, k, v, o, do, lse, kw)
    second = _bwd_launch(q, k, v, o, do, lse, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _assert_grads_close(first, ref.flash_attention_bwd_ref(
        q, k, v, o, do, **kw), torch.bfloat16, f"S={S} {kw} x{scale}")


@pytest.mark.cuda_only
@pytest.mark.parametrize("BH,S", [(2, 300), (10, 1000), (20, 2048)])
@pytest.mark.parametrize("kw", [kw for kw in BWD_MASKS
                                if not kw.get("softcap")],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_tf32_forward_lse_matches_plain(D, kw, BH, S):
    """The 3xTF32 forward's lse (written only when asked; by the main
    kernel, or by the join where the kv range is split, as it is at BH 2,
    S 300 for every mask but the chunked one) against the plain one, and
    the output the same with and without it."""
    dev = _card()
    rng = np.random.default_rng(D + S)
    mk = lambda rows: torch.from_numpy(rng.standard_normal(
        (rows, S, D)).astype(np.float32)).to(dev)
    q, k, v = mk(BH), mk(BH // 2), mk(BH // 2)
    n0 = flash_attention.launches_by_path["tf32"]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    plain = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["tf32"] == n0 + 2
    assert torch.equal(out, plain)
    want = ref.flash_attention_lse_ref(q, k, **kw)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= LSE_TOL


#: f32 with a softcap on the 3xTF32 kernels: the ~100M training example's
#: mask (launch/train_lm.py: causal, local 512, softcap 50) and others
TF32_CAP_MASKS = [dict(causal=True, kind="local", window=512, softcap=50.0),
                  dict(causal=True, kind="global", softcap=20.0),
                  dict(causal=False, kind="local", window=48, softcap=50.0),
                  dict(causal=True, kind="chunked", window=64, softcap=30.0)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("scale", [1.0, 8.0], ids=["unscaled", "qk_x8"])
@pytest.mark.parametrize("kw", TF32_CAP_MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("BH,S", [(8, 333), (64, 512)])
@pytest.mark.parametrize("D", [96, 128])
def test_flash_tf32_kernels_with_a_softcap(D, BH, S, kw, scale):
    """f32 with a softcap at the example's head dim 96 and at 128, GQA
    2:1, ragged S 333 and the example's BH 64, S 512, q and k unscaled
    and times 8 (scores of tens, where the cap bites): the wrapper
    launches "tf32" forward and backward; the forward within ATTN_TOL of
    the function evaluated in float64, the same output with and without
    its lse, the lse within LSE_TOL of the plain one; the backward from
    that lse within BWD_TOL of the plain backward and bitwise the same
    over two calls."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    assert path(torch.float32, D, kw["softcap"]) == "tf32" == bwd_path(
        torch.float32, D, kw["softcap"])
    by_path = dict(flash_attention.launches_by_path)
    q, k, v, o, do, lse = _bwd_case(D + S + int(scale), BH, 2, S, D,
                                    torch.float32, dev, kw, scale)
    by_path["tf32"] += 1
    assert flash_attention.launches_by_path == by_path
    assert torch.equal(o, flash_attention(q, k, v, **kw))
    to4 = lambda t, rows: t.reshape(1, rows, S, D).transpose(1, 2)
    want = _attention_f64(to4(q, BH), to4(k, BH // 2), to4(v, BH // 2), kw)
    tol = ATTN_TOL[torch.float32]
    np.testing.assert_allclose(o.double().cpu().numpy(),
                               want.transpose(1, 2).reshape(BH, S, D)
                               .cpu().numpy(), atol=tol, rtol=tol)
    assert float((lse - ref.flash_attention_lse_ref(q, k, **kw)).abs()
                 .max()) <= LSE_TOL
    by_bwd = dict(flash_attention_bwd.launches_by_path)
    first = _bwd_launch(q, k, v, o, do, lse, kw)
    second = _bwd_launch(q, k, v, o, do, lse, kw)
    by_bwd["tf32"] += 2
    assert flash_attention_bwd.launches_by_path == by_bwd
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_grads_close(first, ref.flash_attention_bwd_ref(
        q, k, v, o, do, **kw), torch.float32, f"D={D} S={S} {kw} x{scale}")


@pytest.mark.cuda_only
def test_flash_tf32_softcap_gradient_through_function():
    """A gradient through ``FlashAttentionFn`` at the example's head dim
    96 with its softcap of 50, f32: the forward launches "tf32" and saves
    its lse, the backward launches "tf32" once, its gradients the backward
    wrapper's on the saved lse."""
    dev = _card()
    kw = dict(causal=True, kind="local", window=512, softcap=50.0)
    q, k, v, _o, do, _lse = _bwd_case(96, 16, 2, 300, 96, torch.float32,
                                      dev, kw)
    qg, kg, vg = (a.clone().requires_grad_(True) for a in (q, k, v))
    fwd0 = dict(flash_attention.launches_by_path)
    bwd0 = dict(flash_attention_bwd.launches_by_path)
    o = flash_attention_fn(qg, kg, vg, **kw)
    assert flash_attention.launches_by_path == {
        p: n + (p == "tf32") for p, n in fwd0.items()}
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches_by_path == {
        p: n + (p == "tf32") for p, n in bwd0.items()}
    want = flash_attention_bwd(q, k, v, o.detach(), do, saved[4], **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda_only
def test_flash_lse_refused_off_the_wgmma_path_and_required_on_it():
    """The wgmma and tf32 backwards without the forward's lse raise
    (nothing falls back); the CUDA-core forward (head dim 16, with or
    without a softcap), which writes no lse, refuses to return one; the
    simt backward takes no lse."""
    dev = _card()
    kw = dict(causal=True, kind="local", window=32)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, o, do, lse = _bwd_case(1, 4, 2, 100, 64, dtype, dev, kw)
        n0 = flash_attention_bwd.launches
        with pytest.raises(ValueError, match="lse"):
            flash_attention_bwd(q, k, v, o, do, **kw)
        with pytest.raises(ValueError, match="lse"):
            flash_attention_bwd(q, k, v, o, do, lse[:, :50].contiguous(),
                                **kw)
        assert flash_attention_bwd.launches == n0
    q, k, v, o, do, lse = _bwd_case(1, 4, 2, 100, 16, torch.float32, dev,
                                    kw)
    assert lse is None
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, return_lse=True, **kw)
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, return_lse=True, softcap=5.0, **kw)
    _bwd_launch(q, k, v, o, do, None, kw)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_bwd_kernel_rows_that_see_only_their_own_key(D, dtype):
    """Window 1: every row sees its own key and the rest of each tile is
    masked out, so p = 1 on the diagonal: dv is dO exactly, and dq and dk
    are 0 up to the rounding of dp - D_i (D_i = dO . o with o = v in
    exact arithmetic), far below the other tests' scale."""
    dev = _card()
    kw = dict(causal=True, kind="local", window=1)
    q, k, v, o, do, lse = _bwd_case(D, 4, 2, 100, D, dtype, dev, kw)
    dq, dk, dv = _bwd_launch(q, k, v, o, do, lse, kw)
    want_dv = do.float().reshape(2, 2, 100, D).sum(dim=1).to(dtype)
    np.testing.assert_allclose(dv.float().cpu().numpy(),
                               want_dv.float().cpu().numpy(),
                               rtol=BWD_TOL[dtype][0], atol=1e-6)
    scale = float(do.float().abs().max() * v.float().abs().max()
                  * k.float().abs().max())
    for g in (dq, dk):
        assert float(g.float().abs().max()) <= 1e-4 * scale


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype,S", [(torch.bfloat16, 512),
                                     (torch.bfloat16, 1000),
                                     (torch.bfloat16, 2048),
                                     (torch.bfloat16, 3000),
                                     (torch.float32, 512),
                                     (torch.float32, 1000),
                                     (torch.float32, 2048),
                                     (torch.float32, 3000)])
def test_flash_bwd_kernel_serving_shape(S, dtype):
    """recurrentgemma's local layers: MQA 10:1 (dK/dV sum the ten query
    heads of the one kv head), head dim 256, window 2,048: the first and
    last key tiles of each window are partial."""
    dev = _card()
    kw = dict(causal=True, kind="local", window=2048)
    q, k, v, o, do, lse = _bwd_case(S, 10, 10, S, 256, dtype, dev, kw)
    got = _bwd_launch(q, k, v, o, do, lse, kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype, f"S={S}")


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype,S", [(torch.bfloat16, 1000),
                                     (torch.bfloat16, 3000),
                                     (torch.float32, 1000),
                                     (torch.float32, 3000)])
def test_flash_bwd_kernel_is_deterministic(dtype, S):
    """No atomics: two runs give bitwise the same gradients, on both
    tensor-core paths (each sums its dK/dV shares in a fixed order)."""
    dev = _card()
    kw = dict(causal=True, kind="local", window=2048)
    q, k, v, o, do, lse = _bwd_case(5, 10, 10, S, 256, dtype, dev, kw)
    first = _bwd_launch(q, k, v, o, do, lse, kw)
    second = _bwd_launch(q, k, v, o, do, lse, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_grads_through_the_kernels(dtype):
    """autograd through ``ops.attention_op`` in the model's layout: the
    forward and backward kernels, one launch each, against autograd
    through the plain versions."""
    dev = _card()
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(3, 2, 96, 4, 1, 64, dtype, dev))
    kw = dict(causal=True, kind="local", window=40)
    do = torch.randn(q.shape, device=dev).to(dtype)
    n0 = flash_attention.launches, flash_attention_bwd.launches
    got = torch.autograd.grad(ops.attention_op(q, k, v, **kw), (q, k, v), do)
    assert (flash_attention.launches - n0[0],
            flash_attention_bwd.launches - n0[1]) == (1, 1)
    want = torch.autograd.grad(ops.attention_op(q, k, v, use_kernel=False,
                                                **kw), (q, k, v), do)
    torch.cuda.synchronize()
    # the kernel's forward rounds p to bf16 before P.V and the plain
    # version does not, so its output (and D_i) differs by ~2^-9
    rel, of_max = BWD_TOL[dtype]
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= (
            4 * rel + of_max if dtype == torch.bfloat16 else
            rel + of_max) * scale


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(1, 3000, 2560), (4, 1000, 2560),
                                   (1, 1, 2560), (2, 257, 48), (3, 65, 8),
                                   (1, 130, 2562), (2, 100, 30)])
def test_rglru_bwd_kernel_is_exactly_the_serial_loop(B, S, W, with_h0):
    """The reverse scan on its path (TMA where W % 4 == 0, else one
    thread a channel): da, db and dh0 bitwise the plain reverse loop."""
    from repro_torch.kernels.rglru_scan import path
    dev = _card()
    rng = np.random.default_rng(B * S + W + 1)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, W)).astype(
        np.float32)).to(dev)
    h0 = mk(B, W) if with_h0 else None
    h = rglru_scan(a, mk(B, S, W), h0)
    dh = mk(B, S, W)
    kernel = path(B, S, W)
    n0, by0 = rglru_scan_bwd.launches, dict(rglru_scan_bwd.launches_by_path)
    da, db, dh0 = rglru_scan_bwd(a, h, dh, h0, with_dh0=True)
    assert rglru_scan_bwd.launches == n0 + 1
    assert rglru_scan_bwd.launches_by_path[kernel] == by0[kernel] + 1
    want = ref.rglru_scan_bwd_ref(a, h, dh, h0)
    for got, w in zip((da, db, dh0), want):
        np.testing.assert_array_equal(got.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda_only
def test_rglru_scan_fn_grads_on_card():
    dev = _card()
    a = (torch.rand(2, 70, 64, device=dev) * 0.5 + 0.5).requires_grad_(True)
    b = torch.randn(2, 70, 64, device=dev, requires_grad=True)
    h0 = torch.randn(2, 64, device=dev, requires_grad=True)
    dh = torch.randn(2, 70, 64, device=dev)
    got = torch.autograd.grad(rglru_scan_fn(a, b, h0), (a, b, h0), dh)
    want = torch.autograd.grad(ref.rglru_scan_ref(a, b, h0), (a, b, h0), dh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda_only
def test_smoke_train_step_on_card_kernels_match_plain():
    """One train step of the recurrentgemma smoke model on the card (f32,
    remat on): the loss and every gradient leaf through the kernels
    within 1e-4 of its largest element through the plain versions; one
    backward launch a local layer and a recurrent layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim.adamw import leaves_with_path
    dev = _card()
    cfg = get_smoke_config("recurrentgemma-2b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = [p.requires_grad_(True) for _, p in leaves_with_path(params)]
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "targets")}
    out = []
    for use_kernel in (True, False):
        n0 = flash_attention_bwd.launches, rglru_scan_bwd.launches
        loss, _ = steps_lib.loss_fn(cfg, params, batch, remat=True,
                                    use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, leaves)
        kinds = cfg.layer_kinds()
        want = ((kinds.count("local"), kinds.count("recurrent"))
                if use_kernel else (0, 0))
        assert (flash_attention_bwd.launches - n0[0],
                rglru_scan_bwd.launches - n0[1]) == want
        out.append((float(loss), grads))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4)
    for g, w in zip(out[0][1], out[1][1]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------------------
# The SSD scan's backward kernel against its plain version, and mamba2's
# gradients through the kernels against the plain versions'.
# ---------------------------------------------------------------------------

from repro_torch.kernels.ssd_scan import (  # noqa: E402
    bwd_path as ssd_bwd_path, ssd_scan_bwd, ssd_scan_fn)

SSD_GRADS = ("dx", "ddA", "ddt", "dB", "dC", "dh0")


def _ssd_bwd_case(seed, B, H, G, S, P, N, dtype, with_h0, with_dh, dev):
    """The forward's inputs (``_ssd_case``), dy in x's dtype and dh f32
    (or None)."""
    args = _ssd_case(seed, B, H, G, S, P, N, dtype, with_h0, dev)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((B, H, S, P)).astype(
        np.float32)).to(device=dev, dtype=dtype)
    dh = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)).to(dev) if with_dh else None)
    return args, dy, dh


def _assert_ssd_grads_close(got, want, dtype, what=""):
    """Each gradient within SSD_TOL of its largest |value|, finite, in its
    input's dtype."""
    tol = SSD_TOL[dtype]
    for name, g, w in zip(SSD_GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), (what, name)
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), (what, name, err)


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,P,N", [
    (2, 3, 3, 37, 8, 16),        # small, prime S: one ragged chunk, G = H
    (2, 4, 2, 200, 40, 100),     # grouped B/C, P and N off the tiles
    (1, 8, 1, 129, 64, 128),     # one row past two chunks
    (1, 80, 1, 3001, 64, 128),   # mamba2-2.7b's shape, prime S
    (2, 8, 2, 200, 64, 128),     # grouped B/C at the served widths
    (1, 8, 4, 64, 16, 16),       # the smoke widths, one whole chunk
    (1, 6, 3, 1, 64, 128),       # one token
    (1, 6, 3, 200, 64, 128),     # 2 heads a group: a head tile cut short
    (2, 10, 2, 129, 64, 128),    # 5 heads a group: tiles of 4 and 1
])
def test_ssd_bwd_kernel_matches_plain(B, H, G, S, P, N, dtype, with_h0,
                                      with_dh):
    """dx, ddA, ddt, dB and dC (summed over each group's heads) and dh0
    against ``ref.ssd_scan_bwd_ref`` at the kernels' chunk; one launch a
    call, on the path ``bwd_path`` names: at P 64, N 128 bf16 the wgmma
    kernel and f32 the 3xTF32 one, the rest the CUDA-core one."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(S + N, B, H, G, S, P, N, dtype, with_h0,
                                 with_dh, dev)
    n0 = ssd_scan_bwd.launches
    by_path = dict(ssd_scan_bwd.launches_by_path)
    got = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == n0 + 1
    ran = _ssd_kernel(dtype, P, N)
    assert ssd_bwd_path(dtype, P, N) == ran
    by_path[ran] += 1
    assert ssd_scan_bwd.launches_by_path == by_path
    want = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK)
    _assert_ssd_grads_close(got, want, dtype, f"S={S} G={G} {dtype}")


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_is_deterministic(dtype):
    """No atomics: two calls at mamba2's shape give bitwise the same
    gradients (the group's heads summed in head order), bf16 on the
    wgmma kernel, f32 on the 3xTF32 one."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(5, 1, 80, 1, 3001, 64, 128, dtype, True,
                                 True, dev)
    by_path = dict(ssd_scan_bwd.launches_by_path)
    first = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    second = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    ran = _ssd_kernel(dtype, 64, 128)
    by_path[ran] += 2
    assert ssd_scan_bwd.launches_by_path == by_path
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _first_ssd_bwd(args, dy, dh):
    """The first SSD backward (``csrc/ssd_scan_bwd.cu``) called directly,
    as chip_smoke's ``simt_ssd_bwd`` does, so that it runs at a shape
    where the wrapper takes the tensor-core kernel; not counted."""
    from repro_torch.kernels import _build
    x, dA, dt, Bm, Cm, h0 = args
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    lib = _build.load("ssd_scan_bwd")
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddA, ddt = torch.empty_like(dA), torch.empty_like(dt)
    dh0 = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    buf = torch.empty(lib.ssd_scan_bwd_scratch_bytes(B, H, S, P, N),
                      dtype=torch.uint8, device=x.device)
    opt = lambda t: None if t is None else t.data_ptr()
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), opt(h0), dy.data_ptr(), opt(dh), dx.data_ptr(),
        ddA.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), buf.data_ptr(), B, H, G, S, P, N,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssd_scan_bwd (simt, direct)")
    return dx, ddA, ddt, dB, dC, dh0


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_bwd_first_design_and_tensor_core_kernel_both_match_plain(
        with_h0):
    """At mamba2-2.7b's shape in bf16 (1, 80, 1, 3,001, 64, 128) the first
    design (the CUDA cores) and the tensor-core kernel, on the same
    inputs, are each within SSD_TOL of the plain version; the wrapper
    launches the tensor-core one."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(11, 1, 80, 1, 3001, 64, 128,
                                 torch.bfloat16, with_h0, with_h0, dev)
    want = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK)
    n0 = ssd_scan_bwd.launches_by_path["wgmma"]
    new = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    assert ssd_scan_bwd.launches_by_path["wgmma"] == n0 + 1
    first = _first_ssd_bwd(args, dy, dh)
    torch.cuda.synchronize()
    _assert_ssd_grads_close(new, want, torch.bfloat16, "wgmma")
    _assert_ssd_grads_close(first, want, torch.bfloat16, "simt")


@pytest.mark.cuda_only
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_f32_first_designs_and_tf32_kernels_all_match_plain(with_h0):
    """At mamba2-2.7b's shape in f32 (1, 80, 1, 3,001, 64, 128) the first
    designs (the CUDA cores, forward and backward) and the 3xTF32
    kernels, on the same inputs, are each within SSD_TOL of the plain
    versions; the wrappers launch the 3xTF32 kernels."""
    from repro_torch.kernels import _build
    dev = _card()
    args, dy, dh = _ssd_bwd_case(13, 1, 80, 1, 3001, 64, 128,
                                 torch.float32, with_h0, with_h0, dev)
    x, dA, dt, Bm, Cm, h0 = args
    yp, hp = ref.ssd_scan_ref(*args, chunk=CHUNK)
    n0 = ssd_scan.launches_by_path["tf32"]
    y, h = ssd_scan(*args)
    assert ssd_scan.launches_by_path["tf32"] == n0 + 1
    y1, h1 = torch.empty_like(x), torch.empty_like(hp)
    _build.check_launch(_build.load("ssd_scan").ssd_scan_fwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y1.data_ptr(), h1.data_ptr(), 1, 80, 1, 3001, 64, 128, 0,
        torch.cuda.current_stream().cuda_stream), "ssd_scan (simt)")
    torch.cuda.synchronize()
    tol = SSD_TOL[torch.float32]
    for yy, hh in ((y, h), (y1, h1)):
        assert float((yy - yp).abs().max()) <= tol * float(yp.abs().max())
        assert float((hh - hp).norm()) <= tol * float(hp.norm())
    want = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK)
    n0 = ssd_scan_bwd.launches_by_path["tf32"]
    new = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    assert ssd_scan_bwd.launches_by_path["tf32"] == n0 + 1
    first = _first_ssd_bwd(args, dy, dh)
    torch.cuda.synchronize()
    _assert_ssd_grads_close(new, want, torch.float32, "tf32")
    _assert_ssd_grads_close(first, want, torch.float32, "simt")


@pytest.mark.cuda_only
def test_ssd_bwd_refuses_what_the_kernel_does_not_take():
    """A head dim above 64 raises on the card (nothing falls back to the
    plain version); without `with_dh0` no dh0 is returned."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(2, 1, 2, 1, 70, 80, 16, torch.float32,
                                 False, False, dev)
    n0 = ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan_bwd(*args, dy, dh)
    assert ssd_scan_bwd.launches == n0
    args, dy, dh = _ssd_bwd_case(2, 1, 2, 1, 70, 16, 16, torch.float32,
                                 False, False, dev)
    assert ssd_scan_bwd(*args, dy, dh)[5] is None


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_op_grads_through_the_kernels(dtype):
    """autograd through ``ops.ssd_op`` in the model's layout (x, dt, A, B,
    C and h0 all leaves): one forward and one backward launch, against
    autograd through the plain version at the kernels' chunk."""
    dev = _card()
    rng = np.random.default_rng(7)
    B, S, H, P, G, N = 2, 150, 8, 64, 2, 128
    mk = lambda *shape, dt=torch.float32: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(
            device=dev, dtype=dt).requires_grad_(True)
    x, Bm, Cm = mk(B, S, H, P, dt=dtype), mk(B, S, G, N, dt=dtype), mk(
        B, S, G, N, dt=dtype)
    dt = torch.nn.functional.softplus(mk(B, S, H) - 2.0).detach()
    dt.requires_grad_(True)
    A = (-torch.linspace(1.0, 8.0, H, device=dev)).requires_grad_(True)
    h0 = mk(B, H, P, N)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(
        np.float32)).to(device=dev, dtype=dtype)
    ins = (x, dt, A, Bm, Cm, h0)
    n0 = ssd_scan.launches, ssd_scan_bwd.launches
    y, _h = ops.ssd_op(x, dt, A, Bm, Cm, h0)
    got = torch.autograd.grad(y, ins, dy)
    assert (ssd_scan.launches - n0[0], ssd_scan_bwd.launches - n0[1]) == (1, 1)
    yp, _hp = ops.ssd_op(x, dt, A, Bm, Cm, h0, chunk=CHUNK, use_kernel=False)
    want = torch.autograd.grad(yp, ins, dy)
    tol = SSD_TOL[dtype]
    for name, g, w in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)


@pytest.mark.cuda_only
def test_mamba_smoke_train_grads_on_card_kernels_match_plain():
    """The mamba2 smoke model's loss gradients on the card through the
    kernels (the SSD scan's forward and backward) against the plain
    versions', every leaf within 5e-2 in norm (phase 8 (c)'s limit) and
    within 1e-4 of its largest element (f32); A_log and dt_bias, which
    reach the loss only through the scan, get a non-zero gradient.  Before
    the backward kernel their gradients were zero here."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim.adamw import leaves_with_path
    dev = _card()
    cfg = get_smoke_config("mamba2-2.7b").replace(n_layers=2)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    named = leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 77))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "targets")}
    out = []
    for use_kernel in (True, False):
        n0 = ssd_scan.launches, ssd_scan_bwd.launches
        loss, _ = steps_lib.loss_fn(cfg, params, batch, remat=True,
                                    use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, leaves)
        # remat recomputes each layer's forward in the backward
        want = ((2 * cfg.n_layers, cfg.n_layers) if use_kernel else (0, 0))
        assert (ssd_scan.launches - n0[0],
                ssd_scan_bwd.launches - n0[1]) == want
        out.append((float(loss), grads))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4)
    for (path, _), g, w in zip(named, out[0][1], out[1][1]):
        name = "/".join(str(p) for p in path)
        assert float((g - w).norm()) <= 5e-2 * float(w.norm()), name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            name
        if "A_log" in name or "dt_bias" in name:
            assert float(g.abs().max()) > 0, name


@pytest.mark.cuda_only
def test_mesh_train_step_on_card_matches_one_device(tmp_path):
    """The recurrentgemma smoke config's mesh train step on a 1x1 NCCL
    mesh (a FileStore under tmp_path) against the one-device step, eager
    (``graph=False``), on the same seed and batches: losses within 1e-5
    relative over three steps,
    the parameters after them within 1e-5, and the same kernel launches
    (the attention and RG-LRU scan forwards and backwards)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.distributed import make_train_step
    from repro_torch.distributed.steps import _full
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    from repro_torch.launch.train import build_state, put_batch
    from repro_torch.models.steps import make_train_batch
    from repro_torch.optim import adamw
    dev = _card()
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config("recurrentgemma-2b")
        shape = InputShape("t", 64, 2, "train")
        opt = adamw.AdamWConfig(total_steps=4, warmup_steps=1)
        runs = []
        for m in (None, mesh):
            # the one-device step eager, as the mesh step runs, so that
            # the wrappers count every step's launches on both
            bundle = make_train_step(cfg, m, shape, opt, device=dev,
                                     graph=False)
            state = build_state(cfg, opt, 0, dev)
            counts = [flash_attention.launches, rglru_scan.launches,
                      flash_attention_bwd.launches, rglru_scan_bwd.launches]
            losses = []
            for i in range(3):
                batch = make_train_batch(cfg, shape,
                                         np.random.default_rng(i), dev)
                state, met = bundle.fn(state, batch)
                losses.append(float(met["loss"]))
            counts = [c1 - c0 for c0, c1 in zip(counts, [
                flash_attention.launches, rglru_scan.launches,
                flash_attention_bwd.launches, rglru_scan_bwd.launches])]
            runs.append((losses, counts, [
                _full(p) for _, p in adamw.leaves_with_path(
                    state["params"])]))
        (l0, c0, p0), (l1, c1, p1) = runs
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        assert c1 == c0 and all(c > 0 for c in c0)
        for a, b in zip(p0, p1):
            assert float((a - b).abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda_only
@pytest.mark.parametrize("seed", range(4))
def test_quantize_on_card_is_bitwise_the_cpu(seed):
    """``compression.quantize`` / ``ef_quantize`` on the card bitwise the
    CPU's over 200 tensors of scales from 1e-8 to 1e2, the scale numpy's
    IEEE float32 division by 127 on both (CUDA's division by a Python
    scalar, a product with its reciprocal, would round some differently)."""
    from repro_torch.distributed.compression import ef_quantize, quantize
    dev = _card()
    rng = np.random.default_rng(seed)
    for _ in range(200):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                             * np.float32(10.0 ** rng.uniform(-8, 2)))
        err = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                               * np.float32(1e-3))
        q0, s0 = quantize(g)
        q1, s1 = quantize(g.to(dev))
        assert torch.equal(q1.cpu(), q0) and torch.equal(s1.cpu(), s0)
        ieee = np.float32(g.abs().max().item()) / np.float32(127.0)
        assert s0.numpy().view(np.int32) == np.asarray(ieee).view(np.int32)
        want = ef_quantize(g, err)
        got = ef_quantize(g.to(dev), err.to(dev))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The six architectures that phase 11 of chip_smoke serves: the flash
# kernel forward and backward at their new shapes, and their smoke models
# at published head dims through the kernels against the plain versions.
# ---------------------------------------------------------------------------

#: (BH, G, D, S, mask): qwen1.5-110b's group of 8 at head dim 128;
#: llama4's chunks of 8,192, S just past one boundary (group 5);
#: gemma3-12b's local window of 1,024 at head dim 256, group 2; hubert's
#: head dim 80, non-causal, on the wgmma kernels
NEW_SHAPES = [(16, 8, 128, 300, dict(causal=True, kind="global")),
              (10, 5, 128, 8292, dict(causal=True, kind="chunked",
                                      window=8192)),
              (4, 2, 256, 1500, dict(causal=True, kind="local",
                                     window=1024)),
              (4, 1, 80, 300, dict(causal=False, kind="global"))]


@pytest.mark.cuda_only
@pytest.mark.parametrize("BH,G,D,S,kw", NEW_SHAPES,
                         ids=["qwen-g8-d128", "llama4-chunked-8192",
                              "gemma3-local-1024-d256", "hubert-d80-wgmma"])
def test_flash_kernels_at_the_new_model_shapes(BH, G, D, S, kw):
    """bf16, forward and backward, one launch each on the path ``path``
    names (wgmma at D 80, 128 and 256), against the plain versions at the
    bf16 tolerances of the shapes before them."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    kernel = path(torch.bfloat16, D)
    assert kernel == "wgmma"
    by_path = dict(flash_attention.launches_by_path)
    q, k, v, o, do, lse = _bwd_case(BH + G + D + S, BH, G, S, D,
                                    torch.bfloat16, dev, kw)
    by_path[kernel] += 1
    assert flash_attention.launches_by_path == by_path
    group = lambda t: t.repeat_interleave(G, 0)
    plain = ref.flash_attention_ref(q, group(k), group(v), **kw)
    _assert_bf16_attention_close(
        o, plain, ref.flash_attention_ref(q, group(k), group(v).abs(), **kw))
    got = _bwd_launch(q, k, v, o, do, lse, kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(got, want, torch.bfloat16, f"{kw}")


#: hubert-xlarge's head dim 80 on the wgmma kernels: MHA and GQA 2:1,
#: every mask (non-causal global, the mask that keeps every pair below
#: S, takes the backward's instantiation without per-pair tests), ragged
#: S
D80_CASES = [(4, 1, 300, dict(causal=False, kind="global")),
             (8, 2, 1001, dict(causal=False, kind="global")),
             (8, 2, 300, dict(causal=True, kind="global")),
             (4, 2, 1001, dict(causal=True, kind="local", window=100)),
             (4, 1, 300, dict(causal=True, kind="chunked", window=128)),
             (4, 2, 300, dict(causal=True, kind="global", softcap=20.0)),
             (4, 1, 1001, dict(causal=False, kind="local", window=48))]


@pytest.mark.cuda_only
@pytest.mark.parametrize("BH,G,S,kw", D80_CASES, ids=lambda x: (
    "-".join(f"{k}{v}" for k, v in x.items()) if isinstance(x, dict)
    else str(x)))
def test_flash_kernels_at_hubert_head_dim(BH, G, S, kw):
    """bf16 at D 80: the forward and backward on the wgmma kernels, one
    launch each, against the plain versions at the bf16 tolerances, and
    the backward bitwise the same over two calls."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    assert path(torch.bfloat16, 80) == bwd_path(torch.bfloat16, 80) == "wgmma"
    by_path = dict(flash_attention.launches_by_path)
    q, k, v, o, do, lse = _bwd_case(BH + G + S, BH, G, S, 80, torch.bfloat16,
                                    dev, kw, 4.0 if kw.get("softcap") else 1.0)
    by_path["wgmma"] += 1
    assert flash_attention.launches_by_path == by_path
    group = lambda t: t.repeat_interleave(G, 0)
    plain = ref.flash_attention_ref(q, group(k), group(v), **kw)
    _assert_bf16_attention_close(
        o, plain, ref.flash_attention_ref(q, group(k), group(v).abs(), **kw))
    got = _bwd_launch(q, k, v, o, do, lse, kw)
    again = _bwd_launch(q, k, v, o, do, lse, kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(got, want, torch.bfloat16, f"D=80 S={S} G={G} {kw}")


@pytest.mark.cuda_only
@pytest.mark.parametrize("S,kw", [(300, dict(causal=False, kind="global")),
                                  (1001, dict(causal=True, kind="local",
                                              window=100))],
                         ids=["global", "local100"])
def test_cuda_core_kernels_held_at_hubert_head_dim(S, kw):
    """The CUDA-core forward and backward, which the wrapper no longer
    takes for bf16 at D 80, called directly there (the witness the wgmma
    kernels are timed beside): the output and each gradient within the
    bf16 tolerances of the plain versions, no wrapper launch counted."""
    dev = _card()
    rng = np.random.default_rng(S)
    mk = lambda rows: torch.from_numpy(rng.standard_normal(
        (rows, S, 80)).astype(np.float32)).to(device=dev,
                                               dtype=torch.bfloat16)
    q, k, v, do = mk(4), mk(2), mk(2), mk(4)
    n0 = flash_attention.launches, flash_attention_bwd.launches
    o, grads = _simt_direct(q, k, v, do, kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0
    kr, vr = (a.repeat_interleave(2, 0) for a in (k, v))
    _assert_bf16_attention_close(
        o, ref.flash_attention_ref(q, kr, vr, **kw),
        ref.flash_attention_ref(q, kr, vr.abs(), **kw))
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    _assert_grads_close(grads, want, torch.bfloat16, f"simt D=80 S={S} {kw}")


PHASE11_ARCHS = ["gemma-7b", "gemma3-12b", "qwen1.5-110b",
                 "llama4-maverick-400b-a17b", "internvl2-2b",
                 "hubert-xlarge"]


def _smoke_at_published_head_dim(arch):
    """The smoke config of `arch` in bf16 with its published head dim (so
    its attention takes the kernel its full model takes)."""
    from repro_torch.configs import get_config, get_smoke_config
    return get_smoke_config(arch).replace(
        head_dim=get_config(arch).resolved_head_dim(), dtype="bfloat16")


def _smoke_batch(cfg, S, seed, dev):
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (2, S))}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (2, S, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, S))
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _route_as_the_kernels_run(monkeypatch):
    """Wraps the MoE router so that a plain run routes each token as the
    kernels' run before it did (bf16 rounding flips near-tied experts, and
    a token routed otherwise has other logits and gradients): after
    ``record()`` each call's experts are kept, after ``replay()`` the
    calls take them in the same order, weighted by their own gates.
    Returns (record, replay)."""
    from repro_torch.models import moe as moe_mod
    orig, first, at = moe_mod._router, [], [None]

    def router(params, x2d, moe):
        w, idx, gates = orig(params, x2d, moe)
        if at[0] is None:
            first.append(idx)
            return w, idx, gates
        idx, at[0] = first[at[0]], at[0] + 1
        w = gates.gather(1, idx)
        return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), \
            idx, gates

    def record():
        first.clear()
        at[0] = None

    def replay():
        at[0] = 0

    monkeypatch.setattr(moe_mod, "_router", router)
    return record, replay


@pytest.mark.cuda_only
@pytest.mark.parametrize("arch", PHASE11_ARCHS)
def test_new_arch_smoke_model_on_card_kernels_match_plain(arch, monkeypatch):
    """Each smoke model of phase 11's six at its published head dim, bf16:
    the forward's logits (hubert's every position, the others' prefill's
    last one and three decode steps after it) through the kernels within
    2e-2 of the largest |logit| of the plain versions', one flash launch a
    layer on the path of its head dim; then the loss and every gradient
    leaf (remat on) within 5e-2 in norm of the plain versions', one
    backward launch a layer on the same path, no leaf zero through the
    kernels that is not through the plain versions.  llama4's plain runs
    route every token as the kernels' runs did."""
    from repro_torch.kernels.flash_attention import path
    from repro_torch.models import model as model_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim.adamw import leaves_with_path
    dev = _card()
    cfg = _smoke_at_published_head_dim(arch)
    kernel = path(torch.bfloat16, cfg.resolved_head_dim())
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = _smoke_batch(cfg, 77, 5, dev)
    inputs = {k: v for k, v in batch.items() if k != "targets"}

    record, replay = _route_as_the_kernels_run(monkeypatch)

    def close(got, want):
        tol = 2e-2 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol

    by_path = dict(flash_attention.launches_by_path)
    record()
    if cfg.encoder_only:
        got = model_lib.forward(cfg, params, inputs)
        replay()
        want = model_lib.forward(cfg, params, inputs, use_kernel=False)
        close(got, want)
    else:
        n = 77 + cfg.n_frontend_tokens
        got, gc = model_lib.prefill(cfg, params, inputs, n + 4)
        replay()
        want, wc = model_lib.prefill(cfg, params, inputs, n + 4,
                                     use_kernel=False)
        close(got, want)
        tok = want.argmax(-1)
        for i in range(3):
            pos = torch.full((2,), n + i, device=dev)
            record()
            got, gc = model_lib.decode_step(cfg, params, tok, pos, gc)
            replay()
            want, wc = model_lib.decode_step(cfg, params, tok, pos, wc)
            close(got, want)
            tok = want.argmax(-1)
    by_path[kernel] += cfg.n_layers
    assert flash_attention.launches_by_path == by_path

    named = leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    runs = []
    for use_kernel in (True, False):
        if use_kernel:
            record()
        else:
            replay()
        n0 = dict(flash_attention_bwd.launches_by_path)
        loss, _ = steps_lib.loss_fn(cfg, params, batch, remat=True,
                                    use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        runs.append((float(loss.detach()),
                     [torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)]))
        assert flash_attention_bwd.launches_by_path == {
            p: c + (cfg.n_layers if use_kernel and p == kernel else 0)
            for p, c in n0.items()}
    (lk, gk), (lp, gp) = runs
    assert abs(lk - lp) <= 5e-2 * abs(lp)
    for (p, _), a, b in zip(named, gk, gp):
        a, b = a.float(), b.float()
        assert bool(a.any()) or not bool(b.any()), p
        assert float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-30, p


# ---------------------------------------------------------------------------
# The serving engine's decode step captured in a CUDA graph
# (``serving.engine.DecodeStep``) against the same step run eagerly
# ---------------------------------------------------------------------------

def _decode_archs():
    from repro_torch.configs import get_smoke_config, list_archs
    return [a for a in list_archs() if not get_smoke_config(a).encoder_only]


def _bf16_smoke(arch, dev):
    """`arch`'s smoke config computing in bf16, as the served models do,
    and its parameters from a generator seeded 0 on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    return cfg, model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


@pytest.mark.cuda_only
@pytest.mark.parametrize("arch", _decode_archs())
def test_graphed_decode_equals_eager_decode(arch):
    """Every smoke architecture that decodes, bf16: from one prefill of
    two rows (internvl2-2b's after its patch embeddings) and a bitwise
    copy of its cache, 8 greedy steps through the captured step and 8
    through the eager one: the tokens equal at every step, the logits
    before and after the final softcap and every cache leaf bitwise; 8
    replays of one graph."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import DecodeStep
    dev = _card()
    cfg, params = _bf16_smoke(arch, dev)
    batch = {k: v for k, v in _smoke_batch(cfg, 21, 7, dev).items()
             if k != "targets"}
    n = 21 + cfg.n_frontend_tokens
    L = n + 9
    logits, cache = model_lib.prefill(cfg, params, batch, L)
    copy = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    graphed = DecodeStep(cfg, params, cache, 2, L, dev, graph=True)
    eager = DecodeStep(cfg, params, copy, 2, L, dev, graph=False)
    tok = logits.argmax(-1).cpu().numpy()
    for i in range(8):
        pos = np.full(2, n + i, np.int64)
        got = graphed(tok, pos)
        want = eager(tok.copy(), pos)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(graphed.logits, eager.logits), i
        assert torch.equal(graphed.pre, eager.pre), i
        tok = got
    assert graphed.replays == 8 and graphed.capture_ms > 0
    assert eager.graph is None and eager.replays == 0
    for a, b in zip(cache, copy):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def _drive(inst, steps_before_admit, late):
    """Steps `inst` until its first request is done, admits `late` into
    the freed slot, steps until none is active; each step's logits."""
    logs = []
    while inst.active[0] is not None:
        inst.step()
        logs.append(inst.decoder.logits.clone())
    assert len(logs) == steps_before_admit
    graph = inst.decoder.graph
    assert inst.admit(late) and inst.active[0] is late
    while inst.n_active():
        inst.step()
        logs.append(inst.decoder.logits.clone())
    assert inst.decoder.graph is graph
    return logs


@pytest.mark.cuda_only
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b",
                                  "deepseek-v2-236b"])
def test_admitting_into_a_freed_slot_after_capture_equals_eager(arch):
    """A request admitted into a slot freed after the capture (its
    prefill spliced into the captured cache in place) decodes through the
    same graph: every request's tokens and every step's logits bitwise
    the eager instance's, one replay a step, no second capture."""
    from repro_torch.serving.engine import Request, ServingInstance
    dev = _card()
    cfg, params = _bf16_smoke(arch, dev)
    runs = []
    for graph in (True, False):
        inst = ServingInstance(cfg, params, slots=2, max_len=64, device=dev,
                               graph=graph)
        reqs = [Request(0, _prompt(cfg, 11, 1), 3),
                Request(1, _prompt(cfg, 23, 2), 9),
                Request(2, _prompt(cfg, 17, 3), 6)]
        assert inst.admit(reqs[0]) and inst.admit(reqs[1])
        logs = _drive(inst, 2, reqs[2])
        assert inst.decoder.replays == (len(logs) if graph else 0)
        runs.append(([r.tokens for r in reqs], logs))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda_only
def test_two_instances_share_the_pool_and_replay_alternately():
    """Two instances of one engine, their steps replayed in turn (each
    one's outputs read before the other replays): each equal to its own
    eager run in tokens and bitwise in every step's logits, both graphs
    in the function's one memory pool."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import Request, ServingEngine
    dev = _card()
    cfg, params = _bf16_smoke("recurrentgemma-2b", dev)
    runs = []
    for graph in (True, False):
        eng = ServingEngine(cfg, params, slots=2, max_len=64, device=dev,
                            graph=graph)
        insts = [eng.instances[i] for i in eng.scale_up(2)]
        reqs = [Request(j, _prompt(cfg, 9 + 5 * j, 10 + j), 4 + j)
                for j in range(4)]
        for j, r in enumerate(reqs):
            assert insts[j % 2].admit(r)
        logs = []
        while any(i.n_active() for i in insts):
            for inst in insts:
                if inst.n_active():
                    inst.step()
                    logs.append(inst.decoder.logits.clone())
        runs.append(([r.tokens for r in reqs], logs))
        if graph:
            pool = engine_mod._shared_step(cfg, 2, 64, insts[0].device).pool
            assert [i.decoder.graph.pool() for i in insts] == [pool, pool]
            assert all(i.decoder.replays > 0 for i in insts)
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda_only
def test_evicting_a_graphed_instance_frees_its_graph():
    """An instance that captured its step, released and evicted: the
    memory allocated returns to its level before the instance (a first
    instance, evicted the same way, warms the libraries and the
    function's stream up before the level is read)."""
    import gc
    from repro_torch.serving.engine import Request, ServingEngine
    dev = _card()
    cfg, params = _bf16_smoke("recurrentgemma-2b", dev)
    eng = ServingEngine(cfg, params, slots=2, max_len=64, device=dev)
    levels = []
    for rid in range(2):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        iid = eng.scale_up(1)[0]
        eng.submit(Request(rid, _prompt(cfg, 13, rid), 5))
        eng.drain()
        decoder = eng.instances[iid].decoder
        assert decoder.graph is not None and decoder.replays == 4
        assert torch.cuda.memory_allocated() > before
        assert eng.release(1) == [iid] and eng.evict_cached(1) == 1
        assert decoder.graph is None
        del decoder
        gc.collect()
        torch.cuda.synchronize()
        levels.append((before, torch.cuda.memory_allocated()))
    before, after = levels[1]
    assert after == before, levels


@pytest.mark.cuda_only
def test_a_step_that_waits_on_the_host_raises_at_capture(monkeypatch):
    """A host sync injected into the decode step (a norm that reads a
    value back): the graphed instance's first step raises before its
    capture, captures nothing and raises again on the next step instead
    of falling back to eager; the eager instance takes the same step."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingInstance
    dev = _card()
    cfg, params = _bf16_smoke("recurrentgemma-2b", dev)
    insts = {graph: ServingInstance(cfg, params, slots=2, max_len=64,
                                    device=dev, graph=graph)
             for graph in (True, False)}
    for inst in insts.values():
        assert inst.admit(Request(0, _prompt(cfg, 12, 0), 4))
    orig = model_lib.rmsnorm

    def syncing(params, x, *args, **kw):
        float(x.float().abs().max())
        return orig(params, x, *args, **kw)
    monkeypatch.setattr(model_lib, "rmsnorm", syncing)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="synchronizing"):
            insts[True].step()
        assert insts[True].decoder.graph is None
        assert insts[True].decoder.replays == 0
        assert torch.cuda.get_sync_debug_mode() == 0
    assert insts[False].step() == []
    assert len(insts[False].active[0].tokens) == 2


# ---------------------------------------------------------------------------
# The train step captured in a CUDA graph (``distributed.steps.TrainStep``)
# against the eager step (``graph=False``), bitwise.
# ---------------------------------------------------------------------------

#: smoke models of an attention, a recurrent, an SSM and a MoE
#: architecture, and the training example's f32 softcapped model (its
#: ``--tiny`` config)
GRAPH_TRAIN_MODELS = ("gemma2-2b", "recurrentgemma-2b", "mamba2-2.7b",
                      "deepseek-v2-236b", "train_lm")
GRAPH_SHAPE = (64, 2)       # S, B


def _graph_model(name):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train_lm
    if name == "train_lm":
        return train_lm.config(tiny=True)
    cfg = get_smoke_config(name)
    return cfg.replace(n_layers=2) if name == "mamba2-2.7b" else cfg


def _train_launches() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    return {f.__name__: f.launches for f in (
        flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd,
        ssd_scan, ssd_scan_bwd, kadamw.adamw_update, kadamw.grad_norm)}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _train_run(cfg, graph: bool, steps: int, microbatch: int = 1,
               between=None, held: bool = True):
    """`steps` steps of `cfg` from seed 0 through ``make_train_step`` on
    the card -> (losses, grad norms, the final state, the step, the
    launches counted after each call); ``between(i, state)`` may return a
    new state before step i."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models.steps import make_train_batch
    dev = _card()
    S, B = GRAPH_SHAPE
    shape = InputShape("t", S, B, "train")
    opt = tadamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps)
    fn = make_train_step(cfg, None, shape, opt, microbatch=microbatch,
                         device=dev, graph=graph, held=held).fn
    state = build_state(cfg, opt, 0, dev)
    losses, norms, counts = [], [], [_train_launches()]
    for i in range(steps):
        if between is not None:
            state = between(i, state)
        batch = make_train_batch(cfg, shape, np.random.default_rng(30 + i),
                                 dev)
        state, m = fn(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        counts.append(_train_launches())
    torch.cuda.synchronize()
    return losses, norms, state, fn, counts


def _assert_train_runs_equal(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b), (a, b)
    from repro_torch.distributed.steps import _tensors
    ta, tb = _tensors(got[2]), _tensors(want[2])
    assert len(ta) == len(tb)
    for i, (a, b) in enumerate(zip(ta, tb)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.cuda_only
@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("name", GRAPH_TRAIN_MODELS)
def test_graphed_train_step_equals_eager_train_step(name, microbatch):
    """Four steps through the captured step and four through the eager
    one, each from seed 0 on the same batches: every loss and gradient
    norm, and every parameter, moment and the step count after them,
    bitwise; one capture, three replays.  The first call's warm-up step
    and its capture each count every launch of a step once, and the
    replays count none: launches run = warm-up + captured x replays =
    the eager run's."""
    cfg = _graph_model(name)
    got = _train_run(cfg, True, 4, microbatch)
    want = _train_run(cfg, False, 4, microbatch)
    _assert_train_runs_equal(got, want)
    fn, counts = got[3], got[4]
    assert (fn.captures, fn.replays) == (1, 3)
    assert fn.capture_ms > 0 and fn.pool_bytes >= 0
    per_step = _delta(want[4][1], want[4][0])
    assert _delta(want[4][-1], want[4][0]) == {
        k: 4 * n for k, n in per_step.items()}
    assert _delta(counts[1], counts[0]) == {
        k: 2 * n for k, n in per_step.items()}
    assert counts[-1] == counts[1]
    assert per_step["adamw_update"] > 0 and per_step["grad_norm"] == 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("name", GRAPH_TRAIN_MODELS)
def test_graphed_held_train_step_equals_eager_casts_at_use(name, microbatch):
    """With f32 weights and bf16 compute (the training example in its own
    f32, where nothing is cast): four steps through the captured step
    reading the held bf16 copies, which the AdamW kernel rewrites, and
    four through the eager step that casts at use (``held=False``), from
    seed 0 on the same batches: every loss and gradient norm, every
    parameter, moment and the step count bitwise (the copies left out of
    the comparison); each copy bitwise its master's cast at the end; the
    same launches a step."""
    cfg = _graph_model(name)
    if name != "train_lm":
        cfg = cfg.replace(dtype="bfloat16")
    got = _train_run(cfg, True, 4, microbatch)
    want = _train_run(cfg, False, 4, microbatch, held=False)
    assert ("held" in got[2]) == (name != "train_lm")
    assert "held" not in want[2]
    strip = lambda st: {"params": st["params"], "opt": st["opt"]}
    _assert_train_runs_equal(got[:2] + (strip(got[2]),),
                             want[:2] + (strip(want[2]),))
    for path, p in tadamw.leaves_with_path(got[2]["params"]):
        h = got[2].get("held", {}).get(tadamw.keystr(path))
        if h is not None:
            assert torch.equal(h, p.to(torch.bfloat16)), path
    assert (got[3].captures, got[3].replays) == (1, 3)
    per_step = _delta(want[4][1], want[4][0])
    assert _delta(got[4][1], got[4][0]) == {
        k: 2 * n for k, n in per_step.items()}


@pytest.mark.cuda_only
def test_graphed_train_step_captures_anew_after_a_restore(tmp_path):
    """Two steps, a checkpoint, the state restored into new tensors (as
    ``train_loop``'s resume does) and two more steps through the same
    captured step: it captures anew on the restored state instead of
    replaying on the old one, and the run is bitwise four eager steps."""
    from repro_torch import checkpoint as ckpt_lib
    cfg = _graph_model("recurrentgemma-2b")
    dev = _card()

    def restore(i, state):
        if i != 2:
            return state
        ckpt_lib.save(str(tmp_path), 2, state)
        return ckpt_lib.restore(str(tmp_path), state, dev)[0]

    got = _train_run(cfg, True, 4, between=restore)
    want = _train_run(cfg, False, 4)
    _assert_train_runs_equal(got, want)
    assert (got[3].captures, got[3].replays) == (2, 2)


@pytest.mark.cuda_only
def test_graphed_train_step_keeps_its_scratch_when_the_buffer_grows():
    """After the capture, the capture stream's scratch buffer grows (a
    larger call on that stream) and a tensor filled with 7s takes memory
    on that stream: the graph keeps the buffer it was captured with, so
    its replays write nothing into the new tensor, and the run stays
    bitwise the eager one."""
    from repro_torch.kernels import _scratch
    from repro_torch.serving.engine import _capture_stream
    cfg = _graph_model("mamba2-2.7b")
    _card()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _capture_stream(dev)
    seen = []

    def grow(i, state):
        if i == 2:
            old = _scratch.scratch(dev, stream.cuda_stream, 1)
            with torch.cuda.stream(stream):
                new = _scratch.scratch(dev, stream.cuda_stream,
                                       4 * old.numel() + (1 << 20))
                junk = torch.full((old.numel(),), 7, dtype=torch.uint8,
                                  device=dev)
            torch.cuda.current_stream(dev).wait_stream(stream)
            assert new.data_ptr() != old.data_ptr()
            seen.extend([old, junk])
        return state

    got = _train_run(cfg, True, 4, between=grow)
    want = _train_run(cfg, False, 4)
    _assert_train_runs_equal(got, want)
    old, junk = seen
    assert got[3].replays == 3 and any(b is old for b in got[3]._held)
    assert bool((junk == 7).all())


@pytest.mark.cuda_only
def test_a_train_step_that_waits_on_the_host_raises_at_warm_up(monkeypatch):
    """A host sync injected into the train step (a norm that reads a value
    back): the graphed step's first call raises in its warm-up, captures
    nothing, leaves the sync debug mode as it was and raises again on the
    next call instead of falling back to eager; the eager step takes the
    same steps."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models import model as model_lib
    from repro_torch.models.steps import make_train_batch
    dev = _card()
    cfg = _graph_model("recurrentgemma-2b")
    shape = InputShape("t", 64, 2, "train")
    opt = tadamw.AdamWConfig(total_steps=4, warmup_steps=1)
    orig = model_lib.rmsnorm

    def syncing(params, x, *args, **kw):
        float(x.float().abs().max())
        return orig(params, x, *args, **kw)
    monkeypatch.setattr(model_lib, "rmsnorm", syncing)
    batch = make_train_batch(cfg, shape, np.random.default_rng(0), dev)
    graphed = make_train_step(cfg, None, shape, opt, device=dev).fn
    state = build_state(cfg, opt, 0, dev)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="synchronizing"):
            graphed(state, batch)
        assert graphed.graph is None and graphed.captures == 0
        assert torch.cuda.get_sync_debug_mode() == 0
    eager = make_train_step(cfg, None, shape, opt, device=dev,
                            graph=False).fn
    for _ in range(2):
        state, m = eager(state, batch)
        assert math.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# The train step's AdamW update and gradient norm kernels against their
# plain versions (``optim.adamw._update_leaf`` and ``global_norm``).
# ---------------------------------------------------------------------------

from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

#: p, g and moment dtypes: f32 state, bf16 moments, bf16 state, bf16
#: weights with f32 gradients (a microbatched step's summed gradients),
#: and f16 moments beside f32 and bf16 weights
ADAMW_DTYPES = [(torch.float32, torch.float32, torch.float32),
                (torch.float32, torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32, torch.bfloat16),
                (torch.float32, torch.float32, torch.float16),
                (torch.bfloat16, torch.bfloat16, torch.float16)]
ADAMW_LENGTHS = [1, 7, 4097, (1 << 26) + 3]


def _adamw_leaf(seed, n, dtypes, dev, offsets=(0, 0, 0, 0)):
    """p, g, m, v of `n` elements in `dtypes` on `dev`, each a view at its
    offset into a longer array; v non-negative, as a second moment is."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p_dt, g_dt, m_dt = dtypes
    out = []
    for dt, off, pos in zip((p_dt, g_dt, m_dt, m_dt), offsets,
                            (False, False, False, True)):
        x = torch.randn(n + off, generator=gen, device=dev)
        x = x.abs() * 1e-2 if pos else x
        out.append(x.to(dt)[off:])
    return out


def _adamw_scalars(dev, scale):
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (scale, 3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("scale", [1.0, 0.37], ids=["noclip", "clip"])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES,
                         ids=lambda d: "/".join(str(t)[6:] for t in d))
@pytest.mark.parametrize("n,offsets", [(n, (0, 0, 0, 0))
                                       for n in ADAMW_LENGTHS]
                         + [(4097, (1, 1, 1, 1)), (4097, (1, 2, 1, 1))],
                         ids=lambda x: str(x))
def test_adamw_kernel_is_bitwise_its_plain_version(n, offsets, dtypes, decay,
                                                   scale):
    """One leaf's update through the kernel bitwise ``_update_leaf`` on
    the same inputs, in every dtype pairing, decayed or not, scaled or
    not, at lengths 1, 7, 4,097 and 2^26+3 and on slice views at storage
    offset 1 (the "vector" path: a common aligned element) and at
    offsets that share none (the "scalar" path); two calls bitwise
    equal."""
    dev = _card()
    cfg = tadamw.AdamWConfig(weight_decay=0.1)
    leaf = _adamw_leaf(n, n, dtypes, dev, offsets)
    sc = _adamw_scalars(dev, scale)
    want = [t.clone() for t in leaf]
    tadamw._update_leaf(*want, cfg, *sc, decay)
    got = []
    for _ in range(2):
        p, g, m, v = (t.clone() for t in leaf)
        if offsets != (0, 0, 0, 0):
            # clones are aligned: views at the offsets again
            p, g, m, v = (torch.cat([t.new_zeros(o), t])[o:]
                          for t, o in zip((p, g, m, v), offsets))
        n0 = kadamw.adamw_update.launches
        path = kadamw.adamw_update(p, g, m, v, cfg, *sc, decay)
        torch.cuda.synchronize()
        assert kadamw.adamw_update.launches == n0 + 1
        assert path == ("vector" if n >= 8 and len(set(offsets)) == 1
                        else "scalar")
        got.append((p, m, v))
    for a, b in zip(got[0], (want[0], want[2], want[3])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.cuda_only
@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(7, 0), (4097, 1), ((1 << 26) + 3, 1)],
                         ids=lambda x: str(x))
def test_adamw_kernel_writes_the_held_copy_in_its_launch(n, offset, g_dtype,
                                                          m_dtype):
    """f32 weights with a bf16 held copy, f32 or bf16 gradients, f32,
    bf16 or f16 moments, at lengths with a head and a tail (views at
    storage offset 1: the body from element 7): one launch writes the
    copy bitwise the new weights' ``.to(torch.bfloat16)`` and updates p,
    m and v bitwise as the plain update; the vector path where n >= 8."""
    dev = _card()
    cfg = tadamw.AdamWConfig(weight_decay=0.1)
    dtypes = (torch.float32, g_dtype, m_dtype)
    leaf = _adamw_leaf(n, n, dtypes, dev, (offset,) * 4)
    sc = _adamw_scalars(dev, 0.37)
    want = [t.clone() for t in leaf]
    tadamw._update_leaf(*want, cfg, *sc, True)
    p, g, m, v = (torch.cat([t.new_zeros(offset), t])[offset:]
                  for t in leaf)
    held = torch.zeros(n + offset, dtype=torch.bfloat16,
                       device=dev)[offset:]
    n0 = kadamw.adamw_update.launches
    path = kadamw.adamw_update(p, g, m, v, cfg, *sc, True, held)
    torch.cuda.synchronize()
    assert kadamw.adamw_update.launches == n0 + 1
    assert path == ("vector" if n >= 8 else "scalar")
    for a, b in zip((p, m, v), (want[0], want[2], want[3])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(held, want[0].to(torch.bfloat16))


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_grad_norm_kernel_within_1e6_of_float64_and_bitwise_twice(dtype):
    """The norm of leaves of 1, 7, 4,097 and 2^26+3 elements, a slice
    at storage offset 1 and a permuted view, mixed f32 and `dtype`:
    within 1e-6 relative of the float64 norm, two calls bitwise equal,
    each counted once with one partials launch a leaf; ``grad_sumsq`` of
    two groups, one call counted, their f64 sums within 1e-6 of the
    squared norm."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    leaves = [torch.randn(n, generator=gen, device=dev).to(dtype)
              for n in ADAMW_LENGTHS]
    leaves.append(torch.randn(4098, generator=gen, device=dev)[1:])
    # a permuted leaf, as autograd gives attention's output projection
    leaves.append(torch.randn(16, 80, 33, generator=gen,
                              device=dev).permute(1, 0, 2))
    want = math.sqrt(sum(float(torch.sum(torch.square(x.double())))
                         for x in leaves))
    n0 = kadamw.grad_norm.launches, dict(kadamw.grad_norm.launches_by_path)
    a, b = kadamw.grad_norm(leaves), kadamw.grad_norm(leaves)
    torch.cuda.synchronize()
    assert a.dtype == torch.float32 and a.dim() == 0
    assert torch.equal(a, b)
    assert abs(float(a) - want) <= 1e-6 * want
    assert kadamw.grad_norm.launches == n0[0] + 2
    assert (kadamw.grad_norm.launches_by_path["partials"]
            == n0[1]["partials"] + 2 * len(leaves))
    n0 = kadamw.grad_norm.launches, dict(kadamw.grad_norm.launches_by_path)
    ss = kadamw.grad_sumsq([leaves[:2], leaves[2:]])
    assert ss.dtype == torch.float64 and ss.shape == (2,)
    assert abs(float(ss.sum()) - want * want) <= 1e-6 * want * want
    assert kadamw.grad_norm.launches == n0[0] + 1
    assert kadamw.grad_norm.launches_by_path["sum"] == n0[1]["sum"] + 2


@pytest.mark.cuda_only
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_update_on_the_smoke_tree_is_bitwise_the_plain_update(state):
    """Three AdamW steps on the recurrentgemma smoke model's tree (f32
    state, or bf16 weights, gradients and moments) with random gradients:
    ``update_with_norm`` through the kernels bitwise the plain update
    given the plain norm, one launch a leaf and none of the norm's; the
    whole ``update`` launching the norm once a step, its norm within 1e-6
    of the plain one; ``use_kernel=False`` launching neither."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    dev = _card()
    dt = getattr(torch, state)
    cfg = get_smoke_config("recurrentgemma-2b")
    ocfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                              moment_dtype=state)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, param_dtype=dt)
    n_leaves = len(tadamw.leaves_with_path(params))
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [tadamw._map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=dev).to(p.dtype),
                         params) for _ in range(3)]
    copy = lambda tree: tadamw._map(torch.clone, tree)
    pk, pp = copy(params), copy(params)
    sk, sp = tadamw.init(pk, ocfg), tadamw.init(pp, ocfg)
    for g in grads:
        gnorm = tadamw.global_norm(g)
        n0 = kadamw.adamw_update.launches, kadamw.grad_norm.launches
        pk, sk, _ = tadamw.update_with_norm(pk, g, sk, ocfg, gnorm, True)
        assert (kadamw.adamw_update.launches - n0[0],
                kadamw.grad_norm.launches - n0[1]) == (n_leaves, 0)
        n0 = kadamw.adamw_update.launches, kadamw.grad_norm.launches
        pp, sp, _ = tadamw.update_with_norm(pp, g, sp, ocfg, gnorm, False)
        assert (kadamw.adamw_update.launches,
                kadamw.grad_norm.launches) == n0
    torch.cuda.synchronize()
    for (path, a), (_, b) in zip(
            tadamw.leaves_with_path((pk, sk.m, sk.v)),
            tadamw.leaves_with_path((pp, sp.m, sp.v))):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    n0 = kadamw.adamw_update.launches, kadamw.grad_norm.launches
    _, _, met = tadamw.update(pk, grads[0], sk, ocfg)
    plain = tadamw.global_norm(grads[0])
    assert (kadamw.adamw_update.launches - n0[0],
            kadamw.grad_norm.launches - n0[1]) == (n_leaves, 1)
    assert abs(float(met["grad_norm"]) - float(plain)) <= 1e-6 * float(plain)


@pytest.mark.cuda_only
def test_update_with_float16_moments_is_bitwise_the_plain_update():
    """``AdamWConfig(moment_dtype="float16")`` on the card: ``init`` makes
    f16 moments, and three steps of the f32 smoke tree through the kernels
    are bitwise the plain update (f16 stored round-to-nearest-even, as
    ``copy_`` stores it), one launch a leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    dev = _card()
    cfg = get_smoke_config("recurrentgemma-2b")
    ocfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                              moment_dtype="float16")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_leaves = len(tadamw.leaves_with_path(params))
    gen = torch.Generator(device=dev).manual_seed(2)
    copy = lambda tree: tadamw._map(torch.clone, tree)
    pk, pp = copy(params), copy(params)
    sk, sp = tadamw.init(pk, ocfg), tadamw.init(pp, ocfg)
    assert all(m.dtype == torch.float16
               for _, m in tadamw.leaves_with_path((sk.m, sk.v)))
    for _ in range(3):
        g = tadamw._map(lambda p: torch.randn(p.shape, generator=gen,
                                              device=dev), params)
        gnorm = tadamw.global_norm(g)
        n0 = kadamw.adamw_update.launches
        pk, sk, _ = tadamw.update_with_norm(pk, g, sk, ocfg, gnorm, True)
        assert kadamw.adamw_update.launches - n0 == n_leaves
        pp, sp, _ = tadamw.update_with_norm(pp, g, sp, ocfg, gnorm, False)
    torch.cuda.synchronize()
    for (path, a), (_, b) in zip(
            tadamw.leaves_with_path((pk, sk.m, sk.v)),
            tadamw.leaves_with_path((pp, sp.m, sp.v))):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.cuda_only
def test_train_step_launches_the_update_kernels_and_plain_none():
    """The smoke model's train step through ``make_train_step`` on the
    card launches the norm once and the update once a leaf a step; with
    ``use_kernel=False`` neither, its losses within 1e-4 of the
    kernels'."""
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models.steps import make_train_batch
    dev = _card()
    cfg = get_smoke_config("recurrentgemma-2b")
    shape = InputShape("t", 64, 2, "train")
    opt = tadamw.AdamWConfig(total_steps=4, warmup_steps=1)
    losses = {}
    for use_kernel in (True, False):
        bundle = make_train_step(cfg, None, shape, opt, device=dev,
                                 use_kernel=use_kernel)
        state = build_state(cfg, opt, 0, dev)
        n_leaves = len(tadamw.leaves_with_path(state["params"]))
        n0 = kadamw.adamw_update.launches, kadamw.grad_norm.launches
        losses[use_kernel] = []
        for i in range(2):
            batch = make_train_batch(cfg, shape, np.random.default_rng(i),
                                     dev)
            state, met = bundle.fn(state, batch)
            losses[use_kernel].append(float(met["loss"]))
        want = (2 * n_leaves, 2) if use_kernel else (0, 0)
        assert (kadamw.adamw_update.launches - n0[0],
                kadamw.grad_norm.launches - n0[1]) == want
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)
