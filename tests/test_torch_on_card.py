"""The hand-written kernels and the slice on the card, against their
plain versions and the numpy host oracle.

This file imports neither jax nor the JAX package, so it runs where the
card is: ``PYTHONPATH=src python -m pytest -q tests/test_torch_on_card.py``.
The ``cuda_only`` tests skip themselves without a card.  Tolerances:
1e-6 on predictions against the plain version (an f32 mean of at most
200 leaves; both sum in numpy's pairwise order, so the difference is 0
unless the compiler reorders), exact against the numpy oracle and on
capacities."""
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
    f32 without a softcap the 3xTF32 one, its kv range split here: the
    grids are small), D = 32 and f32 with a softcap the CUDA-core kernel;
    the launch counts show which ran."""
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
    if D in (64, 128, 256) and dtype == torch.bfloat16:
        ran = "wgmma"
    elif D in (64, 128, 256) and not softcap:
        ran = "tf32"
    else:
        ran = "simt"
    by_path[ran] += 1
    assert flash_attention.launches_by_path == by_path
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATTN_TOL[dtype]
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


@pytest.mark.cuda_only
@pytest.mark.parametrize("kind,window", [("local", 4096), ("global", 0)])
@pytest.mark.parametrize("S", [333, 3000, 4500])
def test_flash_kernel_gemma2_shape_with_softcap(S, kind, window):
    """gemma2-2b's layers: 8 query heads over 4 kv heads (G 2), head dim
    256, a tanh softcap of 50 (scores scaled by 16 so that it bites),
    local attention in a window of 4,096 alternating with global; bf16 on
    the wgmma kernel against its plain version at phase 4's bf16
    tolerance.  S = 4,500 is past the window."""
    from repro_torch.kernels.flash_attention import path
    dev = _card()
    q, k, v = _qkv(S + len(kind), 1, S, 8, 4, 256, torch.bfloat16, dev,
                   scale=4.0)
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
    """bf16 at P = 64, N = 128 runs the tensor-core kernel, everything
    else the CUDA-core kernel; the launch counts show which ran."""
    dev = _card()
    x, dA, dt, Bm, Cm, h0 = _ssd_case(S + N, B, H, G, S, P, N, dtype,
                                      with_h0, dev)
    n0 = ssd_scan.launches
    by_path = dict(ssd_scan.launches_by_path)
    y, h = ssd_scan(x, dA, dt, Bm, Cm, h0)
    yp, hp = ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1
    ran = ("wgmma" if dtype == torch.bfloat16 and (P, N) == (64, 128)
           else "simt")
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
# "wgmma"), f32 there without a softcap on the 3xTF32 one ("tf32"), both
# reading the forward kernel's lse; other head dims and f32 with a
# softcap on the first kernel ("simt").  The forward's lse against the
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
    on its path: D = 16 and f32 with a softcap on the first kernel, bf16
    at D = 64, 128, 256 on the wgmma one and f32 there on the 3xTF32 one,
    both reading the forward's lse."""
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
    one (both reading the forward's lse) and f32 with a softcap on the
    CUDA-core one, each within BWD_TOL of the plain version; dq (BH, S,
    192), dk (BH / G, S, 192), dv (BH / G, S, 128); the tensor-core
    backwards bitwise the same over two calls."""
    dev = _card()
    if dtype == torch.bfloat16:
        want_path = "wgmma"
    else:
        want_path = "simt" if kw.get("softcap") else "tf32"
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


def _simt_mla(q, k, v, do, kw):
    """The CUDA-core forward and backward (``csrc/flash_attention.cu``,
    ``csrc/flash_attention_bwd.cu``) called directly at f32, where the
    wrapper takes the 3xTF32 kernels: (o, (dq, dk, dv))."""
    from repro_torch.kernels import _build, _scratch
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    dv = v.shape[2]
    group = bh // k.shape[0]
    mask = (int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
            int(kw.get("window", 0)), float(kw.get("softcap", 0.0)))
    stream = _scratch.current_stream(q.device)
    o = q.new_empty((bh, s, dv))
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d, dv,
        group, 0, *mask, stream)
    _build.check_launch(err, "flash_attention (simt, direct)")
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, bh, s), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        *(g.data_ptr() for g in grads), stats[0].data_ptr(),
        stats[1].data_ptr(), bh, s, d, dv, group, 0, *mask, stream)
    _build.check_launch(err, "flash_attention_bwd (simt, direct)")
    return o, grads


@pytest.mark.cuda_only
@pytest.mark.parametrize("kw", BWD_MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("S,BH,G", [(37, 4, 1), (333, 8, 2)])
def test_cuda_core_kernels_held_at_f32_mla_head_dims(S, BH, G, kw):
    """The CUDA-core forward and backward, which the wrapper now keeps at
    f32 (192, 128) only with a softcap, called directly at every mask:
    the output within ATTN_TOL and each gradient within BWD_TOL of the
    plain versions, and no wrapper launch counted."""
    dev = _card()
    q, k, v = _mla_qkv(S + BH + 7, BH, G, S, torch.float32, dev)
    do = _mla_qkv(S + BH + 8, BH, 1, S, torch.float32, dev)[2]
    n0 = flash_attention.launches, flash_attention_bwd.launches
    o, grads = _simt_mla(q, k, v, do, kw)
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


@pytest.mark.cuda_only
def test_flash_lse_refused_off_the_wgmma_path_and_required_on_it():
    """The wgmma and tf32 backwards without the forward's lse raise
    (nothing falls back); the CUDA-core forward (head dim 16, or f32
    with a softcap), which writes no lse, refuses to return one; the
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
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, return_lse=True, softcap=5.0, **kw)
    q, k, v, o, do, lse = _bwd_case(1, 4, 2, 100, 16, torch.float32, dev,
                                    kw)
    assert lse is None
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, return_lse=True, **kw)
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
    call, on the path ``bwd_path`` names: bf16 at P 64, N 128 the
    tensor-core kernel, the rest the CUDA-core one."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(S + N, B, H, G, S, P, N, dtype, with_h0,
                                 with_dh, dev)
    n0 = ssd_scan_bwd.launches
    by_path = dict(ssd_scan_bwd.launches_by_path)
    got = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == n0 + 1
    ran = ("wgmma" if dtype == torch.bfloat16 and (P, N) == (64, 128)
           else "simt")
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
    tensor-core kernel, f32 on the CUDA-core one."""
    dev = _card()
    args, dy, dh = _ssd_bwd_case(5, 1, 80, 1, 3001, 64, 128, dtype, True,
                                 True, dev)
    by_path = dict(ssd_scan_bwd.launches_by_path)
    first = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    second = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    ran = "wgmma" if dtype == torch.bfloat16 else "simt"
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
    mesh (a FileStore under tmp_path) against the one-device step on the
    same seed and batches: losses within 1e-5 relative over three steps,
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
            bundle = make_train_step(cfg, m, shape, opt, device=dev)
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
