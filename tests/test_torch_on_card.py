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
