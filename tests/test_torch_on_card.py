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


def _qkv(seed, B, S, Hq, Hkv, D, dtype, device, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda h: torch.from_numpy(
        (rng.standard_normal((B, S, h, D)) * scale).astype(np.float32)
    ).to(device=device, dtype=dtype)
    return mk(Hq), mk(Hkv), mk(Hkv)


def test_lm_wrappers_on_cpu_launch_nothing():
    q, k, v = _qkv(0, 1, 40, 4, 2, 16, torch.float32, "cpu")
    a = torch.rand(2, 30, 8)
    n0 = flash_attention.launches, rglru_scan.launches
    ops.attention_op(q, k, v, kind="local", window=8)
    ops.rglru_op(a, torch.randn(2, 30, 8), torch.randn(2, 8))
    assert (flash_attention.launches, rglru_scan.launches) == n0


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,window,causal,softcap", [
    ("global", 0, True, 0.0), ("local", 32, True, 0.0),
    ("chunked", 32, True, 0.0), ("global", 0, True, 20.0),
    ("global", 0, False, 0.0), ("local", 48, False, 0.0)])
@pytest.mark.parametrize("S", [64, 100, 257])
def test_flash_kernel_matches_plain(S, kind, window, causal, softcap,
                                    dtype):
    dev = _card()
    q, k, v = _qkv(S, 2, S, 4, 2, 32, dtype, dev,
                   scale=4.0 if softcap else 1.0)
    kw = dict(causal=causal, kind=kind, window=window, softcap=softcap)
    n0 = flash_attention.launches
    got = ops.attention_op(q, k, v, **kw)
    plain = ops.attention_op(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1000, 2048])
def test_flash_kernel_serving_shape(S, dtype):
    """recurrentgemma's local layers: MQA 10:1, head dim 256, window
    2,048."""
    dev = _card()
    q, k, v = _qkv(7, 1, S, 10, 1, 256, dtype, dev)
    kw = dict(causal=True, kind="local", window=2048)
    got = ops.attention_op(q, k, v, **kw)
    plain = ops.attention_op(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), atol=tol,
                               rtol=tol)


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
