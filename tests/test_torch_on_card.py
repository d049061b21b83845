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
