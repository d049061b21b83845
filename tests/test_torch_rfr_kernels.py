"""The port's forest kernels against the JAX package's.

On the CPU the port's wrappers compute with their plain PyTorch
versions; those are held here against the Pallas kernels in interpret
mode and against the reference's scalar-loop oracles on the same numpy
inputs.  Tolerances: 1e-6 on predictions (an f32 mean of at most 16
leaves, summed in numpy's pairwise order by the port and in XLA's order
by the reference), exact on capacities and on the port's own numpy-order
oracle.  The hand-written kernels themselves are held against these
plain versions on the card by ``test_torch_on_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rfr_inference import rfr_capacity_sweep as j_sweep
from repro.kernels.rfr_inference import rfr_forest_apply as j_apply
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rfr_inference import (FOREST_SMEM_BYTES,
                                               forest_path,
                                               packed_forest_bytes,
                                               rfr_capacity_sweep,
                                               rfr_forest_apply)

PRED_TOL = 1e-6


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
    """The numpy host oracle's descent (``_predict_numpy``): what the
    port's predictions must equal bitwise."""
    T, NN = feat.shape
    depth = (NN + 1).bit_length() - 1
    N = x.shape[0]
    idx = np.zeros((N, T), np.int64)
    t_ids = np.arange(T)[None, :]
    for _ in range(depth):
        go = x[np.arange(N)[:, None], feat[t_ids, idx]] >= thr[t_ids, idx]
        idx = 2 * idx + 1 + go
    return leaf[t_ids, idx - NN].mean(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# rfr_forest_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,T,depth,F", [(32, 4, 3, 8), (100, 16, 6, 31),
                                         (57, 9, 5, 12)])
def test_rfr_forest_matches_reference(N, T, depth, F):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, F)).astype(np.float32)
    feat, thr, leaf = _forest(rng, T, depth, F)
    got = rfr_forest_apply(*_t(x, feat, thr, leaf)).numpy()
    want_pallas = np.asarray(j_apply(jnp.asarray(x), jnp.asarray(feat),
                                     jnp.asarray(thr), jnp.asarray(leaf),
                                     interpret=True))
    want_ref = np.asarray(jref.rfr_forest_ref(x, feat, thr, leaf))
    assert got.dtype == np.float32 and got.shape == (N,)
    np.testing.assert_allclose(got, want_pallas, atol=PRED_TOL, rtol=PRED_TOL)
    np.testing.assert_allclose(got, want_ref, atol=PRED_TOL, rtol=PRED_TOL)
    np.testing.assert_array_equal(got, _numpy_mean_predict(x, feat, thr,
                                                           leaf))


def test_rfr_forest_apply_empty_batch():
    """N == 0 (a drain with nothing to solve) returns (0,) f32."""
    rng = np.random.default_rng(3)
    feat, thr, leaf = _forest(rng, 4, 3, 8)
    out = rfr_forest_apply(torch.zeros((0, 8)), *_t(feat, thr, leaf))
    want = j_apply(jnp.zeros((0, 8), jnp.float32), jnp.asarray(feat),
                   jnp.asarray(thr), jnp.asarray(leaf), interpret=True)
    assert out.shape == (0,) == want.shape
    assert out.dtype == torch.float32


@pytest.mark.parametrize("N,block_n", [(3, 256), (100, 32), (64, 64)])
def test_rfr_forest_apply_partial_blocks(N, block_n):
    """Batches below and across the reference's block size: the port has
    no blocks, and agrees with every blocking of the reference."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, 10)).astype(np.float32)
    feat, thr, leaf = _forest(rng, 6, 4, 10)
    got = rfr_forest_apply(*_t(x, feat, thr, leaf)).numpy()
    want = np.asarray(j_apply(jnp.asarray(x), jnp.asarray(feat),
                              jnp.asarray(thr), jnp.asarray(leaf),
                              block_n=block_n, interpret=True))
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, atol=PRED_TOL, rtol=PRED_TOL)


@pytest.mark.parametrize("T,depth,want", [(24, 8, "shared"),
                                          (64, 8, "shared"),
                                          (64, 10, "global")])
def test_forest_path_depends_on_forest_bytes_alone(T, depth, want):
    """The forest kernel stages the packed forest (an 8-byte node per
    split, a 4-byte leaf) in shared memory up to FOREST_SMEM_BYTES and
    reads a larger one from device memory; the choice takes the tree
    count and depth, nothing of the rows.  The control plane's 24 trees
    of depth 8 and 64 trees of depth 8 (196,096 bytes) go to shared
    memory, 64 trees of depth 10 (785,920 bytes) do not."""
    nn = (1 << depth) - 1
    assert packed_forest_bytes(T, depth) == T * (8 * nn + 4 * (nn + 1))
    assert forest_path(T, depth) == want
    assert (want == "shared") == (packed_forest_bytes(T, depth)
                                  <= FOREST_SMEM_BYTES)


@pytest.mark.parametrize("T", [1, 7, 8, 24, 33, 130, 300])
def test_pairwise_tree_mean_is_numpy_bitwise(T):
    """The tree mean is numpy's ``mean(axis=1)`` bit for bit, for tree
    counts below, at and above the pairwise block sizes."""
    rng = np.random.default_rng(T)
    vals = (rng.standard_normal((40, T))
            * rng.uniform(0.1, 100.0, (40, 1))).astype(np.float32)
    got = (ref.pairwise_sum(torch.from_numpy(vals)) / T).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  vals.mean(axis=1).view(np.int32))


def _lane_block_sum(vals: np.ndarray) -> np.ndarray:
    """The kernels' sum of at most 128 trees by a row's eight lanes,
    emulated in f32 numpy: lane j keeps a partial sum over trees
    j, j+8, j+16, ... below n - n % 8 (0 where there are none, as for
    n < 8); an xor butterfly at offsets 1, 2, 4 adds each lane's partner
    (lane j takes r[j] + r[j ^ off]); the n % 8 tail trees are then added
    in order."""
    n = vals.shape[1]
    stop = n - n % 8
    r = np.zeros((vals.shape[0], 8), np.float32)
    if stop:
        r = vals[:, :8].copy()
        for t in range(8, stop, 8):
            r = r + vals[:, t:t + 8]
    for off in (1, 2, 4):
        r = r + r[:, np.arange(8) ^ off]
    # every lane holds the same bits: IEEE addition commutes
    assert (r.view(np.int32) == r[:, :1].view(np.int32)).all()
    res = r[:, 0]
    for t in range(stop, n):
        res = res + vals[:, t]
    return res


def _lane_pairwise_sum(vals: np.ndarray) -> np.ndarray:
    """Above 128 trees the lanes follow numpy's split at a multiple of 8
    and sum each block as ``_lane_block_sum``."""
    n = vals.shape[1]
    if n <= 128:
        return _lane_block_sum(vals)
    n2 = n // 2
    n2 -= n2 % 8
    return _lane_pairwise_sum(vals[:, :n2]) + _lane_pairwise_sum(vals[:, n2:])


def _lane_split_mean(vals: np.ndarray) -> np.ndarray:
    """The tree mean of both kernels (the forest kernel and the capacity
    sweep), emulated in f32 numpy."""
    return _lane_pairwise_sum(vals) / np.float32(vals.shape[1])


@pytest.mark.parametrize("T", [1, 5, 7, 8, 24, 33, 128, 130, 300])
def test_lane_split_tree_mean_is_numpy_bitwise(T):
    """The kernels' eight-lane order is numpy's pairwise order at every
    T: lane j's strided sum is numpy's partial sum r[j], and the
    butterfly forms ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)); below 8 trees the
    partial sums are 0 and the trees are added in order, and above 128
    the lanes sum each of numpy's pairwise blocks.  So the tree mean
    equals ``ref.pairwise_sum`` and numpy's ``mean(axis=1)`` bit for
    bit."""
    rng = np.random.default_rng(100 + T)
    vals = (rng.standard_normal((60, T))
            * rng.uniform(0.1, 100.0, (60, 1))).astype(np.float32)
    got = _lane_split_mean(vals)
    assert got.dtype == np.float32
    want = (ref.pairwise_sum(torch.from_numpy(vals)) / T).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  vals.mean(axis=1).view(np.int32))


def test_rfr_forest_rejects_bad_inputs():
    rng = np.random.default_rng(5)
    feat, thr, leaf = _forest(rng, 3, 3, 4)
    x = torch.zeros((5, 4))
    with pytest.raises(TypeError):
        rfr_forest_apply(x.double(), *_t(feat, thr, leaf))
    with pytest.raises(ValueError):
        rfr_forest_apply(x, *_t(feat[:, :6], thr[:, :6], leaf))
    with pytest.raises(ValueError):
        rfr_forest_apply(x.t(), *_t(feat, thr, leaf))


# ---------------------------------------------------------------------------
# rfr_capacity_sweep
# ---------------------------------------------------------------------------


def _sweep_case(seed, S=7, M=6, R=3, T=8, depth=4, F=9):
    """A padded scenario tensor exercising both padding encodings:
    +inf bounds (R padding rows, always pass) and -inf bounds (m beyond
    a scenario's own m_max, always fail)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, R, F)).astype(np.float32)
    feat, thr, leaf = _forest(rng, T, depth, F)
    bounds = rng.uniform(-0.6, 0.6, (S, M, R)).astype(np.float32)
    for s in range(S):
        r_real = int(rng.integers(1, R + 1))
        m_real = int(rng.integers(0, M + 1))
        bounds[s, :, r_real:] = np.inf
        bounds[s, m_real:, :] = -np.inf
    return x, bounds, feat, thr, leaf


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("log_target", [False, True])
def test_rfr_capacity_sweep_matches_reference(use_kernel, log_target):
    case = _sweep_case(5)
    got = ops.rfr_sweep_op(*_t(*case), use_kernel=use_kernel,
                           log_target=log_target)
    jargs = [jnp.asarray(a) for a in case]
    for use_pallas in (True, False):
        want = jops.rfr_sweep_op(*jargs, use_pallas=use_pallas,
                                 interpret=True, log_target=log_target)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jref.rfr_capacity_sweep_ref(*case, log_target=log_target)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rfr_capacity_sweep_m_above_warp():
    """M = 40 > 32 concurrencies per scenario, as with heterogeneous
    m_max: the longest passing prefix is not one warp's ballot."""
    case = _sweep_case(9, S=5, M=40, R=2)
    got = rfr_capacity_sweep(*_t(*case)).numpy()
    want = np.asarray(jref.rfr_capacity_sweep_ref(*case))
    np.testing.assert_array_equal(got, want)


def test_rfr_capacity_sweep_block_partitioning():
    """Capacities do not depend on how scenarios are split: every
    scenario-block size of the reference, and the port on every split
    of the scenario axis, give one answer."""
    x, bounds, feat, thr, leaf = _sweep_case(6, S=11)
    want = np.asarray(jref.rfr_capacity_sweep_ref(x, bounds, feat, thr,
                                                  leaf))
    fo = _t(feat, thr, leaf)
    for bs in (1, 3, 11, 64):
        got = j_sweep(jnp.asarray(x), jnp.asarray(bounds),
                      jnp.asarray(feat), jnp.asarray(thr),
                      jnp.asarray(leaf), block_s=bs, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), want)
        parts = [rfr_capacity_sweep(*_t(x[i:i + bs], bounds[i:i + bs]),
                                    *fo).numpy()
                 for i in range(0, len(x), bs)]
        np.testing.assert_array_equal(np.concatenate(parts), want)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_rfr_capacity_sweep_degenerate_shapes(use_kernel):
    rng = np.random.default_rng(7)
    fo = _t(*_forest(rng, 4, 3, 6))
    for S, M, R in [(0, 4, 2), (3, 0, 2), (3, 4, 0)]:
        out = ops.rfr_sweep_op(torch.zeros((S, M, R, 6)),
                               torch.zeros((S, M, R)), *fo,
                               use_kernel=use_kernel)
        assert out.shape == (S,)
        assert out.dtype == torch.int32
        assert not out.any()
