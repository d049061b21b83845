"""The port's gradient compression (``repro_torch.distributed.
compression``) against the JAX package's: ``quantize``, ``dequantize``,
``ef_quantize`` and ``compress_grads_tree`` bitwise on seeded numpy
gradients (ties at .5 included: both round half to even), and
``compressed_psum`` over 4 gloo ranks (spawned; a FileStore under
``tmp_path``) against the numpy formula: the int8 payloads summed as
int32, the scales averaged, in f32.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc

JOIN_S = 120
SHAPES = [(7,), (64, 33), (3, 5, 129), (1000,)]


def _grads(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ties() -> np.ndarray:
    """max |g| 127, so the scale is 1 and every g / scale is g itself:
    halves that round to even both ways, and the clip's edges."""
    return np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                     126.5, -126.5, 0.0, 0.49999997, 64.5], np.float32)


CASES = ([("normal", s, i) for i, s in enumerate(SHAPES)]
         + [("tiny", (16, 16), 7), ("zeros", (9,), 0), ("ties", None, 0)])


def _case(kind: str, shape, seed: int) -> np.ndarray:
    if kind == "ties":
        return _ties()
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    return _grads(seed, shape, 1e-6 if kind == "tiny" else 1.0)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("kind,shape,seed", CASES)
def test_quantize_bitwise_reference(kind, shape, seed):
    g = _case(kind, shape, seed)
    qj, sj = jc.quantize(jnp.asarray(g))
    qt, st = tc.quantize(torch.from_numpy(g))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert _bits(st.numpy()) == _bits(np.asarray(sj))
    np.testing.assert_array_equal(
        _bits(tc.dequantize(qt, st).numpy()),
        _bits(jc.dequantize(qj, sj)))
    if kind == "ties":
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        np.testing.assert_array_equal(
            qt.numpy(), [127, -127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0, 0,
                         64])


@pytest.mark.parametrize("seed", range(3))
def test_quantize_scale_is_ieee_division(seed):
    """The scale is numpy's float32 max / 127, an IEEE division, over 300
    magnitudes from 1e-8 to 1e2 (what the bitwise-JAX cases take JAX's
    CPU code to give)."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        g = _grads(int(rng.integers(1 << 30)), (33,),
                   float(10.0 ** rng.uniform(-8, 2)))
        _, st = tc.quantize(torch.from_numpy(g))
        want = np.float32(np.abs(g).max()) / np.float32(127.0)
        assert _bits(st.numpy()) == _bits(want)


@pytest.mark.parametrize("kind,shape,seed", CASES)
def test_ef_quantize_bitwise_reference(kind, shape, seed):
    g = _case(kind, shape, seed)
    err = _grads(seed + 100, g.shape, 1e-3)
    qj, sj, ej = jc.ef_quantize(jnp.asarray(g), jnp.asarray(err))
    qt, st, et = tc.ef_quantize(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert _bits(st.numpy()) == _bits(np.asarray(sj))
    np.testing.assert_array_equal(_bits(et.numpy()), _bits(ej))


def test_ef_quantize_bf16_gradient_bitwise_reference():
    g = _grads(3, (40, 17))
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    err = np.zeros(g.shape, np.float32)
    qj, sj, ej = jc.ef_quantize(gj, jnp.asarray(err))
    qt, st, et = tc.ef_quantize(gt, torch.from_numpy(err))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(et.numpy()), _bits(ej))


def test_compress_grads_tree_bitwise_reference():
    tree = {"a": _grads(1, (8, 9)), "b": [_grads(2, (5,)), _grads(3, (2, 3))]}
    err = {"a": _grads(4, (8, 9), 1e-2),
           "b": [_grads(5, (5,), 1e-2), _grads(6, (2, 3), 1e-2)]}
    to_j = lambda t: {"a": jnp.asarray(t["a"]),
                      "b": [jnp.asarray(x) for x in t["b"]]}
    to_t = lambda t: {"a": torch.from_numpy(t["a"]),
                      "b": [torch.from_numpy(x) for x in t["b"]]}
    gj, ej = jc.compress_grads_tree(to_j(tree), to_j(err))
    gt, et = tc.compress_grads_tree(to_t(tree), to_t(err))
    for a, b in ((gt["a"], gj["a"]), (et["a"], ej["a"])):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    for x, y in zip(gt["b"] + et["b"], gj["b"] + ej["b"]):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
    zeros = tc.init_error_state(to_t(tree))
    assert zeros["b"][1].shape == (2, 3) and not zeros["a"].any()


def _psum_worker(rank: int, world: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        g = torch.from_numpy(_grads(10 + rank, (257,), 1.0 + rank))
        err = torch.from_numpy(_grads(20 + rank, (257,), 1e-2))
        mean, new_err = tc.compressed_psum(g, None, err)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        mean_m, _ = tc.compressed_psum(g, (mesh, "data"), err)
        res = {"mean": mean.numpy().tolist(),
               "err": new_err.numpy().tolist(),
               "mean_data": mean_m.numpy().tolist(),
               "data_group": [int(r) for r in dist.get_process_group_ranks(
                   mesh.get_group("data"))]}
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _numpy_psum(ranks):
    """The reference's order of operations in numpy f32."""
    qs, ss = [], []
    for r in ranks:
        target = _grads(10 + r, (257,), 1.0 + r) + _grads(20 + r, (257,),
                                                          1e-2)
        scale = np.float32(max(np.abs(target).max(), 1e-30)) / \
            np.float32(127.0)
        q = np.clip(np.round(target / scale), -127, 127).astype(np.int8)
        qs.append(q.astype(np.int32))
        ss.append(np.float32(scale))
    n = np.float32(len(ranks))
    mean_scale = np.float32(np.sum(np.array(ss, np.float32),
                                   dtype=np.float32)) / n
    return (np.sum(qs, axis=0).astype(np.float32) * mean_scale / n)


def test_compressed_psum_over_four_gloo_ranks(tmp_path):
    import time
    world = 4
    out = os.path.join(tmp_path, "psum")
    ctx = mp.spawn(_psum_worker, args=(world, os.path.join(tmp_path, "st"),
                                       out), nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            assert time.monotonic() < deadline, "no result in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [json.load(open(f"{out}.{r}")) for r in range(world)]
    want = _numpy_psum(range(world))
    for r in range(world):
        got = np.asarray(res[r]["mean"], np.float32)
        # the scales' sum may add in another order than numpy's: one ulp
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
        assert np.array_equal(got, np.asarray(res[0]["mean"], np.float32))
        g = torch.from_numpy(_grads(10 + r, (257,), 1.0 + r))
        err = torch.from_numpy(_grads(20 + r, (257,), 1e-2))
        _, _, ne = tc.ef_quantize(g, err)
        np.testing.assert_array_equal(
            _bits(np.asarray(res[r]["err"], np.float32)), _bits(ne.numpy()))
        group = res[r]["data_group"]
        np.testing.assert_allclose(np.asarray(res[r]["mean_data"]),
                                   _numpy_psum(group), rtol=2e-7, atol=0)
