"""The AdamW update and gradient norm kernels' slice on the CPU: the
entry points of ``csrc/adamw.cu`` against their ctypes signatures, the
wrappers' CPU path (the plain versions, nothing launched), the update
with ``use_kernel`` on and off bitwise the eager update it was before the
kernels, against ``repro.optim.adamw.update``, the host-side split of a
leaf into its aligned body and the scalar head and tail, and the mesh
norm's grouping of DTensor leaves over two gloo ranks.

Tolerances: bitwise where the port is held to its own plain versions
(the same eager ops); 1e-6 against the reference's update (the same f32
arithmetic in the same order) and between a norm's f32 and f64 sums.
The kernels themselves run only on the card: their tests are in
``test_torch_on_card.py``.
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.optim import adamw as jadamw
from repro_torch.kernels import _build
from repro_torch.kernels import adamw as kadamw
from repro_torch.optim import adamw as tadamw

JOIN_S = 120


def _tree(rng, dtype):
    """A nested tree whose names cover the decay rule (decayed "w_q",
    "w1", "table"; undecayed "scale", "bias1", "A_log", "D") and lengths
    1, 7 and a few hundred."""
    def a(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return {"w_q": a(4, 3), "norm": {"scale": a(7)},
            "layers": [{"bias1": a(5), "w1": a(33, 9), "D": a(1)},
                       {"a_param": a(4), "conv_w": a(2, 4)}],
            "A_log": a(3), "table": a(64, 5)}


def _like(rng, tree, dtype=None, gain=1.0):
    """Normal draws from `rng` in the shapes of `tree`'s leaves, in
    `dtype` (each leaf's own where None)."""
    return _map(lambda t: torch.from_numpy(gain * rng.standard_normal(
        t.shape).astype(np.float32)).to(dtype or t.dtype), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _eager_update(params, grads, state, cfg):
    """The update as it stood before the kernels: ``global_norm``, then
    ``_update_leaf`` on every leaf in order."""
    gnorm = tadamw.global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.clip_norm > 0 else torch.ones(()))
    step = state.step + 1
    lr = tadamw.schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c, b2c = 1 - torch.pow(cfg.b1, sf), 1 - torch.pow(cfg.b2, sf)
    leaves = [tadamw.leaves_with_path(t) for t in
              (params, grads, state.m, state.v)]
    for (path, p), (_, g), (_, m), (_, v) in zip(*leaves):
        tadamw._update_leaf(p, g, m, v, cfg, scale, lr, b1c, b2c,
                            tadamw._decayable(path))
    return gnorm, lr, tadamw.OptState(state.m, state.v, step)


def _counts():
    return (kadamw.adamw_update.launches,
            dict(kadamw.adamw_update.launches_by_path),
            kadamw.grad_norm.launches, dict(kadamw.grad_norm.launches_by_path))


def test_every_entry_point_has_its_signature():
    """Every ``extern "C"`` function of ``csrc/adamw.cu`` has its row in
    ``_build.SIGNATURES["adamw"]`` with as many arguments, and no row
    names a function the source lacks."""
    assert _build.SOURCES["adamw"] == "adamw.cu"
    src = (_build.CSRC / "adamw.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^(?:int|long long) (\w+)\(([^)]*)\)\s*\{", body,
                         re.M):
        args = [a for a in m.group(2).split(",") if a.strip()]
        found[m.group(1)] = len(args)
    sigs = _build.SIGNATURES["adamw"]
    assert set(found) == set(sigs)
    for name, (argtypes, _restype) in sigs.items():
        assert len(argtypes) == found[name], name


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_on_cpu_is_the_eager_update(dtype, moments, clip):
    """Five steps of ``update`` on CPU tensors, with the kernels asked
    for: the parameters, both moments and the metrics bitwise the eager
    update's (``global_norm`` and ``_update_leaf``, which the CPU path
    takes), decayed and undecayed leaves alike, and nothing launched."""
    rng = np.random.default_rng(3)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                             clip_norm=clip, moment_dtype=moments)
    params = _tree(rng, dtype)
    grads = [_like(rng, params, gain=3.0) for _ in range(5)]
    mine = _map(torch.clone, params)
    st_mine = tadamw.init(mine, cfg)
    st_want = tadamw.init(params, cfg)
    n0 = _counts()
    for g in grads:
        mine, st_mine, met = tadamw.update(mine, g, st_mine, cfg,
                                           use_kernel=True)
        gnorm, lr, st_want = _eager_update(params, g, st_want, cfg)
        assert torch.equal(met["grad_norm"], gnorm)
        assert torch.equal(met["lr"], lr)
    assert _counts() == n0
    for a, b in zip(tadamw.leaves_with_path((mine, st_mine.m, st_mine.v)),
                    tadamw.leaves_with_path((params, st_want.m, st_want.v))):
        assert a[1].dtype == b[1].dtype and torch.equal(a[1], b[1]), a[0]
    assert int(st_mine.step) == 5


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_use_kernel_false_is_bitwise_use_kernel_true_on_cpu(moments):
    rng = np.random.default_rng(4)
    cfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4,
                             moment_dtype=moments)
    base = _tree(rng, torch.float32)
    grads = [_like(rng, base) for _ in range(3)]
    out = []
    for use_kernel in (True, False):
        p = _map(torch.clone, base)
        st = tadamw.init(p, cfg)
        for g in grads:
            p, st, met = tadamw.update(p, g, st, cfg, use_kernel=use_kernel)
        out.append([t for _, t in tadamw.leaves_with_path(
            (p, st.m, st.v, met["grad_norm"]))])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_update_with_kernels_asked_for_matches_the_reference():
    """``update(use_kernel=True)`` on the CPU within 1e-6 of
    ``repro.optim.adamw.update`` over three steps, the parameters, both
    moments and the norm."""
    rng = np.random.default_rng(5)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=1.0)
    base = _tree(rng, torch.float32)
    grads = [_like(rng, base, gain=2.0) for _ in range(3)]
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    to_j = lambda tree: _map(lambda t: jnp.asarray(t.numpy()), tree)
    jp = to_j(base)
    js = jadamw.init(jp, jcfg)
    tp = _map(torch.clone, base)
    ts = tadamw.init(tp, tcfg)
    jupdate = jax.jit(lambda p, g, s: jadamw.update(p, g, s, jcfg))
    for g in grads:
        jp, js, jm = jupdate(jp, to_j(g), js)
        tp, ts, tm = tadamw.update(tp, g, ts, tcfg, use_kernel=True)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        # both flattened by JAX, in its (sorted-key) order
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(_map(torch.Tensor.numpy,
                                                         got)),
                jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("p_dtype,g_dtype,m_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float16),
    (torch.bfloat16, torch.bfloat16, torch.float16)])
def test_wrapper_on_cpu_tensors_is_its_plain_version(p_dtype, g_dtype,
                                                     m_dtype, decay):
    """``adamw_update`` on CPU tensors is ``_update_leaf`` (path
    "plain"), on a slice view at storage offset 1 too, and launches
    nothing; ``grad_norm`` is ``global_norm`` and ``grad_sumsq`` each
    group's sum of squares within 1e-6 of float64."""
    rng = np.random.default_rng(6)
    cfg = tadamw.AdamWConfig(weight_decay=0.1)
    mk = lambda dt, n: torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(dt)
    scale, lr = torch.tensor(0.5), torch.tensor(1e-2)
    b1c, b2c = torch.tensor(0.1), torch.tensor(0.05)
    for n, off in ((1, 0), (7, 0), (4097, 0), (4097, 1)):
        p, g = mk(p_dtype, n + off)[off:], mk(g_dtype, n + off)[off:]
        m = mk(m_dtype, n + off)[off:]
        v = torch.abs(mk(m_dtype, n + off))[off:]
        want = [t.clone() for t in (p, g, m, v)]
        n0 = _counts()
        assert kadamw.adamw_update(p, g, m, v, cfg, scale, lr, b1c, b2c,
                                   decay) == "plain"
        tadamw._update_leaf(*want, cfg, scale, lr, b1c, b2c, decay)
        assert _counts() == n0
        for a, b in zip((p, m, v), (want[0], want[2], want[3])):
            assert torch.equal(a, b)
    leaves = [mk(g_dtype, n) for n in (1, 7, 4097)]
    assert torch.equal(kadamw.grad_norm(leaves), tadamw.global_norm(leaves))
    groups = [leaves[:2], leaves[2:]]
    sums = kadamw.grad_sumsq(groups)
    assert sums.dtype == torch.float64 and sums.shape == (2,)
    for got, group in zip(sums, groups):
        np.testing.assert_allclose(
            float(got), sum(float(np.sum(np.square(x.double().numpy())))
                            for x in group), rtol=1e-6)


def test_wrapper_checks_its_arguments():
    cfg = tadamw.AdamWConfig()
    one = torch.tensor(1.0)
    p = torch.zeros(5)
    with pytest.raises(ValueError):
        kadamw.adamw_update(p, torch.zeros(4), torch.zeros(5), torch.zeros(5),
                            cfg, one, one, one, one, True)
    with pytest.raises(TypeError):
        kadamw.adamw_update(p, p.clone(), torch.zeros(5),
                            torch.zeros(5, dtype=torch.bfloat16), cfg, one,
                            one, one, one, True)
    with pytest.raises(TypeError):
        kadamw.adamw_update(p.double(), p.double(), p.double(), p.double(),
                            cfg, one, one, one, one, True)
    # float16 moments are taken; float16 weights or gradients are not
    for pg in ((p.half(), p.clone()), (p, p.half())):
        with pytest.raises(TypeError):
            kadamw.adamw_update(*pg, p.half(), p.half(), cfg, one, one, one,
                                one, True)
    with pytest.raises(ValueError):
        kadamw.adamw_update(p, p.clone(), p.clone(), p.clone(), cfg,
                            torch.ones(1), one, one, one, True)


def test_body_split_of_aligned_and_offset_leaves():
    """The host's split of a leaf into its scalar head, its body of
    16-byte vectors of 8 and its tail: the first element at which every
    array is aligned (f32 and bf16 slices at one offset share one), None
    where the arrays' offsets disagree."""
    f = torch.zeros(64)
    h = torch.zeros(64, dtype=torch.bfloat16)
    assert f.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0
    assert kadamw.body(f, h) == 0
    assert kadamw.body(f[1:]) == 3
    assert kadamw.body(h[1:]) == 7
    assert kadamw.body(f[1:], h[1:]) == 7
    assert kadamw.body(f[5:], h[5:]) == 3
    assert kadamw.body(f[1:], h[2:]) is None
    assert kadamw._split(4097, 0) == (0, 512)
    assert kadamw._split(4096, 7) == (7, 511)
    assert kadamw._split(5, 3) == (3, 0)
    assert kadamw._split(7, None) == (7, 0)
    assert kadamw._split(2, 3) == (2, 0)


def test_dense_span_reads_permuted_leaves_in_place():
    """The norm reads a gradient whose elements fill one span of its
    storage in another order (a transposed or permuted view, as autograd
    gives attention's output projection) in place, and copies only what
    does not fill one span (strided slices)."""
    base = torch.arange(24.0).reshape(2, 3, 4)
    for x in (base, base.permute(2, 0, 1), base.transpose(0, 1), base[1:]):
        flat = kadamw.dense_span(x)
        assert flat.data_ptr() == x.data_ptr()
        assert torch.equal(torch.sort(flat).values,
                           torch.sort(x.reshape(-1)).values)
    for strided in (base[:, :, ::2], base[:, :1]):
        flat = kadamw.dense_span(strided)
        assert flat.is_contiguous() and flat.data_ptr() != base.data_ptr()
        assert torch.equal(flat, strided.reshape(-1))


def _norm_worker(rank: int, world: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, distribute_tensor)
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        rng = np.random.default_rng(7)
        full = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((6, 5), (3,), (4, 9), (2, 8))]
        placed = [distribute_tensor(t, mesh, [pl]) for t, pl in zip(
            full, (Shard(0), Replicate(), Shard(1), Shard(0)))]
        res = {"kernel_norm": float(tadamw._kernel_norm(placed)),
               "global_norm": float(tadamw.global_norm(placed))}
        partial = DTensor.from_local(torch.ones(3), mesh, [Partial()],
                                     run_check=False)
        try:
            tadamw._kernel_norm([partial])
            res["partial_refused"] = False
        except ValueError:
            res["partial_refused"] = True
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_mesh_norm_groups_dtensor_leaves_over_two_gloo_ranks(tmp_path):
    """The mesh step's norm over DTensor leaves (``_kernel_norm``: each
    group of leaves sharded over the same mesh dimensions summed on the
    rank's shards, reduced over those dimensions) on two spawned gloo ranks, its grad
    sums the plain versions' on the CPU: on every rank within 1e-6 of
    the float64 norm of the global values and of ``global_norm``; a
    replicated leaf counted once; a gradient left partial refused."""
    import time
    world = 2
    out = os.path.join(tmp_path, "norm")
    ctx = mp.spawn(_norm_worker, args=(world, os.path.join(tmp_path, "st"),
                                       out), nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            assert time.monotonic() < deadline, "no result in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    rng = np.random.default_rng(7)
    full = [rng.standard_normal(s).astype(np.float32)
            for s in ((6, 5), (3,), (4, 9), (2, 8))]
    want = float(np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                             for x in full)))
    for r in range(world):
        res = json.load(open(f"{out}.{r}"))
        np.testing.assert_allclose(res["kernel_norm"], want, rtol=1e-6)
        np.testing.assert_allclose(res["global_norm"], want, rtol=1e-6)
        assert res["partial_refused"]
