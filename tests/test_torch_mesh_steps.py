"""The port's mesh steps on the CPU: spawned gloo process groups on a
(2, 2) ("data", "model") and a (2, 2, 2) ("pod", "data", "model") mesh,
each rank one process, against the one-device steps (which
test_torch_training.py and test_torch_moe.py hold to the JAX package).

One spawn a mesh runs every case (recurrentgemma-2b, mamba2-2.7b,
deepseek-v2-236b on its default ``gshard:G`` dispatch, gemma2-2b, their
smoke configs): the train step's loss and every gradient (``meta
["grads"]``, gathered), one whole step's loss and updated parameters,
and greedy prefill + decode tokens through ``make_prefill_step`` /
``make_decode_step``.  The same spawns run the MoE cases under the dry
run's ``moe_dshard`` hint (``steps.moe_dshard_hints``: expert weights
kept sharded on d, the experts' partial sums all-reduced over "data"),
in the (2, 2) spawn:
deepseek-v2-236b on ``gshard:G`` and on ``sortg:G``, llama4-maverick on
its default, each against one device on the same dispatch: the loss and
every gradient, the prefill's logits and the greedy tokens.  Tolerances:
losses 1e-5 relative, gradients and logits 1e-5 of each leaf's largest
element, parameters after a step 1e-5 absolute (the ranks sum partial
products in another order than one device); tokens equal.  The process
group meets through a FileStore under ``tmp_path`` (no port), and each
join waits at most JOIN_S seconds.
"""
import json
import logging
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b",
         "gemma2-2b")
# (arch, dispatch) under moe_dshard, in DSHARD_MESH's spawn; None: the
# mesh's default dispatch
DSHARD = (("deepseek-v2-236b", "gshard"), ("deepseek-v2-236b", "sortg"),
          ("llama4-maverick-400b-a17b", None))
DSHARD_MESH = "2x2"
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
JOIN_S = 120
B, S, NEW = 4, 8, 3
TOL = 1e-5


def _leaf_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = max(float(a.abs().max()), 1e-6)
    return float((a - b).abs().max()) / scale


def _case(arch: str, mesh) -> dict:
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.distributed import (make_decode_step, make_prefill_step,
                                         make_train_step)
    from repro_torch.distributed.steps import _full
    from repro_torch.launch.train import build_state
    from repro_torch.models import model as model_lib
    from repro_torch.models.steps import make_train_batch
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    shape = InputShape("t", S, B, "train")
    opt = adamw.AdamWConfig(total_steps=4, warmup_steps=1)
    mb = make_train_step(cfg, mesh, shape, opt)
    disp = mb.meta["dispatch"]
    ob = make_train_step(cfg, None, shape, opt, device="cpu",
                         dispatch=disp)
    batch = make_train_batch(cfg, shape, np.random.default_rng(1), "cpu")
    one, multi = (build_state(cfg, opt, 0, "cpu") for _ in range(2))
    l0, _, g0 = ob.meta["grads"](one, batch)
    l1, _, g1 = mb.meta["grads"](multi, batch)
    grad_err = max(_leaf_err(a, _full(b)) for a, b in zip(g0, g1))
    one, m0 = ob.fn(one, batch)
    multi, m1 = mb.fn(multi, batch)
    step_err = max(
        float((a - _full(b)).abs().max()) for (_, a), (_, b) in zip(
            adamw.leaves_with_path(one["params"]),
            adamw.leaves_with_path(multi["params"])))
    out = {"dispatch": disp, "grads_loss": [float(l0), float(l1)],
           "grad_err": grad_err, "n_grads": len(g0),
           "step_loss": [float(m0["loss"]), float(m1["loss"])],
           "step_err": step_err}

    params = model_lib.init_params(cfg, torch.Generator().manual_seed(2),
                                   "cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    L = S + NEW
    logits, cache = model_lib.prefill(cfg, params, {"tokens": toks}, L,
                                      dispatch=disp)
    want = [torch.argmax(logits, -1).to(torch.int32)]
    for t in range(NEW):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = model_lib.decode_step(cfg, params, want[-1], pos,
                                              cache, disp)
        want.append(torch.argmax(logits, -1).to(torch.int32))
    pb = make_prefill_step(cfg, mesh, InputShape("p", S, B, "prefill"),
                           cache_len=L)
    db = make_decode_step(cfg, mesh, InputShape("d", L, B, "decode"))
    logits, cache = pb.fn(params, {"tokens": toks})
    got = [torch.argmax(_full(logits), -1).to(torch.int32)]
    for t in range(NEW):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        nxt, cache = db.fn(params, cache, got[-1], pos)
        got.append(_full(nxt))
    out["tokens"] = [torch.stack(want).tolist(), torch.stack(got).tolist()]
    out["serve_dispatch"] = [pb.meta["dispatch"], db.meta["dispatch"]]
    return out


def _dshard_case(arch: str, dispatch, mesh) -> dict:
    """`arch`'s smoke config under ``moe_dshard`` on `mesh` against one
    device on the same dispatch: the loss and gradients of the train
    step (``meta["grads"]``), the prefill's last logits, and the greedy
    prefill + decode tokens."""
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.distributed import (make_decode_step, make_prefill_step,
                                         make_train_step)
    from repro_torch.distributed.steps import _full, moe_dshard_hints
    from repro_torch.launch.train import build_state
    from repro_torch.models import model as model_lib
    from repro_torch.models.steps import make_train_batch
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    hints = moe_dshard_hints(mesh)
    shape = InputShape("t", S, B, "train")
    opt = adamw.AdamWConfig(total_steps=4, warmup_steps=1)
    mb = make_train_step(cfg, mesh, shape, opt, dispatch=dispatch,
                         extra_hints=hints)
    disp = mb.meta["dispatch"]
    ob = make_train_step(cfg, None, shape, opt, device="cpu",
                         dispatch=disp)
    batch = make_train_batch(cfg, shape, np.random.default_rng(1), "cpu")
    l0, _, g0 = ob.meta["grads"](build_state(cfg, opt, 0, "cpu"), batch)
    l1, _, g1 = mb.meta["grads"](build_state(cfg, opt, 0, "cpu"), batch)
    # f32's own floor: one device on the other grouped dispatch, which
    # computes the same function in another order
    method, groups = disp.split(":")
    other = {"gshard": "sortg", "sortg": "gshard"}[method] + ":" + groups
    _, _, g2 = make_train_step(cfg, None, shape, opt, device="cpu",
                               dispatch=other).meta["grads"](
        build_state(cfg, opt, 0, "cpu"), batch)
    out = {"dispatch": disp, "grads_loss": [float(l0), float(l1)],
           "grad_errs": [[_leaf_err(a, _full(b)), _leaf_err(a, c),
                          float((a - _full(b)).abs().max())]
                         for a, b, c in zip(g0, g1, g2)],
           "grad_max": max(float(a.abs().max()) for a in g0),
           "n_grads": len(g0),
           "hint": [str(mb.meta["hints"]["moe_expert_in"].spec)]}

    params = model_lib.init_params(cfg, torch.Generator().manual_seed(2),
                                   "cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    L = S + NEW
    logits0, cache = model_lib.prefill(cfg, params, {"tokens": toks}, L,
                                       dispatch=disp)
    want = [torch.argmax(logits0, -1).to(torch.int32)]
    for t in range(NEW):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = model_lib.decode_step(cfg, params, want[-1], pos,
                                              cache, disp)
        want.append(torch.argmax(logits, -1).to(torch.int32))
    pb = make_prefill_step(cfg, mesh, InputShape("p", S, B, "prefill"),
                           dispatch=dispatch, extra_hints=hints, cache_len=L)
    db = make_decode_step(cfg, mesh, InputShape("d", L, B, "decode"),
                          dispatch=dispatch, extra_hints=hints)
    logits1, cache = pb.fn(params, {"tokens": toks})
    logits1 = _full(logits1)
    got = [torch.argmax(logits1, -1).to(torch.int32)]
    for t in range(NEW):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        nxt, cache = db.fn(params, cache, got[-1], pos)
        got.append(_full(nxt))
    out["logits_err"] = _leaf_err(logits0, logits1)
    out["tokens"] = [torch.stack(want).tolist(), torch.stack(got).tolist()]
    out["serve_dispatch"] = [pb.meta["dispatch"], db.meta["dispatch"]]
    out["hint"] += [str(b.meta["hints"]["moe_expert_in"].spec)
                    for b in (pb, db)]
    return out


def _worker(rank: int, world: int, store: str, mesh_name: str, out: str):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        shape, names = MESHES[mesh_name]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        res = {arch: _case(arch, mesh) for arch in ARCHS}
        if mesh_name == DSHARD_MESH:
            res["dshard"] = {f"{arch}-{disp}": _dshard_case(arch, disp, mesh)
                             for arch, disp in DSHARD}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh(tmp_path, mesh_name: str, worker=_worker) -> dict:
    """Runs `worker` on every rank of `mesh_name`'s mesh in spawned
    processes; its rank 0's JSON results.  Fails after JOIN_S seconds."""
    import time
    shape, _ = MESHES[mesh_name]
    world = int(np.prod(shape))
    out = os.path.join(tmp_path, f"{mesh_name}.json")
    ctx = mp.spawn(worker, args=(world, os.path.join(tmp_path, "store"),
                                 mesh_name, out),
                   nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{mesh_name} mesh: no result within "
                                     f"{JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_results(request, tmp_path_factory):
    return spawn_mesh(tmp_path_factory.mktemp(request.param), request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_gradients_match_one_device(mesh_results, arch):
    r = mesh_results[arch]
    l0, l1 = r["grads_loss"]
    assert abs(l1 - l0) <= TOL * abs(l0), r
    assert r["n_grads"] > 0
    assert r["grad_err"] <= TOL, r


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_update_matches_one_device(mesh_results, arch):
    r = mesh_results[arch]
    l0, l1 = r["step_loss"]
    assert abs(l1 - l0) <= TOL * abs(l0), r
    assert r["step_err"] <= TOL, r


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_decode_tokens_equal(mesh_results, arch):
    want, got = mesh_results[arch]["tokens"]
    assert got == want


def test_moe_dispatch_is_one_group_a_dp_shard(mesh_results):
    """deepseek-v2 on the mesh defaults to gshard with one group per
    data-parallel shard: 2 on (2, 2), 4 on (2, 2, 2) (B 4 divides)."""
    r = mesh_results["deepseek-v2-236b"]
    groups = int(r["dispatch"].split(":")[1])
    assert r["dispatch"].startswith("gshard:") and groups in (2, 4)
    assert r["serve_dispatch"][0] == r["dispatch"]


@pytest.mark.parametrize("mesh_results", [DSHARD_MESH], indirect=True)
@pytest.mark.parametrize("arch,dispatch", DSHARD,
                         ids=[f"{a}-{d}" for a, d in DSHARD])
def test_mesh_moe_dshard_matches_one_device(mesh_results, arch, dispatch):
    """Under ``moe_dshard`` (the hint winning over the dispatch's own):
    the loss within 1e-5 relative, every gradient leaf and the prefill's
    logits within 1e-5 of their largest element, greedy prefill + decode
    tokens equal to one device's, on the dispatch asked for."""
    r = mesh_results["dshard"][f"{arch}-{dispatch}"]
    assert set(r["hint"]) == {"P('model', None, None, 'data')"}, r
    assert r["dispatch"].startswith(dispatch or "gshard"), r
    assert r["serve_dispatch"][0].startswith(dispatch or "gshard"), r
    l0, l1 = r["grads_loss"]
    assert abs(l1 - l0) <= TOL * abs(l0), r
    assert r["n_grads"] > 0
    # a leaf whose own f32 floor (one device's two grouped dispatches
    # apart, relative to its largest element) passes TOL / 2 is held to
    # TOL of the gradient's largest element over all leaves: llama4's
    # top-1 routers, whose gradient (the aux loss's, beside the rounding
    # of w / sum(w) = 1) is a thousandth of the other leaves'
    for err, floor, abs_err in r["grad_errs"]:
        assert err <= TOL or (floor > TOL / 2
                              and abs_err <= TOL * r["grad_max"]), r
    assert r["logits_err"] <= TOL, r
    want, got = r["tokens"]
    assert got == want
