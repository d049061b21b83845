"""The port's roofline and dry run (``repro_torch.launch.roofline`` /
``dryrun``) on the CPU: ``model_flops`` equal to the JAX package's for
every architecture x shape; ``roofline_terms`` equal to the reference's
on the same inputs once the reference's TPU constants are replaced by
the port's H100 ones; the traced counters on known work (a matmul's
FLOPs and bytes, an all-gather and an all-reduce's wire bytes under a
``fake`` process group); and ``run_cell`` on a smoke config on a fake
(2, 2) mesh: status ok, its per-device argument bytes equal to the sum
of the shard sizes the JAX package's specs give.  Under ``moe_dshard``
the MoE decode cells trace the d-split schedule: the same argument
bytes, and wire bytes that differ from the cell without the hint by
exactly what ``_dshard_wire_delta`` works out from the config.
"""
import math
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.launch import roofline as jroof
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.launch import roofline as troof


@pytest.mark.parametrize("shape", jbase.SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", tbase.list_archs())
def test_model_flops_equal_reference(arch, shape):
    assert troof.model_flops(tbase.get_config(arch),
                             tbase.SHAPE_BY_NAME[shape.name]) == \
        jroof.model_flops(jbase.get_config(arch), shape)


COSTS = [({"flops": 197e12, "bytes accessed": 819e9 * 2}, 256, "gemma2-2b",
          "train_4k"),
         ({"flops": 3.1e15, "bytes accessed": 2.9e13}, 512, "qwen1.5-110b",
          "train_4k"),
         ({"flops": 1.0, "bytes accessed": 0.0}, 1, "mamba2-2.7b",
          "decode_32k")]


@pytest.mark.parametrize("cost,n,arch,shape", COSTS)
def test_roofline_terms_equal_reference_on_h100_constants(
        monkeypatch, cost, n, arch, shape):
    coll = {"all-reduce": 4e9, "all-gather": 1e10, "reduce-scatter": 0.0,
            "all-to-all": 0.0, "collective-permute": 0.0,
            "_counts": {"all-reduce": 2.0}, "_top": []}
    for name, value in (("PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16),
                        ("HBM_BW", tmesh.HBM_BW), ("ICI_BW", tmesh.LINK_BW)):
        monkeypatch.setattr(jroof, name, value)
    want = jroof.roofline_terms(cost, coll, n, jbase.get_config(arch),
                                jbase.SHAPE_BY_NAME[shape])
    got = troof.roofline_terms(cost, coll, n, tbase.get_config(arch),
                               tbase.SHAPE_BY_NAME[shape])
    assert got == want
    assert got["compute_s"] == cost["flops"] / 989e12


def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 450e9 and tmesh.IB_BW == 50e9
    assert tmesh.LINK_BW == tmesh.IB_BW


def test_trace_counter_counts_a_matmul():
    a, b = torch.randn(32, 100), torch.randn(100, 16)
    with troof.TraceCounter() as tc:
        c = a @ b
        c.view(-1)                      # a view moves nothing
    st = tc.stats()
    assert st["flops"] == 2 * 32 * 100 * 16
    assert st["bytes accessed"] == 4 * (32 * 100 + 100 * 16 + 32 * 16)
    assert tc.collectives()["all-gather"] == 0.0


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) ("data", "model") mesh on a fake process group of 4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_world(4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_trace_counter_counts_collectives(fake_mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.steps import fake_mode
    fm = fake_mode()
    with fm:
        x = DTensor.from_local(torch.empty(8, 64), fake_mesh,
                               (Shard(0), Replicate()), run_check=False)
        y = DTensor.from_local(torch.empty(16, 64), fake_mesh,
                               (Replicate(), Partial()), run_check=False)
    with fm, troof.TraceCounter(fm) as tc:
        x.redistribute(fake_mesh, (Replicate(), Replicate()))
        y.redistribute(fake_mesh, (Replicate(), Replicate()))
    coll = tc.collectives()
    assert coll["all-gather"] == 16 * 64 * 4          # the gathered result
    assert coll["all-reduce"] == 2 * 16 * 64 * 4      # counted twice
    assert coll["_counts"]["all-gather"] == 1 == coll["_counts"][
        "all-reduce"]
    assert {t["kind"] for t in coll["_top"]} == {"all-gather", "all-reduce"}


M22 = types.SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": 2, "model": 2})


def _shard_bytes(leaf, spec) -> int:
    n = 1
    for d, entry in zip(tuple(leaf.shape), tuple(spec) + (None,) * 8):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n *= d // math.prod(M22.shape[a] for a in axes)
    return n * np.dtype(leaf.dtype).itemsize


def _jax_arg_bytes(arch: str, shape) -> int:
    """The per-device bytes of the reference's step arguments on a (2, 2)
    mesh, from its specs: train state (bf16 moments, as the dry run's
    default) and batch, or parameters, cache, tokens and positions."""
    cfg = jbase.get_smoke_config(arch)
    total = 0
    leaves = jax.tree_util.tree_flatten_with_path
    if shape.kind == "train":
        state = jsteps.abstract_train_state(
            cfg, jadamw.AdamWConfig(moment_dtype="bfloat16"))
        for path, leaf in leaves(state)[0]:
            total += _shard_bytes(leaf, jsh.pspec_for_param(path, leaf, M22))
        batch = jsteps.abstract_batch(cfg, shape)
        specs = jsh.batch_pspecs(cfg, shape, M22)
        return total + sum(_shard_bytes(v, specs[k])
                           for k, v in batch.items())
    for path, leaf in leaves(jsteps.abstract_params(cfg))[0]:
        total += _shard_bytes(leaf, jsh.pspec_for_param(path, leaf, M22))
    B = shape.global_batch
    cache = jax.eval_shape(lambda: jmodel.init_cache(cfg, B, shape.seq_len))
    for path, leaf in leaves(cache)[0]:
        total += _shard_bytes(leaf, jsh.cache_pspec_for(path, leaf, cfg,
                                                        M22, B))
    tok = jsh.batch_pspecs(cfg, shape, M22)["tokens"]
    return total + 2 * _shard_bytes(jax.ShapeDtypeStruct((B,), np.int32),
                                    tok)


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("deepseek-v2-236b", "train_4k"),
                                        ("recurrentgemma-2b", "decode_32k")])
def test_run_cell_on_a_fake_2x2_mesh(fake_mesh, arch, shape):
    rec = dryrun.run_cell(arch, shape, "single", mesh=fake_mesh,
                          cfg=tbase.get_smoke_config(arch))
    assert rec["status"] == "ok", rec
    assert rec["step"] == ("train" if shape == "train_4k" else "decode")
    r = rec["roofline"]
    assert r["n_devices"] == 4 and r["bottleneck"] in (
        "compute", "memory", "collective")
    assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
    assert rec["memory"]["arg_bytes_analytic_per_device"] == \
        _jax_arg_bytes(arch, jbase.SHAPE_BY_NAME[shape])
    if shape == "train_4k":
        # FSDP gathers and gradient reductions: some wire bytes
        assert r["wire_bytes_per_device"] > 0


def test_moe_dshard_raises_on_an_moe_cell(fake_mesh):
    """The port's MoE splits the groups, the experts and the model width:
    a "moe_expert_in" hint that splits the capacity (no reference path
    installs one) raises on an MoE cell; a cell without MoE ignores
    ``moe_dshard``."""
    from repro_torch.distributed.sharding import NamedSharding, P
    hint = {"moe_expert_in": NamedSharding(fake_mesh,
                                           P("model", None, "data", None))}
    with pytest.raises(NotImplementedError, match="split capacity"):
        dryrun.run_cell("deepseek-v2-236b", "decode_32k", "single",
                        {"extra_hints": hint}, mesh=fake_mesh,
                        cfg=tbase.get_smoke_config("deepseek-v2-236b"))
    rec = dryrun.run_cell("recurrentgemma-2b", "decode_32k", "single",
                          {"moe_dshard": 1}, mesh=fake_mesh,
                          cfg=tbase.get_smoke_config("recurrentgemma-2b"))
    assert rec["status"] == "ok", rec
    plain = dryrun.run_cell("recurrentgemma-2b", "decode_32k", "single",
                            mesh=fake_mesh,
                            cfg=tbase.get_smoke_config("recurrentgemma-2b"))
    assert rec["collectives"]["_counts"] == plain["collectives"]["_counts"]


def _dshard_wire_delta(arch: str, shape) -> tuple:
    """(all-gather, all-reduce) wire bytes a decode step of `arch`'s smoke
    config under ``moe_dshard`` adds on the (2, 2) mesh, by the
    ``TraceCounter``'s convention (a gather counts its gathered tensor, an
    all-reduce twice its tensor), a MoE layer each: the experts' FSDP
    gathers of w_gate, w_up and w_down (E_l, d, F) in f32 go; the routed
    rows (B, d) gathered over "data" and the output's d split laid out as
    rows again (on a CPU mesh a gather and a chunk) come; the gate and up
    products' partial sums (2, E_l, G C, F), all-reduced over "data",
    come.  G is one group a data shard, C the reference's capacity of a
    group's B / G tokens."""
    cfg = jbase.get_smoke_config(arch)
    m = cfg.moe
    B, d, F = shape.global_batch, cfg.d_model, m.d_ff_expert
    e_l, G = m.n_experts // M22.shape["model"], M22.shape["data"]
    C = jmoe._capacity(B // G, m)
    cb = np.dtype(cfg.dtype).itemsize           # the compute dtype
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    gathers = 3 * e_l * d * F * 4               # f32 weights
    rows = 2 * B * d * cb
    partial = 2 * (2 * e_l * G * C * F * cb)
    return n_moe * (rows - gathers), n_moe * partial


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_dshard_decode_on_a_fake_2x2_mesh(fake_mesh, arch):
    """``moe_dshard`` on an MoE decode cell: status ok, the argument
    bytes the JAX package's specs give (the hint moves no parameter), and
    the all-gather / all-reduce wire bytes apart from the cell without
    the hint by exactly ``_dshard_wire_delta``; every other kind alike."""
    shape = jbase.SHAPE_BY_NAME["decode_32k"]
    cfg = tbase.get_smoke_config(arch)
    plain = dryrun.run_cell(arch, "decode_32k", "single", mesh=fake_mesh,
                            cfg=cfg)
    rec = dryrun.run_cell(arch, "decode_32k", "single", {"moe_dshard": 1},
                          mesh=fake_mesh, cfg=cfg)
    assert rec["status"] == "ok" == plain["status"], rec
    assert rec["dispatch"] == plain["dispatch"] == "gshard:2"
    assert rec["memory"]["arg_bytes_analytic_per_device"] == \
        _jax_arg_bytes(arch, shape) == \
        plain["memory"]["arg_bytes_analytic_per_device"]
    gather, reduce = _dshard_wire_delta(arch, shape)
    c, c0 = rec["collectives"], plain["collectives"]
    assert gather < 0 < reduce
    assert c["all-gather"] - c0["all-gather"] == gather
    assert c["all-reduce"] - c0["all-reduce"] == reduce
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert c[kind] == c0[kind]
