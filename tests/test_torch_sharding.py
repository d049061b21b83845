"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the JAX package's, integer for integer.

For every architecture's full config, on the production mesh shapes as
duck-typed meshes ({data: 16, model: 16} and {pod: 2, data: 16, model:
16}, as tests/test_roofline_sharding.py builds them): the spec of every
leaf of the port's parameters (``abstract_params``, fake tensors) equals
JAX ``pspec_for_param``'s for the matching leaf of ``jax.eval_shape``'d
parameters, the stacked period axis stripped (the port keeps one dict a
layer: layer i of the body is the reference's ``body/p<(i - head) %
period>`` at index (i - head) // period); the same for ``batch_pspecs``
over the four shapes and for ``cache_pspec_for`` over the decode shapes.
Then the reference file's rule cases, on the port's layer paths.
"""
import re
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw


def _mesh(shape_map):
    m = types.SimpleNamespace()
    m.axis_names = tuple(shape_map)
    m.shape = dict(shape_map)
    return m


MESH = _mesh({"data": 16, "model": 16})
MESH3 = _mesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": MESH, "multi": MESH3}
ARCHS = tbase.list_archs()
DECODE = [s for s in jbase.SHAPES if s.kind == "decode"]


def _jax_path(cfg, i: int, rest: str) -> str:
    """The reference's tree path of the port's layer i's leaf `rest`."""
    head, period, n_periods, tail = tmodel.block_structure(cfg)
    n_head, P = len(head), len(period)
    if i < n_head:
        return f"head/{i}/{rest}"
    if i < n_head + n_periods * P:
        return f"body/p{(i - n_head) % P}/{rest}"
    return f"tail/{i - n_head - n_periods * P}/{rest}"


def _to_jax(cfg, port_path: str) -> str:
    m = re.fullmatch(r"layers/(\d+)/(.*)", port_path)
    return _jax_path(cfg, int(m.group(1)), m.group(2)) if m else port_path


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _spec_leaves(tree, path=""):
    """(path, spec) of a tree of specs (a spec is a tuple: not walked)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _spec_leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _spec_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _jax_specs(tree, spec_fn):
    """{path: (shape, spec tuple)} of a reference tree, the stacked
    period axis stripped from body leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        ps = jsh._path_str(path)
        spec = tuple(spec_fn(path, leaf))
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)body/", ps):
            assert spec[:1] in ((), (None,)), (ps, spec)
            spec, shape = spec[1:], shape[1:]
        out[ps] = (shape, spec)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    cfg_j, cfg_t = jbase.get_config(arch), tbase.get_config(arch)
    return (arch, cfg_t, jsteps.abstract_params(cfg_j),
            tsteps.abstract_params(cfg_t))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_param_specs_equal_reference(arch_params, mesh_kind):
    arch, cfg, jtree, ttree = arch_params
    mesh = MESHES[mesh_kind]
    want = _jax_specs(jtree, lambda p, l: jsh.pspec_for_param(p, l, mesh))
    leaves = tadamw.leaves_with_path(ttree)
    seen = set()
    for path, leaf in leaves:
        ps = tsh.path_str(path)
        jp = _to_jax(cfg, ps)
        shape, spec = want[jp]
        assert tuple(leaf.shape) == shape, (ps, leaf.shape, shape)
        got = tsh.pspec_for_param(path, leaf, mesh)
        assert tuple(got) == spec, (arch, ps, got, spec)
        seen.add(jp)
    assert seen == set(want)
    # param_shardings: the same specs in the tree's own layout
    tree_specs = tsh.param_shardings(ttree, mesh)
    for path, leaf in leaves:
        assert _at(tree_specs, tsh.path_str(path)) == \
            tsh.pspec_for_param(path, leaf, mesh)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("shape", jbase.SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, shape, mesh_kind):
    mesh = MESHES[mesh_kind]
    want = jsh.batch_pspecs(jbase.get_config(arch), shape, mesh)
    got = tsh.batch_pspecs(tbase.get_config(arch),
                           tbase.SHAPE_BY_NAME[shape.name], mesh)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("l_model", [False, True])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("shape", DECODE, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, shape, mesh_kind, l_model):
    cfg_j, cfg_t = jbase.get_config(arch), tbase.get_config(arch)
    ok, _ = jbase.cell_is_runnable(cfg_j, shape)
    if not ok:
        # no decode cell for this arch: the rules still apply to its
        # cache, at a shorter length
        shape = jbase.InputShape(shape.name, 4096, shape.global_batch,
                                 "decode")
    mesh = MESHES[mesh_kind]
    B, L = shape.global_batch, shape.seq_len
    jtree = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, B, L))
    want = _jax_specs(jtree, lambda p, l: jsh.cache_pspec_for(
        p, l, cfg_j, mesh, B, l_model))
    ttree = tsteps.abstract_cache(cfg_t, B, L)
    assert len(ttree) == cfg_t.n_layers
    for i, layer in enumerate(ttree):
        for name, leaf in layer.items():
            shape_j, spec = want[_jax_path(cfg_t, i, name)]
            assert tuple(leaf.shape) == shape_j
            got = tsh.cache_pspec_for(f"layers/{i}/{name}", leaf, cfg_t,
                                      mesh, B, l_model)
            assert tuple(got) == spec, (arch, i, name, got, spec)
    specs = tsh.cache_shardings(ttree, cfg_t, mesh, B, l_model)
    assert [sorted(s) for s in specs] == [sorted(c) for c in ttree]


# ---------------------------------------------------------------------------
# the reference file's rule cases (tests/test_roofline_sharding.py), on the
# port's per-layer paths
# ---------------------------------------------------------------------------


class _Leaf:
    def __init__(self, *shape):
        self.shape = shape


RULE_CASES = [
    # (path, shape, mesh, expected) — the reference's cases, a body leaf's
    # stacked period axis dropped (its spec's leading None with it)
    ("embed", (256000, 2304), MESH, JP("model")),
    ("layers/0/attn/w_q", (8192, 64, 128), MESH, JP("data", "model")),
    ("layers/0/mlp/w_gate", (8192, 49152), MESH, JP("data", "model")),
    ("layers/0/mlp/w_down", (49152, 8192), MESH, JP("model", "data")),
    ("layers/0/pre_norm/scale", (8192,), MESH, JP()),
    # gemma2: 8 q heads / 4 kv heads on a 16-way model axis -> replicated
    ("layers/0/attn/w_q", (2304, 8, 256), MESH, JP("data")),
    ("layers/0/attn/w_k", (2304, 4, 256), MESH, JP("data")),
    ("layers/0/mlp/w_gate", (2304, 9216), MESH, JP("data", "model")),
    # body stacking: the layer's slice
    ("layers/5/mlp/w_gate", (2304, 9216), MESH, JP("data", "model")),
    # MoE experts: expert-parallel + FSDP
    ("layers/1/moe/w_gate", (160, 5120, 1536), MESH,
     JP("model", "data")),
    ("layers/1/moe/w_down", (160, 1536, 5120), MESH,
     JP("model", None, "data")),
    ("layers/1/moe/w_router", (5120, 160), MESH, JP()),
    # hubert vocab=504 does not divide 16 -> replicated embedding
    ("embed", (504, 1280), MESH, JP()),
    # the models' trees: the table leaf falls through to replicated
    ("embed/table", (256000, 2304), MESH, JP()),
    ("layers/0/mla/w_o", (128, 128, 5120), MESH3,
     JP("model", None, "data")),
    ("layers/0/rglru/a_param", (2560,), MESH, JP("model")),
    ("layers/0/rglru/w_r", (10, 256, 256), MESH, JP()),
]


@pytest.mark.parametrize("path,shape,mesh,want", RULE_CASES,
                         ids=[f"{c[0]}-{len(c[1])}d" for c in RULE_CASES])
def test_param_rules(path, shape, mesh, want):
    got = tsh.pspec_for_param(path, _Leaf(*shape), mesh)
    assert tuple(got) == tuple(want)
    # and the reference gives the same on the same path
    key = tuple(types.SimpleNamespace(key=k) for k in path.split("/"))
    assert tuple(jsh.pspec_for_param(key, _Leaf(*shape), mesh)) == \
        tuple(want)


def test_batch_and_cache_rule_cases():
    cfg = tbase.get_config("gemma2-2b")
    tr = tsh.batch_pspecs(cfg, tbase.SHAPE_BY_NAME["train_4k"], MESH3)
    assert tr["tokens"] == tsh.P(("pod", "data"), None)
    assert tsh.batch_pspecs(cfg, tbase.SHAPE_BY_NAME["decode_32k"],
                            MESH)["tokens"] == tsh.P("data")
    assert tsh.batch_pspecs(cfg, tbase.SHAPE_BY_NAME["long_500k"],
                            MESH)["tokens"] == tsh.P(None)
    cfg3 = tbase.get_config("gemma3-12b")
    spec = tsh.cache_pspec_for("layers/0/k", _Leaf(128, 32768, 8, 256),
                               cfg3, MESH, 128)
    assert spec[0] == "data"
    spec = tsh.cache_pspec_for("layers/0/k", _Leaf(1, 524288, 8, 256),
                               cfg3, MESH, 1)
    assert tuple(spec)[:2] == (None, "data")
    assert all(x is None for x in tuple(spec)[2:])


def test_dp_axes_and_sizes():
    assert tsh.dp_axes(MESH) == ("data",)
    assert tsh.dp_axes(MESH3) == ("pod", "data")
    assert tsh.axis_size(MESH3, ("pod", "data")) == 32
    assert tsh.axis_size(MESH, None) == 1
    assert tsh.dp_entry(MESH3, 256) == ("pod", "data")
    assert tsh.dp_entry(MESH3, 16) is None


def test_spec_equality_trims_trailing_none():
    assert tsh.P(None) == tsh.P()
    assert tsh.P("data", None) == tsh.P("data")
    assert tsh.P("data") != tsh.P(None, "data")
    assert hash(tsh.P("data", None)) == hash(tsh.P("data"))
    assert tsh.replicated(MESH) == tsh.P()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), MESH3) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, "data"), MESH) == \
        (Shard(1), Replicate())
    assert tsh.placements(tsh.P(), MESH3) == (Replicate(),) * 3
    sh = tsh.NamedSharding(MESH, tsh.P("model"))
    assert sh.placements == (Replicate(), Shard(0))


def test_train_state_specs_follow_the_parameters():
    """AdamW's moments take their parameters' specs; its step replicated."""
    cfg = tbase.get_smoke_config("recurrentgemma-2b")
    state = tsteps.abstract_train_state(cfg, tadamw.AdamWConfig())
    specs = tsh.param_shardings(state, MESH)
    p = _spec_leaves(specs["params"])
    assert any(s != tsh.P() for _, s in p)
    assert p == _spec_leaves(specs["opt"].m) == _spec_leaves(specs["opt"].v)
    assert specs["opt"].step == tsh.P()
