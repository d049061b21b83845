"""The port's MoE and MLA layers, and the architectures that use them
(deepseek-v2-236b and llama4-maverick-400b-a17b), against the JAX
package on the same weights (``params_from_numpy`` of the reference's
``init_params``) and the same numpy inputs, on the CPU; the frontends
(internvl2-2b, hubert-xlarge); every non-encoder architecture's prefill
and decode against its forward; the sharding-hint context.

Tolerances, f32 smoke configs: logits and layer outputs 1e-4 absolute
and relative (the same arithmetic summed in other orders: batched
matmuls against XLA's dots, the flash-style attention's plain version
against the q-block scan); the MoE load-balance loss 1e-5.  Integer
results (expert choices, arrival positions, capacities, greedy tokens)
are equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import steps as jsteps
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import base as tbase
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy, params_to_numpy, pctx
from repro_torch.models import steps as tsteps
from repro_torch.serving.engine import Request, ServingEngine

TOL = 1e-4
AUX_TOL = 1e-5
DEEPSEEK = "deepseek-v2-236b"
LLAMA4 = "llama4-maverick-400b-a17b"
DISPATCHES = ("einsum", "sort", "gshard:1", "gshard:2", "sortg:1",
              "sortg:4")


def _pair(arch, **replace):
    """(jcfg, jax params, tcfg, the port's params) for `arch`'s smoke
    config, with `replace` applied to both configs."""
    jcfg = jbase.get_smoke_config(arch).replace(**replace)
    tcfg = tbase.get_smoke_config(arch).replace(**replace)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def deepseek():
    return _pair(DEEPSEEK)


@pytest.fixture(scope="module")
def llama4():
    return _pair(LLAMA4)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jax_layers(cfg, tree):
    """The reference's head / stacked body / tail tree as a per-layer
    list in layer order (the port's layout)."""
    _, period, n_periods, _ = jmodel.block_structure(cfg)
    out = list(tree["head"])
    for j in range(n_periods):
        for pi in range(len(period)):
            out.append(jax.tree.map(lambda a: a[j], tree["body"][f"p{pi}"]))
    return out + list(tree["tail"])


def _moe_layer(pair):
    """The first MoE layer's parameters, (jax, port)."""
    jcfg, jp, tcfg, tp = pair
    i = next(i for i in range(tcfg.n_layers) if tcfg.is_moe_layer(i))
    return _jax_layers(jcfg, jp)[i]["moe"], tp["layers"][i]["moe"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the parameter tree: every leaf both ways
# ---------------------------------------------------------------------------


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4, "internvl2-2b",
                                  "hubert-xlarge"])
def test_conversion_covers_every_reference_leaf_both_ways(arch):
    """params_from_numpy carries every leaf of the reference's tree (the
    MoE's w_router, w_gate, w_up, w_down and shared MLP, the MLA's w_dq,
    q_norm, w_uq, w_dkv, kv_norm, w_ukv and w_o, frontend_proj) with its
    value and dtype, and params_to_numpy gives the same tree back; the
    port's own init has the same tree of shapes, with w_router f32 under
    bf16 weights."""
    jcfg, jp, tcfg, tp = _pair(arch)
    want = _flat(jax.tree.map(np.asarray, jp))
    back = _flat(params_to_numpy(tcfg, tp))
    assert [p for p, _ in back] == [p for p, _ in want]
    for (_, a), (_, b) in zip(back, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    layers = _jax_layers(jcfg, jp)
    for tl, jl in zip(tp["layers"], layers):
        assert [p for p, _ in _flat(jax.tree.map(lambda t: t.numpy(), tl))] \
            == [p for p, _ in _flat(jl)]
    leaves = {jax.tree_util.keystr(p) for layer in layers
              for p, _ in _flat(layer)}
    if arch == DEEPSEEK:
        for name in ("w_dq", "q_norm']['scale", "w_uq", "w_dkv",
                     "kv_norm']['scale", "w_ukv", "w_o"):
            assert f"['mla']['{name}']" in leaves
    if tcfg.moe is not None:
        for name in ("w_router", "w_gate", "w_up", "w_down"):
            assert f"['moe']['{name}']" in leaves
        assert any(k.startswith("['moe']['shared']") for k in leaves)
    shapes = lambda p: jax.tree.map(lambda t: (tuple(t.shape), t.dtype), p)
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert shapes(own) == shapes(tp)
    if tcfg.moe is not None:
        half = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu", param_dtype=torch.bfloat16)
        moe = next(p["moe"] for p in half["layers"] if "moe" in p)
        assert moe["w_router"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_block_structure_matches_reference(arch, smoke):
    """The head / period / tail split the conversion relies on: deepseek
    one dense head layer and a period of 1, llama4 a period of
    lcm(4, 2) = 4, as the reference splits them."""
    get_t = tbase.get_smoke_config if smoke else tbase.get_config
    get_j = jbase.get_smoke_config if smoke else jbase.get_config
    tcfg, jcfg = get_t(arch), get_j(arch)
    got = tmodel.block_structure(tcfg)
    want = jmodel.block_structure(jcfg)
    assert [[tuple(s) for s in part] if isinstance(part, list) else part
            for part in got] == \
        [[tuple(s) for s in part] if isinstance(part, list) else part
         for part in want]
    head, period, n_periods, tail = got
    assert (len(head), len(period)) == ((1, 1) if arch == DEEPSEEK
                                        else (0, 4))
    assert len(head) + len(period) * n_periods + len(tail) == tcfg.n_layers


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_forward_matches_reference(deepseek, dispatch):
    """Every dispatch the reference accepts, on the deepseek smoke
    config's MoE layer (4 experts, top 2, 2 shared; 64 tokens against a
    capacity of 40, so some assignments are dropped)."""
    jcfg = deepseek[0]
    jparams, tparams = _moe_layer(deepseek)
    x = _x(jcfg, 2, 32, 0)
    want = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg.moe,
                            jcfg.activation, dispatch)
    got = tmoe.moe_forward(tparams, torch.from_numpy(x), deepseek[2].moe,
                           jcfg.activation, dispatch)
    assert got.shape == (2, 32, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("dispatch", ("einsum", "sort", "sortg:2"))
def test_llama4_moe_top1_matches_reference(llama4, dispatch):
    """llama4's top-1 routing (the einsum combine's top_k == 1 branch)."""
    jcfg = llama4[0]
    jparams, tparams = _moe_layer(llama4)
    x = _x(jcfg, 2, 24, 1)
    want = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg.moe,
                            jcfg.activation, dispatch)
    got = tmoe.moe_forward(tparams, torch.from_numpy(x), llama4[2].moe,
                           jcfg.activation, dispatch)
    _close(got, want)


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_moe_aux_loss_matches_reference(arch):
    pair = _pair(arch)
    jcfg = pair[0]
    jparams, tparams = _moe_layer(pair)
    x = _x(jcfg, 2, 32, 2)
    want = jmoe.moe_aux_loss(jparams, jnp.asarray(x), jcfg.moe)
    got = tmoe.moe_aux_loss(tparams, torch.from_numpy(x), pair[2].moe)
    assert abs(float(got) - float(want)) <= AUX_TOL


def test_router_capacity_and_positions_match_reference(deepseek):
    """The expert choices and weights, the arrival order within each
    expert over the token-major flattening and the capacity (rounded up
    to 8, at least 8) equal the reference's."""
    jcfg, _, tcfg, _ = deepseek
    jparams, tparams = _moe_layer(deepseek)
    x2d = _x(jcfg, 1, 64, 3)[0]
    jw, jidx, jg = jmoe._router(jparams, jnp.asarray(x2d), jcfg.moe)
    tw, tidx, tg = tmoe._router(tparams, torch.from_numpy(x2d), tcfg.moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    _close(tg, jg)
    np.testing.assert_array_equal(
        tmoe._positions_in_expert(tidx, tcfg.moe.n_experts).numpy(),
        np.asarray(jmoe._positions_in_expert(jidx, jcfg.moe.n_experts)))
    for n in (1, 4, 7, 64, 100, 3000, 4096):
        for moe_t, moe_j in ((tcfg.moe, jcfg.moe),
                             (tbase.get_config(DEEPSEEK).moe,
                              jbase.get_config(DEEPSEEK).moe)):
            assert tmoe._capacity(n, moe_t) == jmoe._capacity(n, moe_j)
    assert tmoe._capacity(3000, tbase.get_config(DEEPSEEK).moe) == 144


@pytest.mark.parametrize("N,k,E", [(1, 1, 4), (37, 2, 4), (300, 6, 160),
                                   (3000, 6, 160), (64, 1, 128)])
def test_positions_in_expert_equal_the_one_hot_cumsum(N, k, E):
    """The port's sort-based arrival order equals the reference's one-hot
    cumsum on random and on skewed expert choices (most tokens on a few
    experts, as an untrained router sends them)."""
    rng = np.random.default_rng(N + E)
    for idx in (rng.integers(0, E, (N, k)),
                np.minimum(rng.geometric(0.3, (N, k)) - 1, E - 1)):
        want = jmoe._positions_in_expert(jnp.asarray(idx, jnp.int32), E)
        got = tmoe._positions_in_expert(torch.from_numpy(idx), E)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_router_breaks_ties_by_the_lower_expert_as_jax_top_k(deepseek):
    """Gates that tie: all equal (a zero router), and pairs that tie
    above the rest.  The port picks the lower expert index first, as
    ``jax.lax.top_k`` does."""
    jcfg, _, tcfg, _ = deepseek
    moe = dataclasses.replace(tcfg.moe, n_experts=6, top_k=3)
    jmoe_cfg = dataclasses.replace(jcfg.moe, n_experts=6, top_k=3)
    w = np.zeros((4, 6), np.float32)
    w[0, [1, 4]] = 1.0      # feature 0 lifts experts 1 and 4 alike
    w[1, [2, 3, 5]] = 0.5   # feature 1 lifts 2, 3 and 5 alike
    x = np.array([[0, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0],
                  [1, 1, 0, 0]], np.float32)
    _, jidx, _ = jmoe._router({"w_router": jnp.asarray(w)}, jnp.asarray(x),
                              jmoe_cfg)
    _, tidx, _ = tmoe._router({"w_router": torch.from_numpy(w)},
                              torch.from_numpy(x), moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        tidx.numpy(), [[0, 1, 2], [1, 4, 0], [2, 3, 5], [1, 4, 2]])


def test_moe_dispatch_methods_agree(deepseek):
    """The port of the reference's ``test_moe_dispatch_methods_agree``:
    einsum (GShard), grouped gshard and sort dispatch agree on kept
    tokens, through the whole deepseek smoke model."""
    _, _, tcfg, tp = deepseek
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 32)))
    outs = {d: tmodel.forward(tcfg, tp, {"tokens": toks}, dispatch=d)
            .numpy() for d in DISPATCHES}
    for d, tol in (("sort", 2e-3), ("gshard:1", 2e-3), ("sortg:1", 2e-3),
                   ("sortg:4", 2e-2), ("gshard:2", 2e-2)):
        np.testing.assert_allclose(outs["einsum"], outs[d], atol=tol,
                                   rtol=tol)


def test_unknown_dispatch_raises(deepseek):
    _, tparams = _moe_layer(deepseek)
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_forward(tparams, torch.zeros(1, 4, deepseek[2].d_model),
                         deepseek[2].moe, dispatch="scatter")


# ---------------------------------------------------------------------------
# MLA and attention at Dqk != Dv
# ---------------------------------------------------------------------------


def _mla_pair(deepseek):
    jcfg, jp, tcfg, tp = deepseek
    spec_j = jmodel.attn_spec(jcfg, jmodel.layer_specs(jcfg)[0])
    spec_t = tmodel.attn_spec(tcfg, tmodel.layer_specs(tcfg)[0])
    return (jcfg, _jax_layers(jcfg, jp)[0]["mla"], spec_j,
            tcfg, tp["layers"][0]["mla"], spec_t)


def test_mla_forward_matches_reference(deepseek):
    jcfg, jparams, jspec, tcfg, tparams, tspec = _mla_pair(deepseek)
    x = _x(jcfg, 2, 20, 4)
    want = jattn.mla_forward(jparams, jnp.asarray(x), jcfg.mla, jspec)
    got = tattn.mla_forward(tparams, torch.from_numpy(x), tcfg.mla, tspec)
    assert got.shape == (2, 20, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("S,cache_len", [(12, 20), (20, 16)])
def test_mla_make_cache_and_decode_match_reference(deepseek, S, cache_len):
    """The prefill's output and latent cache (padded, or the last L
    positions when the prompt is longer), then absorbed-q decode steps'
    outputs and caches."""
    jcfg, jparams, jspec, tcfg, tparams, tspec = _mla_pair(deepseek)
    x = _x(jcfg, 2, S, 5)
    jout, jc = jattn.mla_make_cache(jparams, jnp.asarray(x), jcfg.mla,
                                    jspec, cache_len)
    tout, tc = tattn.mla_make_cache(tparams, torch.from_numpy(x), tcfg.mla,
                                    tspec, cache_len)
    _close(tout, jout)
    assert sorted(tc) == sorted(jc) == ["c_kv", "k_rope"]
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    if S >= cache_len:
        return
    for i in range(3):
        xt = _x(jcfg, 2, 1, 6 + i)
        pos = np.array([S + i, S + i - 3], np.int32)
        jout, jc = jattn.mla_decode(jparams, jnp.asarray(xt), jc, jcfg.mla,
                                    jspec, jnp.asarray(pos))
        tout, tc = tattn.mla_decode(tparams, torch.from_numpy(xt), tc,
                                    tcfg.mla, tspec,
                                    torch.from_numpy(pos).long())
        _close(tout, jout)
        for key in tc:
            _close(tc[key], jc[key])


@pytest.mark.parametrize("spec", [
    jattn.AttnSpec("global", True, 0, 0.0, 0.0, False, q_block=8),
    jattn.AttnSpec("global", False, 0, 0.0, 0.0, False, q_block=8),
    jattn.AttnSpec("local", True, 7, 0.0, 0.0, False, q_block=8),
    jattn.AttnSpec("chunked", True, 8, 0.0, 0.0, False, q_block=8),
    jattn.AttnSpec("global", True, 0, 0.0, 20.0, False, q_block=8)],
    ids=["global", "bidirectional", "local", "chunked", "softcap"])
def test_attention_with_a_narrower_v_matches_blockwise_attention(spec):
    """The plain version at Dqk 24 / Dv 16 (the deepseek smoke config's
    shape, scale 1/sqrt(24)), through ``ops.attention_op`` with and
    without the kernel wrapper (its plain version on the CPU), against
    the reference's ``blockwise_attention``; GQA 2:1."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 32, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), spec)
    kw = dict(causal=spec.causal, kind=spec.kind, window=spec.window,
              softcap=spec.softcap)
    n0 = flash_attention.launches
    for use_kernel in (True, False):
        got = ops.attention_op(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), use_kernel=use_kernel,
                               **kw)
        assert got.shape == (2, 32, 4, 16)
        _close(got, want)
    assert flash_attention.launches == n0       # CPU: nothing launched


# ---------------------------------------------------------------------------
# the MoE / MLA architectures end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_forward_matches_reference(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    toks = _tokens(jcfg, 2, 40, 0)
    want = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 40, tcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and every layer's cache, then 4 decode steps'
    logits and greedy tokens, against the reference (llama4's chunked
    layers past their smoke window of 16)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    B, S0, n_dec = 2, 21, 4
    toks = _tokens(jcfg, B, S0, 1)
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, 32)
    _close(tl, jl)
    for t_layer, j_layer in zip(tc, _jax_layers(jcfg, jc)):
        assert sorted(t_layer) == sorted(j_layer)
        for key in t_layer:
            assert tuple(t_layer[key].shape) == j_layer[key].shape
            _close(t_layer[key], j_layer[key])
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode_step(jcfg, p, t,
                                                              pos, c))
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok = tl.argmax(-1).numpy().astype(np.int32)
    for i in range(n_dec):
        np.testing.assert_array_equal(ttok, jtok)
        jl, jc = jdecode(jp, jnp.asarray(jtok),
                         jnp.full((B,), S0 + i, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(ttok).long(),
                                    torch.full((B,), S0 + i), tc)
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_greedy_tokens_match_reference_engine(arch):
    """Both serving engines, one instance of two slots, three requests:
    the same greedy tokens for every request (MLA caches and the MoE
    layers through slot splicing and batched decode)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    prompts = [np.random.default_rng(s).integers(
        0, tcfg.vocab_size, n).astype(np.int32)
        for s, n in zip((1, 2, 3), (9, 30, 17))]
    jeng = JServingEngine(jcfg, jp, slots=2, max_len=64)
    teng = ServingEngine(tcfg, tp, slots=2, max_len=64, device="cpu")
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.scale_up(1)
        for i, p in enumerate(prompts):
            eng.submit(req(i, p.copy(), 6))
    want = {r.rid: r.tokens for r in jeng.drain()}
    got = {r.rid: r.tokens for r in teng.drain()}
    assert got == want and len(got) == 3


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4, "internvl2-2b",
                                  "hubert-xlarge"])
def test_loss_matches_reference(arch):
    """The train loss (chunked xent plus the MoE layers' weighted
    load-balance loss; frontend tokens carry no targets) on the
    reference's batch, with and without remat."""
    jcfg, jp, tcfg, tp = _pair(arch)
    shape = jbase.InputShape("smoke", 32, 2, "train")
    jbatch = jsteps.make_train_batch(jcfg, shape)
    tbatch = tsteps.make_train_batch(tcfg, shape, device="cpu")
    assert sorted(tbatch) == sorted(jbatch)
    for key in jbatch:
        np.testing.assert_array_equal(tbatch[key].numpy(),
                                      np.asarray(jbatch[key]))
    want, wm = jsteps.loss_fn(jcfg, jp, jbatch)
    for remat in (False, True):
        got, gm = tsteps.loss_fn(tcfg, tp, tbatch, remat=remat)
        _close(got, want)
        assert abs(float(gm["aux"]) - float(wm["aux"])) <= AUX_TOL
    assert (float(wm["aux"]) > 0) == (tcfg.moe is not None)


# ---------------------------------------------------------------------------
# frontends and every non-encoder architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internvl2-2b", "hubert-xlarge"])
def test_frontend_forward_matches_reference(arch):
    """internvl2-2b: projected patch embeddings before the embedded
    tokens; hubert-xlarge: projected audio frames, encoder-only
    (bidirectional attention, logits from the embedding table)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(8)
    if tcfg.frontend == "audio":
        batch = {"frames": rng.standard_normal(
            (2, 24, tcfg.frontend_dim)).astype(np.float32)}
    else:
        batch = {"patch_embeds": rng.standard_normal(
            (2, tcfg.n_frontend_tokens, tcfg.frontend_dim)).astype(
                np.float32),
            "tokens": _tokens(tcfg, 2, 16, 9)}
    want = jmodel.forward(jcfg, jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got = tmodel.forward(tcfg, tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert got.shape == (2, 24, tcfg.vocab_size)
    assert "lm_head" not in tp or not tcfg.encoder_only
    assert all(not s.causal for s in tmodel.layer_specs(tcfg)) == \
        tcfg.encoder_only
    _close(got, want)


NON_ENCODER = [a for a in jbase.list_archs()
               if not jbase.get_config(a).encoder_only]


@pytest.mark.parametrize("arch", NON_ENCODER)
def test_prefill_decode_matches_forward(arch):
    """The port of the reference's ``test_prefill_decode_matches_forward``
    (capacity lifted for MoE so no token drops, as there): prefill of 24
    tokens and 3 teacher-forced decode steps match the full forward at
    those positions (tolerance 5e-3, as there), and each matches the JAX
    model's prefill / decode within 1e-4, as does the forward."""
    jcfg, jp, tcfg, tp = _pair(arch)
    if tcfg.moe is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=64.0))
    B, S0, n_dec = 2, 24, 4
    S = S0 + n_dec
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    n_front = 0
    if tcfg.frontend == "vision":
        n_front = tcfg.n_frontend_tokens
        batch["patch_embeds"] = rng.standard_normal(
            (B, n_front, tcfg.frontend_dim)).astype(np.float32)
    jfull = jmodel.forward(jcfg, jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    full = tmodel.forward(tcfg, tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    _close(full, jfull)
    pre = {k: (v[:, :S0] if k == "tokens" else v) for k, v in batch.items()}
    jl, jc = jmodel.prefill(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in pre.items()},
                            S + n_front)
    lg, cache = tmodel.prefill(tcfg, tp, {k: torch.from_numpy(v)
                                          for k, v in pre.items()},
                               S + n_front)
    _close(lg, jl)
    _close(lg, full[:, n_front + S0 - 1], 5e-3)
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode_step(jcfg, p, t,
                                                              pos, c))
    for i in range(n_dec - 1):
        pos = S0 + i + n_front
        jl, jc = jdecode(jp, jnp.asarray(toks[:, S0 + i]),
                         jnp.full((B,), pos, jnp.int32), jc)
        lg, cache = tmodel.decode_step(
            tcfg, tp, torch.from_numpy(toks[:, S0 + i]).long(),
            torch.full((B,), pos), cache)
        _close(lg, jl)
        _close(lg, full[:, n_front + S0 + i], 5e-3)


# ---------------------------------------------------------------------------
# pctx: hints on a mesh, the identity on plain tensors
# ---------------------------------------------------------------------------


def test_sharding_hints_redistribute_dtensors_on_a_one_rank_mesh(tmp_path):
    """Hints installed on a 1-rank gloo mesh: ``constrain`` redistributes
    a DTensor to the hint's placements (its values unchanged), skips a
    rank-mismatched site and a key without a hint, and returns a plain
    tensor as it is; the context is restored on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.sharding import NamedSharding, P
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        x = distribute_tensor(t, mesh, (Shard(0), Replicate()))
        plain = torch.ones(2, 3)
        hints = {"activations": NamedSharding(mesh, P(None, None, "model")),
                 "attn_q": NamedSharding(mesh, P("data", None, "model",
                                                 None))}
        with pctx.sharding_hints(hints):
            y = pctx.constrain(x, "activations")
            assert tuple(y.placements) == (Replicate(), Shard(2))
            assert torch.equal(y.full_tensor(), t)
            assert pctx.constrain(x, "attn_q") is x    # rank-mismatched
            assert pctx.constrain(x, "logits") is x     # no hint
            assert pctx.constrain(plain, "activations") is plain
            assert pctx.hint("attn_q") is hints["attn_q"]
        assert pctx.hint("activations") is None
        assert pctx.constrain(x, "activations") is x
    finally:
        dist.destroy_process_group()
