"""The port's recurrentgemma and mamba2 models against the JAX package's
on the same weights (``params_from_numpy`` of the reference's
``init_params``), on the CPU, gemma2-2b's ring cache past three local
windows, and the port's copy of the configs against the reference's.

Tolerance on logits: 1e-4 absolute and relative, f32 (smoke configs run
in f32; the port's serial scan and flash-style attention sum in another
order than the reference's associative scan and q-block scan)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import profiles as jprofiles
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.core import profiles as tprofiles
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import model as tmodel
from repro_torch.models import params_from_numpy

ARCH = "recurrentgemma-2b"
TOL = 1e-4


def _models(arch):
    jcfg = jbase.get_smoke_config(arch)
    tcfg = tbase.get_smoke_config(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def both():
    return _models(ARCH)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jax_decode(cfg):
    return jax.jit(lambda p, t, pos, c: jmodel.decode_step(cfg, p, t, pos,
                                                           c))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _jax_layers(cfg, tree):
    """The reference's head / stacked body / tail tree as a per-layer
    list in layer order (the port's cache layout)."""
    _, period, n_periods, _ = jmodel.block_structure(cfg)
    out = list(tree["head"])
    for j in range(n_periods):
        for pi in range(len(period)):
            out.append(jax.tree.map(lambda a: a[j], tree["body"][f"p{pi}"]))
    return out + list(tree["tail"])


def _check_conversion(jcfg, jp, tcfg, tp):
    """Every leaf of every layer converted, values and dtypes kept."""
    layers = _jax_layers(jcfg, jp)
    assert len(tp["layers"]) == len(layers) == tcfg.n_layers
    for tl, jl in zip(tp["layers"], layers):
        flat_t = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), tl))[0]
        flat_j = jax.tree_util.tree_flatten_with_path(jl)[0]
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (_, a), (_, b) in zip(flat_t, flat_j):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_converted_params_cover_the_reference(both):
    _check_conversion(*both)


def test_init_params_shapes_match_the_reference(both):
    """The port's own init draws other numbers but the same tree of
    shapes and dtypes; a_param stays f32 under bf16 weights."""
    jcfg, _, tcfg, _ = both
    gen = torch.Generator().manual_seed(0)
    own = tmodel.init_params(tcfg, gen, "cpu")
    ref = params_from_numpy(
        tcfg, jax.tree.map(np.asarray,
                           jmodel.init_params(jcfg, jax.random.PRNGKey(1))),
        device="cpu")
    shapes = lambda p: jax.tree.map(lambda t: (tuple(t.shape), t.dtype), p)
    assert shapes(own) == shapes(ref)
    half = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                              param_dtype=torch.bfloat16)
    rec = next(p for p in half["layers"] if "rglru" in p)
    assert rec["rglru"]["a_param"].dtype == torch.float32
    assert rec["rglru"]["w_x"].dtype == torch.bfloat16


def test_dense_init_draws_a_large_tensor_a_slice_at_a_time(monkeypatch):
    """Above ``WHOLE_DRAW_BYTES`` of f32 a tensor is drawn one slice of
    its first axis at a time (llama4-maverick's stacked experts at
    published width): the shape and dtype asked for, every value within
    2 std of 0 (std 1/sqrt(fan-in)), and the slices each drawn from the
    generator in turn, as three draws of one slice would be."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "WHOLE_DRAW_BYTES", 64 * 32 * 4)
    got = layers.dense_init(torch.Generator().manual_seed(4), (3, 64, 32),
                            64, torch.bfloat16)
    assert got.shape == (3, 64, 32) and got.dtype == torch.bfloat16
    assert float(got.float().abs().max()) <= 2.0 / 8
    gen = torch.Generator().manual_seed(4)
    want = torch.stack([layers.dense_init(gen, (64, 32), 64)
                        for _ in range(3)]).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_forward_matches_reference(both):
    jcfg, jp, tcfg, tp = both
    toks = _tokens(jcfg, 2, 40, 0)
    want = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 40, tcfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_reference(both):
    """Prefill logits and cache, then 4 decode steps' logits and greedy
    tokens, against the reference."""
    jcfg, jp, tcfg, tp = both
    B, S0, n_dec = 2, 24, 4
    S = S0 + n_dec
    toks = _tokens(jcfg, B, S0, 1)
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, S)
    n0 = flash_attention.launches, rglru_scan.launches
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, S)
    assert (flash_attention.launches, rglru_scan.launches) == n0  # CPU
    _close(tl, jl)
    for t_layer, j_layer in zip(tc, _jax_layers(jcfg, jc)):
        assert sorted(t_layer) == sorted(j_layer)
        for key in t_layer:
            assert tuple(t_layer[key].shape) == j_layer[key].shape
            _close(t_layer[key], j_layer[key])
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok = tl.argmax(-1).numpy().astype(np.int32)
    jdecode = _jax_decode(jcfg)
    for i in range(n_dec):
        np.testing.assert_array_equal(ttok, jtok)
        pos = S0 + i
        jl, jc = jdecode(jp, jnp.asarray(jtok),
                         jnp.full((B,), pos, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(ttok).long(),
                                    torch.full((B,), pos), tc)
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("S0,n_dec", [(24, 4), (40, 8)])
def test_prefill_decode_matches_own_forward(both, S0, n_dec):
    """Teacher forcing: prefill(S0) + decode of the next tokens equals
    the port's own full forward at those positions.  S0 = 40 is past the
    smoke window of 16, so the local layers' ring cache wraps."""
    _, _, tcfg, tp = both
    B = 2
    S = S0 + n_dec
    toks = torch.from_numpy(_tokens(tcfg, B, S, 2)).long()
    full = tmodel.forward(tcfg, tp, {"tokens": toks})
    lg, cache = tmodel.prefill(tcfg, tp, {"tokens": toks[:, :S0]}, S)
    _close(lg, full[:, S0 - 1])
    for i in range(S0, S):
        lg, cache = tmodel.decode_step(tcfg, tp, toks[:, i],
                                       torch.full((B,), i), cache)
        _close(lg, full[:, i])


#: the ring-cache case per arch and its tolerance: recurrentgemma's (the
#: file's), and gemma2-2b's alternating local / global attention with
#: softcaps at the 5e-3 of the reference's own ring test
#: (``tests/test_models.py:178``)
RING_TOL = {ARCH: TOL, "gemma2-2b": 5e-3}


@pytest.mark.parametrize("arch", sorted(RING_TOL))
def test_long_prompt_ring_cache_matches_reference(arch, both):
    """A prompt three windows long: prefill leaves the local layers' ring
    cache rolled; decoding past it matches the reference's decode and
    both models' full forward."""
    jcfg, jp, tcfg, tp = both if arch == ARCH else _models(arch)
    tol = RING_TOL[arch]
    W = tcfg.window
    S = 3 * W
    toks = _tokens(jcfg, 1, S, 3)
    jfull = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S - 8])},
                            S)
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S - 8]).long()}, S)
    local = [i for i, k in enumerate(tcfg.layer_kinds()) if k == "local"]
    assert local and all(tc[i]["k"].shape[1] == W for i in local)
    jdecode = _jax_decode(jcfg)
    for i in range(S - 8, S):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i]),
                         jnp.full((1,), i, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tcfg, tp,
                                    torch.from_numpy(toks[:, i]).long(),
                                    torch.full((1,), i), tc)
        _close(tl, jl, tol)
    _close(tl, jfull[:, -1], tol)


def test_rglru_state_carries_across_a_split_prompt(both):
    """``rglru_forward`` given the state of a first chunk continues the
    conv and the recurrence (the scan's h0): the two halves equal one
    pass, and the reference's ``rglru_forward`` with the same state."""
    from repro.models import rglru as jrglru
    from repro_torch.models import rglru as trglru
    jcfg, jp, tcfg, tp = both
    li = tcfg.layer_kinds().index("recurrent")
    tparams = tp["layers"][li]["rglru"]
    jparams = _jax_layers(jcfg, jp)[li]["rglru"]
    x = np.random.default_rng(4).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    args = (tcfg.n_heads, tcfg.rglru)
    whole = trglru.rglru_forward(tparams, tx, *args)
    first, state = trglru.rglru_forward(tparams, tx[:, :11], *args,
                                        return_state=True)
    second = trglru.rglru_forward(tparams, tx[:, 11:], *args,
                                  state={k: v.clone()
                                         for k, v in state.items()})
    _close(torch.cat([first, second], dim=1), whole)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    _close(second, jrglru.rglru_forward(jparams, jnp.asarray(x[:, 11:]),
                                        *args, state=jstate))


# ---------------------------------------------------------------------------
# configs: a copy, not an import
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference_field_by_field():
    assert tbase.list_archs() == jbase.list_archs()
    assert sorted(tbase.SMOKE_REGISTRY) == sorted(jbase.SMOKE_REGISTRY)
    pairs = ([(tbase.get_config(a), jbase.get_config(a))
              for a in jbase.list_archs()]
             + [(tbase.get_smoke_config(a), jbase.get_smoke_config(a))
                for a in jbase.SMOKE_REGISTRY])
    for t, j in pairs:
        assert type(t).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(t) == dataclasses.asdict(j), j.name
        assert t.param_count() == j.param_count()
        assert t.layer_kinds() == j.layer_kinds()
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]
    assert tbase.get_config(ARCH).param_count() == 2_682_096_640


def test_arch_functions_equal_the_reference():
    got, want = tprofiles.arch_functions(), jprofiles.arch_functions()
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])


# ---------------------------------------------------------------------------
# mamba2: SSD layers only (the smoke config made two layers deep, so the
# cache and the per-layer conversion are a list of more than one)
# ---------------------------------------------------------------------------

MAMBA = "mamba2-2.7b"


@pytest.fixture(scope="module")
def mamba():
    jcfg = jbase.get_smoke_config(MAMBA).replace(n_layers=2)
    tcfg = tbase.get_smoke_config(MAMBA).replace(n_layers=2)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def test_mamba_converted_params_cover_the_reference(mamba):
    """Every ``ssd`` leaf of every layer converted, values and dtypes
    kept; the port's own init has the same tree of shapes and dtypes,
    with A_log, D and dt_bias f32 under bf16 weights."""
    jcfg, jp, tcfg, tp = mamba
    _check_conversion(*mamba)
    assert sorted(tp["layers"][0]["ssd"]) == sorted(
        ["w_in", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm",
         "w_out"])
    shapes = lambda p: jax.tree.map(lambda t: (tuple(t.shape), t.dtype), p)
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert shapes(own) == shapes(tp)
    half = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                              param_dtype=torch.bfloat16)
    ssd = half["layers"][1]["ssd"]
    assert {k: ssd[k].dtype for k in ("A_log", "D", "dt_bias")} == \
        dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)
    assert ssd["w_in"].dtype == torch.bfloat16


def test_mamba_forward_matches_reference(mamba):
    jcfg, jp, tcfg, tp = mamba
    toks = _tokens(jcfg, 2, 37, 0)      # 37: a ragged last chunk
    want = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 37, tcfg.vocab_size)
    _close(got, want)


def test_mamba_prefill_and_decode_match_reference(mamba):
    """Prefill logits and every layer's cache (the SSM state h in the
    compute dtype and the conv tail), then 4 decode steps' logits and
    greedy tokens, against the reference."""
    jcfg, jp, tcfg, tp = mamba
    B, S0, n_dec = 2, 21, 4
    toks = _tokens(jcfg, B, S0, 1)
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    n0 = ssd_scan.launches
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, 32)
    assert ssd_scan.launches == n0      # CPU: the plain version
    _close(tl, jl)
    jlayers = _jax_layers(jcfg, jc)
    assert len(tc) == len(jlayers) == 2
    for t_layer, j_layer in zip(tc, jlayers):
        assert sorted(t_layer) == sorted(j_layer) == ["conv", "h"]
        for key in t_layer:
            assert tuple(t_layer[key].shape) == j_layer[key].shape
            assert str(t_layer[key].dtype).split(".")[-1] == \
                str(j_layer[key].dtype)
            _close(t_layer[key], j_layer[key])
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok = tl.argmax(-1).numpy().astype(np.int32)
    jdecode = _jax_decode(jcfg)
    for i in range(n_dec):
        np.testing.assert_array_equal(ttok, jtok)
        pos = S0 + i
        jl, jc = jdecode(jp, jnp.asarray(jtok),
                         jnp.full((B,), pos, jnp.int32), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(ttok).long(),
                                    torch.full((B,), pos), tc)
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
    np.testing.assert_array_equal(ttok, jtok)
    for t_layer, j_layer in zip(tc, _jax_layers(jcfg, jc)):
        for key in t_layer:
            _close(t_layer[key], j_layer[key])


@pytest.mark.parametrize("S0,n_dec", [(2, 6), (16, 8), (29, 4)])
def test_mamba_prefill_decode_matches_own_forward(mamba, S0, n_dec):
    """Teacher forcing: prefill(S0) + decode of the next tokens equals
    the port's own full forward at those positions.  S0 = 2 is shorter
    than the conv's tail of 3 (the tail is zero-padded)."""
    _, _, tcfg, tp = mamba
    B = 2
    S = S0 + n_dec
    toks = torch.from_numpy(_tokens(tcfg, B, S, 2)).long()
    full = tmodel.forward(tcfg, tp, {"tokens": toks})
    lg, cache = tmodel.prefill(tcfg, tp, {"tokens": toks[:, :S0]}, S)
    _close(lg, full[:, S0 - 1])
    for i in range(S0, S):
        lg, cache = tmodel.decode_step(tcfg, tp, toks[:, i],
                                       torch.full((B,), i), cache)
        _close(lg, full[:, i])


def test_ssd_state_carries_across_a_split_prompt(mamba):
    """``ssd_forward`` given the state of a first part of the prompt
    continues the conv and the scan (the kernel's h0): the two parts
    equal the port's one pass and the reference's ``ssd_forward`` over
    the whole prompt."""
    from repro.models import ssd as jssd
    from repro_torch.models import ssd as tssd
    jcfg, jp, tcfg, tp = mamba
    tparams = tp["layers"][0]["ssd"]
    jparams = _jax_layers(jcfg, jp)[0]["ssd"]
    x = np.random.default_rng(4).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    whole = tssd.ssd_forward(tparams, tx, tcfg.ssd)
    first, state = tssd.ssd_forward(tparams, tx[:, :11], tcfg.ssd,
                                    return_state=True)
    second = tssd.ssd_forward(tparams, tx[:, 11:], tcfg.ssd,
                              state={k: v.clone() for k, v in state.items()})
    _close(torch.cat([first, second], dim=1), whole)
    _close(torch.cat([first, second], dim=1),
           jssd.ssd_forward(jparams, jnp.asarray(x), jcfg.ssd))


#: the smoke architectures whose decode caches hold every layer kind's
#: leaves: attention k / v (local, and global with gemma2-2b), RG-LRU h
#: and conv, SSD h and conv, MLA c_kv and k_rope
IN_PLACE_ARCHS = {"recurrentgemma-2b": {"k", "v", "h", "conv"},
                  "gemma2-2b": {"k", "v"},
                  "mamba2-2.7b": {"h", "conv"},
                  "deepseek-v2-236b": {"c_kv", "k_rope"}}


def _out_of_place(state, key, value, slot=None):
    """``layers.write_state`` as decode wrote its cache before the step
    was captured: a new tensor for the entry (a slot write into a copy)."""
    if slot is None:
        state[key] = value.to(state[key].dtype).contiguous()
    else:
        buf = state[key].clone()
        buf[torch.arange(buf.shape[0]), slot] = value[:, 0]
        state[key] = buf
    return state[key]


@pytest.mark.parametrize("arch", sorted(IN_PLACE_ARCHS))
def test_decode_writes_every_cache_leaf_in_place(arch, monkeypatch):
    """Three decode steps after a prefill (two rows, caches of 40, the
    local ring wrapped past the smoke window of 16 on the third step) keep
    every cache leaf of every layer at its ``data_ptr()``, with values
    and logits bitwise those of the same steps writing new tensors."""
    from repro_torch.models import attention, layers, rglru, ssd
    cfg = tbase.get_smoke_config(arch)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    S0, B = 14, 2
    toks = torch.from_numpy(_tokens(cfg, B, S0 + 3, 4)).long()
    _, cache = tmodel.prefill(cfg, params, {"tokens": toks[:, :S0]}, 40)
    assert {k for layer in cache for k in layer} == IN_PLACE_ARCHS[arch]
    fresh = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    ptrs = [{k: t.data_ptr() for k, t in layer.items()} for layer in cache]
    got = []
    for i in range(3):
        lg, out = tmodel.decode_step(cfg, params, toks[:, S0 + i],
                                     torch.full((B,), S0 + i), cache)
        assert out is cache
        got.append(lg)
    assert [{k: t.data_ptr() for k, t in layer.items()}
            for layer in cache] == ptrs
    for module in (attention, layers, rglru, ssd):
        if hasattr(module, "write_state"):
            monkeypatch.setattr(module, "write_state", _out_of_place)
    want = fresh
    for i in range(3):
        lg, want = tmodel.decode_step(cfg, params, toks[:, S0 + i],
                                      torch.full((B,), S0 + i), want)
        assert torch.equal(lg, got[i])
    for layer, old, ptr in zip(cache, want, ptrs):
        for key in layer:
            assert old[key].data_ptr() != ptr[key]
            assert torch.equal(layer[key], old[key]), key
