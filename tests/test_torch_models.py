"""The port's recurrentgemma model against the JAX package's on the same
weights (``params_from_numpy`` of the reference's ``init_params``), on
the CPU, and the port's copy of the configs against the reference's.

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
from repro_torch.models import model as tmodel
from repro_torch.models import params_from_numpy

ARCH = "recurrentgemma-2b"
TOL = 1e-4


@pytest.fixture(scope="module")
def both():
    jcfg = jbase.get_smoke_config(ARCH)
    tcfg = tbase.get_smoke_config(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jax_decode(cfg):
    return jax.jit(lambda p, t, pos, c: jmodel.decode_step(cfg, p, t, pos,
                                                           c))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


def _jax_layers(cfg, tree):
    """The reference's head / stacked body / tail tree as a per-layer
    list in layer order (the port's cache layout)."""
    _, period, n_periods, _ = jmodel.block_structure(cfg)
    out = list(tree["head"])
    for j in range(n_periods):
        for pi in range(len(period)):
            out.append(jax.tree.map(lambda a: a[j], tree["body"][f"p{pi}"]))
    return out + list(tree["tail"])


def test_converted_params_cover_the_reference(both):
    jcfg, jp, tcfg, tp = both
    layers = _jax_layers(jcfg, jp)
    assert len(tp["layers"]) == len(layers) == tcfg.n_layers
    for tl, jl in zip(tp["layers"], layers):
        flat_t = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), tl))[0]
        flat_j = jax.tree_util.tree_flatten_with_path(jl)[0]
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (_, a), (_, b) in zip(flat_t, flat_j):
            np.testing.assert_array_equal(a, np.asarray(b))


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


def test_long_prompt_ring_cache_matches_reference(both):
    """A prompt three windows long: prefill leaves the local layers' ring
    cache rolled; decoding past it matches the reference's decode and
    both models' full forward."""
    jcfg, jp, tcfg, tp = both
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
        _close(tl, jl)
    _close(tl, jfull[:, -1])


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


@pytest.mark.parametrize("arch,what", [("mamba2-2.7b", "ssd_scan"),
                                       ("deepseek-v2-236b", "MoE"),
                                       ("llama4-maverick-400b-a17b", "MoE")])
def test_unported_layers_raise_naming_their_slice(arch, what):
    cfg = tbase.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=what):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


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
