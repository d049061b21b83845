"""The port's serving engine on the recurrentgemma smoke config, on the
CPU: the five cases of ``tests/test_serving.py`` (continuous batching,
cache splicing, dual-staged data-plane semantics), the same greedy
tokens as the JAX package's engine on the same weights (every smoke
architecture that decodes; internvl2-2b, whose prefill takes patch
embeddings the reference's engine cannot pass, by ``decode_step``
against the reference's), the SSM state spliced into a slot, the
graphed decode step running eagerly on the CPU, and no quiet fallback to
the CPU when the card is asked for and missing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_numpy, prefill)
from repro_torch.serving.engine import (Request, ServingEngine,
                                        ServingInstance)

ARCH = "recurrentgemma-2b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _engine(cfg, params, **kw):
    return ServingEngine(cfg, params, device="cpu", **kw)


def _req(rid, cfg, n=12, max_new=4, seed=None):
    rng = np.random.default_rng(seed if seed is not None else rid)
    return Request(rid=rid, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=max_new)


def test_all_requests_complete(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=2, max_len=64)
    eng.scale_up(2)
    for i in range(7):
        eng.submit(_req(i, cfg))
    done = eng.drain()
    assert len(done) == 7
    assert all(len(r.tokens) == 4 for r in done)
    assert all(r.t_done is not None and r.t_first_token is not None
               and r.t_admit is not None for r in done)


def test_batched_decode_matches_single_instance(setup):
    """Splicing a prefill into a slot then batch-decoding equals running
    the request alone (greedy tokens identical)."""
    cfg, params = setup
    req_a = _req(0, cfg, n=10, max_new=5, seed=42)
    req_b = _req(1, cfg, n=14, max_new=5, seed=43)
    solo = _engine(cfg, params, slots=1, max_len=64)
    solo.scale_up(1)
    solo.submit(Request(0, req_a.prompt.copy(), 5))
    tokens_solo = solo.drain()[0].tokens

    both = _engine(cfg, params, slots=2, max_len=64)
    both.scale_up(1)
    both.submit(Request(0, req_a.prompt.copy(), 5))
    both.submit(Request(1, req_b.prompt.copy(), 5))
    done = both.drain()
    tokens_shared = next(r for r in done if r.rid == 0).tokens
    assert tokens_solo == tokens_shared


def test_release_stops_traffic_logical_start_resumes(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=2, max_len=64)
    eng.scale_up(2)
    eng.release(1)
    assert eng.n_saturated() == 1
    for i in range(3):
        eng.submit(_req(i, cfg, max_new=2))
    eng.tick()
    cached_inst = [eng.instances[i] for i in eng.cached]
    assert all(inst.n_active() == 0 for inst in cached_inst)
    eng.logical_start(1)
    assert eng.n_saturated() == 2
    done = eng.drain()
    assert len(done) == 3


def test_evict_cached_removes_instances(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=1, max_len=32)
    eng.scale_up(3)
    eng.release(2)
    assert eng.evict_cached(2) == 2
    assert len(eng.instances) == 1
    assert eng.n_saturated() == 1


def test_instance_slot_reuse(setup):
    cfg, params = setup
    inst = ServingInstance(cfg, params, slots=1, max_len=64, device="cpu")
    r1 = _req(0, cfg, max_new=2)
    assert inst.admit(r1)
    assert not inst.admit(_req(1, cfg))  # full
    while inst.n_active():
        inst.step()
    assert inst.admit(_req(2, cfg, max_new=2))  # slot reusable


def _greedy_tokens_of_both_engines(arch, lengths):
    """Both engines, one instance of two slots, the reference's weights:
    the greedy tokens of every request, (JAX, port)."""
    jcfg = jax_smoke_config(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    prompts = [np.random.default_rng(s).integers(
        0, cfg.vocab_size, n).astype(np.int32)
        for s, n in zip((1, 2, 3), lengths)]
    jeng = JServingEngine(jcfg, jp, slots=2, max_len=64)
    teng = _engine(cfg, params, slots=2, max_len=64)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.scale_up(1)
        for i, p in enumerate(prompts):
            eng.submit(req(i, p.copy(), 6))
    return ({r.rid: r.tokens for r in jeng.drain()},
            {r.rid: r.tokens for r in teng.drain()})


#: every smoke architecture with a decode step (hubert-xlarge is an
#: encoder); internvl2-2b's prefill takes patch embeddings
DECODING = [a for a in list_archs()
            if not get_smoke_config(a).encoder_only]


def _greedy_tokens_by_decode_step(arch, lengths, n_new=6):
    """The frontend architectures: the reference's engine passes a
    request's tokens alone, so the same prompts (each after its own
    patch embeddings from the seed) go through ``model.prefill`` and
    greedy ``model.decode_step`` calls of both packages, one request a
    batch row; the greedy tokens of each row, (JAX, port)."""
    jcfg = jax_smoke_config(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    rng = np.random.default_rng(1)
    n_front, S = cfg.n_frontend_tokens, min(lengths)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (len(lengths), S)
                                    ).astype(np.int32),
             "patch_embeds": rng.standard_normal(
                 (len(lengths), n_front, cfg.frontend_dim)
             ).astype(np.float32)}
    L = n_front + S + n_new
    jl, jc = jmodel.prefill(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, L)
    tl, tc = prefill(cfg, params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, L)
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode_step(jcfg, p, t,
                                                              pos, c))
    want = [np.asarray(jnp.argmax(jl, -1))]
    got = [tl.argmax(-1).numpy()]
    for i in range(n_new - 1):
        pos = n_front + S + i
        jl, jc = jdecode(jp, jnp.asarray(want[-1], jnp.int32),
                         jnp.full((len(lengths),), pos, jnp.int32), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(got[-1]).long(),
                             torch.full((len(lengths),), pos), tc)
        want.append(np.asarray(jnp.argmax(jl, -1)))
        got.append(tl.argmax(-1).numpy())
    return ({i: [int(t[i]) for t in want] for i in range(len(lengths))},
            {i: [int(t[i]) for t in got] for i in range(len(lengths))})


@pytest.mark.parametrize("arch", DECODING)
def test_every_decoding_arch_greedy_tokens_match_reference(arch):
    """Every smoke architecture that decodes, prompts shorter and longer
    than the smoke window of 16: the same greedy tokens as the JAX
    package's engine for every request, through the port's engine (its
    decode step the graphed one, run eagerly on the CPU); internvl2-2b
    by ``decode_step`` against the reference's."""
    if get_smoke_config(arch).frontend is not None:
        want, got = _greedy_tokens_by_decode_step(arch, (9, 30, 17))
    else:
        want, got = _greedy_tokens_of_both_engines(arch, (9, 30, 17))
    assert got == want


def test_greedy_tokens_match_reference_engine():
    """recurrentgemma, prompts longer and shorter than the smoke window of
    16: the same greedy tokens for every request."""
    want, got = _greedy_tokens_of_both_engines(ARCH, (9, 30, 17))
    assert got == want


def test_mamba2_greedy_tokens_match_reference_engine():
    """mamba2, prompts that leave a ragged last chunk of the smoke chunk
    of 8: the same greedy tokens for every request."""
    want, got = _greedy_tokens_of_both_engines("mamba2-2.7b", (13, 17, 21))
    assert got == want


def test_spliced_ssm_state_equals_a_batch_one_prefill():
    """mamba2, two layers: admitting a request into slot 1 of a busy
    instance copies every layer's SSM state h and conv tail into that
    slot's rows, equal to a batch-1 prefill of the prompt, and leaves
    slot 0's rows as they were."""
    cfg = get_smoke_config("mamba2-2.7b").replace(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    inst = ServingInstance(cfg, params, slots=2, max_len=64, device="cpu")
    assert inst.admit(_req(0, cfg, n=11, max_new=4))
    before = [{k: v[0].clone() for k, v in layer.items()}
              for layer in inst.cache]
    req = _req(1, cfg, n=19, max_new=4)
    assert inst.admit(req)
    _, want = prefill(cfg, params, {"tokens": torch.from_numpy(
        req.prompt[None].astype(np.int64))}, 64)
    assert len(inst.cache) == len(want) == 2
    for layer, one, kept in zip(inst.cache, want, before):
        assert sorted(layer) == ["conv", "h"]
        for key in layer:
            torch.testing.assert_close(layer[key][1], one[key][0], rtol=0,
                                       atol=0)
            torch.testing.assert_close(layer[key][0], kept[key], rtol=0,
                                       atol=0)


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serving_entry_points_need_the_card_unless_asked(no_card, setup):
    cfg, params = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingInstance(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, {})
    assert ServingEngine(cfg, params, device="cpu").device.type == "cpu"


def test_graphed_step_runs_eagerly_on_the_cpu(setup):
    """``graph=True`` (the default) on the CPU: the step runs eagerly, no
    graph is captured or replayed, and the tokens and the step's logits
    are bitwise those of ``graph=False``; evicting an instance closes
    its step."""
    cfg, params = setup
    runs = []
    for graph in (True, False):
        inst = ServingInstance(cfg, params, slots=2, max_len=64,
                               device="cpu", graph=graph)
        assert not inst.decoder.graphed
        reqs = [_req(0, cfg, n=10, max_new=5), _req(1, cfg, n=21, max_new=5)]
        for r in reqs:
            assert inst.admit(r)
        logits = []
        while inst.n_active():
            inst.step()
            logits.append(inst.decoder.logits.clone())
        assert inst.decoder.graph is None and inst.decoder.replays == 0
        assert inst.decoder.capture_ms is None
        runs.append(([r.tokens for r in reqs], logits))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1]) == 4
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    eng = _engine(cfg, params, slots=1, max_len=32)
    iid = eng.scale_up(1)[0]
    inst = eng.instances[iid]
    eng.submit(_req(0, cfg, max_new=2))
    eng.drain()
    assert inst.decoder.logits is not None
    eng.release(1)
    assert eng.evict_cached(1) == 1
    assert inst.decoder.logits is None and inst.decoder.graph is None


def test_graphed_instance_needs_the_card_unless_asked(no_card, setup):
    """A graphed instance or engine asked for the card without one raises
    as every entry point does; asked for the CPU, it runs eagerly."""
    cfg, params = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingInstance(cfg, params, graph=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, graph=True)
    inst = ServingInstance(cfg, params, device="cpu", graph=True)
    assert inst.device.type == "cpu" and not inst.decoder.graphed
