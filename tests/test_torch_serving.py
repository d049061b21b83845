"""The port's serving engine on the recurrentgemma smoke config, on the
CPU: the five cases of ``tests/test_serving.py`` (continuous batching,
cache splicing, dual-staged data-plane semantics), the same greedy
tokens as the JAX package's engine on the same weights, and no quiet
fallback to the CPU when the card is asked for and missing."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_cache, init_params, params_from_numpy
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


def test_greedy_tokens_match_reference_engine():
    """Both engines, one instance of two slots, the reference's weights,
    prompts longer and shorter than the smoke window of 16: the same
    greedy tokens for every request."""
    jcfg = jax_smoke_config(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    prompts = [np.random.default_rng(s).integers(
        0, cfg.vocab_size, n).astype(np.int32)
        for s, n in ((1, 9), (2, 30), (3, 17))]
    jeng = JServingEngine(jcfg, jp, slots=2, max_len=64)
    teng = _engine(cfg, params, slots=2, max_len=64)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.scale_up(1)
        for i, p in enumerate(prompts):
            eng.submit(req(i, p.copy(), 6))
    want = {r.rid: r.tokens for r in jeng.drain()}
    got = {r.rid: r.tokens for r in teng.drain()}
    assert got == want


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
