"""The train step captured in a CUDA graph (``distributed.steps.TrainStep``),
on the CPU: what it does where there is no card, its binding to a state
held with a stand-in graph that runs the step only when replayed, the
in-place step count against the reference's schedule, the step's
random draws (none, so remat stashes no RNG state) and the kernels'
scratch kept for a graph.  The card's tests, graphed against eager
bitwise, are in ``tests/test_torch_on_card.py`` (``-k graph``).

The same numpy-drawn batches go through the port's step; the reference
(``repro.optim.adamw.schedule``) is compared within 1e-6, as AdamW's
other CPU tests hold it."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.distributed import make_train_step
from repro_torch.distributed import steps as steps_mod
from repro_torch.kernels import _scratch
from repro_torch.launch.train import build_state
from repro_torch.models.steps import make_train_batch
from repro_torch.optim import adamw as tadamw

SHAPE = tbase.InputShape("t", 32, 2, "train")
OPT = tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b")


def _cfg(arch):
    cfg = tbase.get_smoke_config(arch)
    return cfg.replace(n_layers=2) if arch == "mamba2-2.7b" else cfg


def _batches(cfg, n, shape=SHAPE):
    return [make_train_batch(cfg, shape, np.random.default_rng(20 + i), "cpu")
            for i in range(n)]


def _assert_states_equal(a, b):
    ta, tb = steps_mod._tensors(a), steps_mod._tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_step_on_cpu_is_the_bare_body_bitwise(arch, microbatch):
    """On the CPU ``make_train_step``'s ``fn`` is a ``TrainStep`` that
    runs its ``body`` eagerly even with ``graph=True``: three steps give
    every metric and every parameter, moment and the step count bitwise
    the bare body's on a state from the same seed; nothing captured."""
    cfg = _cfg(arch)
    bundle = make_train_step(cfg, None, SHAPE, OPT, microbatch=microbatch,
                             device="cpu", graph=True)
    fn = bundle.fn
    assert isinstance(fn, steps_mod.TrainStep) and not fn.graphed
    s_fn, s_body = (build_state(cfg, OPT, 0, "cpu") for _ in range(2))
    for b in _batches(cfg, 3):
        s_fn, m_fn = fn(s_fn, b)
        s_body, m_body = fn.body(s_body, {k: v.clone() for k, v in b.items()})
        assert m_fn.keys() == m_body.keys()
        for k in m_fn:
            assert torch.equal(m_fn[k], m_body[k]), k
    _assert_states_equal(s_fn, s_body)
    assert int(s_fn["opt"].step) == 3
    assert fn.graph is None and fn.captures == fn.replays == 0


def test_step_count_advances_in_place_on_the_reference_schedule():
    """The update advances the state's own step tensor (so that a graph
    replaying it moves the count): steps 1-3 give an ``lr`` bitwise the
    port's ``schedule`` at 1, 2, 3 and within 1e-6 of the reference's,
    warmup and cosine decay both crossed."""
    cfg = _cfg("recurrentgemma-2b")
    fn = make_train_step(cfg, None, SHAPE, OPT, device="cpu").fn
    state = build_state(cfg, OPT, 0, "cpu")
    count = state["opt"].step
    jcfg = jadamw.AdamWConfig(**OPT._asdict())
    for i, b in enumerate(_batches(cfg, 3), start=1):
        state, m = fn(state, b)
        assert state["opt"].step is count and int(count) == i
        assert count.dtype == torch.int32
        assert torch.equal(m["lr"], tadamw.schedule(OPT, i))
        want = float(jadamw.schedule(jcfg, jnp.int32(i)))
        assert math.isclose(float(m["lr"]), want, rel_tol=1e-6), (i, want)


def test_graph_without_a_card_raises_unless_the_cpu_is_named(monkeypatch):
    """The train step asked for the card without one raises, as every
    entry point does (``graph=True`` is the default); named the CPU it
    builds and runs eagerly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg("recurrentgemma-2b")
    for kw in ({}, {"graph": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_train_step(cfg, None, SHAPE, OPT, **kw)
    fn = make_train_step(cfg, None, SHAPE, OPT, device="cpu", graph=True).fn
    assert not fn.graphed
    state, m = fn(build_state(cfg, OPT, 0, "cpu"), _batches(cfg, 1)[0])
    assert math.isfinite(float(m["loss"]))


class _StandInGraph:
    """What ``serving.engine.capture`` returns, with the step recorded
    and run only at ``replay``, its metrics written into the same
    tensors each time, as a CUDA graph writes its outputs."""

    def __init__(self, run):
        self.run, self.metrics = run, {}

    def replay(self):
        _, m = self.run()
        for k, v in m.items():
            self.metrics.setdefault(k, torch.empty_like(v)).copy_(v)


@pytest.fixture
def stand_in(monkeypatch):
    """``TrainStep``'s warm-up and capture replaced by the stand-in
    graph's, and the device synchronise by nothing, so that the graphed
    path's bookkeeping runs on the CPU."""
    made = []

    def capture(device, run, pool_for=None):
        made.append(_StandInGraph(run))
        return made[-1], (None, made[-1].metrics), [], 0

    monkeypatch.setattr(steps_mod, "warm_up", lambda device, run: run())
    monkeypatch.setattr(steps_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return made


def test_a_state_at_other_addresses_is_captured_anew(stand_in):
    """With the stand-in graph: the first call on a state runs the step
    eagerly and captures it; later calls on that state replay on the
    batch copied into the static buffers; a state whose tensors lie
    elsewhere (a copy, as a restored checkpoint is) is captured anew,
    never replayed on the old one.  Each state ends bitwise the bare
    body's after as many steps; the metrics returned are copies that a
    later replay leaves alone; a batch of another shape raises."""
    cfg = _cfg("recurrentgemma-2b")
    bundle = make_train_step(cfg, None, SHAPE, OPT, device="cpu")
    fn, body = bundle.fn, bundle.fn.body
    fn.graphed = True
    a = build_state(cfg, OPT, 0, "cpu")
    b = steps_mod._map2(lambda t, _s: t.clone(), a, a)
    want_a = steps_mod._map2(lambda t, _s: t.clone(), a, a)
    want_b = steps_mod._map2(lambda t, _s: t.clone(), a, a)
    batches = _batches(cfg, 3)
    held = []
    for i, x in enumerate(batches):
        a, m = fn(a, x)
        want_a, w = body(want_a, {k: v.clone() for k, v in x.items()})
        assert torch.equal(m["loss"], w["loss"]), i
        held.append(m)
    assert (fn.captures, fn.replays, len(stand_in)) == (1, 2, 1)
    assert all(m["loss"] is not fn.metrics["loss"] for m in held)
    first = held[1]["loss"].clone()
    for i, x in enumerate(batches[:2]):
        b, m = fn(b, x)
        want_b, w = body(want_b, {k: v.clone() for k, v in x.items()})
        assert torch.equal(m["loss"], w["loss"]), i
    assert (fn.captures, fn.replays, len(stand_in)) == (2, 3, 2)
    assert torch.equal(held[1]["loss"], first)
    _assert_states_equal(a, want_a)
    _assert_states_equal(b, want_b)
    other = make_train_batch(cfg, tbase.InputShape("t", 16, 2, "train"),
                             np.random.default_rng(0), "cpu")
    with pytest.raises(ValueError, match="captured step"):
        fn(b, other)
    fn.close()
    assert fn.graph is None and fn.batch is None and fn.metrics is None


@pytest.mark.parametrize("arch", tuple(tbase.list_archs()))
def test_train_step_draws_no_random_numbers(arch):
    """One train step with remat of every architecture's smoke model
    leaves the CPU generator's state as it was: the model draws no
    random numbers, so remat's recomputation needs no stashed RNG state
    (``preserve_rng_state=False``, which a graph capture requires) and
    gives the same gradients."""
    cfg = _cfg(arch)
    fn = make_train_step(cfg, None, SHAPE, OPT, remat=True, device="cpu").fn
    state = build_state(cfg, OPT, 0, "cpu")
    batch = _batches(cfg, 1)[0]
    before = torch.get_rng_state()
    _, m = fn(state, batch)
    assert torch.equal(torch.get_rng_state(), before)
    assert math.isfinite(float(m["loss"]))


def test_scratch_handed_out_while_held_is_kept_after_it_grows():
    """Buffers handed out inside ``_scratch.held()`` are listed once each
    for the graph captured there; growing the buffer afterwards replaces
    it in the table but not in the list, so the graph's memory stays
    alive; buffers handed out outside the block are not listed."""
    dev = torch.device("cpu")
    key = 1 << 40           # a stream handle no other test uses
    _scratch.scratch(dev, key + 1, 64)
    with _scratch.held() as bufs:
        a = _scratch.scratch(dev, key, 1000)
        assert _scratch.scratch(dev, key, 10).data_ptr() == a.data_ptr()
    assert len(bufs) == 1 and bufs[0] is a
    b = _scratch.scratch(dev, key, 5000)
    assert b.data_ptr() != a.data_ptr() and bufs[0] is a
    assert not _scratch._HELD
