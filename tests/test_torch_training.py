"""The port's training path against the JAX package's, on the CPU: AdamW
(f32, and bf16 parameters and moments within one bf16 ulp), the chunked
cross-entropy and loss, the model's gradients (the recurrentgemma,
mamba2 and deepseek-v2 smoke configs) and three train steps on the
recurrentgemma smoke config, the plain versions of the three backward
kernels, the policy fit, the data pipeline, checkpoints and the
fault-tolerance drill; and serving's outputs unchanged by the autograd
dispatch.

Both packages get the same numpy inputs and weights (``params_from_numpy``
of the reference's ``init_params``).  Tolerances, f32 throughout: AdamW
1e-6 (the same arithmetic in the same order); cross-entropy and loss
1e-5; model gradients 1e-4 relative to each leaf's largest element, and
losses 1e-4 (the port's serial scan and flash-style attention sum in
another order than the reference's associative scan and q-block scan);
the backward plain versions 1e-5 absolute plus 1e-4 relative (explicit
formulas against autograd of the forward); policy losses 1e-4,
agreements 0.01.

The reference's ``make_train_step`` fails on a (1, 1) mesh under JAX 0.9
(``with_sharding_constraint`` refuses the explicit-axis mesh, the fault
that fails its own drills), so the three-step comparison runs the
reference's ``loss_fn`` and ``adamw.update`` under ``jax.jit`` instead.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # degraded deterministic fallback loop
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

import repro.policy as jpol
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.policy.train import TrainConfig as JTrainConfig
import repro_torch.policy as tpol
import repro_torch.policy.train as ttrain
from repro_torch import checkpoint as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import make_train_step
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     InjectedFailure,
                                                     StragglerDetector,
                                                     Watchdog,
                                                     plan_elastic_mesh)
from repro_torch.distributed.steps import _like
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.flash_attention import (bwd_path, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fn)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                            rglru_scan_fn)
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import (CHUNK, ssd_scan, ssd_scan_bwd,
                                          ssd_scan_fn)
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import (params_from_numpy, params_to_numpy,
                                train_state_from_numpy)
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw as tadamw

ARCH = "recurrentgemma-2b"
#: the architectures whose smoke models' gradients are held to jax.grad
#: (mamba2's two layers deep, as in test_torch_models.py; deepseek-v2's
#: dense first layer and one MoE layer, MLA at q/k 24, v 16)
GRAD_ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b")
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "policy_traces.jsonl")
GRAD_TOL = 1e-4
XENT_TOL = 1e-5
BWD_TOL = (1e-5, 1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    """A tensor of its own (the port's AdamW updates in place)."""
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(got, want, rtol):
    """Every leaf of `got` within `rtol` of its largest element in
    `want` (the same paths in the same order)."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.fixture(scope="module")
def smoke(request):
    """(JAX config, JAX params, port config) of ARCH's smoke model, or of
    the architecture a test parametrises it with (indirect)."""
    arch = getattr(request, "param", ARCH)
    jcfg = jbase.get_smoke_config(arch)
    tcfg = tbase.get_smoke_config(arch)
    if arch == "mamba2-2.7b":
        jcfg, tcfg = jcfg.replace(n_layers=2), tcfg.replace(n_layers=2)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg


def _port_params(tcfg, jp):
    return params_from_numpy(tcfg, _np(jp), device="cpu")


def _batch(B, S, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _nested_tree(rng):
    """A nested tree whose names cover the decay rule's exclusions."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"w_q": a(4, 3), "norm": {"scale": a(3)},
            "layers": [{"bias1": a(5), "w1": a(5, 2), "D": a(2)},
                       {"a_param": a(4), "b_r": a(4), "conv_w": a(2, 4)}],
            "dt_bias": a(3), "A_log": a(3), "table": a(6, 3)}


def _bf16_ulp(x):
    """One bf16 ulp at each element of the f32 array x (the spacing of
    bf16 values at its magnitude; the smallest normal's at zero)."""
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _to_numpy(t):
    return t.float().numpy()


@pytest.mark.parametrize("clip_norm,dtype", [
    pytest.param(1.0, "float32", id="1.0"),
    pytest.param(0.0, "float32", id="0.0"),
    pytest.param(1.0, "bfloat16", id="bfloat16-1.0"),
    pytest.param(0.0, "bfloat16", id="bfloat16-0.0")])
def test_adamw_update_matches_reference(clip_norm, dtype):
    """Five steps on a nested tree: parameters, both moments and the
    metrics within 1e-6 of ``repro.optim.adamw.update`` in f32.  With
    bf16 parameters, gradients and moments (``moment_dtype="bfloat16"``,
    deepseek-v2's training state) each step starts from the reference's
    state and every parameter and moment is within one bf16 ulp of the
    reference's: the same f32 arithmetic rounded once to bf16, where a
    contracted multiply-add may round the f32 value to the other side of
    a bf16 midpoint."""
    rng = np.random.default_rng(1)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=8,
                  clip_norm=clip_norm, weight_decay=0.1, moment_dtype=dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    params = _nested_tree(rng)
    grads = [jax.tree.map(lambda x: 3.0 * rng.standard_normal(x.shape)
                          .astype(np.float32), params) for _ in range(5)]
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    js = jadamw.init(jp, jcfg)
    tp = jax.tree.map(lambda a: _t(a).to(tdt), params)
    ts = tadamw.init(tp, tcfg)
    jupdate = jax.jit(lambda p, g, s: jadamw.update(p, g, s, jcfg))

    def from_jax(tree):
        return jax.tree.map(
            lambda a: _t(np.asarray(a, np.float32)).to(tdt), tree)

    for g in grads:
        if dtype == "bfloat16":
            # the reference's state as the port's, so that each step's
            # rounding is held alone
            tp = from_jax(jp)
            ts = tadamw.OptState(from_jax(js.m), from_jax(js.v),
                                 torch.tensor(int(js.step), dtype=torch.int32))
        jp, js, jm = jupdate(jp, jax.tree.map(
            lambda a: jnp.asarray(a).astype(jdt), g), js)
        tp, ts, tm = tadamw.update(
            tp, jax.tree.map(lambda a: _t(a).to(tdt), g), ts, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        if dtype == "float32":
            continue
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            got = jax.tree.map(_to_numpy, got)
            for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
                assert a.dtype == np.float32
                b = np.asarray(b, np.float32)
                assert np.all(np.abs(a - b) <= _bf16_ulp(b)), \
                    jax.tree_util.keystr(path)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        got = jax.tree.map(_to_numpy, got)
        for (path, a), (_, b) in zip(_leaves(got), _leaves(_np(want))):
            assert b.dtype == jdt, jax.tree_util.keystr(path)
            if dtype == "float32":
                np.testing.assert_allclose(
                    a, b, rtol=1e-6, atol=1e-6,
                    err_msg=jax.tree_util.keystr(path))
    for leaf in jax.tree.leaves((tp, ts.m, ts.v)):
        assert leaf.dtype == tdt
    assert int(ts.step) == int(js.step) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_sliced_update_is_bitwise_the_unsliced_one(monkeypatch, dtype):
    """Leaves above ``SLICE_ELEMENTS`` are updated a slice of their first
    axis at a time; the update is elementwise, so three steps with a
    slice of 7 elements (every leaf of more than 7 sliced, ragged last
    slices, 1-d leaves in runs) give bitwise the parameters and moments
    of the unsliced update, in f32 and in bf16."""
    rng = np.random.default_rng(2)
    tree = _nested_tree(rng)
    tree["stack"] = rng.standard_normal((5, 4, 3)).astype(np.float32)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32), tree) for _ in range(3)]
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                             moment_dtype=str(dtype).split(".")[-1])
    out = []
    for limit in (1 << 30, 7):
        monkeypatch.setattr(tadamw, "SLICE_ELEMENTS", limit)
        p = jax.tree.map(lambda a: _t(a).to(dtype), tree)
        st = tadamw.init(p, cfg)
        for g in grads:
            p, st, _ = tadamw.update(
                p, jax.tree.map(lambda a: _t(a).to(dtype), g), st, cfg)
        out.append([t for _, t in tadamw.leaves_with_path((p, st.m, st.v))])
    assert any(t.numel() > 7 for t in out[0])
    for a, b in zip(*out):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def _decayed(update, params, to_tensor, to_numpy):
    """The leaves one update with zero gradients changes: only decay
    moves a parameter then."""
    cfg_kw = dict(lr=1e-1, weight_decay=0.5, warmup_steps=0)
    before = to_numpy(params)
    zeros = jax.tree.map(lambda a: np.zeros_like(a), before)
    return before, to_numpy(update(to_tensor(before), to_tensor(zeros),
                                   cfg_kw))


def _jax_update(p, g, kw):
    cfg = jadamw.AdamWConfig(**kw)
    return jax.jit(lambda p, g: jadamw.update(p, g, jadamw.init(p, cfg),
                                              cfg)[0])(p, g)


def _port_update(p, g, kw):
    cfg = tadamw.AdamWConfig(**kw)
    return tadamw.update(p, g, tadamw.init(p, cfg), cfg)[0]


def _changed(before, after):
    return [not np.array_equal(a, b) for a, b in
            zip(jax.tree.leaves(before), jax.tree.leaves(after))]


@pytest.mark.parametrize("which", ["recurrentgemma", "policy"])
def test_adamw_decays_the_reference_leaves(smoke, which):
    """The port decides decay on the same key-path strings, so the same
    leaves decay, leaf by leaf, on the recurrentgemma smoke params (as
    the reference's stacked tree) and on the policy's."""
    if which == "policy":
        params = dict(jpol.init_params(14, 16, 0))
        to_t = lambda tree: jax.tree.map(_t, tree)
        to_np = lambda tree: jax.tree.map(
            lambda x: np.array(x, np.float32), tree)
        j_before, j_after = _decayed(_jax_update, params,
                                     lambda t: jax.tree.map(jnp.asarray, t),
                                     to_np)
        t_before, t_after = _decayed(_port_update, params, to_t, to_np)
    else:
        jcfg, jp, tcfg = smoke
        j_before, j_after = _decayed(_jax_update, _np(jp),
                                     lambda t: jax.tree.map(jnp.asarray, t),
                                     _np)
        t_before, t_after = _decayed(
            _port_update, _np(jp),
            lambda tree: params_from_numpy(tcfg, tree, device="cpu"),
            lambda tree: params_to_numpy(tcfg, tree)
            if isinstance(tree, dict) and "layers" in tree else tree)
    want = _changed(j_before, j_after)
    assert _changed(t_before, t_after) == want
    assert any(want) and not all(want)


def test_adamw_schedule_matches_reference():
    cfg_kw = dict(lr=3e-4, warmup_steps=100, total_steps=1000,
                  min_lr_frac=0.1)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    for step in (0, 1, 50, 100, 550, 999, 1000, 1500):
        np.testing.assert_allclose(
            float(tadamw.schedule(tcfg, torch.tensor(step))),
            float(jadamw.schedule(jcfg, jnp.asarray(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Cross-entropy and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_xent_matches_reference(smoke, with_mask):
    jcfg, jp, tcfg = smoke
    tp = _port_params(tcfg, jp)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 48, tcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, tcfg.vocab_size, (2, 48)).astype(np.int32)
    mask = (rng.random((2, 48)) < 0.6).astype(np.float32) if with_mask \
        else None
    jl, jw = jax.jit(lambda p, h, t, m: jsteps.chunked_xent(
        jcfg, p, h, t, m, chunk=16))(
            jp, jnp.asarray(h), jnp.asarray(tgt),
            None if mask is None else jnp.asarray(mask))
    tl, tw = tsteps.chunked_xent(tcfg, tp, _t(h), _t(tgt),
                                 None if mask is None else _t(mask), chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=XENT_TOL)
    assert float(tw) == float(jw)
    assert tsteps._pick_chunk(48, 16) == jsteps._pick_chunk(48, 16) == 16
    assert tsteps._pick_chunk(3000) == jsteps._pick_chunk(3000) == 500


def test_make_train_batch_equals_reference(smoke):
    jcfg, _, tcfg = smoke
    shape = jbase.InputShape("t", 24, 3, "train")
    want = jsteps.make_train_batch(jcfg, shape, np.random.default_rng(5))
    got = tsteps.make_train_batch(tcfg, shape, np.random.default_rng(5),
                                  device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_loss_fn_matches_reference(smoke):
    jcfg, jp, tcfg = smoke
    tp = _port_params(tcfg, jp)
    b = _batch(2, 32, seed=3)
    jl, jm = jax.jit(lambda p, b: jsteps.loss_fn(jcfg, p, b))(
        jp, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        tl, tm = tsteps.loss_fn(tcfg, tp, jax.tree.map(_t, b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=XENT_TOL)
    for key in ("xent", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=XENT_TOL, atol=1e-7)


# ---------------------------------------------------------------------------
# Model gradients and train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads(smoke):
    jcfg, jp, _ = smoke
    b = jax.tree.map(jnp.asarray, _batch(2, 40, seed=4))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(jcfg, p, b), has_aux=True))(jp)
    return float(loss), _np(grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("smoke", GRAD_ARCHS, indirect=True)
def test_model_gradients_match_jax(smoke, jax_grads, remat):
    """The loss and every gradient leaf of the smoke model within 1e-4 of
    ``jax.value_and_grad(repro.models.steps.loss_fn)``, with the kernels'
    autograd Functions (their plain versions on the CPU): recurrentgemma
    through attention and the RG-LRU scan, mamba2 through the SSD scan
    (the reference differentiates ``ssd_chunked`` at the model's chunk,
    the port ``ref.ssd_scan_bwd_ref`` at the kernels')."""
    jcfg, jp, tcfg = smoke
    tp = _port_params(tcfg, jp)
    leaves = [p.requires_grad_(True) for _, p in tadamw.leaves_with_path(tp)]
    b = jax.tree.map(_t, _batch(2, 40, seed=4))
    loss, _ = tsteps.loss_fn(tcfg, tp, b, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    want_loss, want = jax_grads
    np.testing.assert_allclose(float(loss), want_loss, rtol=GRAD_TOL)
    _assert_trees_close(params_to_numpy(tcfg, _like(tp, iter(grads))), want,
                        GRAD_TOL)


def test_three_train_steps_match_reference(smoke):
    """Three steps from ``train_state_from_numpy`` of the reference's
    state give losses within 1e-4 of the reference's loss_fn + adamw
    step (remat on, the reference's default AdamWConfig but a short
    warmup so that the steps move)."""
    jcfg, jp, tcfg = smoke
    ocfg = dict(warmup_steps=1, total_steps=10, lr=3e-3)
    jo = jadamw.AdamWConfig(**ocfg)
    state = {"params": jp, "opt": jadamw.init(jp, jo)}
    batches = [_batch(2, 32, seed=10 + i) for i in range(3)]

    @jax.jit
    def jstep(state, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: jsteps.loss_fn(jcfg, p, b, remat=True),
            has_aux=True)(state["params"])
        p, o, _ = jadamw.update(state["params"], g, state["opt"], jo)
        return {"params": p, "opt": o}, loss

    tstate = train_state_from_numpy(tcfg, _np(state), device="cpu")
    bundle = make_train_step(tcfg, None,
                             tbase.InputShape("t", 32, 2, "train"),
                             tadamw.AdamWConfig(**ocfg), remat=True,
                             device="cpu")
    for b in batches:
        state, jl = jstep(state, jax.tree.map(jnp.asarray, b))
        tstate, tm = bundle.fn(tstate, jax.tree.map(_t, b))
        np.testing.assert_allclose(float(tm["loss"]), float(jl),
                                   rtol=GRAD_TOL)
    assert int(tstate["opt"].step) == 3


def test_deepseek_bf16_state_trains_and_loses_no_gradient():
    """deepseek-v2's smoke model as phase 8 (b) trains it on the card:
    ``build_state`` with bf16 parameters (the router's f32) and bf16
    moments, bf16 compute.  Every leaf's gradient through the MLA
    attention, the sort dispatch, the router (its f32 logits) and the aux
    loss exists and is not identically zero (the train step's zero fill
    would hide a detached one); three steps of ``make_train_step`` keep
    every dtype, move every leaf and give finite losses."""
    cfg = tbase.get_smoke_config("deepseek-v2-236b").replace(
        dtype="bfloat16")
    ocfg = tadamw.AdamWConfig(warmup_steps=1, total_steps=4, lr=1e-2,
                              moment_dtype="bfloat16")
    state = tlaunch.build_state(cfg, ocfg, seed=0, device="cpu",
                                param_dtype=torch.bfloat16)
    named = tadamw.leaves_with_path(state["params"])
    want = {"/".join(p): (torch.float32 if p[-1] == "['w_router']"
                          else torch.bfloat16) for p, _ in named}
    assert {"/".join(p): t.dtype for p, t in named} == want
    assert all(t.dtype == torch.bfloat16
               for _, t in tadamw.leaves_with_path(state["opt"].m))
    b = jax.tree.map(_t, _batch(2, 32, seed=3))
    leaves = [t.requires_grad_(True) for _, t in named]
    loss, mets = tsteps.loss_fn(cfg, state["params"], b, remat=True)
    assert float(mets["aux"].detach()) > 0
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    lost = ["/".join(p) for (p, _), g in zip(named, grads)
            if g is None or not bool(g.any())]
    assert not lost, lost
    before = [t.detach().clone() for t in leaves]
    bundle = make_train_step(cfg, None,
                             tbase.InputShape("t", 32, 2, "train"),
                             ocfg, remat=True, device="cpu")
    losses = []
    for i in range(3):
        state, m = bundle.fn(state, jax.tree.map(
            _t, _batch(2, 32, seed=20 + i)))
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    after = tadamw.leaves_with_path(state["params"])
    assert {"/".join(p): t.dtype for p, t in after} == want
    still = ["/".join(p) for (p, t), t0 in zip(after, before)
             if torch.equal(t.detach(), t0)]
    assert not still, still


def test_microbatch_step_matches_whole_batch(smoke):
    """Gradient accumulation over 2 microbatches gives the whole batch's
    step (the mean loss is linear in the per-microbatch means at equal
    token counts)."""
    jcfg, jp, tcfg = smoke
    shape = tbase.InputShape("t", 16, 4, "train")
    b = jax.tree.map(_t, _batch(4, 16, seed=5))
    out = []
    for mb in (1, 2):
        st = train_state_from_numpy(
            tcfg, {"params": _np(jp),
                   "opt": _np(jadamw.init(jp, jadamw.AdamWConfig()))},
            device="cpu")
        bundle = make_train_step(tcfg, None, shape, remat=False,
                                 microbatch=mb, device="cpu")
        st, m = bundle.fn(st, b)
        out.append((float(m["loss"]), params_to_numpy(tcfg, st["params"])))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    _assert_trees_close(out[1][1], out[0][1], 1e-5)


def test_params_to_numpy_round_trip(smoke):
    jcfg, jp, tcfg = smoke
    want = _np(jp)
    got = params_to_numpy(tcfg, params_from_numpy(tcfg, want, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b)


def test_train_state_from_numpy(smoke):
    jcfg, jp, tcfg = smoke
    rng = np.random.default_rng(6)
    noisy = lambda a: (a + rng.standard_normal(a.shape)).astype(a.dtype)
    opt = jadamw.OptState(m=jax.tree.map(noisy, _np(jp)),
                          v=jax.tree.map(noisy, _np(jp)),
                          step=np.asarray(7, np.int32))
    st = train_state_from_numpy(tcfg, {"params": _np(jp), "opt": opt},
                                device="cpu")
    assert int(st["opt"].step) == 7 and st["opt"].step.dtype == torch.int32
    for got, want in ((st["params"], _np(jp)), (st["opt"].m, opt.m),
                      (st["opt"].v, opt.v)):
        for (_, a), (_, b) in zip(_leaves(params_to_numpy(tcfg, got)),
                                  _leaves(want)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The backward kernels' plain versions
# ---------------------------------------------------------------------------

MASKS = [dict(causal=True, kind="local", window=8),
         dict(causal=True, kind="local", window=1),
         dict(causal=True, kind="global"),
         dict(causal=False, kind="global"),
         dict(causal=True, kind="chunked", window=8),
         dict(causal=True, kind="global", softcap=5.0),
         dict(causal=False, kind="local", window=5, softcap=3.0),
         dict(causal=True, kind="chunked", window=8, softcap=2.0)]


def _attn_inputs(seed, BH=4, G=2, S=37, D=16, Dv=None):
    Dv = Dv or D
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, D)).astype(np.float32)
    k = rng.standard_normal((BH // G, S, D)).astype(np.float32)
    v = rng.standard_normal((BH // G, S, Dv)).astype(np.float32)
    do = rng.standard_normal((BH, S, Dv)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what=""):
    atol, rtol = BWD_TOL
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _mask_id(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items())


#: (mask, group, v's head dim): D = Dv = 16 at every mask, and MLA's
#: shape cut down, q and k of head dim 24 with v of 16 (the deepseek
#: smoke config's), at every mask ``blockwise_attention`` evaluates as
#: the plain version does (its local span looks back only, so not the
#: bidirectional local mask)
FLASH_BWD_CASES = (
    [pytest.param(kw, group, None, id=f"{_mask_id(kw)}-{group}")
     for kw in MASKS for group in (2, 4)]
    + [pytest.param(kw, group, 16, id=f"{_mask_id(kw)}-{group}-qk24-v16")
       for kw in MASKS if kw["causal"] or kw["kind"] != "local"
       for group in (1, 2)])


@pytest.mark.parametrize("kw,group,dv", FLASH_BWD_CASES)
def test_flash_bwd_ref_matches_autograd_and_jax(kw, group, dv):
    """``flash_attention_bwd_ref`` in the kernels' layout, GQA (two kv
    rows of two query rows each) and MQA (one kv row for all four),
    against torch autograd through the plain forward and against
    ``jax.grad`` of the reference's oracle with k and v repeated; with v
    narrower than q and k (head dims 24 and 16, MHA and GQA 2:1), against
    ``jax.grad`` of the reference's ``blockwise_attention``, which XLA
    differentiates when the reference trains MLA."""
    q, k, v, do = (_attn_inputs(7, G=group) if dv is None
                   else _attn_inputs(7, G=group, D=24, Dv=dv))
    G = q.shape[0] // k.shape[0]
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = ref.flash_attention_ref(qt, kt.repeat_interleave(G, 0),
                                vt.repeat_interleave(G, 0), **kw)
    want = torch.autograd.grad(o, (qt, kt, vt), _t(do))
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o.detach(),
                                      _t(do), **kw)
    for name, a, b in zip("qkv", got, want):
        _close(a, b.numpy(), f"d{name} vs autograd")

    def jloss(q, k, v):
        if dv is None:
            out = jref.flash_attention_ref(q, jnp.repeat(k, G, 0),
                                           jnp.repeat(v, G, 0), **kw)
        else:
            # (BH, S, D) as one batch of BH heads: (1, S, BH, D)
            spec = jattn.AttnSpec(kw["kind"], kw["causal"],
                                  kw.get("window", 0), 0.0,
                                  kw.get("softcap", 0.0), False, q_block=8)
            out = jattn.blockwise_attention(
                *(a.transpose(1, 0, 2)[None] for a in (q, k, v)),
                spec)[0].transpose(1, 0, 2)
        return jnp.sum(out * do)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, jg):
        assert a.shape == b.shape
        _close(a, b, f"d{name} vs jax.grad")


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_ref_matches_autograd_and_jax(with_h0):
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 1.0, (2, 23, 6)).astype(np.float32)
    b = rng.standard_normal((2, 23, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 6)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((2, 23, 6)).astype(np.float32)
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    h0t = _t(h0).requires_grad_(True) if with_h0 else None
    h = ref.rglru_scan_ref(at, bt, h0t)
    ins = (at, bt) + ((h0t,) if with_h0 else ())
    want = torch.autograd.grad(h, ins, _t(dh))
    da, db, dh0 = ref.rglru_scan_bwd_ref(_t(a), h.detach(), _t(dh),
                                         None if h0 is None else _t(h0))
    got = (da, db) + ((dh0,) if with_h0 else ())
    for a_, b_ in zip(got, want):
        _close(a_, b_.numpy())

    def jloss(a, b, h0):
        return jnp.sum(jref.rglru_scan_ref(a, b, h0) * dh)

    jg = jax.grad(jloss, argnums=(0, 1, 2) if with_h0 else (0, 1))(
        a, b, h0)
    for a_, b_ in zip(got, jg):
        _close(a_, b_)
    if not with_h0:   # zeros h0: dh0 is still a_0 g_0
        _close(dh0, (a[:, 0] * db.numpy()[:, 0]))


def _ssd_inputs(seed, B=2, H=4, G=2, S=37, P=5, N=6, with_h0=True,
                with_dh=True):
    """The SSD scan's inputs (x, dA, dt, Bm, Cm, h0) in the kernels'
    layout, f32 numpy, h0 None unless `with_h0`; dy and dh (None unless
    `with_dh`).  dt = softplus(N(-2, 1)), A in [-4, -1]: decays of the
    model's size."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(B, H, S) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    args = (f(B, H, S, P), (dt * A[None, :, None]).astype(np.float32), dt,
            f(B, G, S, N), f(B, G, S, N), f(B, H, P, N) if with_h0 else None)
    return args, f(B, H, S, P), f(B, H, P, N) if with_dh else None


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,S", [(1, 37), (2, 150), (4, 64), (4, 129)])
def test_ssd_bwd_ref_matches_autograd_and_jax(G, S, with_h0, with_dh):
    """``ref.ssd_scan_bwd_ref`` (the SSD backward kernel's plain version,
    at the kernels' chunk of 64) against torch autograd through
    ``ref.ssd_scan_ref`` in float64 (1e-10 of each gradient's largest
    |value|: the same function) and against ``jax.grad`` of the
    reference's token-by-token oracle in f32 with B and C repeated to the
    heads (1e-4), for G = 1, 2 and H (4 heads), a ragged S and whole
    chunks, with and without h0, and a zero or non-zero gradient by the
    final state."""
    args, dy, dh = _ssd_inputs(S + G, G=G, S=S, with_h0=with_h0,
                               with_dh=with_dh)
    names = ("dx", "ddA", "ddt", "dB", "dC", "dh0")
    got = ref.ssd_scan_bwd_ref(*(None if a is None else _t(a)
                                 for a in args), _t(dy),
                               None if dh is None else _t(dh), chunk=CHUNK)
    d64 = lambda a: None if a is None else torch.from_numpy(
        np.array(a, np.float64))
    leaves = [d64(a).requires_grad_(True) for a in args if a is not None]
    y, hf = ref.ssd_scan_ref(*leaves[:5], leaves[5] if with_h0 else None,
                             chunk=CHUNK)
    loss = (y * d64(dy)).sum() + ((hf * d64(dh)).sum() if with_dh else 0.0)
    want = torch.autograd.grad(loss, leaves)
    g64 = ref.ssd_scan_bwd_ref(*(d64(a) for a in args), d64(dy), d64(dh),
                               chunk=CHUNK)
    for name, a, b in zip(names, g64, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-10 * scale, name

    rep = 4 // G

    def jloss(x, dA, dt, Bm, Cm, h0):
        y, hf = jref.ssd_scan_ref(x, dA, dt, jnp.repeat(Bm, rep, 1),
                                  jnp.repeat(Cm, rep, 1), h0)
        out = jnp.sum(y * dy)
        return out + jnp.sum(hf * dh) if with_dh else out

    h0 = args[5] if with_h0 else np.zeros((2, 4, 5, 6), np.float32)
    jg = jax.grad(jloss, argnums=tuple(range(6)))(*args[:5], h0)
    for name, a, b in zip(names, got, jg):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-4 * float(np.abs(b).max()), (name, err)


@pytest.mark.parametrize("P,N", [(64, 128), (64, 64), (32, 128), (40, 100),
                                 (16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_path_depends_on_dtype_and_shape_alone(dtype, P, N):
    """bf16 at (P, N) = (64, 128), mamba2-2.7b's shape, takes the
    tensor-core backward (``csrc/ssd_scan_bwd_wgmma.cu``); f32 and every
    other shape the CUDA-core one, as the forward's ``path`` splits."""
    want = ("wgmma" if dtype == torch.bfloat16 and (P, N) == (64, 128)
            else "simt")
    assert tssd.bwd_path(dtype, P, N) == want
    assert tssd.path(dtype, P, N) == want


#: the bf16 card tests' tolerance for the SSD backward, of each
#: gradient's largest |value|
SSD_BF16_TOL = 2e-2


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,S", [(1, 200), (2, 200), (1, 129), (2, 129)])
def test_ssd_bwd_bf16_split_model_within_card_tolerance(G, S, with_h0,
                                                        with_dh):
    """The tensor-core backward's rounding, modelled in PyTorch
    (``ref.ssd_scan_bwd_ref(..., split=True)``: bf16 inputs, every value
    that is not a bf16 input fed to its products as bf16 hi + lo, f32
    sums, bf16 dx, dB and dC), at mamba2-2.7b's widths (4 heads of 64,
    d_state 128; S 200 and a ragged 129; G 1 and 2; with and without h0
    and a gradient by the final state), against the float64 plain
    backward on the same bf16 values: each gradient within the card
    tests' bf16 tolerance (2e-2) of its largest |value|.  Worst seen:
    3.34e-3 (dB, S 129, G 2, with h0), the bf16 rounding of the outputs;
    the splits move ddA, ddt and dh0 by 6e-6 of their largest at most.
    The model must differ from the unsplit f32 backward (the splits are
    applied)."""
    args, dy, dh = _ssd_inputs(S + G, B=1, H=4, G=G, S=S, P=64, N=128,
                               with_h0=with_h0, with_dh=with_dh)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    opt = lambda a: None if a is None else _t(a)
    ins = (bf(args[0]), _t(args[1]), _t(args[2]), bf(args[3]), bf(args[4]),
           opt(args[5]), bf(dy), opt(dh))
    got = ref.ssd_scan_bwd_ref(*ins, chunk=CHUNK, split=True)
    plain = ref.ssd_scan_bwd_ref(*ins, chunk=CHUNK)
    want = ref.ssd_scan_bwd_ref(*(None if a is None else a.double()
                                  for a in ins), chunk=CHUNK)
    for name, g, w in zip(("dx", "ddA", "ddt", "dB", "dC", "dh0"), got,
                          want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dB", "dC")
                           else torch.float32), name
        assert bool(torch.isfinite(g.float()).all()), name
        err = float((g.double() - w).abs().max())
        assert err <= SSD_BF16_TOL * float(w.abs().max()), (name, err)
    assert not torch.equal(got[1], plain[1])
    assert not torch.equal(got[5], plain[5])


def test_bf16_split_carries_sixteen_bits():
    """``ref.bf16_split``: hi is x rounded to bf16, lo the rest rounded
    again; hi + lo is within 2^-16 of |x| (relative) on normal values."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10_000).astype(np.float32)) * 1e3
    hi, lo = ref.bf16_split(x)
    assert torch.equal(hi, x.bfloat16().float())
    assert torch.equal(lo, (x - hi).bfloat16().float())
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -16


def test_autograd_functions_on_cpu_take_the_plain_backward():
    """On CPU tensors the Functions (attention, the RG-LRU scan, the SSD
    scan) differentiate with the plain versions and launch nothing."""
    q, k, v, do = _attn_inputs(9)
    kw = dict(causal=True, kind="local", window=8)
    n0 = (flash_attention.launches, flash_attention_bwd.launches,
          rglru_scan.launches, rglru_scan_bwd.launches, ssd_scan.launches,
          ssd_scan_bwd.launches)
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = flash_attention_fn(qt, kt, vt, **kw)
    got = torch.autograd.grad(o, (qt, kt, vt), _t(do))
    want = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o.detach(),
                                       _t(do), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    a = torch.rand(2, 9, 5) * 0.5 + 0.5
    b = torch.randn(2, 9, 5)
    at, bt = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    h = rglru_scan_fn(at, bt)
    dh = torch.randn(2, 9, 5)
    got = torch.autograd.grad(h, (at, bt), dh)
    want = ref.rglru_scan_bwd_ref(a, h.detach(), dh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    args, dy, dhf = _ssd_inputs(14, G=2, S=70, with_h0=True, with_dh=True)
    leaves = [_t(a).requires_grad_(True) for a in args]
    y, hf = ssd_scan_fn(*leaves)
    got = torch.autograd.grad((y, hf), leaves, (_t(dy), _t(dhf)))
    want = ref.ssd_scan_bwd_ref(*map(_t, args), _t(dy), _t(dhf), chunk=CHUNK)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the final state unused: its gradient is zeros, and h0 takes none
    y, _hf = ssd_scan_fn(*leaves[:5], _t(args[5]))
    got = torch.autograd.grad(y, leaves[:5], _t(dy))
    want = ref.ssd_scan_bwd_ref(*map(_t, args), _t(dy), chunk=CHUNK)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (flash_attention.launches, flash_attention_bwd.launches,
            rglru_scan.launches, rglru_scan_bwd.launches, ssd_scan.launches,
            ssd_scan_bwd.launches) == n0
    da, db, dh0 = rglru_scan_bwd(a, h.detach(), dh)
    assert dh0 is None
    assert ssd_scan_bwd(*map(_t, args), _t(dy))[5] is None


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_path_depends_on_dtype_head_dim_and_softcap_alone(
        dtype, D, softcap):
    """bf16 at head dims 64, 128 and 256 takes the wgmma backward, softcap
    or not; f32 there without a softcap the 3xTF32 one (the cases the
    forward's ``path`` sends to its 3xTF32 kernel); f32 with a softcap
    and every other head dim the CUDA-core one.  With v's head dim given
    (``v_dim``): equal to D it changes nothing; MLA's (192, 128) takes the
    wgmma backward in bf16, the 3xTF32 one in f32 without a softcap and
    the CUDA-core one with it, and every other v narrower or wider than q
    and k the CUDA-core one, as the forward's
    ``path`` says in every case (each tensor-core backward reads the lse
    its forward writes)."""
    if D in (64, 128, 256) and dtype == torch.bfloat16:
        want = "wgmma"
    elif D in (64, 128, 256) and not softcap:
        want = "tf32"
    else:
        want = "simt"
    assert bwd_path(dtype, D, softcap) == want
    assert bwd_path(dtype, D, softcap, D) == want
    assert (want == "tf32") == (tflash.path(dtype, D, softcap) == "tf32")
    if dtype == torch.bfloat16:
        mla = "wgmma"
    else:
        mla = "simt" if softcap else "tf32"
    assert bwd_path(dtype, 192, softcap, 128) == mla
    for dv in (D // 2, 2 * D):
        assert bwd_path(dtype, D, softcap, dv) == "simt"
    for d, dv in ((D, D), (D, D // 2), (192, 128)):
        assert bwd_path(dtype, d, softcap, dv) == tflash.path(dtype, d,
                                                              softcap, dv)


def _lse_f64(q, k, kw):
    """Row log-sum-exp of the scaled, softcapped, masked scores in
    float64 numpy (k repeated to q's rows)."""
    BH, S, D = q.shape
    kr = np.repeat(k.astype(np.float64), BH // k.shape[0], axis=0)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), kr) / np.sqrt(D)
    if kw.get("softcap"):
        s = np.tanh(s / kw["softcap"]) * kw["softcap"]
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if kw.get("causal", True):
        keep &= qp >= kp
    if kw.get("kind") == "local":
        keep &= (qp - kp) < kw["window"]
    elif kw.get("kind") == "chunked":
        keep &= qp // kw["window"] == kp // kw["window"]
    s = np.where(keep[None], s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kw", MASKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_plain_lse_matches_float64(kw, group):
    """``ref.flash_attention_lse_ref`` (what the bf16 forward kernel
    writes for its backward, and what the CPU wrapper returns) against a
    float64 log-sum-exp, within 1e-5 (f32 scores of 16 products)."""
    q, k, _v, _do = _attn_inputs(11, G=group)
    want = _lse_f64(q, k, kw)
    got = ref.flash_attention_lse_ref(_t(q), _t(k), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    out, lse = flash_attention(_t(q), _t(k), _t(_v), return_lse=True, **kw)
    assert torch.equal(lse, got)
    assert torch.equal(out, flash_attention(_t(q), _t(k), _t(_v), **kw))


@pytest.mark.parametrize("dtype,D,softcap,lse_saved", [
    (torch.bfloat16, 64, 5.0, True), (torch.bfloat16, 16, 5.0, False),
    (torch.float32, 64, 5.0, False), (torch.float32, 64, 0.0, True),
    (torch.float32, 16, 0.0, False)])
def test_flash_attention_fn_saves_lse_only_when_a_gradient_is_needed(
        monkeypatch, dtype, D, softcap, lse_saved):
    """The forward asks for the lse only when a gradient will be taken on
    a backward path that reads it (bf16 at the tensor-core head dims on
    wgmma; f32 there without a softcap on tf32), so serving's calls write
    none; on CPU tensors it is the plain lse and nothing launches."""
    q, k, v, do = _attn_inputs(12, D=D)
    kw = dict(causal=True, kind="local", window=8, softcap=softcap)
    asked = []
    real = tflash.flash_attention

    def recording(*args, **kwargs):
        asked.append(kwargs.get("return_lse", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention", recording)
    n0 = (flash_attention.launches, flash_attention_bwd.launches,
          dict(flash_attention.launches_by_path),
          dict(flash_attention_bwd.launches_by_path))
    qt, kt, vt = (_t(a).to(dtype) for a in (q, k, v))
    with torch.no_grad():
        flash_attention_fn(qt, kt, vt, **kw)
    flash_attention_fn(qt, kt, vt, **kw)      # no input needs a gradient
    assert asked == [False, False]
    qg, kg, vg = (a.clone().requires_grad_(True) for a in (qt, kt, vt))
    o = flash_attention_fn(qg, kg, vg, **kw)
    assert asked[-1] == lse_saved
    saved = o.grad_fn.saved_tensors
    assert len(saved) == (5 if lse_saved else 4)
    if lse_saved:
        assert torch.equal(saved[4], ref.flash_attention_lse_ref(qt, kt,
                                                                 **kw))
    got = torch.autograd.grad(o, (qg, kg, vg), _t(do).to(dtype))
    want = ref.flash_attention_bwd_ref(qt, kt, vt, o.detach(),
                                       _t(do).to(dtype), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (flash_attention.launches, flash_attention_bwd.launches,
            dict(flash_attention.launches_by_path),
            dict(flash_attention_bwd.launches_by_path)) == n0


@pytest.mark.parametrize("kw", [MASKS[0], MASKS[5], MASKS[7]],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_flash_attention_fn_grads_match_jax(kw):
    """Autograd through ``flash_attention_fn`` (the kernels' dispatch, on
    the CPU their plain versions) at a tensor-core head dim, MQA 4:1,
    against ``jax.grad`` of the reference's oracle with k and v repeated,
    within 1e-4 of each gradient's largest element."""
    q, k, v, do = _attn_inputs(13, G=4, D=64)
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad(flash_attention_fn(qt, kt, vt, **kw),
                              (qt, kt, vt), _t(do))

    def jloss(q, k, v):
        out = jref.flash_attention_ref(q, jnp.repeat(k, 4, 0),
                                       jnp.repeat(v, 4, 0), **kw)
        return jnp.sum(out * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * float(np.abs(b).max()), (name, err)


def test_serving_outputs_unchanged_by_the_autograd_dispatch(smoke):
    """Under ``torch.no_grad`` the ops go through the autograd Functions;
    the prefill's logits and cache are bitwise those of the forward
    wrappers called directly, as serving called them before."""
    jcfg, jp, tcfg = smoke
    tp = _port_params(tcfg, jp)
    batch = {"tokens": _t(_batch(2, 24, seed=11)["tokens"])}
    new = tmodel.prefill(tcfg, tp, batch, 32)
    saved = ops.flash_attention_fn, ops.rglru_scan_fn
    try:
        ops.flash_attention_fn = flash_attention
        ops.rglru_scan_fn = rglru_scan
        old = tmodel.prefill(tcfg, tp, batch, 32)
    finally:
        ops.flash_attention_fn, ops.rglru_scan_fn = saved
    assert torch.equal(new[0], old[0])
    for c_new, c_old in zip(new[1], old[1]):
        for key in c_new:
            assert torch.equal(c_new[key], c_old[key])


# ---------------------------------------------------------------------------
# The policy fit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def policy_fits():
    """The JAX trainer and the port's on the fixture's split, at
    TrainConfig(hidden=16, epochs=30, seed=0), each step's loss
    recorded."""
    j_losses, t_losses = [], []
    jit = jax.jit

    def recording_jit(fn):
        compiled = jit(fn)

        def run(*args):
            out = compiled(*args)
            j_losses.append(float(out[2]))
            return out
        return run

    orig_step = ttrain._step

    def recording_step(*args):
        out = orig_step(*args)
        t_losses.append(float(out[1]))
        return out

    jtr, jho = jpol.split(jpol.load_traces(FIXTURE))
    ttr, tho = tpol.split(tpol.load_traces(FIXTURE))
    kw = dict(hidden=16, epochs=30, seed=0)
    jax.jit = recording_jit
    ttrain._step = recording_step
    try:
        j = jpol.train_policy(jtr, jho, JTrainConfig(**kw))
        t = tpol.train_policy(ttr, tho, tpol.TrainConfig(**kw), device="cpu")
    finally:
        jax.jit = jit
        ttrain._step = orig_step
    return j, t, j_losses, t_losses, (ttr, tho)


def test_policy_fit_losses_match_jax(policy_fits):
    _, _, j_losses, t_losses, _ = policy_fits
    assert len(t_losses) == len(j_losses) >= 20
    np.testing.assert_allclose(t_losses[:20], j_losses[:20], rtol=1e-4)


def test_policy_fit_agreement_matches_jax(policy_fits):
    (jp, jm), (tp, tm), _, _, _ = policy_fits
    assert set(tp) == set(jp)
    assert all(a.dtype == np.float32 for a in tp.values())
    for key in ("train_agreement", "holdout_agreement"):
        assert abs(tm[key] - jm[key]) <= 0.01, (key, tm[key], jm[key])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    assert tm["n_train"] == jm["n_train"]


def test_policy_fit_is_deterministic(policy_fits):
    _, (tp, tm), _, _, (ttr, tho) = policy_fits
    tp2, tm2 = tpol.train_policy(ttr, tho, tpol.TrainConfig(
        hidden=16, epochs=30, seed=0), device="cpu")
    assert tm2 == tm
    for key in tp:
        np.testing.assert_array_equal(tp2[key], tp[key])


def test_policy_offline_rl_mode(policy_fits):
    """The reference's offline-RL case: reward weights normalised to a
    mean of 1, and the same loss as the JAX trainer's."""
    _, _, _, _, (ttr, tho) = policy_fits
    kw = dict(hidden=8, epochs=2, mode="offline-rl", qos_penalty=8.0)
    _, m = tpol.train_policy(ttr, None, tpol.TrainConfig(**kw),
                             device="cpu")
    assert m["mode_weight_mean"] == pytest.approx(1.0, abs=1e-5)
    jtr, _ = jpol.split(jpol.load_traces(FIXTURE))
    _, jm = jpol.train_policy(jtr, None, JTrainConfig(**kw))
    assert m["mode_weight_mean"] == pytest.approx(jm["mode_weight_mean"],
                                                  abs=1e-6)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
    with pytest.raises(ValueError):
        tpol.train_policy(ttr, tho, tpol.TrainConfig(mode="bogus"),
                          device="cpu")


# ---------------------------------------------------------------------------
# Data, checkpoints, fault tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seq,batch", [("gemma2-2b", 32, 4),
                                           (ARCH, 64, 2)])
def test_token_pipeline_equals_reference(arch, seq, batch):
    jp = jpipe.TokenPipeline(jbase.get_smoke_config(arch),
                             jbase.InputShape("t", seq, batch, "train"),
                             seed=3)
    tp = tpipe.TokenPipeline(tbase.get_smoke_config(arch),
                             tbase.InputShape("t", seq, batch, "train"),
                             seed=3)
    for step in (0, 1, 7):
        a, b = tp.batch(step), jp.batch(step)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tp.shard_batch(2, 1, 2)["tokens"],
                                  jp.shard_batch(2, 1, 2)["tokens"])


def test_byte_corpus_equals_reference():
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src",
                        "repro", "data")
    a = tpipe.ByteCorpus(root=root, max_bytes=1 << 14).batch(3, 4, 48)
    b = jpipe.ByteCorpus(root=root, max_bytes=1 << 14).batch(3, 4, 48)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def _state(seed):
    rng = np.random.default_rng(seed)
    params = {"w": _t(rng.standard_normal((3, 4)).astype(np.float32)),
              "layers": [{"scale": _t(rng.standard_normal(4)
                                      .astype(np.float32))}]}
    opt = tadamw.init(params, tadamw.AdamWConfig(moment_dtype="bfloat16"))
    opt.m["w"].fill_(0.5)
    return {"params": params, "opt": opt._replace(
        step=torch.tensor(seed, dtype=torch.int32))}


def test_checkpoint_round_trip_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3):
        tckpt.save(d, step, _state(step), keep=2)
    assert sorted(os.listdir(d)) == ["step_000000002", "step_000000003"]
    assert tckpt.latest_step(d) == 3
    state, meta = tckpt.restore(d, _state(0), device="cpu")
    want = _state(3)
    assert meta["step"] == 3
    assert isinstance(state["opt"], tadamw.OptState)
    assert state["opt"].m["w"].dtype == torch.bfloat16
    for key in ("w",):
        assert torch.equal(state["params"][key], want["params"][key])
        assert torch.equal(state["opt"].m[key], want["opt"].m[key])
    assert torch.equal(state["params"]["layers"][0]["scale"],
                       want["params"]["layers"][0]["scale"])
    assert int(state["opt"].step) == 3
    with np.load(os.path.join(d, "step_000000003", "arrays.npz")) as z:
        assert "opt/m/layers/0/scale" in z.files


def test_checkpoint_restore_given_step_and_checks(tmp_path):
    d = str(tmp_path / "ck")
    for step in (4, 8):
        tckpt.save(d, step, _state(step))
    state, meta = tckpt.restore(d, _state(0), device="cpu", step=4)
    assert meta["step"] == 4
    assert torch.equal(state["params"]["w"], _state(4)["params"]["w"])
    bad = _state(0)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tckpt.restore(d, bad, device="cpu")
    bad = _state(0)
    bad["params"]["w"] = torch.zeros(3, 4, dtype=torch.float64)
    with pytest.raises(TypeError):
        tckpt.restore(d, bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), _state(0), device="cpu")


def test_straggler_detector_flags_slow_host():
    sd = StragglerDetector(k_sigma=3.0, min_samples=5)
    rng = np.random.default_rng(0)
    for _ in range(50):
        for h in range(8):
            sd.record(h, 1.0 + 0.01 * rng.standard_normal())
        sd.record(8, 2.5 + 0.01 * rng.standard_normal())  # straggler
    assert sd.stragglers() == [8]


def test_straggler_detector_quiet_on_uniform_fleet():
    sd = StragglerDetector()
    for _ in range(30):
        for h in range(8):
            sd.record(h, 1.0)
    assert sd.stragglers() == []


def test_watchdog():
    t = [0.0]
    wd = Watchdog(timeout_s=10.0, clock=lambda: t[0])
    wd.beat(1)
    t[0] = 5.0
    assert not wd.stalled()
    t[0] = 16.0
    assert wd.stalled()
    wd.beat(2)
    assert not wd.stalled()


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 4096))
def test_plan_elastic_mesh_properties(n):
    shape, axes = plan_elastic_mesh(n, model_parallel=16, pod_size=256)
    used = int(np.prod(shape))
    assert used <= n                       # never over-subscribes
    assert len(shape) == len(axes)
    if n >= 16:
        assert shape[-1] == 16             # TP degree preserved
        assert used >= (n // 256) * 256 or used >= 16
    if n >= 512:
        assert axes[0] == "pod"            # multi-pod when possible


def test_plan_elastic_mesh_shrinks_after_node_loss():
    full, _ = plan_elastic_mesh(512)
    degraded, axes = plan_elastic_mesh(512 - 16)   # lost one 16-chip node
    assert int(np.prod(degraded)) < int(np.prod(full))
    assert degraded[-1] == 16


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_step=3)
    for i in range(3):
        inj.maybe_fail(i)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)  # second call: already fired


SHAPE = tbase.InputShape("t", 32, 2, "train")


def test_train_fail_resume_end_to_end(tmp_path):
    """The drill on the CPU: train, die at step 6, resume from the step-4
    checkpoint, finish; the final checkpoint is step 10."""
    cfg = tbase.get_smoke_config(ARCH)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(InjectedFailure):
        tlaunch.train_loop(cfg, SHAPE, steps=10, ckpt_dir=ckpt, save_every=4,
                           fail_at=6, quiet=True, device="cpu")
    assert tckpt.latest_step(ckpt) == 4
    _state, history = tlaunch.train_loop(cfg, SHAPE, steps=10, ckpt_dir=ckpt,
                                         resume=True, save_every=4,
                                         quiet=True, device="cpu")
    assert len(history) == 6               # steps 4..9
    assert np.isfinite(history[-1])
    assert tckpt.latest_step(ckpt) == 10


def test_resume_is_deterministic(tmp_path):
    """The stateless pipeline and the checkpointed state reproduce the
    uninterrupted run's losses."""
    cfg = tbase.get_smoke_config(ARCH)
    oc = tadamw.AdamWConfig(total_steps=8, warmup_steps=1)
    _, straight = tlaunch.train_loop(cfg, SHAPE, steps=8, quiet=True,
                                     opt_cfg=oc, device="cpu")
    ckpt = str(tmp_path / "ckpt2")
    tlaunch.train_loop(cfg, SHAPE, steps=4, ckpt_dir=ckpt, save_every=4,
                       quiet=True, opt_cfg=oc, device="cpu")
    _, resumed = tlaunch.train_loop(cfg, SHAPE, steps=8, ckpt_dir=ckpt,
                                    resume=True, quiet=True, opt_cfg=oc,
                                    device="cpu")
    np.testing.assert_allclose(straight[4:], resumed, rtol=1e-4)


def test_train_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "16", "--device", "cpu"])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "[train] done: 3 steps" in out
