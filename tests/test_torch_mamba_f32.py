"""mamba2 in f32 on the CPU: the port against the JAX package at the
published SSD shape, the AdamW update with float16 moments against the
reference's, the SSD kernels' path by dtype and shape, and the 3xTF32
rounding of the f32 tensor-core SSD kernels modelled in PyTorch against
float64.

The model is ``get_config("mamba2-2.7b")`` in f32 (``dtype="float32"``,
as ``examples/train_lm.py`` sets its config), at its SSD shape (d_state
128, head dim 64, one group) but narrowed to d_model 256 (8 heads), 2
layers and vocab 256; weights come across from the JAX model through
``models/convert.py``.  Inputs are drawn with numpy from a seed.

Tolerances: prefill logits and final SSM states within 1e-4 of their
largest |value| (f32; the port scans in chunks of 64, the reference in
its own); every gradient leaf within 1e-4 relative in norm; AdamW's
parameters and norm within 1e-6 (the same f32 arithmetic in the same
order), its float16 moments within one float16 ulp (rtol 1e-3, and one
subnormal ulp, 2^-24, absolute): both sides round the f32 moment to
float16 at the store; the rounding model's outputs and gradients within
``SSD_TOL`` (1e-4) of their largest |value| from float64, the card
tests' f32 tolerance for the SSD kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import CHUNK
from repro_torch.models import model as tmodel
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw as tadamw

ARCH = "mamba2-2.7b"
NARROW = dict(dtype="float32", d_model=256, n_layers=2, vocab_size=256)
TOL = 1e-4
SSD_TOL = 1e-4
ADAMW_TOL = 1e-6
F16_RTOL, F16_ATOL = 1e-3, 2.0 ** -24


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, port params): mamba2-2.7b in
    f32, narrowed, the port's weights converted from the JAX model's."""
    jcfg = jbase.get_config(ARCH).replace(**NARROW)
    tcfg = tbase.get_config(ARCH).replace(**NARROW)
    assert (tcfg.ssd.d_state, tcfg.ssd.head_dim, tcfg.ssd.n_groups) == \
        (128, 64, 1)
    assert tcfg.ssd.n_heads(tcfg.d_model) == 8
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _jax_layers(cfg, tree):
    """The reference's head / stacked body / tail cache as a per-layer
    list in layer order (the port's cache layout)."""
    _, period, n_periods, _ = jmodel.block_structure(cfg)
    out = list(tree["head"])
    for j in range(n_periods):
        for pi in range(len(period)):
            out.append(jax.tree.map(lambda a: a[j], tree["body"][f"p{pi}"]))
    return out + list(tree["tail"])


def test_f32_prefill_matches_the_jax_model(model):
    """Prefill of a ragged S = 130 (two chunks of 64 and two rows): the
    last logits and every layer's final SSM state, in f32, within 1e-4 of
    their largest |value| of the JAX model's."""
    jcfg, jp, tcfg, tp = model
    toks = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 130)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 160)
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, 160)
    assert tl.dtype == torch.float32
    _within(tl.numpy(), jl, TOL, "logits")
    jlayers = _jax_layers(jcfg, jc)
    assert len(tc) == len(jlayers) == 2
    for i, (t_layer, j_layer) in enumerate(zip(tc, jlayers)):
        assert t_layer["h"].dtype == torch.float32
        _within(t_layer["h"].numpy(), j_layer["h"], TOL, f"layer {i} h")


def test_f32_gradients_match_jax_grad(model):
    """The loss (remat on) and every gradient leaf within 1e-4 of
    ``jax.value_and_grad(repro.models.steps.loss_fn)`` relative in norm,
    none zero where the JAX model's is not: the port's SSD backward (its
    plain version on the CPU) against XLA's differentiation of the
    reference's chunked SSD."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(12)
    b = {k: rng.integers(0, tcfg.vocab_size, (2, 130)).astype(np.int32)
         for k in ("tokens", "targets")}
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, b),
                                 remat=True), has_aux=True))(jp)
    named = tadamw.leaves_with_path(tp)
    leaves = [p.requires_grad_(True) for _, p in named]
    loss, _ = tsteps.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                         for k, v in b.items()}, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL)
    from repro_torch.distributed.steps import _like
    got = params_to_numpy(tcfg, _like(tp, iter(grads)))
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, e) in zip(g, w):
        a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
        name = jax.tree_util.keystr(path)
        assert np.any(a) or not np.any(e), f"{name} lost"
        rel = np.linalg.norm(a - e) / max(np.linalg.norm(e), 1e-30)
        assert rel <= TOL, (name, rel)


def _adamw_tree(rng):
    """A nested tree whose names cover the decay rule, lengths 1 to a few
    hundred, f32."""
    def a(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return {"w_q": a(4, 3), "norm": {"scale": a(7)},
            "layers": [{"bias1": a(5), "w1": a(33, 9), "D": a(1)},
                       {"a_param": a(4), "conv_w": a(2, 4)}],
            "A_log": a(3), "table": a(64, 5)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def test_float16_moments_init():
    """``init`` with ``moment_dtype="float16"`` makes float16 zeros in the
    parameters' shapes, as the reference's does."""
    rng = np.random.default_rng(4)
    tree = _adamw_tree(rng)
    cfg = tadamw.AdamWConfig(moment_dtype="float16")
    state = tadamw.init(tree, cfg)
    want = jadamw.init(_map(lambda t: jnp.asarray(t.numpy()), tree),
                       jadamw.AdamWConfig(moment_dtype="float16"))
    for got, ref_tree in ((state.m, want.m), (state.v, want.v)):
        for (_, a), (_, b) in zip(
                _leaves(_map(torch.Tensor.numpy, got)), _leaves(ref_tree)):
            assert a.dtype == np.float16 == np.asarray(b).dtype
            assert a.shape == b.shape and not a.any()


def test_float16_moments_update_matches_the_reference():
    """Three steps of ``update(use_kernel=True)`` on the CPU with float16
    moments against ``repro.optim.adamw.update`` under jit on the same
    numpy leaves: the parameters and the norm within 1e-6, both moments
    within one float16 ulp."""
    rng = np.random.default_rng(5)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=1.0,
              moment_dtype="float16")
    base = _adamw_tree(rng)
    grads = [_map(lambda t: torch.from_numpy(2.0 * rng.standard_normal(
        t.shape).astype(np.float32)), base) for _ in range(3)]
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    to_j = lambda tree: _map(lambda t: jnp.asarray(t.numpy()), tree)
    jp = to_j(base)
    js = jadamw.init(jp, jcfg)
    tp = _map(torch.clone, base)
    ts = tadamw.init(tp, tcfg)
    jupdate = jax.jit(lambda p, g, s: jadamw.update(p, g, s, jcfg))
    for g in grads:
        jp, js, jm = jupdate(jp, to_j(g), js)
        tp, ts, tm = tadamw.update(tp, g, ts, tcfg, use_kernel=True)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAMW_TOL)
    for got, want, rtol, atol in ((tp, jp, ADAMW_TOL, ADAMW_TOL),
                                  (ts.m, js.m, F16_RTOL, F16_ATOL),
                                  (ts.v, js.v, F16_RTOL, F16_ATOL)):
        for (path, a), b in zip(
                _leaves(_map(torch.Tensor.numpy, got)), jax.tree.leaves(want)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_allclose(
                a.astype(np.float32), np.asarray(b, np.float32), rtol=rtol,
                atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("P,N", [(64, 128), (64, 64), (32, 128), (40, 100),
                                 (16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_path_names_tf32_for_f32_at_mamba2s_shape(dtype, P, N):
    """``path`` and ``bwd_path``: "tf32" for f32 at (64, 128), "wgmma" for
    bf16 there, "simt" at every other shape."""
    want = ("simt" if (P, N) != (64, 128)
            else "tf32" if dtype == torch.float32 else "wgmma")
    assert tssd.path(dtype, P, N) == tssd.bwd_path(dtype, P, N) == want


@pytest.mark.parametrize("name,source", [
    ("ssd_scan_tf32", "ssd_scan_tf32.cu"),
    ("ssd_scan_bwd_tf32", "ssd_scan_bwd_tf32.cu")])
def test_tf32_entry_points_have_their_signatures(name, source):
    """Every ``extern "C"`` function of the f32 tensor-core SSD sources has
    its row in ``_build.SIGNATURES`` with as many arguments, the same as
    its bf16 twin's, and no row names a function the source lacks."""
    import re
    from repro_torch.kernels import _build
    assert _build.SOURCES[name] == source
    src = (_build.CSRC / source).read_text()
    found = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
             for m in re.finditer(r'^extern "C" (?:int|long long) (\w+)'
                                  r'\(([^)]*)\)', src, re.M)}
    sigs = _build.SIGNATURES[name]
    assert set(found) == set(sigs)
    twin = _build.SIGNATURES[name.replace("tf32", "wgmma")]
    for fn, (argtypes, restype) in sigs.items():
        assert len(argtypes) == found[fn], fn
        assert twin[fn.replace("tf32", "wgmma")] == (argtypes, restype), fn


def _ssd_inputs(seed, G, S, with_h0, with_dh, H=4, P=64, N=128):
    """The SSD scan's inputs (x, dA, dt, Bm, Cm, h0) f32 in the kernels'
    layout, dy and dh; h0 and dh None unless asked for.  dt =
    softplus(N(-2, 1)), A in [-16, -1]: mamba2's decays."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    dt = torch.nn.functional.softplus(f(1, H, S) - 2.0)
    A = -torch.linspace(1.0, 16.0, H)
    args = (f(1, H, S, P), dt * A[None, :, None], dt, f(1, G, S, N),
            f(1, G, S, N), f(1, H, P, N) if with_h0 else None)
    return args, f(1, H, S, P), f(1, H, P, N) if with_dh else None


def _f64(args):
    return tuple(None if a is None else a.double() for a in args)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,S", [(1, 200), (2, 200), (1, 129), (2, 129)])
def test_ssd_tf32_split_model_forward_within_card_tolerance(G, S, with_h0):
    """The f32 tensor-core forward's rounding, modelled in PyTorch
    (``ref.ssd_scan_ref(..., split="tf32")``: every product 3xTF32 on the
    operands the kernel feeds the tensor cores, f32 sums and states), at
    mamba2-2.7b's widths (4 heads of 64, d_state 128; S 200 and a ragged
    129; G 1 and 2; with and without h0) against the float64 plain
    version on the same f32 values: y and the final state within the card
    tests' f32 tolerance (1e-4) of their largest |value|.  Worst seen:
    1.11e-6 (y, S 129, G 2) and 1.37e-6 (the state, S 129, G 2, with h0),
    against 1.13e-6 and 1.37e-6 for the unsplit f32 version: the split's
    2^-22 a product is below the f32 sums' own rounding.  The model differs from the unsplit f32 version
    (the split is applied)."""
    args, _, _ = _ssd_inputs(S + G, G, S, with_h0, False)
    y, h = ref.ssd_scan_ref(*args, chunk=CHUNK, split="tf32")
    yp, hp = ref.ssd_scan_ref(*args, chunk=CHUNK)
    yw, hw = ref.ssd_scan_ref(*_f64(args), chunk=CHUNK)
    assert y.dtype == h.dtype == torch.float32
    _within(y.numpy(), yw.numpy(), SSD_TOL, "y")
    _within(h.numpy(), hw.numpy(), SSD_TOL, "h")
    assert not torch.equal(y, yp) and not torch.equal(h, hp)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,S", [(1, 200), (2, 200), (1, 129), (2, 129)])
def test_ssd_bwd_tf32_split_model_within_card_tolerance(G, S, with_h0,
                                                        with_dh):
    """The f32 tensor-core backward's rounding, modelled in PyTorch
    (``ref.ssd_scan_bwd_ref(..., split="tf32")``: every product 3xTF32,
    R B and R^T C taken on R summed over each tile of a group's heads,
    the walks' running states and everything else f32), at the forward
    test's shapes, with and without a gradient by the final state,
    against the float64 plain backward on the same f32 values: each of
    dx, ddA, ddt, dB, dC and dh0 within the card tests' f32 tolerance
    (1e-4) of its largest |value|.  Worst seen: 3.86e-6 (dC, S 129, G 1),
    against 3.96e-6 for the unsplit f32 backward.  The model differs from
    the unsplit f32 backward (the split is applied)."""
    args, dy, dh = _ssd_inputs(S + 7 * G, G, S, with_h0, with_dh)
    got = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK, split="tf32")
    plain = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK)
    want = ref.ssd_scan_bwd_ref(*_f64(args), dy.double(),
                                None if dh is None else dh.double(),
                                chunk=CHUNK)
    for name, g, w in zip(("dx", "ddA", "ddt", "dB", "dC", "dh0"), got,
                          want):
        assert g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        _within(g.numpy(), w.numpy(), SSD_TOL, name)
    assert not torch.equal(got[0], plain[0])
    assert not torch.equal(got[5], plain[5])


def test_tf32_mm_is_three_tf32_products():
    """``ref.tf32_mm`` sums lo_a hi_b + hi_a lo_b + hi_a hi_b with every
    term's operands TF32 (10 mantissa bits): within 2^-20 of the f64
    product's scale, where one TF32 product misses by some 2^-11."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((3, 64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 64, 128)).astype(np.float32))
    want = a.double() @ b.double()
    scale = float(want.abs().max())
    got = ref.tf32_mm(a, b)
    assert float((got.double() - want).abs().max()) <= 2.0 ** -20 * scale
    one = ref.tf32_round(a) @ ref.tf32_round(b)
    assert float((one.double() - want).abs().max()) > 2.0 ** -14 * scale
