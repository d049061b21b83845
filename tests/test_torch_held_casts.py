"""The one-card train step's held bf16 working copies of the f32 master
weights (``models.model.held_copies``, ``models.layers.cast`` /
``held_casts`` / ``HeldCast``, the AdamW update's writer), on the CPU,
where the update's plain version writes them.

With f32 parameters and bf16 compute, three ``held=True`` steps are
held bitwise (``torch.equal``) to three ``held=False`` steps, today's
casts at use, at every architecture's smoke config: losses, gradient
norms, every parameter and moment.  Each held copy stays bitwise its
master's cast after every step and after a checkpoint's restore; no f32
leaf is cast at use without a copy inside a held step, and every copy
is read.  The JAX package is compared once: the held path's loss and
gradients against ``jax.grad`` of the reference's loss on the same numpy
weights and batch at recurrentgemma-2b's smoke config in bf16 compute,
within 5e-2 relative in norm per leaf (the repo's bf16 gradient
tolerance, ``PERF.md`` §2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import base as tbase
from repro_torch.distributed import make_train_step
from repro_torch.distributed import steps as steps_mod
from repro_torch.kernels import adamw as kadamw
from repro_torch.launch.train import build_state
from repro_torch.models import layers, params_from_numpy
from repro_torch.models import model as tmodel
from repro_torch.models import steps as tsteps
from repro_torch.models.steps import make_train_batch
from repro_torch.optim import adamw as tadamw

SHAPE = tbase.InputShape("t", 32, 2, "train")
OPT = tadamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6)
#: the relative error in norm allowed a gradient leaf in bf16 compute
BF16_GRAD_TOL = 5e-2


def _cfg(arch, dtype="bfloat16"):
    cfg = tbase.get_smoke_config(arch).replace(dtype=dtype)
    return cfg.replace(n_layers=2) if arch == "mamba2-2.7b" else cfg


def _batches(cfg, n):
    return [make_train_batch(cfg, SHAPE, np.random.default_rng(40 + i),
                             "cpu") for i in range(n)]


def _state_tensors(state):
    """The parameters' and moments' tensors and the step count: the held
    copies left out."""
    return steps_mod._tensors({"params": state["params"],
                               "opt": state["opt"]})


def _assert_copies_fresh(state):
    """Every held copy bitwise its master's cast to bf16."""
    held = state["held"]
    named = tadamw.leaves_with_path(state["params"])
    for path, p in named:
        h = held.get(tadamw.keystr(path))
        if h is not None:
            assert h.dtype == torch.bfloat16 and h.is_contiguous()
            assert torch.equal(h, p.detach().to(torch.bfloat16)), path
    assert set(held) <= {tadamw.keystr(path) for path, _ in named}


def _run(cfg, held: bool, steps: int = 3, microbatch: int = 1, after=None):
    """`steps` steps from seed 0 -> (losses, norms, final state); after
    each step ``after(state)``."""
    fn = make_train_step(cfg, None, SHAPE, OPT, microbatch=microbatch,
                         device="cpu", held=held).fn
    state = build_state(cfg, OPT, 0, "cpu")
    losses, norms = [], []
    for b in _batches(cfg, steps):
        state, m = fn(state, b)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if after is not None:
            after(state)
    return losses, norms, state


def _assert_runs_equal(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b), (a, b)
    ta, tb = _state_tensors(got[2]), _state_tensors(want[2])
    assert len(ta) == len(tb)
    for i, (a, b) in enumerate(zip(ta, tb)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.fixture
def reads(monkeypatch):
    """The held copies ``HeldCast`` was handed, by id, and the misses
    counted from zero."""
    seen = set()
    apply = layers.HeldCast.apply

    def recorded(w, held):
        seen.add(id(held))
        return apply(w, held)
    monkeypatch.setattr(layers.HeldCast, "apply", recorded)
    monkeypatch.setattr(layers.cast, "misses", 0)
    return seen


@pytest.mark.parametrize("arch", tuple(tbase.list_archs()))
def test_held_steps_are_bitwise_the_casts_at_use(arch, reads):
    """Three held steps of the smoke model with f32 weights and bf16
    compute bitwise three ``held=False`` steps: every loss and gradient
    norm, every parameter, moment and the step count; each copy its
    master's cast after every step; no f32 leaf cast without a copy, and
    every copy read by the forward."""
    cfg = _cfg(arch)
    got = _run(cfg, True, after=_assert_copies_fresh)
    assert layers.cast.misses == 0
    held = got[2]["held"]
    assert held and {id(h) for h in held.values()} == reads
    want = _run(cfg, False)
    assert "held" not in want[2]
    _assert_runs_equal(got, want)


def test_held_microbatched_step_is_bitwise_the_casts_at_use():
    """With the batch split in two microbatches, the held copies serve
    both forwards: three steps bitwise ``held=False``'s."""
    cfg = _cfg("recurrentgemma-2b")
    got = _run(cfg, True, microbatch=2, after=_assert_copies_fresh)
    _assert_runs_equal(got, _run(cfg, False, microbatch=2))


def test_copies_are_never_checkpointed_and_are_made_anew_on_restore(
        tmp_path):
    """A checkpoint of a state with copies saves its parameters and
    moments only; a template holding copies restores without them; the
    restored state's next step makes them anew from the restored
    weights, and the run is bitwise three uninterrupted held steps."""
    cfg = _cfg("recurrentgemma-2b")
    fn = make_train_step(cfg, None, SHAPE, OPT, device="cpu").fn
    state = build_state(cfg, OPT, 0, "cpu")
    b0, b1, b2 = _batches(cfg, 3)
    state, _ = fn(state, b0)
    state, _ = fn(state, b1)
    path = ckpt_lib.save(str(tmp_path), 2, state)
    with np.load(f"{path}/arrays.npz") as npz:
        assert npz.files and not any(k.startswith("held") for k in npz.files)
    restored, meta = ckpt_lib.restore(str(tmp_path), state, "cpu")
    assert meta["step"] == 2 and "held" not in restored
    restored, m = fn(restored, b2)
    _assert_copies_fresh(restored)
    want = _run(cfg, True)
    assert torch.equal(m["loss"], want[0][-1])
    _assert_runs_equal(([], [], restored), ([], [], want[2]))
    for k in restored["held"]:
        assert torch.equal(restored["held"][k], want[2]["held"][k]), k


def test_a_step_without_holding_refreshes_the_copies_it_finds():
    """A ``held=False`` step on a state that holds copies casts at use
    and still rewrites each copy with its new weights, so none is stale
    for a held step after it."""
    cfg = _cfg("recurrentgemma-2b")
    state = build_state(cfg, OPT, 0, "cpu")
    b = _batches(cfg, 2)
    state, _ = make_train_step(cfg, None, SHAPE, OPT, device="cpu").fn(
        state, b[0])
    before = {k: h.clone() for k, h in state["held"].items()}
    state, _ = make_train_step(cfg, None, SHAPE, OPT, device="cpu",
                               held=False).fn(state, b[1])
    _assert_copies_fresh(state)
    assert any(not torch.equal(before[k], h)
               for k, h in state["held"].items())


@pytest.mark.parametrize("case", ["f32 compute", "bf16 state",
                                  "cast_params"])
def test_no_copies_where_the_step_casts_nothing_or_casts_at_entry(case):
    """No copy is made where no f32 leaf is cast to a bf16 compute dtype
    (f32 compute; deepseek-v2's bf16 state, whose router is read in f32)
    or where ``cast_params`` casts the matrices at the step's entry; the
    step runs as before."""
    arch = "deepseek-v2-236b" if case == "bf16 state" else "gemma2-2b"
    cfg = _cfg(arch, "float32" if case == "f32 compute" else "bfloat16")
    fn = make_train_step(cfg, None, SHAPE, OPT, device="cpu",
                         cast_params=case == "cast_params").fn
    dtype = torch.bfloat16 if case == "bf16 state" else torch.float32
    state = build_state(cfg, OPT, 0, "cpu", param_dtype=dtype)
    state, m = fn(state, _batches(cfg, 1)[0])
    assert "held" not in state and np.isfinite(float(m["loss"]))


def test_held_cast_gradient_is_bitwise_the_casts_on_a_product_used_twice():
    """A weight used twice through ``cast`` inside ``held_casts`` (two
    ``HeldCast`` nodes) gets the gradient ``.to()`` gives, bitwise: each
    use's bf16 gradient widened to f32 and the two added in f32; the
    forward returns the copy's values without copying them."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(48, 40, generator=gen)
    x = torch.randn(5, 48, generator=gen).bfloat16()
    y = torch.randn(7, 48, generator=gen).bfloat16()
    held = w.to(torch.bfloat16)

    def grad(holding):
        leaf = w.clone().requires_grad_(True)
        pairs = [(leaf, held)] if holding else []
        with layers.held_casts(pairs):
            a = layers.cast(leaf, torch.bfloat16)
            out = (x @ a).float().square().sum() + (
                y @ layers.cast(leaf, torch.bfloat16)).float().sum()
            if holding:
                assert a.data_ptr() == held.data_ptr()
                assert a.grad_fn is not None
        return torch.autograd.grad(out, leaf)[0]
    want, got = grad(False), grad(True)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_held_cast_gradient_is_bitwise_through_the_chunked_loss():
    """The tied table's gradient through ``chunked_xent``'s chunks, each
    under ``torch.utils.checkpoint`` (a ``HeldCast`` in each chunk's
    forward and again in its recomputation), bitwise ``.to()``'s."""
    cfg = _cfg("gemma2-2b")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    h = torch.randn(2, 40, cfg.d_model, generator=gen).bfloat16()
    targets = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    table = params["embed"]["table"]
    held = tmodel.held_copies(cfg, params)["['embed']['table']"]

    def grad(holding):
        leaf = table.clone().requires_grad_(True)
        p = {**params, "embed": {"table": leaf}}
        with layers.held_casts([(leaf, held)] if holding else []):
            loss, _ = tsteps.chunked_xent(cfg, p, h, targets, chunk=8)
            return torch.autograd.grad(loss, leaf)[0]
    assert torch.equal(grad(True), grad(False))


def test_plain_writer_is_bitwise_the_cast_sliced_or_not(monkeypatch):
    """``adamw_update`` on the CPU and ``plain_update`` (also sliced along
    the first axis, as large leaves are) write the new weights' bf16 cast
    into the copy and update p, m and v bitwise as without it; a copy of
    another dtype or beside bf16 weights raises."""
    gen = torch.Generator().manual_seed(7)
    cfg = tadamw.AdamWConfig()
    sc = [torch.tensor(x) for x in (0.5, 3e-4, 1 - 0.9 ** 2, 1 - 0.95 ** 2)]
    p, g, m = (torch.randn(37, 11, generator=gen) for _ in range(3))
    v = torch.rand(37, 11, generator=gen) * 1e-2
    want = [t.clone() for t in (p, m, v)]
    tadamw._update_leaf(want[0], g, want[1], want[2], cfg, *sc, True)
    monkeypatch.setattr(tadamw, "SLICE_ELEMENTS", 64)
    for update in (kadamw.adamw_update, tadamw.plain_update):
        got = [t.clone() for t in (p, m, v)]
        held = torch.zeros(37, 11, dtype=torch.bfloat16)
        update(got[0], g, got[1], got[2], cfg, *sc, True, held)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(held, want[0].to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        kadamw.adamw_update(p.clone(), g, m.clone(), v.clone(), cfg, *sc,
                            True, torch.zeros(37, 11))
    with pytest.raises(TypeError, match="bfloat16"):
        kadamw.adamw_update(p.bfloat16(), g, m.clone(), v.clone(), cfg, *sc,
                            True, torch.zeros(37, 11, dtype=torch.bfloat16))


@pytest.fixture
def stand_in(monkeypatch):
    """``TrainStep``'s warm-up and capture replaced by a stand-in graph
    that runs the step at each replay, so that the graphed path's
    bookkeeping runs on the CPU."""
    class Graph:
        def __init__(self, run):
            self.run, self.metrics = run, {}

        def replay(self):
            for k, v in self.run()[1].items():
                self.metrics.setdefault(k, torch.empty_like(v)).copy_(v)

    def capture(device, run, pool_for=None):
        g = Graph(run)
        return g, (None, g.metrics), [], 0
    monkeypatch.setattr(steps_mod, "warm_up", lambda device, run: run())
    monkeypatch.setattr(steps_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_graphed_step_makes_the_copies_before_its_capture(stand_in):
    """Through the graphed path (a stand-in graph): the first call makes
    the state's copies before it binds the state's addresses, so the
    later calls replay rather than capture anew, and the run is bitwise
    the eager ``held=False`` run."""
    cfg = _cfg("recurrentgemma-2b")
    fn = make_train_step(cfg, None, SHAPE, OPT, device="cpu").fn
    fn.graphed = True
    state = build_state(cfg, OPT, 0, "cpu")
    losses, norms = [], []
    for b in _batches(cfg, 3):
        state, m = fn(state, b)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    assert (fn.captures, fn.replays) == (1, 2)
    assert any(t is next(iter(state["held"].values())) for t in fn._bound)
    _assert_copies_fresh(state)
    _assert_runs_equal((losses, norms, state), _run(cfg, False))


def _bf16_smoke():
    """(JAX config, JAX params, port config) of recurrentgemma-2b's smoke
    model computed in bf16, the parameters f32."""
    jcfg = jbase.get_smoke_config("recurrentgemma-2b").replace(
        dtype="bfloat16")
    return (jcfg, jmodel.init_params(jcfg, jax.random.PRNGKey(0)),
            _cfg("recurrentgemma-2b"))


def test_held_step_matches_jax_grad_in_bf16_compute():
    """On the same numpy weights and batch (recurrentgemma-2b's smoke
    config, f32 weights, bf16 compute): the held step's loss, and the
    held path's gradients (the forward and its recomputations reading
    the copies), within BF16_GRAD_TOL of ``jax.value_and_grad`` of the
    reference's loss, each gradient leaf relative in norm."""
    jcfg, jp, tcfg = _bf16_smoke()
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch),
                                 remat=True), has_aux=True))(jp)
    jflat = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
             for k, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def port_params():
        return params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    params = port_params()
    named = tadamw.leaves_with_path(params)
    held = tmodel.held_copies(tcfg, params)
    leaves = [p.requires_grad_(True) for _, p in named]
    with layers.held_casts([(p, held[tadamw.keystr(k)]) for k, p in named
                            if tadamw.keystr(k) in held]):
        loss, _ = tsteps.loss_fn(tcfg, params, tb, remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    state = {"params": port_params()}
    state["opt"] = tadamw.init(state["params"], OPT)
    _, m = make_train_step(tcfg, None, SHAPE, OPT, device="cpu").fn(state,
                                                                     tb)
    assert "held" in state
    assert torch.equal(m["loss"], loss.detach())
    np.testing.assert_allclose(float(m["loss"]), float(jloss),
                               rtol=BF16_GRAD_TOL)
    from repro_torch.models import params_to_numpy
    got = params_to_numpy(tcfg, steps_mod._like(params, iter(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(leaves, grads)])))
    gflat = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
             for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert gflat.keys() == jflat.keys()
    for k, want in jflat.items():
        err = np.linalg.norm(gflat[k] - want)
        assert err <= BF16_GRAD_TOL * max(np.linalg.norm(want), 1e-30), (
            k, err, np.linalg.norm(want))
