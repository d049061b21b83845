"""The twins of the JAX package's examples on the CPU:
``launch/train_lm.py`` (``examples/train_lm.py``, the ~100M byte-level
training driver), ``launch/quickstart.py`` and
``launch/dryrun_multipod.py``.

The training twin builds the example's config, shape and AdamW settings;
three steps of its config through the port's train step (from
``train_state_from_numpy`` of the reference's initial state) give losses
within 1e-4 of the reference's jitted ``loss_fn`` + ``adamw.update`` on
the same ``ByteCorpus`` batches, at the ``--tiny`` widths and at a
2-layer narrow variant with the example's head dim of 96 and gemma2's
softcap of 50 (on the card the 3xTF32 kernels' case; here their plain
versions).  The reference's own ``train_loop`` is not run: its train
step fails on a (1, 1) mesh under JAX 0.9 (the fault of the reference's
drill tests).  Its command line trains, checkpoints and resumes on the
CPU, the resumed losses equal to the straight run's.  The quickstart
twin runs whole, its Jiagu placements equal to the reference scheduler's
on the same world; the dry-run twin's summary comes from a cell that
``test_torch_roofline.py`` also traces, on a fake (2, 2) mesh.
"""
import dataclasses
import itertools
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import make_train_step
from repro_torch.launch import dryrun, dryrun_multipod, quickstart, train_lm
from repro_torch.models import train_state_from_numpy

#: losses of the port against the reference's (f32; another summation
#: order in attention and the scan), as test_torch_training.py holds them
LOSS_TOL = 1e-4


def _example_config(tiny: bool):
    """The reference's config as examples/train_lm.py builds it."""
    base = jbase.get_config("gemma2-2b")
    if tiny:
        return base.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, d_ff=512, vocab_size=256,
                            window=128, dtype="float32")
    return base.replace(n_layers=10, d_model=768, n_heads=8, n_kv_heads=4,
                        head_dim=96, d_ff=3072, vocab_size=256, window=512,
                        dtype="float32")


@pytest.mark.parametrize("tiny", [False, True], ids=["100m", "tiny"])
def test_twin_builds_the_examples_config_shape_and_adamw(tiny):
    """The twin's config is the example's field for field (the 100M one
    has 88,685,568 parameters, head dim 96 and gemma2's softcap of 50);
    its shape and AdamW settings are the example's."""
    got, want = train_lm.config(tiny), _example_config(tiny)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    if not tiny:
        assert (got.head_dim, got.attn_softcap, got.param_count()) == \
            (96, 50.0, 88_685_568)
    shape = train_lm.shape_of(tiny)
    assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
        ("train_lm", 256 if tiny else 512, 8, "train")
    assert train_lm.shape_of(tiny, 2, 64).global_batch == 2
    for steps in (4, 300):
        want_opt = jadamw.AdamWConfig(lr=6e-4, total_steps=steps,
                                      warmup_steps=max(steps // 20, 1))
        assert train_lm.opt_config(steps)._asdict() == want_opt._asdict()


def _variant(name: str):
    """(reference config, port config, batch, seq): the --tiny widths at a
    short sequence, or the example's 100M config narrowed to 2 layers at
    its head dim of 96, softcap 50, in a window the sequence crosses."""
    if name == "tiny":
        return _example_config(True), train_lm.config(True), 4, 96
    narrow = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                  d_ff=256, window=48)
    return (_example_config(False).replace(**narrow),
            train_lm.config(False).replace(**narrow), 2, 96)


@pytest.fixture(scope="module")
def corpus():
    return tpipe.ByteCorpus()


@pytest.mark.parametrize("name", ["tiny", "d96-softcap50"])
def test_three_steps_match_reference_on_byte_batches(corpus, name):
    """Three steps of the twin's config from the reference's initial
    state: the port's train step (remat on, the example's AdamW) against
    the reference's jitted loss_fn + adamw.update on the same ByteCorpus
    batches, each loss within 1e-4; both corpora give the same bytes."""
    jcfg, tcfg, B, S = _variant(name)
    assert (tcfg.head_dim, tcfg.attn_softcap) == (
        (32, 50.0) if name == "tiny" else (96, 50.0))
    jo = jadamw.AdamWConfig(lr=6e-4, total_steps=300, warmup_steps=15)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    state = {"params": jp, "opt": jadamw.init(jp, jo)}
    jcorpus = jpipe.ByteCorpus()
    batches = [corpus.batch(i, B, S) for i in range(3)]
    for i, b in enumerate(batches):
        want = jcorpus.batch(i, B, S)
        assert all(np.array_equal(b[k], want[k]) for k in want)

    @jax.jit
    def jstep(state, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: jsteps.loss_fn(jcfg, p, b, remat=True),
            has_aux=True)(state["params"])
        p, o, _ = jadamw.update(state["params"], g, state["opt"], jo)
        return {"params": p, "opt": o}, loss

    tstate = train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, state), device="cpu")
    bundle = make_train_step(tcfg, None, train_lm.shape_of(False, B, S),
                             train_lm.opt_config(300), remat=True,
                             device="cpu")
    for b in batches:
        state, jl = jstep(state, jax.tree.map(jnp.asarray, b))
        tstate, tm = bundle.fn(tstate, {k: torch.from_numpy(np.array(v))
                                        for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jl),
                                   rtol=LOSS_TOL)
    assert int(tstate["opt"].step) == 3


def test_twin_command_line_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``train_lm --tiny --steps 4 --device cpu``: the example's lines,
    finite losses, a checkpoint at the end; a run resumed from the
    straight run's step-2 checkpoint (saved every 2 steps through
    ``run``) gives the straight run's last two losses again, and the same
    command run once more resumes at step 4 and takes no step."""
    straight, resumed = tmp_path / "a", tmp_path / "b"
    argv = ["--tiny", "--steps", "4", "--device", "cpu"]
    times = []
    _state, losses = train_lm.run(
        train_lm.parse(argv + ["--ckpt-dir", str(straight)]), save_every=2,
        times=times)
    out = capsys.readouterr().out
    assert "model: 2L d=128 params=0.5M" in out
    assert f"done. loss: {losses[0]:.3f} -> {losses[-1]:.3f}" in out
    assert len(losses) == 4 == len(times)
    assert all(math.isfinite(x) for x in losses)
    assert sorted(os.listdir(straight)) == ["step_000000002",
                                            "step_000000004"]
    shutil.copytree(straight / "step_000000002",
                    resumed / "step_000000002")
    _state, again = train_lm.run(
        train_lm.parse(argv + ["--ckpt-dir", str(resumed)]))
    assert "[train] resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(again, losses[2:], rtol=0, atol=0)
    train_lm.main(argv + ["--ckpt-dir", str(straight)])
    assert "resumed from step 4" in capsys.readouterr().out


def test_twin_raises_without_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.run(train_lm.parse(["--tiny", "--steps", "1"]))


def test_quickstart_twin_runs_whole_and_places_as_the_reference(
        capsys, monkeypatch):
    """The quickstart on the CPU: 20 finite train steps, 4 requests served
    with 8 new tokens each, and the 5 Jiagu placements (one slow and one
    fast decision) on the nodes the reference's scheduler picks in the
    same world (both packages number nodes from a class-level counter,
    started here at 0 for each)."""
    from repro import core as jcore
    from repro.core import cluster as jcluster
    from repro_torch.core import cluster as tcluster
    for module in (jcluster, tcluster):
        monkeypatch.setattr(module.Node, "_ids", itertools.count())
    got = quickstart.run("cpu")
    out = capsys.readouterr().out
    assert "scheduled 5 replicas: fast=1 slow=1" in out
    losses = got["losses"]
    assert len(losses) == quickstart.TRAIN_STEPS
    assert all(math.isfinite(x) for x in losses)
    assert len(got["served"]) == quickstart.N_REQUESTS
    assert all(len(r.tokens) == 8 for r in got["served"])

    specs = jcore.arch_functions()
    gt = jcore.GroundTruth(seed=0)
    store = jcore.ProfileStore(seed=0)
    qos = jcore.QoSStore(store, gt)
    pred = jcore.PerfPredictor(n_trees=16, max_depth=8, seed=0)
    X, y = jcore.generate_dataset(specs, gt, store, qos, 800, seed=1)
    pred.add_dataset(X, y)
    sched = jcore.JiaguScheduler(jcore.Cluster(specs), store, qos, pred)
    fn = f"serve-{quickstart.ARCH}"
    sched.schedule(fn, 3, now=0.0)
    sched.on_tick(1.0)
    want = sched.schedule(fn, 2, now=2.0)
    assert [(p.node_id, p.count) for p in got["placements"]] == \
        [(p.node_id, p.count) for p in want]
    assert (got["metrics"].fast, got["metrics"].slow) == \
        (sched.metrics.fast, sched.metrics.slow) == (1, 1)


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) ("data", "model") mesh on a fake process group of 4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_world(4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_dryrun_multipod_twin_summarises_a_cell(fake_mesh):
    """The dry-run walkthrough's summary of gemma2-2b x train_4k at its
    smoke config on a fake (2, 2) mesh (a cell test_torch_roofline.py
    traces too): the example's lines, with the record's numbers."""
    rec = dryrun.run_cell("gemma2-2b", "train_4k", "single", mesh=fake_mesh,
                          cfg=tbase.get_smoke_config("gemma2-2b"))
    lines = dryrun_multipod.summary(rec)
    assert lines[0] == "=== gemma2-2b x train_4k x single (16x16) ==="
    rf = rec["roofline"]
    assert lines[1].startswith(f"step={rec['step']} dispatch=")
    assert lines[2] == ("per-device arg bytes: "
                        f"{rec['memory']['arg_bytes_analytic_per_device'] / 2**30:.2f} GiB")
    assert lines[3].endswith(f"-> bottleneck: {rf['bottleneck']}")
    assert lines[4] == (f"useful_ratio={rf['useful_ratio']:.3f} "
                        f"roofline_frac={rf['roofline_frac']:.4f}")
    assert lines[5].startswith("collective schedule: {")
    failed = dict(rec, status="error")
    assert dryrun_multipod.summary(failed)[1] == str(failed)
