"""The learned policy of the port (``repro_torch.policy``) against the
reference's (``repro.policy``): the trace dataset, the numpy init, the
torch ``forward`` against the reference's ``np_scores`` and jnp
``forward`` on the matrices of ``tests/data/policy_traces.jsonl``, the
``PolicyStore`` round trip, and the ``"learned"`` stack served from a
store with its hot swap across a live retrain.  The policy is the
numpy init with ``mu``/``sd`` from ``normalization`` (training is not
ported yet); the port serves it on the CPU."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.policy as ref_policy
import repro.policy.train as ref_train
import repro_torch.policy as port_policy
from repro_torch.core.pipeline import DecisionContext
from repro_torch.platform import Platform
from repro_torch.policy import (LearnedScorer, PolicyStore, PolicyStoreError,
                                forward, init_params, load_traces, matrices,
                                normalization, np_scores, top1_agreement)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "policy_traces.jsonl")
#: the torch forward against numpy, per score (f32 products, tanh)
SCORE_TOL = 1e-5
MANIFEST = {
    "scenario": {"kind": "burst-storm", "n_functions": 4,
                 "duration_s": 20, "target_nodes": 8, "seed": 0},
    "scheduler": {"name": "learned"},
    "prediction": {"n_train": 300, "n_trees": 8, "engine": "torch",
                   "device": "cpu"},
}


@pytest.fixture(scope="module")
def ds():
    return load_traces(FIXTURE)


@pytest.fixture(scope="module")
def policy(ds):
    X, mask, _y = matrices(ds)
    p = init_params(ds.n_features, 16, seed=3)
    p["mu"], p["sd"] = normalization(X, mask)
    return p


def test_dataset_matches_reference(ds):
    ref = ref_policy.load_traces(FIXTURE)
    assert ds.feature_names == ref.feature_names
    assert len(ds) == len(ref) > 0
    for got, want in zip(matrices(ds), ref_policy.matrices(ref)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_matches_reference(ds, seed):
    got = init_params(ds.n_features, 16, seed)
    want = ref_train.init_params(ds.n_features, 16, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_forward_matches_np_scores_and_reference(ds, policy):
    """Every candidate row of the fixture: within 1e-5 of ``np_scores``
    and of the reference's jnp ``forward``, and the same masked argmax
    wherever the top-2 margin exceeds that."""
    X, mask, y = matrices(ds)
    t = {k: torch.from_numpy(v) for k, v in policy.items()}
    got = forward(t, torch.from_numpy(X)).numpy()
    assert got.shape == X.shape[:2] and got.dtype == np.float32
    want = ref_train.np_scores(policy, X)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    jp = np.asarray(ref_train.forward(
        {k: jnp.asarray(v) for k, v in policy.items()}, jnp.asarray(X)))
    np.testing.assert_allclose(got, jp, rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(np_scores(policy, X), want)
    masked = want - 1e9 * (1.0 - mask)
    top2 = np.sort(masked, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > SCORE_TOL
    assert clear.sum() > 0
    np.testing.assert_array_equal(
        (got - 1e9 * (1.0 - mask)).argmax(-1)[clear],
        masked.argmax(-1)[clear])
    assert top1_agreement(policy, X, mask, y) == \
        ref_train.top1_agreement(policy, X, mask, y)


def test_scorer_scores_each_decision_as_numpy(ds, policy):
    scorer = LearnedScorer(policy, epoch=0, device="cpu")
    assert scorer.stats.swaps == 1 and scorer.epoch == 0
    for d in ds.decisions[:8]:
        np.testing.assert_allclose(scorer.scores(d.features),
                                   np_scores(policy, d.features),
                                   rtol=0, atol=SCORE_TOL)


def test_store_roundtrip_and_epochs(tmp_path, ds, policy):
    store = PolicyStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.load()
    store.save(policy, epoch=0, mode="imitation",
               feature_names=ds.feature_names)
    store.save(policy, epoch=3, mode="offline-rl")
    assert store.epochs() == [0, 3] and store.latest_epoch() == 3
    _loaded, meta = store.load()
    assert meta["epoch"] == 3 and meta["mode"] == "offline-rl"
    pinned, meta0 = store.load(epoch=0)
    assert tuple(meta0["feature_names"]) == ds.feature_names
    for k, v in policy.items():
        np.testing.assert_array_equal(pinned[k], v)
    # the reference's store reads what the port's wrote
    ref_loaded, _ = ref_policy.PolicyStore(str(tmp_path)).load(epoch=0)
    for k, v in policy.items():
        np.testing.assert_array_equal(ref_loaded[k], v)
    np.savez(tmp_path / "policy_e000005.npz", w1=policy["w1"])
    with pytest.raises(PolicyStoreError):
        store.load(epoch=5)


def record_batches(scorer):
    """Wrap the scorer's batch forward; returns the (rows, scores) list."""
    seen, inner = [], scorer.scores

    def scores(rows):
        out = inner(rows)
        seen.append((rows.copy(), out.copy()))
        return out

    scorer.scores = scores
    return seen


def test_learned_stack_serves_stored_policy(tmp_path, policy):
    PolicyStore(str(tmp_path)).save(policy, epoch=0, mode="imitation")
    m = copy.deepcopy(MANIFEST)
    m["policy"] = {"store": str(tmp_path), "epoch": 0}
    plat = Platform.build(config=m)
    scorer = plat.scheduler.learned_scorer
    assert scorer.policy is not None and scorer.stats.swaps == 1
    assert scorer.device == "cpu"
    seen = record_batches(scorer)
    res = plat.run()
    assert res.ticks == 20 and scorer.stats.batches > 0 and seen
    assert scorer.stats.stale_serves == 0
    for rows, got in seen:
        np.testing.assert_allclose(got, np_scores(policy, rows), rtol=0,
                                   atol=SCORE_TOL)


def test_hot_swap_keeps_stale_serves_zero(tmp_path, policy):
    PolicyStore(str(tmp_path)).save(policy, epoch=0, mode="imitation")
    m = copy.deepcopy(MANIFEST)
    m["policy"] = {"store": str(tmp_path)}
    plat = Platform.build(config=m)
    plat.run()
    sched = plat.scheduler
    scorer, svc = sched.learned_scorer, sched.prediction_service
    swaps0, epoch0 = scorer.stats.swaps, svc.epoch
    svc.retrain()                         # live epoch bump
    assert svc.epoch == epoch0 + 1
    assert scorer.stats.swaps == swaps0 + 1
    assert scorer.expected_epoch == svc.epoch == scorer.epoch
    fn = next(iter(plat.cluster.specs))
    ctx = DecisionContext(sched, fn, 1, 21.0, None)
    nodes = list(plat.cluster.nodes.values())[:4]
    assert len(scorer.score_batch(ctx, nodes)) == len(nodes)
    assert scorer.stats.stale_serves == 0
    # a missed swap is counted
    scorer.expect(scorer.epoch + 1)
    scorer.score_batch(ctx, nodes)
    assert scorer.stats.stale_serves == 1


def test_scorer_stage_serves_on_the_forest_device():
    from repro_torch.platform import get_stage
    plat = Platform.build(config=copy.deepcopy(MANIFEST))
    stage = get_stage("scorer", "learned")(plat.scheduler)
    assert isinstance(stage, LearnedScorer) and stage.device == "cpu"
    assert plat.scheduler.learned_scorer.device == "cpu"
    assert sorted(port_policy.__all__) == sorted(
        n for n in ref_policy.__all__
        if n not in ("TrainConfig", "train_policy"))
