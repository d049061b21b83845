"""The port's predictor against the JAX package's: a forest fitted by the
reference and carried across predicts exactly what the reference's numpy
engine predicts, the port's own fit is the reference's fit bit for bit,
and every engine of the port agrees on real trained trees."""
import numpy as np
import pytest
import torch

from repro.core import (GroundTruth, ProfileStore, QoSStore,
                        generate_dataset, synthetic_functions)
from repro.core.predictor import PerfPredictor as JPerfPredictor
from repro.core.predictor import RandomForestRegressor as JForest
from repro_torch.core.predictor import (PerfPredictor, RandomForestRegressor,
                                        forest_from_numpy)
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def dataset():
    specs = synthetic_functions(6, seed=0)
    gt = GroundTruth(seed=0)
    store = ProfileStore(seed=0)
    qos = QoSStore(store, gt)
    return generate_dataset(specs, gt, store, qos, 600, seed=3)


@pytest.fixture(scope="module")
def jax_forest(dataset):
    X, y = dataset
    return JForest(n_trees=12, max_depth=7, seed=0).fit(X, np.log(y))


def test_carried_forest_predicts_as_reference(dataset, jax_forest):
    """ForestArrays fitted by the reference -> the port's torch engine on
    the CPU: bitwise the reference's numpy engine."""
    X, _y = dataset
    a = jax_forest.arrays
    want = jax_forest.predict(X, engine="numpy")
    port = RandomForestRegressor(device="cpu").load_arrays(a.feat, a.thr,
                                                           a.leaf)
    assert (port.n_trees, port.max_depth) == (12, 7)
    for engine in ("numpy", "torch", "cuda"):
        np.testing.assert_array_equal(port.predict(X, engine=engine), want)
    feat, thr, leaf = forest_from_numpy(a.feat, a.thr, a.leaf, "cpu")
    got = ops.rfr_op(torch.from_numpy(X), feat, thr, leaf).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_fit_is_bit_identical(dataset, jax_forest):
    X, y = dataset
    port = RandomForestRegressor(n_trees=12, max_depth=7, seed=0,
                                 device="cpu").fit(X, np.log(y))
    for name in ("feat", "thr", "leaf"):
        np.testing.assert_array_equal(getattr(port.arrays, name),
                                      getattr(jax_forest.arrays, name))


def test_perf_predictor_matches_reference(dataset):
    """The online predictor (log target, batched predict) on the torch
    engine against the reference's numpy engine."""
    X, y = dataset
    jp = JPerfPredictor(n_trees=8, max_depth=6, seed=2)
    jp.add_dataset(X[:400], y[:400])
    pp = PerfPredictor(n_trees=8, max_depth=6, seed=2, engine="torch",
                       device="cpu")
    pp.add_dataset(X[:400], y[:400])
    want = jp.predict(X[400:])
    np.testing.assert_array_equal(pp.predict(X[400:]), want)
    parts = pp.predict_many([X[400:450], X[450:]])
    np.testing.assert_array_equal(np.concatenate(parts), want)
    assert pp.inference_count == 2 * len(X[400:])


def test_refit_drops_device_arrays(dataset):
    X, y = dataset
    m = RandomForestRegressor(n_trees=4, max_depth=4, device="cpu")
    m.fit(X, y)
    first = m.device_arrays()
    assert m.device_arrays() is first          # uploaded once per fit
    m.fit(X[:300], y[:300])
    assert m.device_arrays() is not first


def test_rfr_op_consistent_with_trained_model():
    """The kernel engine and the numpy engine of the actual predictor
    agree on real trained trees (on the CPU the kernel wrapper computes
    with its plain version)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 10)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 *
         rng.standard_normal(400)).astype(np.float64)
    m = RandomForestRegressor(n_trees=8, max_depth=5, seed=1, device="cpu")
    m.fit(X, y)
    p_np = m.predict(X[:64], engine="numpy")
    p_cu = m.predict(X[:64], engine="cuda")
    np.testing.assert_allclose(p_np, p_cu, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(p_np, m.predict(X[:64], engine="torch"))


def test_unknown_engine_rejected():
    with pytest.raises(ValueError):
        PerfPredictor(engine="pallas", device="cpu")
    with pytest.raises(ValueError):
        RandomForestRegressor(device="cpu").fit(
            np.zeros((4, 2), np.float32), np.arange(4.0)).predict(
            np.zeros((1, 2), np.float32), engine="jax")
