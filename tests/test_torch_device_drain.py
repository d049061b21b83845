"""The port's device-resident capacity drain against the JAX package's
numpy host drain: bit-identical capacity tables AND matching EngineStats
accounting, cold and warm, homogeneous and heterogeneous (schema-v2
node shapes, per-query m_max), plus the device cache's eviction and
retrain invalidation.  Both packages build the same world from the same
seeds; the port runs its "torch" engine (and "cuda", which on CPU
tensors computes with the kernel's plain version) with device="cpu"."""
import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.cluster import Node as RefNode
from repro_torch.core.cluster import Node as PortNode

STAT_KEYS = ("solves", "unique_solves", "cache_hits", "coalesced_dupes",
             "rows_built", "predict_calls")


def _world(pkg, **pred_kw):
    specs = pkg.synthetic_functions(5, seed=2)
    gt = pkg.GroundTruth(seed=0)
    store = pkg.ProfileStore(seed=0)
    qos = pkg.QoSStore(store, gt)
    pred = pkg.PerfPredictor(n_trees=12, max_depth=7, seed=0, **pred_kw)
    X, y = pkg.generate_dataset(specs, gt, store, qos, 700, seed=1)
    pred.add_dataset(X, y)
    return specs, gt, store, qos, pred


@pytest.fixture(scope="module")
def ref_world():
    return _world(ref_core)


@pytest.fixture(scope="module")
def port_world():
    return _world(port_core, engine="torch", device="cpu")


@pytest.fixture()
def restore_engine(port_world):
    pred = port_world[4]
    prev = pred.engine
    yield pred
    pred.engine = prev


def _shapes(pkg):
    return [pkg.NodeResources(),
            pkg.NodeResources(cpu_mcores=96_000.0, mem_mb=262_144.0),
            pkg.NodeResources(cpu_mcores=24_000.0, mem_mb=65_536.0)]


def _hetero_nodes(pkg, node_cls, specs, seed, n_nodes, n_patterns=6):
    """Nodes drawn from a pattern pool (so signature sharing occurs)
    across three node shapes (so schema-v2 signatures diverge)."""
    rng = np.random.default_rng(seed)
    names = sorted(specs)
    shapes = _shapes(pkg)
    patterns = []
    for _ in range(n_patterns):
        pat = {}
        for g in rng.choice(names, size=int(rng.integers(1, 4)),
                            replace=False):
            pat[g] = (int(rng.integers(1, 5)), int(rng.integers(0, 3)))
        patterns.append(pat)
    nodes = []
    for i in range(n_nodes):
        node = node_cls(shapes[i % len(shapes)])
        for g, (ns, nc) in patterns[rng.integers(n_patterns)].items():
            node.state(g).n_sat = ns
            node.state(g).n_cached = nc
        nodes.append(node)
    return nodes


def _tables(nodes):
    return [sorted((fn, e.capacity) for fn, e in node.table.items())
            for node in nodes]


def _clear(nodes):
    for node in nodes:
        node.table.clear()


def test_port_fit_matches_reference_world(ref_world, port_world):
    for name in ("feat", "thr", "leaf"):
        np.testing.assert_array_equal(
            getattr(ref_world[4].model.arrays, name),
            getattr(port_world[4].model.arrays, name))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("schema", [1, 2])
def test_drain_parity_with_reference_host(ref_world, port_world,
                                          restore_engine, schema, engine):
    """numpy host oracle (reference, full sweep for stats parity) vs the
    port's device drain: identical tables and EngineStats, cold and
    warm; schema 2 adds node-shape rows, margins and shape-keyed
    signatures."""
    m_max = 12
    specs, _gt, store, qos, pred = ref_world
    ref_nodes = _hetero_nodes(ref_core, RefNode, specs, 17, 64)
    host = ref_core.CapacityEngine(
        pred, store, qos, specs,
        ref_core.EngineConfig(m_max=m_max, early_exit=False), schema=schema)
    host.update_nodes(ref_nodes, m_max=m_max)
    ref_tables = _tables(ref_nodes)
    ref_stats = host.stats.snapshot()

    specs, _gt, store, qos, ppred = port_world
    ppred.engine = engine
    nodes = _hetero_nodes(port_core, PortNode, specs, 17, 64)
    dev = port_core.CapacityEngine(
        ppred, store, qos, specs,
        port_core.EngineConfig(m_max=m_max, drain="device"), schema=schema)
    dev.update_nodes(nodes, m_max=m_max)
    assert _tables(nodes) == ref_tables
    dev_stats = dev.stats.snapshot()
    for k in STAT_KEYS:
        assert dev_stats[k] == ref_stats[k], k
    # warm drain: every signature resolves as a device-side gather
    rows_before = dev.stats.rows_built
    _clear(nodes)
    assert dev.update_nodes(nodes, m_max=m_max) == 0
    assert _tables(nodes) == ref_tables
    assert dev.stats.rows_built == rows_before
    assert dev.stats.cache_hits == ref_stats["cache_hits"] \
        + ref_stats["solves"]


def test_host_drain_parity_with_reference(ref_world, port_world,
                                          restore_engine):
    """The port's own host drain (chunked early exit) on the torch
    engine against the reference's on numpy."""
    specs, _gt, store, qos, pred = ref_world
    ref_nodes = _hetero_nodes(ref_core, RefNode, specs, 5, 48)
    host = ref_core.CapacityEngine(pred, store, qos, specs,
                                   ref_core.EngineConfig(m_max=16))
    host.update_nodes(ref_nodes)
    specs, _gt, store, qos, ppred = port_world
    ppred.engine = "torch"
    nodes = _hetero_nodes(port_core, PortNode, specs, 5, 48)
    port = port_core.CapacityEngine(ppred, store, qos, specs,
                                    port_core.EngineConfig(m_max=16))
    port.update_nodes(nodes)
    assert _tables(nodes) == _tables(ref_nodes)
    for k in STAT_KEYS:
        assert port.stats.snapshot()[k] == host.stats.snapshot()[k], k


def _queries(specs, seed=23, n=20):
    names = sorted(specs)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coloc = {}
        for g in rng.choice(names, size=int(rng.integers(0, 4)),
                            replace=False):
            coloc[g] = (float(rng.integers(1, 5)), float(rng.integers(0, 3)))
        fn = names[int(rng.integers(len(names)))]
        out.append((coloc, fn, int(rng.integers(1, 17)), None))
    return out


def test_device_drain_heterogeneous_m_max(ref_world, port_world,
                                          restore_engine):
    """Per-query m_max exercises the -inf padding (m beyond a scenario's
    own sweep must fail) inside one packed tensor."""
    specs, _gt, store, qos, pred = ref_world
    host = ref_core.CapacityEngine(
        pred, store, qos, specs,
        ref_core.EngineConfig(cache=False, early_exit=False))
    want = [c for c, _r in host.solve_many(_queries(specs))]
    specs, _gt, store, qos, ppred = port_world
    ppred.engine = "cuda"
    dev = port_core.CapacityEngine(
        ppred, store, qos, specs,
        port_core.EngineConfig(cache=False, drain="device"))
    assert [c for c, _r in dev.solve_many(_queries(specs))] == want


def test_device_drain_rows_billed_to_first_occurrence(port_world,
                                                      restore_engine):
    """Duplicate signatures inside one batch bill rows once, cache hits
    bill zero."""
    specs, _gt, store, qos, pred = port_world
    names = sorted(specs)
    pred.engine = "torch"
    dev = port_core.CapacityEngine(
        pred, store, qos, specs,
        port_core.EngineConfig(m_max=8, drain="device"))
    q = ({names[1]: (2.0, 1.0)}, names[0], 8, None)
    (c1, r1), (c2, r2) = dev.solve_many([q, q])
    assert c1 == c2
    assert r1 > 0 and r2 == 0
    (c3, r3), = dev.solve_many([q])
    assert c3 == c1 and r3 == 0
    assert dev.stats.coalesced_dupes == 1
    assert dev.stats.cache_hits == 1


def test_device_drain_empty_and_trivial_batches(port_world, restore_engine):
    specs, _gt, store, qos, pred = port_world
    pred.engine = "torch"
    dev = port_core.CapacityEngine(pred, store, qos, specs,
                                   port_core.EngineConfig(drain="device"))
    assert dev.solve_many([]) == []
    (cap, rows), = dev.solve_many([({}, sorted(specs)[0], 0, None)])
    assert cap == 0 and rows == 0


def test_device_cache_eviction_compacts_slots(port_world, restore_engine):
    """The device capacity vector (an int32 tensor) is bounded like the
    host cache: oldest slots evicted, survivors compacted, gathers still
    correct."""
    specs, _gt, store, qos, pred = port_world
    names = sorted(specs)
    pred.engine = "torch"
    dev = port_core.CapacityEngine(
        pred, store, qos, specs,
        port_core.EngineConfig(m_max=6, drain="device",
                               max_cache_entries=3))
    colocs = [{names[j]: (float(i + 1), 0.0)}
              for i in range(2) for j in range(1, 4)]
    expect = {}
    for i, coloc in enumerate(colocs):
        (cap, _r), = dev.solve_many([(dict(coloc), names[0], 6, None)])
        expect[i] = cap
    assert len(dev._dev_slots) <= 3
    assert int(dev._dev_caps.shape[0]) == len(dev._dev_slots)
    assert str(dev._dev_caps.dtype) == "torch.int32"
    for i in (3, 4, 5):
        (cap, rows), = dev.solve_many([(dict(colocs[i]), names[0], 6, None)])
        assert cap == expect[i] and rows == 0
    (cap, rows), = dev.solve_many([(dict(colocs[0]), names[0], 6, None)])
    assert cap == expect[0] and rows > 0


def test_device_drain_retrain_invalidates(port_world):
    """An epoch bump clears the device-side cache too: a post-retrain
    gather can never serve a pre-retrain capacity."""
    specs, gt, store, qos, _pred = port_world
    p2 = port_core.PerfPredictor(n_trees=6, max_depth=6, seed=3,
                                 engine="torch", device="cpu")
    X, y = port_core.generate_dataset(specs, gt, store, qos, 300, seed=9)
    p2.add_dataset(X, y)
    dev = port_core.CapacityEngine(
        p2, store, qos, specs,
        port_core.EngineConfig(m_max=8, drain="device"))
    names = sorted(specs)
    q = ({names[1]: (2.0, 0.0)}, names[0], 8, None)
    dev.solve_many([q])
    assert dev._dev_slots and dev._dev_caps is not None
    p2.add_sample(X[0], float(y[0]), retrain=False)
    p2.retrain()
    (cap, rows), = dev.solve_many([q])
    assert rows > 0
    assert dev.stats.stale_epoch_hits == 0
    p2.engine = "numpy"
    cap_ref, _ = port_core.CapacityEngine(
        p2, store, qos, specs,
        port_core.EngineConfig(m_max=8)).capacity(
        {names[1]: (2.0, 0.0)}, names[0], 8)
    assert cap == cap_ref
