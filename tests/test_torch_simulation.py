"""The slice end to end: the reference's ``scenario_simulation`` on its
numpy engine against the port's on the torch engine (device="cpu"), for
both capacity drains.  Every outcome that does not read the wall clock
must be equal: density, QoS violations, request counts, peak nodes, the
scheduler's and the autoscaler's counters, and every node's capacity
table.  The device drain is attached through the scheduler registry: a
Jiagu scheduler that arrives with a ``drain="device"`` service, which
the ``Simulation`` then keeps instead of attaching its own."""
import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core

SCENARIO = dict(n_functions=8, duration_s=60, target_nodes=24, seed=0)


def outcome(res, sim):
    s, c = res.sched, res.scaling
    return {
        "density": res.density,
        "qos_violation_rate": res.qos_violation_rate,
        "requests": res.requests,
        "violated_requests": res.violated_requests,
        "nodes_peak": res.nodes_peak,
        "sched": (s.decisions, s.fast, s.slow, s.failed, s.instances_placed),
        "scaling": (c.real_cold_starts, c.logical_cold_starts, c.releases,
                    c.evictions, c.migrations),
        # node ids come from a process-wide counter: compare in id order
        "tables": [sorted((fn, e.capacity)
                          for fn, e in sim.cluster.nodes[i].table.items())
                   for i in sorted(sim.cluster.nodes)],
    }


def device_drain_jiagu(ctx):
    """Jiagu with a device-drain PredictionService already attached."""
    sched = port_core.JiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                                     ctx.predictor, m_max=ctx.m_max)
    sched.attach_service(port_core.PredictionService(
        ctx.predictor, ctx.store, ctx.qos, ctx.specs,
        port_core.EngineConfig(m_max=ctx.m_max,
                               retrain_every=ctx.retrain_every,
                               learned_shape_margin=ctx.learned_shape_margin,
                               drain="device"),
        schema=ctx.schema_version))
    return sched


@pytest.fixture(scope="module")
def reference():
    scn = ref_core.make_scenario("burst-storm", **SCENARIO)
    world = ref_core.scenario_world(scn)
    sim = ref_core.scenario_simulation(scn, "jiagu", world=world)
    return outcome(sim.run(), sim)


@pytest.mark.parametrize("drain", ["host", "device"])
def test_jiagu_slice_matches_reference(reference, drain):
    port_core.register_scheduler("jiagu-device-drain", device_drain_jiagu,
                                 needs_predictor=True,
                                 dual_staged_default=True, overwrite=True)
    scn = port_core.make_scenario("burst-storm", **SCENARIO)
    world = port_core.scenario_world(scn, engine="torch", device="cpu")
    name = "jiagu" if drain == "host" else "jiagu-device-drain"
    sim = port_core.scenario_simulation(scn, name, world=world)
    assert sim.scheduler.prediction_service.cfg.drain == drain
    res = sim.run()
    got = outcome(res, sim)
    assert res.sched.decisions > 0 and res.inference_calls > 0
    for key, want in reference.items():
        assert got[key] == want, key


def test_world_matches_reference():
    """Same scenario, same seeds: the same population, trace and
    forest."""
    rs = ref_core.make_scenario("burst-storm", **SCENARIO)
    ps = port_core.make_scenario("burst-storm", **SCENARIO)
    assert sorted(rs.specs) == sorted(ps.specs)
    for fn in rs.trace.rps:
        np.testing.assert_array_equal(rs.trace.rps[fn], ps.trace.rps[fn])
    rw = ref_core.scenario_world(rs, n_train=300)
    pw = port_core.scenario_world(ps, n_train=300, engine="numpy")
    for name in ("feat", "thr", "leaf"):
        np.testing.assert_array_equal(
            getattr(rw.predictor.model.arrays, name),
            getattr(pw.predictor.model.arrays, name))


def test_admission_matches_reference():
    """Queue-backed admission on both packages' shims: the same outcomes
    and tables, the same per-SLO-class requests and violations, and
    per-function conservation within 1e-6."""
    from repro.admission import AdmissionConfig as RefAdmission
    from repro_torch.admission import AdmissionConfig as PortAdmission
    rs = ref_core.make_scenario("burst-storm", **SCENARIO)
    ref = ref_core.scenario_simulation(
        rs, "jiagu", world=ref_core.scenario_world(rs, n_train=300),
        admission=RefAdmission(enabled=True, vertical=True))
    want_res = ref.run()
    ps = port_core.make_scenario("burst-storm", **SCENARIO)
    sim = port_core.scenario_simulation(
        ps, "jiagu", world=port_core.scenario_world(
            ps, n_train=300, engine="torch", device="cpu"),
        admission=PortAdmission(enabled=True, vertical=True))
    assert sim.admission is not None and sim.autoscaler.admission is not None
    res = sim.run()
    got, want = outcome(res, sim), outcome(want_res, ref)
    for key in want:
        assert got[key] == want[key], key
    assert res.class_requests and res.class_requests == \
        want_res.class_requests
    assert res.class_violations == want_res.class_violations
    assert (res.dropped_requests, res.queue_depth_peak, res.vertical_grows,
            res.vertical_shrinks) == (
        want_res.dropped_requests, want_res.queue_depth_peak,
        want_res.vertical_grows, want_res.vertical_shrinks)
    assert sim.admission.conservation_error() < 1e-6
