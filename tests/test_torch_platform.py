"""The platform facade of the port (``repro_torch.platform``) against the
reference's (``repro.platform``) on the same manifests: the config tree,
the facade against the shim, every outcome of single-cell, two-cell and
admission runs for each scheduler family, the checked-in quick baseline
of ``BENCH_large_cluster.json`` (read, never written), the telemetry
section, and that a default build asks for the card.  The port runs
``prediction.engine = "torch"`` on ``prediction.device = "cpu"`` (the
kernels' plain versions); the reference runs its default engine."""
import copy
import json
from pathlib import Path

import pytest
import torch

import repro.platform as ref_platform
import repro_torch.core as port_core
import repro_torch.platform as port_platform
from repro_torch.admission import BEST_EFFORT, LATENCY_CRITICAL
from repro_torch.core.cells import CellSimulation
from repro_torch.telemetry import (NULL_TRACER, MetricsObserver, RunReport,
                                   Telemetry, append_bench, bench_path,
                                   load_bench, promote_baseline)
from repro_torch.telemetry.report import BENCH_SCHEMA, REPORT_SCHEMA

ROOT = Path(__file__).resolve().parents[1]
ON_CPU = {"engine": "torch", "device": "cpu"}
#: the scenario of tests/test_torch_simulation.py, a 300-row forest
MANIFEST = {
    "scenario": {"kind": "burst-storm", "n_functions": 8,
                 "duration_s": 60, "target_nodes": 24, "seed": 0},
    "prediction": {"n_train": 300, "n_trees": 8},
}
_EPS = 1e-6


def manifest(*, prediction=None, **sections):
    m = copy.deepcopy(MANIFEST)
    m["prediction"].update(prediction or {})
    m.update(copy.deepcopy(sections))
    return m


def on_cpu(m):
    m = copy.deepcopy(m)
    m.setdefault("prediction", {}).update(ON_CPU)
    return m


def outcome(res, sim):
    """Every outcome of a run that does not read the wall clock (the
    fields of tests/test_torch_simulation.py plus the admission axis)."""
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
        "class_requests": dict(res.class_requests),
        "class_violations": dict(res.class_violations),
        "dropped": res.dropped_requests,
        "queue_depth_peak": res.queue_depth_peak,
        # node ids come from a process-wide counter: compare in id order
        "tables": [sorted((fn, e.capacity)
                          for fn, e in sim.cluster.nodes[i].table.items())
                   for i in sorted(sim.cluster.nodes)],
    }


def controllers(sim):
    """The admission controllers of a run (one per cell)."""
    if isinstance(sim, CellSimulation):
        return [c.autoscaler.admission for c in sim.cells]
    return [sim.admission]


# ---------------------------------------------------------------------------
# The config tree
# ---------------------------------------------------------------------------


def test_config_roundtrip_defaults():
    cfg = port_platform.PlatformConfig()
    d = cfg.to_dict()
    json.dumps(d)
    assert port_platform.PlatformConfig.from_dict(d) == cfg
    assert cfg.prediction.device is None and cfg.prediction.engine is None


def test_config_roundtrip_custom():
    cfg = port_platform.PlatformConfig.from_dict({
        "cluster": {"node_classes": [
            {"name": "std", "weight": 2},
            {"name": "huge", "cpu_mcores": 96_000.0,
             "mem_mb": 262_144.0, "weight": 1}], "max_nodes": 128},
        "scenario": {"kind": "diurnal-shift", "n_functions": 5,
                     "duration_s": 90, "target_nodes": 12, "seed": 3,
                     "spec_seed": 8, "trace_kw": {"n_regions": 2}},
        "scheduler": {"name": "gsight", "max_candidates": 3},
        "prediction": {"schema_version": 2, "n_train": 100, **ON_CPU},
        "cells": {"count": 3, "load_cap": 0.5},
        "admission": {"enabled": True, "vertical": True},
    })
    d = cfg.to_dict()
    json.dumps(d)
    back = port_platform.PlatformConfig.from_dict(d)
    assert back == cfg
    assert back.prediction.device == "cpu"
    assert [c.name for c in back.cluster.to_node_classes()] == ["std", "huge"]


def test_manifest_is_the_reference_manifest_plus_device():
    """The port's tree is the reference's, section for section and key
    for key, with one more key: ``prediction.device``."""
    port = port_platform.PlatformConfig().to_dict()
    assert port["prediction"].pop("device") is None
    assert port == ref_platform.PlatformConfig().to_dict()


def test_from_dict_rejects_unknown_sections_and_keys():
    err = port_platform.PlatformConfigError
    with pytest.raises(err, match="unknown sections"):
        port_platform.PlatformConfig.from_dict({"schedulerz": {}})
    with pytest.raises(err, match="unknown keys"):
        port_platform.PlatformConfig.from_dict({"scheduler": {"nam": "x"}})
    with pytest.raises(err, match="unknown keys"):
        port_platform.PlatformConfig.from_dict({"prediction": {"drain": 1}})
    with pytest.raises(err, match="expected a dict"):
        port_platform.PlatformConfig.from_dict({"scaling": 7})


@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda", "jax",
                                    "pallas", "triton"])
def test_engine_names_are_the_ports(engine):
    cfg = port_platform.PlatformConfig.from_dict(
        {"prediction": {"engine": engine}})
    if engine in port_core.INFERENCE_ENGINES:
        cfg.validate()
    else:
        with pytest.raises(port_platform.PlatformConfigError,
                           match="engine"):
            cfg.validate()


def test_device_is_validated():
    cfg = port_platform.PlatformConfig.from_dict(
        {"prediction": {"device": "no-such-device"}})
    with pytest.raises(port_platform.PlatformConfigError, match="device"):
        cfg.validate()
    for ok in ("cpu", "cuda", "cuda:0"):
        port_platform.PlatformConfig.from_dict(
            {"prediction": {"device": ok}}).validate()


# ---------------------------------------------------------------------------
# The facade against the shim, and against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_world():
    cfg = port_platform.PlatformConfig.from_dict(on_cpu(MANIFEST))
    scenario = port_platform.scenario_from_config(cfg)
    world = port_core.scenario_world(scenario, n_train=300, n_trees=8,
                                     **ON_CPU)
    return scenario, world


def test_facade_equals_shim(port_world):
    scenario, world = port_world
    world.gt.reseed()
    sim = port_core.scenario_simulation(scenario, "jiagu", world=world)
    want = outcome(sim.run(), sim)
    world.gt.reseed()
    plat = port_platform.Platform.build(
        scenario=scenario, config=on_cpu(MANIFEST), world=world)
    got = outcome(plat.run(), plat.simulation)
    assert got == want
    assert plat.service.inference_engine == "torch"
    assert plat.world.predictor.model.device_arrays()[0].device.type == "cpu"


CASES = {
    "jiagu": manifest(scheduler={"name": "jiagu"}),
    "harvesting": manifest(scheduler={"name": "harvesting"}),
    "k8s": manifest(scheduler={"name": "k8s"}),
    "learned": manifest(scheduler={"name": "learned"}),
    "jiagu-2-cells": manifest(scheduler={"name": "jiagu"},
                              cells={"count": 2}),
    "jiagu-admission": manifest(scheduler={"name": "jiagu"},
                                admission={"enabled": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_platform_matches_reference(case):
    m = CASES[case]
    ref = ref_platform.Platform.build(config=copy.deepcopy(m))
    want = outcome(ref.run(), ref.simulation)
    plat = port_platform.Platform.build(config=on_cpu(m))
    res = plat.run()
    got = outcome(res, plat.simulation)
    for key, value in want.items():
        assert got[key] == value, key
    assert res.sched.decisions > 0
    if case == "learned":
        scorer = plat.scheduler.learned_scorer
        assert scorer.policy is None and scorer.stats.batches > 0
        assert scorer.stats.stale_serves == 0
    if case.endswith("cells"):
        assert isinstance(plat.simulation, CellSimulation)
        assert len(plat.simulation.cells) == 2
    if case.endswith("admission"):
        # the axis was live, and accounts per SLO class as the reference
        assert set(res.class_requests) <= {LATENCY_CRITICAL, BEST_EFFORT}
        assert res.class_requests
        assert sum(res.class_requests.values()) == \
            pytest.approx(res.requests, rel=1e-6)
        ref_rates = {k: v / ref.result.class_requests[k]
                     for k, v in ref.result.class_violations.items()}
        assert {k: v / res.class_requests[k]
                for k, v in res.class_violations.items()} == ref_rates
        for ctl in controllers(plat.simulation):
            assert ctl.conservation_error() < _EPS


def test_admission_disabled_builds_no_controller():
    plat = port_platform.Platform.build(config=on_cpu(
        manifest(admission={"enabled": False}, scenario={
            "kind": "burst-storm", "n_functions": 4, "duration_s": 20,
            "target_nodes": 8, "seed": 0})))
    assert plat.simulation.admission is None
    assert plat.autoscaler.admission is None
    res = plat.run()
    assert not res.class_requests and res.queue_depth_peak == 0.0


def test_reproduces_checked_in_quick_baseline():
    """Row 0 of the checked-in ``BENCH_large_cluster.json`` quick
    baseline (burst-storm@64, k8s, the first run against a fresh world),
    through ``Platform.build`` as the study's manifest describes it."""
    from benchmarks.large_cluster import study_spec

    data = load_bench("large_cluster", root=str(ROOT))
    assert data is not None, "BENCH_large_cluster.json is checked in"
    base = data["baseline"]
    assert base["mode"] == "quick"
    row = base["rows"][0]
    assert (row["scenario"], row["target_nodes"], row["system"]) == \
        ("burst-storm", 64, "k8s")
    spec = study_spec(quick=True, seed=0)["base"]
    plat = port_platform.Platform.build(config={
        "scenario": {**spec["scenario"], "kind": "burst-storm",
                     "target_nodes": 64},
        "scheduler": {"name": "k8s"},
        "prediction": {**spec["prediction"], **ON_CPU}})
    res = plat.run()
    s = res.sched
    got = {
        "density": round(res.density, 3),
        "qos_violation": round(res.qos_violation_rate, 4),
        "mean_nodes": round(res.node_seconds / max(res.ticks, 1), 1),
        "peak_nodes": res.nodes_peak,
        "rows_per_schedule": round(
            s.critical_inference_rows / max(s.decisions, 1), 2),
        "fast_frac": round(s.fast / max(s.fast + s.slow, 1), 3),
    }
    assert got == {k: row[k] for k in got}


# ---------------------------------------------------------------------------
# No hidden device
# ---------------------------------------------------------------------------


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


SMALL = {"scenario": {"kind": "burst-storm", "n_functions": 4,
                      "duration_s": 20, "target_nodes": 8, "seed": 0},
         "prediction": {"n_train": 200, "n_trees": 6}}


@pytest.mark.parametrize("prediction", [{}, {"engine": "torch"},
                                        {"engine": "cuda"}])
def test_default_device_is_the_card(no_card, prediction):
    m = copy.deepcopy(SMALL)
    m["prediction"].update(prediction)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_platform.Platform.build(config=m)


def test_numpy_build_never_touches_the_card(no_card):
    m = copy.deepcopy(SMALL)
    m["prediction"]["engine"] = "numpy"
    plat = port_platform.Platform.build(config=m)
    assert plat.run().ticks == 20
    assert plat.service.inference_engine == "numpy"


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


def small(**telemetry):
    m = on_cpu(SMALL)
    if telemetry:
        m["telemetry"] = telemetry
    return m


def test_telemetry_explicit_on_matches_reference():
    plat = port_platform.Platform.build(config=small(
        metrics=True, spans=True, histogram_bins=4))
    res = plat.run()
    snap = plat.metrics_snapshot()
    assert snap["sim.ticks"]["value"] == res.ticks
    assert snap["run.density"]["value"] == pytest.approx(res.density)
    assert snap["schedule.decisions"]["value"] == res.sched.decisions
    names = {r["name"] for r in plat.span_summary()}
    assert "schedule" in names and "capacity_solve" in names
    assert snap["span.schedule.ms"]["count"] == res.ticks
    json.dumps(snap)
    ref = ref_platform.Platform.build(config={
        **copy.deepcopy(SMALL), "telemetry": {"metrics": True,
                                              "spans": True}})
    ref.run()
    want = ref.metrics_snapshot()
    assert sorted(snap) == sorted(want)
    for key in ("sim.ticks", "schedule.decisions", "run.density",
                "run.qos_violation_rate", "run.engine.solves"):
        assert snap[key]["value"] == want[key]["value"], key


def test_telemetry_defaults_off_without_observers():
    plat = port_platform.Platform.build(config=small())
    assert plat.telemetry is None
    assert plat.simulation.tracer is NULL_TRACER
    assert plat.service.tracer is NULL_TRACER
    plat.run()
    assert plat.metrics_snapshot() == {} and plat.span_summary() == []


def test_telemetry_defaults_on_with_observers():
    plat = port_platform.Platform.build(config=small(),
                                        observers=[MetricsObserver()])
    assert plat.telemetry is not None
    assert plat.simulation.tracer is plat.telemetry.tracer
    assert plat.service.tracer is plat.telemetry.tracer


def test_telemetry_explicit_off_with_observers():
    plat = port_platform.Platform.build(
        config=small(metrics=False, spans=False),
        observers=[MetricsObserver()])
    assert plat.telemetry is None
    assert plat.simulation.tracer is NULL_TRACER


def test_publish_result_engine_stats_gauges():
    plat = port_platform.Platform.build(config=small(metrics=True))
    plat.run()
    snap = plat.metrics_snapshot()
    assert snap["run.engine.solves"]["kind"] == "gauge"
    assert snap["run.engine.solves"]["value"] == \
        plat.service.stats.snapshot()["solves"]
    assert Telemetry.create().observer.registry is not None


def test_run_report_round_trip_under_tmp_path(tmp_path):
    rep = RunReport.build("s", "quick", manifest=on_cpu(SMALL),
                          metrics={"d": 30.0},
                          rows=[{"system": "jiagu", "density": 30.0}])
    d = rep.to_dict()
    json.dumps(d)
    assert RunReport.from_dict(d) == rep
    assert rep.schema == REPORT_SCHEMA and rep.config_hash
    with pytest.raises(ValueError):
        RunReport.from_dict({**d, "schema": "bogus@9"})
    root = str(tmp_path)
    p = append_bench(rep, root=root)
    assert p == bench_path("s", root) == str(tmp_path / "BENCH_s.json")
    for i in range(4):
        append_bench(RunReport.build("s", "quick", metrics={"d": 31.0 + i}),
                     root=root, max_runs=3)
    data = load_bench("s", root=root)
    assert data["schema"] == BENCH_SCHEMA and len(data["runs"]) == 3
    assert data["baseline"]["metrics"]["d"] == 30.0
    promote_baseline("s", root=root)
    assert load_bench("s", root=root)["baseline"]["metrics"]["d"] == 34.0
