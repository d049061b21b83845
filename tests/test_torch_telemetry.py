"""The port's regression gate and dashboard (``repro_torch.telemetry.
gate`` / ``dashboard``): the gate and dashboard cases of
``tests/test_telemetry.py`` on the port, and both against the reference
on copies of the checked-in ``BENCH_large_cluster.json`` and
``BENCH_capacity_engine.json`` (the originals are only read).  Every case
points ``REPRO_BENCH_DIR`` at its own temporary directory, so nothing
writes the repo root's files; one case checks that without it the gate's
``--promote`` and the dashboard's default page are refused."""
import dataclasses
import json
import shutil
from pathlib import Path

import pytest

from repro.core.events import JsonlObserver as RefJsonlObserver
from repro.telemetry import dashboard as ref_dash
from repro.telemetry import gate as ref_gate
from repro_torch.core.events import JsonlObserver
from repro_torch.telemetry import (RunReport, Tolerances, append_bench,
                                   compare_reports, gate_study)
from repro_torch.telemetry import dashboard as dash
from repro_torch.telemetry import gate
from repro_torch.telemetry.gate import main as gate_main

ROOT = Path(__file__).resolve().parents[1]
STUDIES = ("large_cluster", "capacity_engine")
#: the one line of the page that differs between two renders: its
#: generation time
GENERATED = '<div class="sub">generated '


@pytest.fixture(autouse=True)
def bench_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path))
    return tmp_path


def _report(study="s", mode="quick", density=30.0, qos=0.01, **meta):
    return RunReport.build(
        study, mode, manifest={"m": 1},
        metrics={"d": density},
        rows=[{"scenario": "burst-storm", "target_nodes": 8,
               "system": "jiagu", "density": density,
               "qos_violation": qos, "cold_ms_p50": 5.0,
               "cold_ms_p99": 40.0, "sched_ms_p50": 1.0,
               "sched_ms_p99": 3.0}],
        meta=meta)


# ---------------------------------------------------------------------------
# the gate cases of tests/test_telemetry.py, on the port
# ---------------------------------------------------------------------------


def test_gate_passes_within_tolerance_and_fails_beyond():
    base, fresh = _report(density=30.0), _report(density=29.0)
    deltas = compare_reports(base.to_dict(), fresh.to_dict())
    assert not [d for d in deltas if d.status == "FAIL"]
    worse = _report(density=30.0 * 0.9)   # -10% > 5% floor
    deltas = compare_reports(base.to_dict(), worse.to_dict())
    bad = [d for d in deltas if d.status == "FAIL"]
    assert bad and bad[0].metric == "density"


def test_gate_qos_hard_fails_absolute():
    base = _report(qos=0.01)
    ok = compare_reports(base.to_dict(), _report(qos=0.029).to_dict())
    assert not [d for d in ok if d.status == "FAIL"]
    bad = compare_reports(base.to_dict(), _report(qos=0.05).to_dict())
    assert [d for d in bad
            if d.status == "FAIL" and d.metric == "qos_violation"]


def test_gate_mode_mismatch_and_vanished_row():
    base = _report(mode="full")
    deltas = compare_reports(base.to_dict(), _report(mode="quick").to_dict())
    assert deltas[0].status == "FAIL" and deltas[0].metric == "mode"
    fresh = _report(mode="full")
    fresh.rows = []
    deltas = compare_reports(base.to_dict(), fresh.to_dict())
    assert [d for d in deltas
            if d.status == "FAIL" and d.fresh == "missing"]


def test_gate_tolerances_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_GATE_DENSITY_TOL", "0.5")
    assert Tolerances.from_env().density == 0.5


def test_gate_study_missing_baseline_fails():
    deltas = gate_study("large_cluster")
    assert deltas[0].status == "FAIL"


def test_gate_main_end_to_end(capsys):
    append_bench(_report(study="large_cluster", density=30.0))
    assert gate_main(["--study", "large_cluster"]) == 0
    append_bench(_report(study="large_cluster", density=20.0))
    assert gate_main(["--study", "large_cluster"]) == 1
    out = capsys.readouterr().out
    assert "density" in out and "FAIL" in out
    # a looser CLI tolerance lets the same delta through
    assert gate_main(["--study", "large_cluster",
                      "--density-tol", "0.5"]) == 0
    # promotion moves the baseline; the gate then passes clean
    assert gate_main(["--promote", "large_cluster"]) == 0
    assert gate_main(["--study", "large_cluster"]) == 0


def test_gate_and_dashboard_write_nothing_under_the_default_root(
        monkeypatch, tmp_path, capsys):
    """The default root holds the reference's BENCH files: without
    --root or REPRO_BENCH_DIR, --promote and the dashboard's default page
    are refused before anything is read or written."""
    monkeypatch.delenv("REPRO_BENCH_DIR")
    page = ROOT / "benchmarks" / "artifacts" / "dashboard.html"

    def stamps():
        return {p: p.stat().st_mtime_ns
                for p in [*ROOT.glob("BENCH_*.json"), page] if p.exists()}

    before = stamps()
    for main, argv in ((gate_main, ["--promote", "large_cluster"]),
                       (dash.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        assert "REPRO_BENCH_DIR" in capsys.readouterr().err
    assert stamps() == before
    # an explicit root is enough for both
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path))
    append_bench(_report(study="large_cluster", density=30.0))
    assert gate_main(["--promote", "large_cluster"]) == 0
    assert dash.main([]) == 0
    assert (tmp_path / "benchmarks" / "artifacts" / "dashboard.html"
            ).exists()


def test_gate_lazy_exports_name_the_gate_module():
    import repro_torch.telemetry as telemetry
    for name in telemetry._GATE_EXPORTS:
        assert getattr(telemetry, name) is getattr(gate, name)
        assert name in telemetry.__all__
    with pytest.raises(AttributeError):
        telemetry.no_such_name


# ---------------------------------------------------------------------------
# the dashboard cases of tests/test_telemetry.py, on the port
# ---------------------------------------------------------------------------


def test_dashboard_renders_self_contained_html(bench_dir):
    append_bench(_report(study="large_cluster", density=30.0))
    append_bench(_report(study="large_cluster", density=31.0))
    ev = bench_dir / "benchmarks" / "artifacts" / "events"
    ev.mkdir(parents=True)
    with JsonlObserver(str(ev / "burst-storm_8_jiagu.jsonl"),
                       meta={"manifest": {"scheduler":
                                          {"name": "jiagu"}}}) as obs:
        obs._write({"event": "tick", "now": 0.0, "nodes": 4,
                    "instances": 80, "density": 20.0})
        obs._write({"event": "schedule", "now": 1.0, "fn": "f",
                    "placed": 2,
                    "trace": {"filtered": {"no-capacity": 3}}})
        obs._write({"event": "span", "name": "schedule", "seq": 0,
                    "depth": 0, "ms": 1.5})
    out = bench_dir / "dash.html"
    assert dash.main(["--out", str(out)]) == 0
    html = out.read_text()
    assert html.startswith("<!DOCTYPE html>")
    assert "<svg" in html and "large_cluster" in html
    assert "no-capacity" in html            # reason breakdown rendered
    assert "jiagu" in html
    assert "http" not in html.split("</style>")[1]  # no external assets
    # single self-contained file: nothing else was written next to it
    assert [p.name for p in out.parent.glob("dash*")] == ["dash.html"]


def test_dashboard_renders_empty_state(bench_dir):
    html = dash.render(root=str(bench_dir), events_dir=str(bench_dir))
    assert "no BENCH_" in html


# ---------------------------------------------------------------------------
# the port against the reference on copies of the checked-in BENCH files
# ---------------------------------------------------------------------------


def _copy_benches(dst: Path):
    for study in STUDIES:
        src = ROOT / f"BENCH_{study}.json"
        before = src.read_bytes()
        shutil.copy(src, dst / src.name)
        assert src.read_bytes() == before


def _worse(run: dict) -> dict:
    """`run` with every row's density 10% down, its QoS violation rate
    and engine calls up: failing and warning deltas for both studies."""
    run = json.loads(json.dumps(run))
    for row in run["rows"]:
        for key, f in (("density", 0.9), ("engine_calls", 1.5),
                       ("device_us_per_solve", 5.0)):
            if isinstance(row.get(key), (int, float)):
                row[key] = row[key] * f
        if isinstance(row.get("qos_violation"), float):
            row["qos_violation"] += 0.05
    run["rows"] = run["rows"][1:]            # one row vanishes
    return run


@pytest.mark.parametrize("study", STUDIES)
def test_gate_matches_reference_on_bench_copies(study, bench_dir, capsys):
    _copy_benches(bench_dir)
    tables = []
    for mod in (ref_gate, gate):
        got = mod.gate_study(study)
        data = json.loads((bench_dir / f"BENCH_{study}.json").read_text())
        worse = mod.compare_reports(data["baseline"],
                                    _worse(data["runs"][-1]))
        assert [d.status for d in worse].count("FAIL") > 0
        mod.print_delta_table(got, only_interesting=False)
        mod.print_delta_table(worse)
        assert mod.main(["--study", study, "--all"]) in (0, 1)
        tables.append(([dataclasses.astuple(d) for d in got + worse],
                       capsys.readouterr().out))
    assert tables[1] == tables[0]
    assert len(tables[0][0]) > 10


def test_dashboard_matches_reference_on_bench_copies(bench_dir):
    _copy_benches(bench_dir)
    ev = bench_dir / "events"
    ev.mkdir()
    with RefJsonlObserver(str(ev / "burst-storm_8_jiagu.jsonl"),
                          meta={"manifest": {"scheduler":
                                             {"name": "jiagu"}}}) as obs:
        for i in range(5):
            obs._write({"event": "tick", "now": float(i), "nodes": 4,
                        "instances": 80 + i, "density": 20.0 + i,
                        "queue_depth": i % 3})
        obs._write({"event": "schedule", "now": 1.0, "fn": "f",
                    "placed": 2,
                    "trace": {"filtered": {"no-capacity": 3}}})
        obs._write({"event": "span", "name": "schedule", "seq": 0,
                    "depth": 0, "ms": 1.5})

    def page(mod):
        lines = mod.render(str(bench_dir), str(ev)).splitlines()
        stamped = [i for i, line in enumerate(lines)
                   if line.startswith(GENERATED)]
        assert len(stamped) == 1
        del lines[stamped[0]]
        return lines

    want = page(ref_dash)
    assert page(dash) == want
    assert any("capacity" in line.lower() for line in want)
    assert any("large_cluster" in line for line in want)
