"""Benchmark regression gate: diff a fresh ``RunReport`` against the
checked-in ``BENCH_<study>.json`` baseline (port of
``repro.telemetry.gate``; pure Python, the same rules and table).

    PYTHONPATH=src python -m repro_torch.telemetry.gate [--study S ...]
        [--density-tol 0.05] [--qos-tol 0.02] [--latency-tol 3.0]
        [--promote S]

For every study the gate matches the latest recorded run against the
study's ``baseline`` entry row-by-row (rows are keyed by their sweep
coordinates — (scenario, target_nodes, system) for the large-cluster
study, (nodes,) for the capacity-engine scaling study) and applies
per-metric rules:

  * **density** — hard-fails when a fresh row's density drops more than
    ``density_tol`` (relative) below baseline: the deployment-density
    win is the paper's headline and must not silently erode.
  * **QoS violation rate** — hard-fails when fresh exceeds baseline by
    more than ``qos_tol`` (absolute).  QoS regressions are never
    tolerable noise: an overcommitting scheduler that breaks its <10%
    bar is wrong, not slow.
  * **latency percentiles** (cold-start / sched-cost p50/p99) — these
    carry real wall-clock components (forest inference time), so the
    slack is generous (``latency_tol`` relative, warn-first); they
    hard-fail only past the slack.
  * **deterministic counters** (engine calls/rows, tables_equal) —
    seeded runs make these reproducible; ``tables_equal`` flipping to
    False is a hard parity failure, call-count growth past
    ``counter_tol`` fails the capacity-engine study (the batching win
    regressed).

Exit status 0 = pass (warnings allowed), 1 = regression (the delta
table names every offending row).  ``--promote`` copies the latest run
over the baseline — run it only after reviewing an accepted change.

The default root (``report.repo_root()``) holds the reference's
``BENCH_*.json``: ``--promote`` refuses to run unless ``--root`` or
``REPRO_BENCH_DIR`` names the directory it may rewrite.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .report import (bench_path, load_bench, promote_baseline,
                     repo_root)

#: the studies verify.sh --bench gates by default
DEFAULT_STUDIES = ("large_cluster", "capacity_engine", "scaling",
                   "policy", "admission")


@dataclass
class Tolerances:
    density: float = 0.05     # relative density drop allowed
    qos: float = 0.02         # absolute QoS violation-rate increase
    latency: float = 3.0      # relative latency slack (wall-clock noise)
    counters: float = 0.25    # relative growth of deterministic counters
    slope: float = 0.3        # absolute slack on scaling-law exponents

    @classmethod
    def from_env(cls) -> "Tolerances":
        def f(name, default):
            return float(os.environ.get(name, default))
        return cls(density=f("REPRO_GATE_DENSITY_TOL", cls.density),
                   qos=f("REPRO_GATE_QOS_TOL", cls.qos),
                   latency=f("REPRO_GATE_LATENCY_TOL", cls.latency),
                   counters=f("REPRO_GATE_COUNTER_TOL", cls.counters),
                   slope=f("REPRO_GATE_SLOPE_TOL", cls.slope))


@dataclass
class Delta:
    study: str
    row: str
    metric: str
    base: Any
    fresh: Any
    status: str               # "ok" | "warn" | "FAIL"
    note: str = ""

    def table_row(self) -> Tuple[str, ...]:
        def fmt(v):
            if isinstance(v, float):
                return f"{v:.4g}"
            return str(v)
        return (self.study, self.row, self.metric, fmt(self.base),
                fmt(self.fresh), self.status, self.note)


@dataclass
class Rule:
    metric: str
    #: "min" — fresh must stay >= base*(1-tol); "max" — fresh must stay
    #: <= base*(1+tol); "max_abs" — fresh <= base + tol; "eq" — exact
    direction: str
    tol_name: Optional[str]   # Tolerances field, None for "eq"
    hard: bool = True


@dataclass
class StudyRules:
    key: Tuple[str, ...]
    rules: List[Rule] = field(default_factory=list)
    #: rules applied to the report-level ``metrics`` dict (scaling-law
    #: exponents, whole-sweep aggregates) rather than per-row values
    metric_rules: List[Rule] = field(default_factory=list)


STUDY_RULES: Dict[str, StudyRules] = {
    "large_cluster": StudyRules(
        key=("scenario", "target_nodes", "system"),
        rules=[Rule("density", "min", "density", hard=True),
               Rule("qos_violation", "max_abs", "qos", hard=True),
               Rule("cold_ms_p50", "max", "latency", hard=True),
               Rule("cold_ms_p99", "max", "latency", hard=True),
               Rule("sched_ms_p50", "max", "latency", hard=False),
               Rule("sched_ms_p99", "max", "latency", hard=True)]),
    "capacity_engine": StudyRules(
        key=("nodes",),
        rules=[Rule("tables_equal", "eq", None, hard=True),
               Rule("engine_calls", "max", "counters", hard=True),
               Rule("engine_rows", "max", "counters", hard=False),
               Rule("unique_solves", "max", "counters", hard=False),
               Rule("device_us_per_solve", "max", "latency", hard=False),
               Rule("device_calls", "max", "counters", hard=False)],
        # the device drain's headline: per-solve latency must stay flat
        # as the cluster grows (log-log slope ~<= 0), and the numpy-vs-
        # device capacity tables must stay bit-identical at every size
        metric_rules=[Rule("device_per_solve_slope", "max_abs", "slope",
                           hard=True),
                      Rule("tables_equal_all", "eq", None, hard=True)]),
    "scaling": StudyRules(
        key=("target_nodes",),
        rules=[Rule("density", "min", "density", hard=True),
               Rule("qos_violation", "max_abs", "qos", hard=True),
               Rule("wall_ms_per_node", "max", "latency", hard=False)],
        # the event core's headline: per-node wall-clock must stay
        # sub-linear in fleet size, and the single-cell event loop must
        # keep reproducing the legacy Simulation bit-for-bit
        metric_rules=[Rule("wallclock_per_node_slope", "max_abs",
                           "slope", hard=True),
                      Rule("cells_parity", "eq", None, hard=True)]),
    "policy": StudyRules(
        key=("system",),
        rules=[Rule("density", "min", "density", hard=True),
               Rule("qos_violation", "max_abs", "qos", hard=True),
               Rule("stale_serves", "eq", None, hard=True)],
        # the learned stack's headline: the scorer must keep imitating
        # the traced jiagu decisions (holdout top-1 agreement), its QoS
        # may not drift past the no-overcommit K8s baseline by more
        # than the absolute QoS tolerance, and the consolidation win
        # over K8s must not erode
        metric_rules=[Rule("imitation_agreement", "min", "qos",
                           hard=True),
                      Rule("learned_qos_excess", "max_abs", "qos",
                           hard=True),
                      Rule("learned_density_ratio", "min", "density",
                           hard=True),
                      Rule("stale_serves", "eq", None, hard=True)]),
    "admission": StudyRules(
        key=("system", "seed"),
        rules=[Rule("density", "min", "density", hard=True),
               Rule("qos_violation", "max_abs", "qos", hard=True),
               Rule("lc_violation", "max_abs", "qos", hard=False)],
        # the admission study's headline: the vertical-queue arm's
        # seed-mean density win over horizontal-only must not erode
        # (warn-first — per-seed deltas are noisy, the in-run
        # RuntimeError gate enforces win > 0 on every bench run), the
        # latency-critical violation excess may not drift past the
        # absolute QoS tolerance, and queue conservation must stay at
        # float-eps
        metric_rules=[Rule("density_win", "min", "density",
                           hard=False),
                      Rule("lc_excess", "max_abs", "qos", hard=True),
                      Rule("queue_delay_p99", "max", "latency",
                           hard=False),
                      Rule("conservation", "max_abs", "qos",
                           hard=True)]),
}
#: fallback for studies without registered rules: gate the headline
#: metrics if the rows carry them
_GENERIC = StudyRules(
    key=(), rules=[Rule("density", "min", "density", hard=True),
                   Rule("qos_violation", "max_abs", "qos", hard=True)])


def _row_key(row: Dict[str, Any], key: Tuple[str, ...]) -> str:
    if not key:
        return "-"
    return "/".join(str(row.get(k, "?")) for k in key)


def _apply_rule(study: str, row_name: str, rule: Rule, base_v, fresh_v,
                tol: Tolerances) -> Optional[Delta]:
    if base_v is None or fresh_v is None or base_v == "" or fresh_v == "":
        return None
    t = getattr(tol, rule.tol_name) if rule.tol_name else 0.0
    ok = True
    note = ""
    if rule.direction == "eq":
        ok = base_v == fresh_v
        note = "must match baseline" if not ok else ""
    elif rule.direction == "min":
        floor = base_v * (1.0 - t)
        ok = fresh_v >= floor
        if not ok:
            note = f"below {floor:.4g} (-{t:.0%} floor)"
    elif rule.direction == "max":
        ceil = base_v * (1.0 + t)
        ok = fresh_v <= ceil
        if not ok:
            note = f"above {ceil:.4g} (+{t:.0%} ceiling)"
    elif rule.direction == "max_abs":
        ceil = base_v + t
        ok = fresh_v <= ceil
        if not ok:
            note = f"above {ceil:.4g} (+{t} absolute)"
    else:                                              # pragma: no cover
        raise ValueError(f"unknown rule direction {rule.direction!r}")
    status = "ok" if ok else ("FAIL" if rule.hard else "warn")
    return Delta(study, row_name, rule.metric, base_v, fresh_v, status,
                 note)


def compare_reports(baseline: Dict[str, Any], fresh: Dict[str, Any],
                    tol: Optional[Tolerances] = None) -> List[Delta]:
    """Row-matched, rule-driven diff of two RunReport dicts.  Returns
    every evaluated delta; callers decide on ``status == "FAIL"``."""
    tol = tol or Tolerances()
    study = fresh.get("study", baseline.get("study", "?"))
    deltas: List[Delta] = []
    if baseline.get("mode") != fresh.get("mode"):
        deltas.append(Delta(
            study, "-", "mode", baseline.get("mode"), fresh.get("mode"),
            "FAIL", "baseline and fresh run modes differ — re-baseline"))
        return deltas
    if baseline.get("config_hash") != fresh.get("config_hash"):
        deltas.append(Delta(
            study, "-", "config_hash", baseline.get("config_hash"),
            fresh.get("config_hash"), "warn",
            "manifest changed since baseline (promote after review)"))
    spec = STUDY_RULES.get(study, _GENERIC)
    base_rows = {_row_key(r, spec.key): r
                 for r in baseline.get("rows", [])}
    fresh_rows = {_row_key(r, spec.key): r
                  for r in fresh.get("rows", [])}
    for name, brow in base_rows.items():
        frow = fresh_rows.get(name)
        if frow is None:
            deltas.append(Delta(study, name, "-", "present", "missing",
                                "FAIL", "row vanished from the sweep"))
            continue
        for rule in spec.rules:
            d = _apply_rule(study, name, rule, brow.get(rule.metric),
                            frow.get(rule.metric), tol)
            if d is not None:
                deltas.append(d)
    for name in fresh_rows:
        if name not in base_rows:
            deltas.append(Delta(study, name, "-", "missing", "present",
                                "ok", "new row (not in baseline)"))
    bmet = baseline.get("metrics") or {}
    fmet = fresh.get("metrics") or {}
    for rule in spec.metric_rules:
        d = _apply_rule(study, "metrics", rule, bmet.get(rule.metric),
                        fmet.get(rule.metric), tol)
        if d is not None:
            deltas.append(d)
    return deltas


def gate_study(study: str, tol: Optional[Tolerances] = None,
               root: Optional[str] = None) -> List[Delta]:
    """Gate one study's latest recorded run against its baseline."""
    data = load_bench(study, root)
    if data is None:
        return [Delta(study, "-", "-", "baseline", "missing", "FAIL",
                      f"no {os.path.basename(bench_path(study, root))} "
                      f"(run the benchmark, then commit the baseline)")]
    if not data.get("runs"):
        return [Delta(study, "-", "-", "runs", "empty", "FAIL",
                      "no recorded runs to gate")]
    return compare_reports(data["baseline"], data["runs"][-1], tol)


def print_delta_table(deltas: Sequence[Delta],
                      only_interesting: bool = True) -> None:
    """The human-readable delta table --bench prints on regression."""
    shown = [d for d in deltas
             if not only_interesting or d.status != "ok"]
    if not shown:
        print("# gate: all gated metrics within tolerance")
        return
    headers = ("study", "row", "metric", "baseline", "fresh", "status",
               "note")
    rows = [d.table_row() for d in shown]
    widths = [max(len(h), *(len(r[i]) for r in rows))
              for i, h in enumerate(headers)]
    line = "  ".join(h.ljust(w) for h, w in zip(headers, widths))
    print(line)
    print("  ".join("-" * w for w in widths))
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="BENCH_*.json regression gate")
    ap.add_argument("--study", action="append", default=None,
                    help="study to gate (repeatable; default: "
                         f"{', '.join(DEFAULT_STUDIES)})")
    ap.add_argument("--root", default=None,
                    help="directory holding BENCH_*.json "
                         "(default: repo root / $REPRO_BENCH_DIR)")
    ap.add_argument("--density-tol", type=float, default=None)
    ap.add_argument("--qos-tol", type=float, default=None)
    ap.add_argument("--latency-tol", type=float, default=None)
    ap.add_argument("--counter-tol", type=float, default=None)
    ap.add_argument("--slope-tol", type=float, default=None)
    ap.add_argument("--promote", action="append", default=None,
                    metavar="STUDY",
                    help="promote STUDY's latest run to baseline and "
                         "exit (no gating)")
    ap.add_argument("--all", action="store_true",
                    help="print every evaluated delta, not just "
                         "warnings/failures")
    args = ap.parse_args(argv)

    if args.promote and not (args.root or os.environ.get("REPRO_BENCH_DIR")):
        ap.error("--promote rewrites BENCH_<study>.json: name its "
                 "directory with --root or REPRO_BENCH_DIR")
    if args.promote:
        for study in args.promote:
            promote_baseline(study, args.root)
            print(f"# gate: promoted latest {study} run to baseline "
                  f"({bench_path(study, args.root)})")
        return 0

    tol = Tolerances.from_env()
    for name in ("density", "qos", "latency", "counters", "slope"):
        cli = getattr(args, {"counters": "counter_tol"}.get(
            name, f"{name}_tol"))
        if cli is not None:
            setattr(tol, name, cli)

    studies = args.study or list(DEFAULT_STUDIES)
    deltas: List[Delta] = []
    for study in studies:
        deltas.extend(gate_study(study, tol, args.root))
    print(f"# gate: {len(studies)} studies "
          f"({', '.join(studies)}) @ {args.root or repo_root()}")
    print_delta_table(deltas, only_interesting=not args.all)
    failures = [d for d in deltas if d.status == "FAIL"]
    warns = [d for d in deltas if d.status == "warn"]
    print(f"# gate: {len(deltas)} deltas, {len(warns)} warnings, "
          f"{len(failures)} failures => "
          f"{'FAIL' if failures else 'PASS'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
