"""``RunReport`` — one schema-versioned JSON record per benchmark run —
and the persisted ``BENCH_<study>.json`` trajectory files.

Jiagu's claims are quantitative (+54.8% density, 81–93.7% lower
scheduling cost, 57–69% less cold-start latency); before this module
the repo's own numbers lived in commit messages and vanished.  Every
benchmark now persists a ``RunReport`` into a versioned
``BENCH_<study>.json`` at the repo root:

    {"schema": "repro.telemetry/bench@1", "study": "large_cluster",
     "baseline": {<RunReport>},          # the accepted reference
     "runs": [{<RunReport>}, ...]}       # append-only trajectory

A ``RunReport`` carries the headline metrics (density, QoS violation
rate, cold-start p50/p99, sched-cost p50/p99, engine telemetry), the
per-configuration result rows, the git SHA, and a hash of the config
manifest that produced it — enough for ``repro.telemetry.gate`` to
decide whether a fresh run regressed and for the dashboard to render
the whole trajectory.

The trajectory is bounded (``max_runs``); the ``baseline`` entry only
moves when explicitly promoted (``gate --promote`` after an accepted
improvement), so the regression gate always compares against a
deliberately chosen reference, not merely the previous run.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

REPORT_SCHEMA = "repro.telemetry/run-report@1"
BENCH_SCHEMA = "repro.telemetry/bench@1"
#: trajectory bound: plenty for a dashboard, never unbounded growth
MAX_RUNS_DEFAULT = 40

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def repo_root() -> str:
    """The repo root BENCH files live in (``REPRO_BENCH_DIR``
    overrides, for tests and isolated runs)."""
    return os.environ.get("REPRO_BENCH_DIR", _REPO_ROOT)


def bench_path(study: str, root: Optional[str] = None) -> str:
    return os.path.join(root or repo_root(), f"BENCH_{study}.json")


def git_sha(short: bool = True) -> str:
    try:
        cmd = ["git", "rev-parse"] + (["--short"] if short else []) \
            + ["HEAD"]
        out = subprocess.run(
            cmd, cwd=_REPO_ROOT, capture_output=True, text=True,
            timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def manifest_hash(manifest: Any) -> str:
    """Stable short hash of a JSON-able config manifest — two reports
    are comparable only if they ran the same configuration."""
    blob = json.dumps(manifest, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class RunReport:
    """One benchmark run, ready to persist/gate/render."""

    study: str
    mode: str = "quick"                  # quick | full
    schema: str = REPORT_SCHEMA
    created_utc: str = ""
    git_sha: str = ""
    config_hash: str = ""
    #: headline scalars (density, qos, latency percentiles, engine
    #: telemetry) — typically a MetricsRegistry.snapshot() or a curated
    #: summary dict
    metrics: Dict[str, Any] = field(default_factory=dict)
    #: per-configuration result rows (one per scenario/size/system)
    rows: List[Dict[str, Any]] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def build(cls, study: str, mode: str, manifest: Any = None,
              metrics: Optional[Dict[str, Any]] = None,
              rows: Optional[List[Dict[str, Any]]] = None,
              meta: Optional[Dict[str, Any]] = None) -> "RunReport":
        return cls(study=study, mode=mode,
                   created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime()),
                   git_sha=git_sha(),
                   config_hash=manifest_hash(manifest or {}),
                   metrics=dict(metrics or {}),
                   rows=[dict(r) for r in (rows or [])],
                   meta=dict(meta or {}))

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": self.schema, "study": self.study,
                "mode": self.mode, "created_utc": self.created_utc,
                "git_sha": self.git_sha, "config_hash": self.config_hash,
                "metrics": self.metrics, "rows": self.rows,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunReport":
        if d.get("schema") != REPORT_SCHEMA:
            raise ValueError(
                f"unknown run-report schema {d.get('schema')!r} "
                f"(expected {REPORT_SCHEMA})")
        return cls(study=d["study"], mode=d.get("mode", "quick"),
                   schema=d["schema"],
                   created_utc=d.get("created_utc", ""),
                   git_sha=d.get("git_sha", ""),
                   config_hash=d.get("config_hash", ""),
                   metrics=dict(d.get("metrics", {})),
                   rows=list(d.get("rows", [])),
                   meta=dict(d.get("meta", {})))


# ---------------------------------------------------------------------------
# BENCH_<study>.json trajectory persistence
# ---------------------------------------------------------------------------


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:                                # pragma: no cover
        pass
    return str(o)


def load_bench(study: str, root: Optional[str] = None,
               path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The parsed BENCH file, or None if it doesn't exist yet."""
    p = path or bench_path(study, root)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        data = json.load(f)
    if data.get("schema") != BENCH_SCHEMA:
        raise ValueError(
            f"{p}: unknown bench schema {data.get('schema')!r} "
            f"(expected {BENCH_SCHEMA})")
    return data


def append_bench(report: RunReport, root: Optional[str] = None,
                 path: Optional[str] = None,
                 max_runs: int = MAX_RUNS_DEFAULT) -> str:
    """Append ``report`` to the study's trajectory (creating the file —
    and seeding its baseline — on first run) and return the path."""
    p = path or bench_path(report.study, root)
    data = load_bench(report.study, root, path=p)
    rec = report.to_dict()
    if data is None:
        data = {"schema": BENCH_SCHEMA, "study": report.study,
                "baseline": rec, "runs": []}
    data["runs"].append(rec)
    if max_runs and len(data["runs"]) > max_runs:
        data["runs"] = data["runs"][-max_runs:]
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, default=_json_default)
        f.write("\n")
    os.replace(tmp, p)
    return p


def promote_baseline(study: str, root: Optional[str] = None,
                     path: Optional[str] = None) -> Dict[str, Any]:
    """Make the latest run the new accepted baseline (after a reviewed,
    deliberate improvement — the gate never does this on its own)."""
    p = path or bench_path(study, root)
    data = load_bench(study, root, path=p)
    if data is None or not data["runs"]:
        raise FileNotFoundError(
            f"no recorded runs for study {study!r} at {p}")
    data["baseline"] = data["runs"][-1]
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, default=_json_default)
        f.write("\n")
    os.replace(tmp, p)
    return data
