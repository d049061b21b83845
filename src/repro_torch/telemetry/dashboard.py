"""Self-contained HTML run dashboard (port of
``repro.telemetry.dashboard``).

    PYTHONPATH=src python -m repro_torch.telemetry.dashboard \
        [--root DIR] [--events DIR] [--out FILE]

Renders one static HTML file (inline CSS + SVG, no external assets, no
JS) from two sources:

  * the checked-in ``BENCH_<study>.json`` trajectories (baseline +
    recorded runs) — per-scheduler density / QoS / cold-start panels
    for the latest large-cluster run, capacity-engine scaling, and the
    headline-metric trajectory across runs;
  * a run's ``artifacts/events/*.jsonl`` observer streams — density
    over simulated time per scheduler, ``DecisionTrace`` rejection-
    reason breakdowns, and the span table (count / total / mean / max
    wall-clock per control-plane section, flamegraph-style widths).

Charts follow the repo's dataviz conventions: one fixed categorical
slot per scheduler (color follows the entity across every panel),
sequential single-hue bars for magnitudes, a legend plus direct value
labels, native ``<title>`` hover tooltips, and a table view under each
panel.  Light and dark render from the same markup via CSS custom
properties.

The page is the reference's, byte for byte, on the same inputs (its
title included), apart from the line stamping the generation time.
``main`` writes no page under the default root (``report.repo_root()``,
which holds the reference's files) unless ``--out``, ``--root`` or
``REPRO_BENCH_DIR`` says where.
"""
from __future__ import annotations

import argparse
import html
import json
import math
import os
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .report import load_bench, repo_root

#: fixed categorical slot per scheduler — identity keeps its hue in
#: every panel; unknown systems take the next free slot in this order
SYSTEM_ORDER = ("k8s", "jiagu", "harvesting", "gsight", "owl")
N_SLOTS = 8

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px 32px; background: var(--surface-0);
  color: var(--text-primary);
  font: 14px/1.45 -apple-system, "Segoe UI", Roboto, Helvetica, Arial,
        sans-serif;
}
body {
  --surface-0: #fcfcfb; --surface-1: #ffffff; --border: #e4e3df;
  --grid: #ecebe7; --text-primary: #0b0b0b; --text-secondary: #52514e;
  --text-muted: #8a8985; --seq: #2a78d6;
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --series-4: #eda100; --series-5: #e87ba4; --series-6: #008300;
  --series-7: #4a3aa7; --series-8: #e34948;
}
@media (prefers-color-scheme: dark) {
  body {
    --surface-0: #1a1a19; --surface-1: #222221; --border: #3a3a37;
    --grid: #32322f; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --text-muted: #8a8985; --seq: #3987e5;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --series-4: #c98500; --series-5: #d55181; --series-6: #008300;
    --series-7: #9085e9; --series-8: #e66767;
  }
}
h1 { font-size: 20px; margin: 0 0 2px; }
h2 { font-size: 15px; margin: 0 0 8px; }
.sub { color: var(--text-secondary); margin-bottom: 20px; }
.grid { display: flex; flex-wrap: wrap; gap: 16px; }
.card {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 16px 16px 10px;
}
.legend { display: flex; gap: 14px; flex-wrap: wrap; margin: 6px 0 2px;
          color: var(--text-secondary); font-size: 12px; }
.legend span.sw { display: inline-block; width: 10px; height: 10px;
                  border-radius: 3px; margin-right: 5px;
                  vertical-align: -1px; }
svg text { fill: var(--text-secondary); font-size: 11px; }
svg text.val { fill: var(--text-primary); }
svg text.muted { fill: var(--text-muted); }
svg line.grid { stroke: var(--grid); stroke-width: 1; }
svg line.axis { stroke: var(--border); stroke-width: 1; }
details { margin: 6px 0 2px; color: var(--text-secondary); }
details table { border-collapse: collapse; font-size: 12px;
                margin-top: 6px; }
details th, details td { border: 1px solid var(--border);
                         padding: 2px 8px; text-align: right; }
details th:first-child, details td:first-child { text-align: left; }
.empty { color: var(--text-muted); font-style: italic; }
"""


def _e(s: Any) -> str:
    return html.escape(str(s))


def _slot(system: str, order: List[str]) -> int:
    if system not in order:
        order.append(system)
    return (order.index(system) % N_SLOTS) + 1


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 100:
            return f"{v:,.0f}"
        if abs(v) >= 1:
            return f"{v:.2f}".rstrip("0").rstrip(".")
        return f"{v:.3g}"
    return str(v)


def _table(headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> str:
    head = "".join(f"<th>{_e(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_e(_fmt(c))}</td>" for c in r) + "</tr>"
        for r in rows)
    return (f"<details><summary>table view</summary><table>"
            f"<tr>{head}</tr>{body}</table></details>")


def _legend(series: Sequence[Tuple[str, int]]) -> str:
    items = "".join(
        f"<div><span class='sw' "
        f"style='background:var(--series-{slot})'></span>{_e(n)}</div>"
        for n, slot in series)
    return f"<div class='legend'>{items}</div>"


# ---------------------------------------------------------------------------
# SVG primitives
# ---------------------------------------------------------------------------


def _grouped_bars(groups: Sequence[Tuple[str, List[Tuple[str, float]]]],
                  slots: Dict[str, int], unit: str = "",
                  height: int = 190, label_vals: bool = True) -> str:
    """Vertical grouped bar chart: one group per sweep point, one
    4px-rounded bar per scheduler, 2px gaps, native tooltips."""
    if not groups:
        return "<div class='empty'>no data</div>"
    vmax = max((v for _, bars in groups for _, v in bars), default=0.0)
    vmax = vmax * 1.12 or 1.0
    n_series = max(len(bars) for _, bars in groups)
    bar_w, gap = 26, 2
    group_w = n_series * (bar_w + gap) + 26
    ml, mr, mt, mb = 44, 8, 8, 34
    w = ml + mr + group_w * len(groups)
    plot_h = height - mt - mb
    parts = [f"<svg viewBox='0 0 {w} {height}' width='{w}' "
             f"height='{height}' role='img'>"]
    for i in range(5):
        y = mt + plot_h * i / 4
        v = vmax * (1 - i / 4)
        parts.append(f"<line class='grid' x1='{ml}' y1='{y:.1f}' "
                     f"x2='{w - mr}' y2='{y:.1f}'/>")
        parts.append(f"<text x='{ml - 5}' y='{y + 3.5:.1f}' "
                     f"text-anchor='end'>{_fmt(v)}</text>")
    parts.append(f"<line class='axis' x1='{ml}' y1='{mt + plot_h}' "
                 f"x2='{w - mr}' y2='{mt + plot_h}'/>")
    for gi, (glabel, bars) in enumerate(groups):
        gx = ml + gi * group_w + 13
        for bi, (sname, v) in enumerate(bars):
            x = gx + bi * (bar_w + gap)
            h = plot_h * (v / vmax) if vmax else 0.0
            y = mt + plot_h - h
            slot = slots.get(sname, 1)
            r = min(4.0, h)
            parts.append(
                f"<path d='M{x},{mt + plot_h} v{-(h - r):.1f} "
                f"q0,{-r} {r},{-r} h{bar_w - 2 * r} q{r},0 {r},{r} "
                f"v{h - r:.1f} z' fill='var(--series-{slot})'>"
                f"<title>{_e(sname)} · {_e(glabel)}: "
                f"{_fmt(v)}{unit}</title></path>"
                if h > r else
                f"<rect x='{x}' y='{y:.1f}' width='{bar_w}' "
                f"height='{max(h, 0.5):.1f}' "
                f"fill='var(--series-{slot})'>"
                f"<title>{_e(sname)} · {_e(glabel)}: "
                f"{_fmt(v)}{unit}</title></rect>")
            if label_vals:
                parts.append(
                    f"<text class='val' x='{x + bar_w / 2}' "
                    f"y='{y - 4:.1f}' text-anchor='middle'>"
                    f"{_fmt(v)}</text>")
        cx = gx + (n_series * (bar_w + gap) - gap) / 2
        parts.append(f"<text x='{cx:.1f}' y='{height - 16}' "
                     f"text-anchor='middle'>{_e(glabel)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def _hbars(items: Sequence[Tuple[str, float, str]],
           fill: str = "var(--seq)", width: int = 460) -> str:
    """Horizontal magnitude bars (sequential single hue): label,
    proportional bar, value label at the data end."""
    if not items:
        return "<div class='empty'>no data</div>"
    vmax = max(v for _, v, _ in items) or 1.0
    lw, vw, bh, gap = 190, 86, 16, 6
    bar_span = width - lw - vw - 12
    h = len(items) * (bh + gap) + 6
    parts = [f"<svg viewBox='0 0 {width} {h}' width='{width}' "
             f"height='{h}' role='img'>"]
    for i, (label, v, vtext) in enumerate(items):
        y = 3 + i * (bh + gap)
        bw = max(bar_span * v / vmax, 1.5)
        parts.append(f"<text x='{lw - 6}' y='{y + bh - 4}' "
                     f"text-anchor='end'>{_e(label[:30])}</text>")
        parts.append(
            f"<rect x='{lw}' y='{y}' rx='4' width='{bw:.1f}' "
            f"height='{bh}' fill='{fill}'>"
            f"<title>{_e(label)}: {_e(vtext)}</title></rect>")
        parts.append(f"<text class='val' x='{lw + bw + 6:.1f}' "
                     f"y='{y + bh - 4}'>{_e(vtext)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def _lines(series: Dict[str, List[Tuple[float, float]]],
           slots: Dict[str, int], width: int = 460, height: int = 170,
           x_label: str = "", y_zero: bool = True) -> str:
    """Multi-series line chart (2px strokes, endpoint dots + direct
    labels)."""
    pts = [p for s in series.values() for p in s]
    if not pts:
        return "<div class='empty'>no data</div>"
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0 = 0.0 if y_zero else min(ys)
    y1 = max(ys) * 1.08 or 1.0
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0
    ml, mr, mt, mb = 44, 64, 8, 26
    pw, ph = width - ml - mr, height - mt - mb

    def sx(x):
        return ml + pw * (x - x0) / (x1 - x0)

    def sy(y):
        return mt + ph * (1 - (y - y0) / (y1 - y0))

    parts = [f"<svg viewBox='0 0 {width} {height}' width='{width}' "
             f"height='{height}' role='img'>"]
    for i in range(5):
        gy = mt + ph * i / 4
        v = y1 - (y1 - y0) * i / 4
        parts.append(f"<line class='grid' x1='{ml}' y1='{gy:.1f}' "
                     f"x2='{width - mr}' y2='{gy:.1f}'/>")
        parts.append(f"<text x='{ml - 5}' y='{gy + 3.5:.1f}' "
                     f"text-anchor='end'>{_fmt(v)}</text>")
    parts.append(f"<line class='axis' x1='{ml}' y1='{mt + ph}' "
                 f"x2='{width - mr}' y2='{mt + ph}'/>")
    parts.append(f"<text class='muted' x='{ml}' y='{height - 8}'>"
                 f"{_e(x_label)} {_fmt(x0)} → {_fmt(x1)}</text>")
    for name, data in series.items():
        if not data:
            continue
        slot = slots.get(name, 1)
        path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in data)
        parts.append(f"<polyline points='{path}' fill='none' "
                     f"stroke='var(--series-{slot})' stroke-width='2'>"
                     f"<title>{_e(name)}</title></polyline>")
        lx, ly = data[-1]
        parts.append(f"<circle cx='{sx(lx):.1f}' cy='{sy(ly):.1f}' "
                     f"r='3' fill='var(--series-{slot})'/>")
        parts.append(f"<text x='{sx(lx) + 6:.1f}' "
                     f"y='{sy(ly) + 3.5:.1f}'>{_e(name)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def _card(title: str, body: str, note: str = "") -> str:
    sub = f"<div class='sub' style='margin:0 0 6px'>{note}</div>" \
        if note else ""
    return f"<div class='card'><h2>{_e(title)}</h2>{sub}{body}</div>"


# ---------------------------------------------------------------------------
# Event-stream ingestion (artifacts/events/*.jsonl)
# ---------------------------------------------------------------------------


def load_event_streams(events_dir: str) -> List[Dict[str, Any]]:
    """Parse every ``*.jsonl`` stream into one summary dict per file:
    scheduler name, density-over-time samples, rejection-reason counts,
    scale-event counts, span aggregates."""
    streams: List[Dict[str, Any]] = []
    if not events_dir or not os.path.isdir(events_dir):
        return streams
    for fname in sorted(os.listdir(events_dir)):
        if not fname.endswith(".jsonl"):
            continue
        path = os.path.join(events_dir, fname)
        summary: Dict[str, Any] = {
            "file": fname, "system": None, "ticks": [], "qdepth": [],
            "reasons": defaultdict(int), "scale": defaultdict(int),
            "spans": {}, "schedules": 0, "events": 0}
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue          # truncated tail of a crash
                    summary["events"] += 1
                    ev = rec.get("event")
                    if ev == "meta":
                        sched = (rec.get("manifest") or {}).get(
                            "scheduler") or {}
                        summary["system"] = sched.get("name")
                    elif ev == "tick":
                        summary["ticks"].append(
                            (rec.get("now", 0.0),
                             rec.get("density", 0.0)))
                        if "queue_depth" in rec:
                            summary["qdepth"].append(
                                (rec.get("now", 0.0),
                                 rec["queue_depth"]))
                    elif ev == "schedule":
                        summary["schedules"] += 1
                        for reason, n in (rec.get("trace") or {}).get(
                                "filtered", {}).items():
                            summary["reasons"][reason] += n
                    elif ev == "scale":
                        summary["scale"][rec.get("kind", "?")] += \
                            rec.get("count", 0)
                    elif ev == "span":
                        row = summary["spans"].setdefault(
                            rec.get("name", "?"),
                            {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
                        row["count"] += 1
                        row["total_ms"] += rec.get("ms", 0.0)
                        row["max_ms"] = max(row["max_ms"],
                                            rec.get("ms", 0.0))
        except OSError:
            continue
        if summary["system"] is None:
            # fall back to the run_study naming convention
            # (<kind>_<nodes>_<system>.jsonl)
            stem = fname[:-6]
            summary["system"] = stem.rsplit("_", 1)[-1] or stem
        streams.append(summary)
    return streams


# ---------------------------------------------------------------------------
# Panels
# ---------------------------------------------------------------------------


def _latest(bench: Dict[str, Any]) -> Dict[str, Any]:
    runs = bench.get("runs") or []
    return runs[-1] if runs else bench.get("baseline", {})


def _metric_panels(run: Dict[str, Any], slots: Dict[str, int],
                   order: List[str]) -> str:
    rows = run.get("rows", [])
    if not rows:
        return ""
    systems = sorted({r["system"] for r in rows if "system" in r},
                     key=lambda s: (_slot(s, order)))
    panels = []
    for metric, title, unit in (
            ("density", "Density (instances / active node)", ""),
            ("qos_violation", "QoS violation rate", ""),
            ("cold_ms_p99", "Cold-start p99 (ms)", " ms")):
        groups = []
        for r in rows:
            if r.get("system") != systems[0] or metric not in r:
                continue
            glabel = f"{r.get('scenario', '?')}@{r.get('target_nodes')}"
            bars = []
            for s in systems:
                match = [x for x in rows
                         if x.get("system") == s
                         and x.get("scenario") == r.get("scenario")
                         and x.get("target_nodes")
                         == r.get("target_nodes")
                         and metric in x]
                if match:
                    bars.append((s, float(match[0][metric])))
            if bars:
                groups.append((glabel, bars))
        if not groups:
            continue
        svg = _grouped_bars(groups, slots, unit=unit)
        legend = _legend([(s, slots[s]) for s in systems])
        table = _table(
            ["scenario@nodes"] + systems,
            [[g] + [dict(bars).get(s, "") for s in systems]
             for g, bars in groups])
        panels.append(_card(title, legend + svg + table))
    return "".join(panels)


def _trajectory_panel(study: str, bench: Dict[str, Any],
                      slots: Dict[str, int], order: List[str]) -> str:
    """Headline metric across the recorded runs (the BENCH
    trajectory), baseline included as run 0."""
    runs = [bench.get("baseline")] + list(bench.get("runs") or [])
    runs = [r for r in runs if r]

    def headline(run) -> Dict[str, float]:
        rows = run.get("rows", [])
        out: Dict[str, List[float]] = defaultdict(list)
        for r in rows:
            if "density" in r and "system" in r:
                out[r["system"]].append(float(r["density"]))
            elif r.get("speedup") is not None:
                # device-drain-only rows (legacy path not run at that
                # size) carry speedup=None and don't enter the mean
                out["engine speedup"].append(float(r["speedup"]))
        return {k: sum(v) / len(v) for k, v in out.items() if v}

    series: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for i, run in enumerate(runs):
        for name, v in headline(run).items():
            series[name].append((float(i), v))
    if not series:
        return ""
    for name in series:
        _slot(name, order)
    y_label = "mean density" if any(
        n != "engine speedup" for n in series) else "speedup (x)"
    svg = _lines(dict(series), slots, x_label="run #")
    shas = [r.get("git_sha", "?") for r in runs]
    table = _table(["run", "git", *series.keys()],
                   [[i, shas[i]] + [
                       dict(series[n]).get(float(i), "")
                       for n in series] for i in range(len(runs))])
    return _card(f"{study}: trajectory ({y_label}, run 0 = baseline)",
                 svg + table)


def _reasons_panel(streams: List[Dict[str, Any]]) -> str:
    per_system: Dict[str, Dict[str, int]] = defaultdict(
        lambda: defaultdict(int))
    for s in streams:
        for reason, n in s["reasons"].items():
            per_system[s["system"]][reason] += n
    if not per_system:
        return ""
    blocks = []
    for system, reasons in sorted(per_system.items()):
        items = [(reason, float(n), f"{n:,}")
                 for reason, n in sorted(reasons.items(),
                                         key=lambda kv: -kv[1])[:10]]
        blocks.append(f"<div class='sub' style='margin:8px 0 2px'>"
                      f"{_e(system)}</div>" + _hbars(items))
    table = _table(
        ["system", "reason", "count"],
        [[sys_, r, n] for sys_, rs in sorted(per_system.items())
         for r, n in sorted(rs.items(), key=lambda kv: -kv[1])])
    return _card("Decision-trace rejection reasons (per scheduler)",
                 "".join(blocks) + table,
                 note="why candidate nodes were filtered out of "
                      "placements, from the schedule event stream")


def _policy_panel(bench: Dict[str, Any], slots: Dict[str, int],
                  order: List[str]) -> str:
    """Learned-vs-baseline comparison from the latest policy run:
    density bars per system, QoS violation magnitudes, and the training
    / serving gate metrics (agreement, QoS excess, stale serves)."""
    latest = _latest(bench)
    rows = [r for r in latest.get("rows", []) if r.get("system")]
    if not rows:
        return ""
    for r in rows:
        slots[r["system"]] = _slot(r["system"], order)
    systems = [r["system"] for r in rows]
    density = [(r["system"], float(r.get("density", 0.0)))
               for r in rows]
    qos_items = [(r["system"], float(r.get("qos_violation", 0.0)),
                  f"{float(r.get('qos_violation', 0.0)):.4f}")
                 for r in rows]
    met = latest.get("metrics", {})
    note = (f"trained on {met.get('n_decisions', '?')} traced "
            f"decisions · imitation holdout agreement "
            f"{met.get('imitation_agreement', '?')} (gated ≥ 0.90) · "
            f"QoS excess over k8s {met.get('learned_qos_excess', '?')} "
            f"· density ratio {met.get('learned_density_ratio', '?')}x "
            f"k8s · stale-epoch serves {met.get('stale_serves', '?')}")
    legend = _legend([(s, slots[s]) for s in systems])
    svg = _grouped_bars([("density", density)], slots)
    table = _table(
        ["system", "density", "qos violation", "decisions", "placed",
         "stale serves"],
        [[r.get(k, "") for k in (
            "system", "density", "qos_violation", "decisions",
            "placed", "stale_serves")] for r in rows])
    return _card(
        "Learned policy vs baselines (latest policy run)",
        legend + svg
        + "<div class='sub' style='margin:8px 0 2px'>QoS violation "
          "rate</div>" + _hbars(qos_items) + table,
        note=note)


def _admission_panel(bench: Dict[str, Any], slots: Dict[str, int],
                     order: List[str]) -> str:
    """Per-SLO-class QoS comparison from the latest admission run:
    seed-mean violation rate per class, one bar per arm, plus the
    headline A/B metrics (density win, latency-critical excess)."""
    latest = _latest(bench)
    rows = [r for r in latest.get("rows", []) if r.get("system")]
    if not rows:
        return ""
    arms = sorted({r["system"] for r in rows})
    for a in arms:
        slots[a] = _slot(a, order)

    def mean(arm, key):
        vals = [float(r.get(key, 0.0)) for r in rows
                if r["system"] == arm]
        return sum(vals) / len(vals) if vals else 0.0

    groups = [(cls, [(a, mean(a, key)) for a in arms])
              for cls, key in (("latency-critical", "lc_violation"),
                               ("best-effort", "be_violation"),
                               ("overall", "qos_violation"))]
    met = latest.get("metrics", {})
    note = (f"seed-mean over {len(rows) // max(len(arms), 1)} seeds · "
            f"density win {met.get('density_win', '?')} (gated &gt; 0) "
            f"· latency-critical excess {met.get('lc_excess', '?')} · "
            f"queue delay p99 {met.get('queue_delay_p99', '?')}s · "
            f"{met.get('vertical_shrinks', '?')} vertical shrinks")
    legend = _legend([(a, slots[a]) for a in arms])
    svg = _grouped_bars(groups, slots)
    table = _table(
        ["arm", "seed", "density", "qos", "lc", "be", "queue p99 s",
         "shrinks"],
        [[r.get(k, "") for k in (
            "system", "seed", "density", "qos_violation",
            "lc_violation", "be_violation", "queue_delay_p99",
            "vertical_shrinks")] for r in rows])
    return _card(
        "Admission: per-SLO-class QoS by arm (latest admission run)",
        legend + svg + table, note=note)


def _queue_depth_panel(streams: List[Dict[str, Any]],
                       slots: Dict[str, int],
                       order: List[str]) -> str:
    """Pending-request backlog over simulated time, from the tick
    records of admission-enabled event streams."""
    series: Dict[str, List[Tuple[float, float]]] = {}
    for s in streams:
        if s["qdepth"] and s["system"]:
            prev = series.get(s["system"])
            if prev is None or len(s["qdepth"]) > len(prev):
                series[s["system"]] = s["qdepth"]
    if not series:
        return ""
    for name in series:
        _slot(name, order)
    svg = _lines(series, slots, width=560, x_label="sim time (s)")
    return _card("Queue depth over simulated time (events stream)",
                 svg,
                 note="fleet pending-request backlog per tick; only "
                      "admission-enabled runs emit the gauge")


def _density_over_time_panel(streams: List[Dict[str, Any]],
                             slots: Dict[str, int],
                             order: List[str]) -> str:
    series: Dict[str, List[Tuple[float, float]]] = {}
    for s in streams:
        if s["ticks"] and s["system"]:
            # one representative stream per scheduler (the largest run)
            prev = series.get(s["system"])
            if prev is None or len(s["ticks"]) > len(prev):
                series[s["system"]] = s["ticks"]
    if not series:
        return ""
    for name in series:
        _slot(name, order)
    svg = _lines(series, slots, width=560, x_label="sim time (s)")
    return _card("Density over simulated time (events stream)", svg)


def _spans_panel(streams: List[Dict[str, Any]]) -> str:
    agg: Dict[str, Dict[str, float]] = {}
    for s in streams:
        for name, row in s["spans"].items():
            dst = agg.setdefault(name, {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
            dst["count"] += row["count"]
            dst["total_ms"] += row["total_ms"]
            dst["max_ms"] = max(dst["max_ms"], row["max_ms"])
    if not agg:
        return ""
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"])
    items = [(name, r["total_ms"],
              f"{r['total_ms']:,.1f} ms · {int(r['count'])}x")
             for name, r in rows]
    table = _table(
        ["span", "count", "total ms", "mean ms", "max ms"],
        [[name, int(r["count"]), round(r["total_ms"], 2),
          round(r["total_ms"] / max(r["count"], 1), 3),
          round(r["max_ms"], 2)] for name, r in rows])
    return _card("Control-plane spans (wall clock)",
                 _hbars(items) + table,
                 note="schedule / retrain / capacity_solve sections "
                      "from the span stream; bar = total wall time")


# ---------------------------------------------------------------------------
# Page assembly
# ---------------------------------------------------------------------------


def render(root: Optional[str] = None, events_dir: Optional[str] = None,
           studies: Optional[Sequence[str]] = None) -> str:
    root = root or repo_root()
    if studies is None:
        studies = sorted(
            f[len("BENCH_"):-len(".json")] for f in os.listdir(root)
            if f.startswith("BENCH_") and f.endswith(".json"))
    if events_dir is None:
        events_dir = os.path.join(root, "benchmarks", "artifacts",
                                  "events")
    benches = {}
    for study in studies:
        try:
            data = load_bench(study, root)
        except ValueError:
            data = None
        if data:
            benches[study] = data
    streams = load_event_streams(events_dir)

    order: List[str] = list(SYSTEM_ORDER)
    slots: Dict[str, int] = {}

    def ensure_slots(names):
        for n in names:
            slots[n] = _slot(n, order)

    for bench in benches.values():
        ensure_slots(r.get("system") for r in _latest(bench).get(
            "rows", []) if r.get("system"))
    ensure_slots(s["system"] for s in streams if s["system"])

    cards: List[str] = []
    lc = benches.get("large_cluster")
    if lc:
        cards.append(_metric_panels(_latest(lc), slots, order))
    for study, bench in benches.items():
        cards.append(_trajectory_panel(study, bench, slots, order))
    ce = benches.get("capacity_engine")
    if ce:
        rows = _latest(ce).get("rows", [])
        # device-drain-only rows (legacy skipped past its node cap)
        # have speedup=None: shown in the table, left out of the bars
        items = [(f"{r['nodes']} nodes", float(r["speedup"]),
                  f"{r['speedup']}x cold / "
                  f"{r.get('warm_speedup', 0)}x warm")
                 for r in rows
                 if "nodes" in r and r.get("speedup") is not None]
        if items:
            table = _table(
                ["nodes", "legacy ms", "engine ms", "warm ms",
                 "device ms", "device µs/solve", "speedup",
                 "call reduction"],
                [["" if r.get(k) is None else r.get(k, "") for k in (
                    "nodes", "legacy_ms", "engine_ms", "warm_ms",
                    "device_ms", "device_us_per_solve",
                    "speedup", "call_reduction")] for r in rows])
            cards.append(_card(
                "Capacity-engine speedup vs legacy (latest run)",
                _hbars(items) + table))
    sc = benches.get("scaling")
    if sc:
        latest = _latest(sc)
        rows = [r for r in latest.get("rows", [])
                if r.get("target_nodes") and r.get("wall_s")]
        if len(rows) >= 2:
            series = {
                "wall s": [(math.log10(r["target_nodes"]),
                            math.log10(max(r["wall_s"], 1e-3)))
                           for r in rows],
                "ms/node": [(math.log10(r["target_nodes"]),
                             math.log10(max(r["wall_ms_per_node"],
                                            1e-6)))
                            for r in rows],
            }
            ensure_slots(series)
            met = latest.get("metrics", {})
            table = _table(
                ["target nodes", "cells", "mean nodes", "wall s",
                 "ms/node", "density", "qos", "idle cell frac"],
                [[r.get(k, "") for k in (
                    "target_nodes", "cells", "mean_nodes", "wall_s",
                    "wall_ms_per_node", "density", "qos_violation",
                    "idle_cell_frac")] for r in rows])
            cards.append(_card(
                "Event-core scaling: fleet size vs wall clock "
                "(log-log)",
                _lines(series, slots, width=560,
                       x_label="log10 target nodes", y_zero=False)
                + table,
                note=f"cell-sharded event core, per-node wall-clock "
                     f"slope "
                     f"{met.get('wallclock_per_node_slope', '?')} "
                     f"(gated &lt; 1.0) · cells_parity="
                     f"{met.get('cells_parity', '?')}"))
    pol = benches.get("policy")
    if pol:
        cards.append(_policy_panel(pol, slots, order))
    adm = benches.get("admission")
    if adm:
        cards.append(_admission_panel(adm, slots, order))
    cards.append(_density_over_time_panel(streams, slots, order))
    cards.append(_queue_depth_panel(streams, slots, order))
    cards.append(_reasons_panel(streams))
    cards.append(_spans_panel(streams))

    sha = next((_latest(b).get("git_sha") for b in benches.values()
                if _latest(b).get("git_sha")), "unknown")
    body = "".join(c for c in cards if c) or \
        "<div class='empty'>no BENCH_*.json baselines and no event " \
        "streams found — run scripts/verify.sh --bench first</div>"
    n_events = sum(s["events"] for s in streams)
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>repro.telemetry dashboard</title>
<style>{_CSS}</style></head>
<body>
<h1>repro.telemetry — benchmark &amp; run dashboard</h1>
<div class="sub">generated {time.strftime('%Y-%m-%d %H:%M:%SZ',
                                          time.gmtime())}
 · git {_e(sha)} · studies: {_e(', '.join(benches) or 'none')}
 · {len(streams)} event streams ({n_events:,} events)</div>
<div class="grid">{body}</div>
</body></html>
"""


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="render the self-contained telemetry dashboard")
    ap.add_argument("--root", default=None,
                    help="directory holding BENCH_*.json "
                         "(default: repo root / $REPRO_BENCH_DIR)")
    ap.add_argument("--events", default=None,
                    help="events JSONL dir (default: "
                         "<root>/benchmarks/artifacts/events)")
    ap.add_argument("--out", default=None,
                    help="output HTML path (default: "
                         "<root>/benchmarks/artifacts/dashboard.html)")
    args = ap.parse_args(argv)
    if not (args.out or args.root or os.environ.get("REPRO_BENCH_DIR")):
        ap.error("name the page's directory with --out, --root or "
                 "REPRO_BENCH_DIR")
    root = args.root or repo_root()
    out = args.out or os.path.join(root, "benchmarks", "artifacts",
                                   "dashboard.html")
    page = render(root, args.events)
    d = os.path.dirname(os.path.abspath(out))
    os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        f.write(page)
    print(f"# dashboard: wrote {out} ({len(page) / 1024:.0f} KiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
