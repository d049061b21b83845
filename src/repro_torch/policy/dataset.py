"""DecisionTrace JSONL streams -> supervised training matrices.

The scheduler's decision pipeline already emits a ``DecisionTrace`` per
placement; with ``trace_features`` on (``PlatformConfig
pipeline.trace_features``), each trace carries every node's raw feature
row captured *before* the decision mutated the cluster
(``pipeline.candidate_feature_row``), plus the chosen node.  A
``JsonlObserver`` artifact of such a run is therefore a complete offline
dataset of (cluster state, candidate features, decision, outcome) —
this module parses it back:

  * schedule records (schema v2) become ``DecisionRecord``s: a
    ``[n_candidates, n_features]`` float32 matrix, the chosen-candidate
    index (the imitation label), and outcome annotations,
  * tick records carry cumulative request/violation counters, so each
    decision is labelled ``qos_breach`` by the *windowed* violation
    rate over ``qos_horizon_s`` after it — no re-simulation needed,
  * the trailing summary record supplies run-level fallbacks.

Versionless (v1) records predate the feature capture and are counted
and skipped, never errors: old artifacts stay readable, they just
contribute no training rows.  Everything here is numpy-only — JAX
enters in ``repro.policy.train``.
"""
from __future__ import annotations

import hashlib
import json
import os
from bisect import bisect_right
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..core.pipeline import CANDIDATE_FEATURES, TRACE_SCHEMA_VERSION

#: decisions whose within-horizon violation rate exceeds this are
#: labelled ``qos_breach`` (matches the benchmarks' "materially
#: violating" threshold, not any single violated request)
BREACH_THRESHOLD = 0.01


@dataclass
class DecisionRecord:
    """One scheduling decision as a training example."""

    now: float
    fn: str
    node_ids: List[int]
    features: np.ndarray          # [n_candidates, n_features] float32
    chosen: int                   # index into node_ids (the label)
    requested: int
    cold_start: bool = False      # decision scaled out a fresh node
    qos_breach: bool = False      # QoS violations within the horizon


@dataclass
class PolicyDataset:
    """Parsed decisions plus the bookkeeping a trainer needs."""

    decisions: List[DecisionRecord] = field(default_factory=list)
    feature_names: Tuple[str, ...] = CANDIDATE_FEATURES
    schema_version: int = TRACE_SCHEMA_VERSION
    #: v1 records seen (no ``schema_version`` key) — readable, skipped
    skipped_versionless: int = 0
    #: v2 records without feature capture (``trace_features`` off) or
    #: without a usable label (failed decision, unknown chosen node)
    skipped_unlabelled: int = 0
    #: the trailing run-summary record, when the stream carried one
    summary: Optional[Dict[str, Any]] = None

    def __len__(self) -> int:
        return len(self.decisions)

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def max_candidates(self) -> int:
        return max((len(d.node_ids) for d in self.decisions), default=0)


def _iter_records(source) -> Iterable[dict]:
    """Yield JSON records from a path, an open iterable of lines, or an
    iterable of already-parsed dicts."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)
        return
    for item in source:
        if isinstance(item, dict):
            yield item
        else:
            line = item.strip()
            if line:
                yield json.loads(line)


def load_traces(source, *, qos_horizon_s: float = 30.0,
                breach_threshold: float = BREACH_THRESHOLD
                ) -> PolicyDataset:
    """Parse one JSONL event stream into a ``PolicyDataset``.

    ``qos_breach`` labelling: the stream's tick records carry cumulative
    request/violation counters; a decision at time ``t`` is breached
    when the violation rate over ``(t, t + qos_horizon_s]`` exceeds
    ``breach_threshold``.  Streams without the counters (pre-summary
    artifacts) fall back to the run summary's per-function rate, then
    to False."""
    ds = PolicyDataset()
    schedules: List[dict] = []
    tick_t: List[float] = []
    tick_req: List[float] = []
    tick_viol: List[float] = []
    for rec in _iter_records(source):
        ev = rec.get("event")
        if ev == "tick" and "requests" in rec:
            tick_t.append(float(rec["now"]))
            tick_req.append(float(rec["requests"]))
            tick_viol.append(float(rec["violated"]))
        elif ev == "schedule" and "trace" in rec:
            schedules.append(rec["trace"])
        elif ev == "summary":
            ds.summary = rec

    def _window_breach(now: float) -> Optional[bool]:
        if len(tick_t) < 2:
            return None
        i0 = bisect_right(tick_t, now) - 1
        i1 = bisect_right(tick_t, now + qos_horizon_s) - 1
        if i0 < 0:
            i0 = 0
        if i1 <= i0:
            i1 = min(i0 + 1, len(tick_t) - 1)
        dreq = tick_req[i1] - tick_req[i0]
        dviol = tick_viol[i1] - tick_viol[i0]
        return (dviol / max(dreq, 1e-9)) > breach_threshold

    summary_rates = (ds.summary or {}).get("per_fn_violation_rate", {})

    for trace in schedules:
        if "schema_version" not in trace:
            ds.skipped_versionless += 1
            continue
        cands = trace.get("candidates")
        chosen_node = trace.get("chosen_node", -1)
        if not cands or chosen_node < 0:
            ds.skipped_unlabelled += 1
            continue
        # binder/filter rejections are feasibility, not preference: a
        # pointwise scorer cannot see them, and serving re-applies them
        # — so rejected nodes leave the training candidate set (never
        # the chosen node itself, which some stage rejected before
        # another bound it)
        rejected = set(trace.get("rejected", ())) - {chosen_node}
        kept = [(int(nid), row) for nid, row in cands
                if int(nid) not in rejected]
        node_ids = [nid for nid, _row in kept]
        if chosen_node not in node_ids:
            ds.skipped_unlabelled += 1
            continue
        feats = np.asarray([row for _nid, row in kept],
                           dtype=np.float32)
        if feats.shape[1] != len(ds.feature_names):
            ds.skipped_unlabelled += 1
            continue
        now = float(trace["now"])
        breach = _window_breach(now)
        if breach is None:
            breach = summary_rates.get(
                trace.get("fn", ""), 0.0) > breach_threshold
        ds.decisions.append(DecisionRecord(
            now=now, fn=trace.get("fn", ""), node_ids=node_ids,
            features=feats, chosen=node_ids.index(chosen_node),
            requested=int(trace.get("requested", 1)),
            cold_start=bool(trace.get("scale_out", False)),
            qos_breach=bool(breach)))
    return ds


# ---------------------------------------------------------------------------
# Splitting / batching
# ---------------------------------------------------------------------------


def merge(datasets: Iterable[PolicyDataset]) -> PolicyDataset:
    """Concatenate datasets from several collection runs (e.g. one per
    scenario seed) — skip counters add, the last summary wins."""
    out = PolicyDataset()
    for ds in datasets:
        out.decisions.extend(ds.decisions)
        out.skipped_versionless += ds.skipped_versionless
        out.skipped_unlabelled += ds.skipped_unlabelled
        if ds.summary is not None:
            out.summary = ds.summary
    return out


def _holdout_hash(rec: DecisionRecord) -> int:
    """Deterministic per-decision bucket in [0, 1000) — stable across
    runs, machines and record order (md5, not ``hash()``)."""
    key = f"{rec.fn}:{rec.now:.3f}".encode()
    return int.from_bytes(hashlib.md5(key).digest()[:4], "big") % 1000


def split(ds: PolicyDataset, holdout_frac: float = 0.2
          ) -> Tuple[PolicyDataset, PolicyDataset]:
    """Deterministic train/holdout split keyed on (fn, time) — the same
    artifact always splits the same way, independent of parse order."""
    cut = int(holdout_frac * 1000)
    train = [d for d in ds.decisions if _holdout_hash(d) >= cut]
    hold = [d for d in ds.decisions if _holdout_hash(d) < cut]
    return (replace(ds, decisions=train), replace(ds, decisions=hold))


def matrices(ds: PolicyDataset, n_candidates: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-width batch form: ``(X [N, C, F], mask [N, C], y [N])``.

    Decisions with fewer candidates are zero-padded and masked;
    decisions with more than ``n_candidates`` keep their first
    ``n_candidates`` rows (the chosen row is always kept — decisions
    whose label falls outside the cap are dropped, which cannot happen
    when ``n_candidates >= ds.max_candidates``, the default)."""
    C = n_candidates or max(ds.max_candidates, 1)
    F = ds.n_features
    keep = [d for d in ds.decisions if d.chosen < C]
    N = len(keep)
    X = np.zeros((N, C, F), dtype=np.float32)
    mask = np.zeros((N, C), dtype=np.float32)
    y = np.zeros((N,), dtype=np.int32)
    for i, d in enumerate(keep):
        c = min(len(d.node_ids), C)
        X[i, :c] = d.features[:c]
        mask[i, :c] = 1.0
        y[i] = d.chosen
    return X, mask, y


def normalization(X: np.ndarray, mask: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Masked per-feature mean / std over all real candidate rows —
    stored inside the policy (not trained, not weight-decayed) so
    serving applies the identical transform."""
    m = mask.reshape(-1).astype(bool)
    rows = X.reshape(-1, X.shape[-1])[m]
    if rows.size == 0:
        F = X.shape[-1]
        return (np.zeros(F, np.float32), np.ones(F, np.float32))
    mu = rows.mean(axis=0)
    sd = rows.std(axis=0)
    sd = np.where(sd < 1e-6, 1.0, sd)
    return mu.astype(np.float32), sd.astype(np.float32)


def reward_weights(ds: PolicyDataset, *, qos_penalty: float = 3.0,
                   cold_penalty: float = 0.5) -> np.ndarray:
    """Offline-RL per-decision weights: advantage-weighted imitation.

    Every logged decision starts at weight 1 (the behaviour policy is
    already strong); decisions followed by a QoS breach within the
    horizon are down-weighted by ``1 + qos_penalty`` and cold-start
    scale-outs by ``1 + cold_penalty``, so the learner imitates the
    trace's *good* outcomes preferentially.  Normalized to mean 1 so
    the loss scale (and learning-rate transfer) matches imitation."""
    w = np.ones(len(ds.decisions), dtype=np.float32)
    for i, d in enumerate(ds.decisions):
        if d.qos_breach:
            w[i] /= (1.0 + qos_penalty)
        if d.cold_start:
            w[i] /= (1.0 + cold_penalty)
    if len(w):
        w /= max(w.mean(), 1e-9)
    return w


__all__ = [
    "BREACH_THRESHOLD", "DecisionRecord", "PolicyDataset",
    "load_traces", "merge", "split", "matrices", "normalization",
    "reward_weights",
]
