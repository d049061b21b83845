"""SLO classes as a scenario population axis.

Two classes partition every function population:

  * ``latency-critical`` — the paper's implicit default: every request
    carries the function's QoS latency target and queueing beyond a
    tight budget is a violation.  Harvested last: a vertical shrink
    keeps a guard reservation above the measured floor and any queue
    pressure restores the full request.
  * ``best-effort`` — batch-ish traffic that absorbs queueing (a
    generous queue-delay budget) and is harvested first: the vertical
    resizer shrinks its cpu reservations toward the solo-run footprint
    and the harvesting scheduler packs it deeper.

Tagging is a pure function of (function name, fraction, seed) via the
same salted-hash trick ``profiles.py`` uses for intrinsic resource
behaviour — deterministic across processes, order-independent, and —
critically for the admission-off parity gates — it consumes **no** RNG
stream: ``scenario_functions`` draws exactly the same population
whether or not SLO classes are in play.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable

LATENCY_CRITICAL = "latency-critical"
BEST_EFFORT = "best-effort"
SLO_CLASSES = (LATENCY_CRITICAL, BEST_EFFORT)


def _hash_unit(name: str, salt: str) -> float:
    h = hashlib.sha256(f"{name}:{salt}".encode()).digest()
    return int.from_bytes(h[:8], "little") / 2**64


def tag_slo_classes(fn_names: Iterable[str], best_effort_frac: float,
                    seed: int = 0) -> Dict[str, str]:
    """Deterministically tag ``best_effort_frac`` of the population as
    best-effort (per-name salted hash — stable under population growth:
    adding functions never re-tags existing ones)."""
    out: Dict[str, str] = {}
    for fn in fn_names:
        u = _hash_unit(fn, f"slo:{seed}")
        out[fn] = BEST_EFFORT if u < best_effort_frac \
            else LATENCY_CRITICAL
    return out


def delay_budget_s(slo_class: str, lc_budget_s: float,
                   be_budget_s: float) -> float:
    """Queue-delay budget for one class — beyond it, released requests
    count as violated for that class."""
    return be_budget_s if slo_class == BEST_EFFORT else lc_budget_s
