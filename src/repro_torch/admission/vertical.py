"""Vertical resize: shrink/grow a running instance's cpu reservation,
re-solved through the PredictionService capacity table.

"Tiny Autoscalers" (arxiv 2203.00592) shows per-function dynamic CPU
allocation is a utilization win independent of horizontal scaling.
Here the autoscaler's tick ends with a vertical pass that harvests the
*reservation* of over-provisioned best-effort functions:

  * every function's cpu request is conservative (``cpu_req``); its
    solo-run profile measured what it actually uses at saturation
    (``mcpu``, observable — the ground-truth ``cpu_work`` stays
    hidden, exactly the paper's profiling methodology).  The safe
    floor of a shrink is ``mcpu / (cpu_req * safe_util)``: the
    instance keeps its working cpu plus ``1/safe_util`` slack.
  * shrinks apply per node (``Node.shares``) and only after the
    PredictionService confirms the node's current packing is within
    its predicted-QoS capacity (``capacity_hint`` against the live
    colocation) — a resize never violates predicted QoS, and nodes
    whose table the service has not solved yet are left alone.
  * a shrunk function's *harvest bound* rises: its instances reserve
    ``share`` of their former footprint, so the harvesting scheduler
    may pack ``headroom / share`` of the predicted capacity (capped at
    ``bound_cap < 1`` — the bound can approach but never exceed the
    capacity table, so packing stays inside the predicted-QoS-safe
    region).  This is the per-function harvest bound the PR-5
    follow-up asked for; with no vertical activity every function
    falls back to the scheduler's global scalar and placement is
    bit-identical.
  * queue pressure (depth > 0) or any latency-critical tag grows the
    function straight back to full share — growth is always safe (it
    only returns reservation).

Grow/shrink transitions are emitted through ``events.on_scale`` as
``"vertical_grow"`` / ``"vertical_shrink"`` (count = instances whose
reservation changed), riding the same observer stream as every other
scaling transition.
"""
from __future__ import annotations

from typing import Dict, Optional

from .slo import BEST_EFFORT

_EPS = 1e-9


class VerticalScaler:
    """Plans and applies per-function cpu-share targets."""

    def __init__(self, specs, slo: Dict[str, str], *,
                 min_share: float = 0.5,
                 safe_util: float = 0.8,
                 bound_cap: float = 0.98,
                 lc_guard: float = 0.15,
                 resize_every_s: float = 15.0,
                 store=None):
        self.specs = specs
        self.slo = slo
        self.min_share = min_share
        self.safe_util = safe_util
        self.bound_cap = bound_cap
        #: extra reservation a latency-critical shrink keeps above the
        #: floor (best-effort is harvested first and deepest)
        self.lc_guard = lc_guard
        self.resize_every_s = resize_every_s
        self.store = store
        #: current per-function share (absent -> 1.0, never resized)
        self.share: Dict[str, float] = {}
        self.grows = 0
        self.shrinks = 0
        self._last = float("-inf")

    # -- policy ----------------------------------------------------------

    def floor_share(self, fn: str) -> float:
        """The lowest safe reservation share for ``fn``: solo-measured
        cpu over the request, with ``1/safe_util`` slack — clamped into
        ``[min_share, 1]``.  Falls back to ``min_share`` when no
        profile store is attached."""
        spec = self.specs[fn]
        if self.store is None:
            return self.min_share
        mcpu = float(self.store.profile(spec)[0])
        safe = mcpu / max(spec.cpu_req * self.safe_util, _EPS)
        return min(1.0, max(self.min_share, safe))

    def target_share(self, fn: str, queue_depth: float) -> float:
        """Any function with an empty (post-drain) queue shrinks toward
        its measured solo footprint — pressure means full reservation.
        Best-effort goes all the way to the floor; latency-critical
        keeps ``lc_guard`` extra reservation on top of it (harvested
        last, per the class contract)."""
        if queue_depth > _EPS:
            return 1.0
        floor = self.floor_share(fn)
        if self.slo.get(fn) == BEST_EFFORT:
            return floor
        return min(1.0, floor + self.lc_guard)

    def harvest_bound(self, fn: str, headroom: float) -> Optional[float]:
        """Per-function harvest bound implied by the current share, or
        None for the scheduler's global default (share == 1).  The cap
        is class-tiered: best-effort may pack to ``bound_cap`` of the
        predicted capacity, latency-critical keeps ``lc_guard`` of the
        bound in reserve — harvested last, shallower."""
        s = self.share.get(fn, 1.0)
        if s >= 1.0 - _EPS:
            return None
        cap = self.bound_cap
        if self.slo.get(fn) != BEST_EFFORT:
            cap = max(headroom, self.bound_cap - self.lc_guard)
        return min(cap, headroom / s)

    # -- application ------------------------------------------------------

    def tick(self, now: float, cluster, scheduler, depths,
             events) -> None:
        """One vertical pass (rate-limited to ``resize_every_s``):
        retarget every function with live instances, apply per-node,
        refresh the scheduler's per-function harvest bounds.

        ``depths`` maps fn -> *post-drain* backlog (the controller's
        snapshot from the previous tick's drain): mid-tick the queues
        always hold this tick's still-undrained arrivals, which is not
        pressure — only backlog that survived a drain is."""
        if now - self._last < self.resize_every_s:
            return
        self._last = now
        svc = getattr(scheduler, "prediction_service", None)
        if svc is None:
            return      # no capacity table to solve resizes against
        bounds = getattr(scheduler, "harvest_bounds", None)
        headroom = getattr(scheduler, "harvest_headroom", 0.85)
        for fn in self.specs:
            if cluster.sat_count(fn) + cluster.cached_count(fn) <= 0:
                if self.share.pop(fn, None) is not None and \
                        bounds is not None:
                    bounds.pop(fn, None)
                continue
            target = self.target_share(fn, depths.get(fn, 0.0))
            cur = self.share.get(fn, 1.0)
            if abs(target - cur) <= _EPS:
                continue
            changed = self._apply(fn, target, cur, cluster, svc)
            if changed:
                if target >= 1.0 - _EPS:
                    self.share.pop(fn, None)
                    self.grows += 1
                else:
                    self.share[fn] = target
                    self.shrinks += 1
                events.on_scale(now, fn,
                                "vertical_grow" if target > cur
                                else "vertical_shrink", changed)
            if bounds is not None:
                b = self.harvest_bound(fn, headroom)
                if b is None:
                    bounds.pop(fn, None)
                else:
                    bounds[fn] = b

    def _apply(self, fn: str, target: float, cur: float, cluster,
               svc) -> int:
        """Apply ``target`` share on every node hosting ``fn``.  Grows
        are unconditional (returning reservation is always safe);
        shrinks require the node's live packing to sit within its
        predicted-QoS capacity.  Returns instances resized."""
        changed = 0
        for node in cluster.nodes_with(fn):
            st = node.funcs.get(fn)
            if st is None or st.total <= 0:
                continue
            if target < cur:
                # predicted-QoS capacity for the node's live packing:
                # the service cache when the exact colocation was
                # solved, else the node's async-maintained capacity
                # table entry (the Jiagu pre-decision table)
                cap = svc.capacity_hint(svc.node_coloc(node), fn,
                                        node_res=node.res)
                if cap is None:
                    entry = node.table.get(fn)
                    cap = entry.capacity if entry is not None else None
                if cap is None or st.total > cap:
                    continue    # unsolved or already at predicted edge
            if target >= 1.0 - _EPS:
                if node.shares.pop(fn, None) is not None:
                    changed += st.total
            else:
                if node.shares.get(fn) != target:
                    node.shares[fn] = target
                    changed += st.total
        return changed
