"""Bounded per-function pending-request queues with pluggable
admit/release stages.

Jiagu admits every request instantly: a burst storm translates 1:1
into scale-up demand and the only latency a request can suffer is
execution latency.  Real platforms (KEDA-style queue scalers,
Knative's activator) put a bounded buffer in front of each function:
requests beyond the fleet's current service rate *queue*, queue depth
and age become the autoscaler's signal, and overflow is shed.  This
module is that buffer:

  * ``FunctionQueue`` — one bounded FIFO per function.  Depth is
    fractional (the simulator works in request-rates, not discrete
    requests); arrivals enter as per-tick *buckets* stamped with their
    arrival time, so a FIFO drain knows the exact queueing delay of
    every released request without per-request bookkeeping.
  * ``AdmitStage`` implementations decide what happens at the bound:
    ``bounded-fifo`` rejects the newest arrivals (classic bounded
    queue), ``shed-oldest`` admits the new traffic and drops the
    stalest backlog (bounded staleness — the dropped requests would
    have blown their delay budget anyway).
  * ``QueueReleaseStage`` implementations decide how fast the backlog
    drains into service: ``greedy`` releases up to the fleet's full
    current service rate, ``paced`` keeps a fraction of it in reserve
    so a draining backlog cannot re-saturate freshly placed instances.

Conservation is the load-bearing invariant — every request that ever
arrived is exactly one of {released, dropped, still pending}:

    arrived == released + dropped + depth

``FunctionQueue.conservation_error()`` exposes the residual and
``tests/test_admission.py`` drives it with randomized admit/release/
drop sequences.

Stages are registered in the platform stage registry under the
``admit:`` and ``queue-release:`` kinds (see ``core/platform.py``), so
``PlatformConfig.admission`` selects them by name like any pipeline
stage.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

#: released-bucket record: (arrival_time, count)
Released = List[Tuple[float, float]]

_EPS = 1e-9


class FunctionQueue:
    """Bounded FIFO of pending requests for one function.

    ``buckets`` holds ``[arrival_time, count]`` pairs in arrival order;
    ``depth`` mirrors their sum so depth reads are O(1).  All counts
    are floats (request *mass* per tick, matching the simulator's
    rate-based traffic model)."""

    __slots__ = ("fn", "cap", "buckets", "depth",
                 "arrived", "released", "dropped")

    def __init__(self, fn: str, cap: float):
        self.fn = fn
        self.cap = float(cap)
        self.buckets: Deque[List[float]] = deque()
        self.depth = 0.0
        # lifetime conservation counters
        self.arrived = 0.0
        self.released = 0.0
        self.dropped = 0.0

    # -- primitive ops (stages build on these) --------------------------

    def push(self, now: float, count: float) -> None:
        if count <= _EPS:
            return
        self.arrived += count
        if self.buckets and self.buckets[-1][0] == now:
            self.buckets[-1][1] += count
        else:
            self.buckets.append([now, count])
        self.depth += count

    def drop_newest(self, count: float) -> float:
        """Shed up to ``count`` of the most recent arrivals (reject at
        the door).  Returns the amount actually dropped."""
        got = 0.0
        while count > _EPS and self.buckets:
            t, c = self.buckets[-1]
            take = min(c, count)
            if take >= c - _EPS:
                self.buckets.pop()
                take = c
            else:
                self.buckets[-1][1] = c - take
            got += take
            count -= take
        self.depth -= got
        self.dropped += got
        return got

    def drop_oldest(self, count: float) -> float:
        """Shed up to ``count`` of the stalest backlog."""
        got = 0.0
        while count > _EPS and self.buckets:
            t, c = self.buckets[0]
            take = min(c, count)
            if take >= c - _EPS:
                self.buckets.popleft()
                take = c
            else:
                self.buckets[0][1] = c - take
            got += take
            count -= take
        self.depth -= got
        self.dropped += got
        return got

    def pop(self, count: float) -> Released:
        """FIFO-release up to ``count`` requests into service.  Returns
        the released ``(arrival_time, count)`` buckets (oldest first)
        so the caller can account exact queueing delays."""
        out: Released = []
        while count > _EPS and self.buckets:
            t, c = self.buckets[0]
            take = min(c, count)
            if take >= c - _EPS:
                self.buckets.popleft()
                take = c
            else:
                self.buckets[0][1] = c - take
            out.append((t, take))
            count -= take
        got = sum(c for _t, c in out)
        self.depth -= got
        self.released += got
        return out

    # -- reads ----------------------------------------------------------

    def oldest_age(self, now: float) -> float:
        """Age of the queue head — the worst queueing delay any pending
        request has accumulated so far."""
        return (now - self.buckets[0][0]) if self.buckets else 0.0

    def conservation_error(self) -> float:
        """|arrived - released - dropped - depth| — zero (to float eps)
        by construction; tests and the benchmark assert it."""
        return abs(self.arrived - self.released - self.dropped
                   - self.depth)


# ---------------------------------------------------------------------------
# Admit stages (what happens at the bound)
# ---------------------------------------------------------------------------


class BoundedFifoAdmit:
    """Classic bounded queue: arrivals beyond the cap are rejected at
    the door (newest dropped first)."""

    name = "bounded-fifo"

    def admit(self, q: FunctionQueue, arriving: float,
              now: float) -> Tuple[float, float]:
        """Returns (accepted, dropped)."""
        if arriving <= _EPS:
            return 0.0, 0.0
        accepted = min(arriving, max(q.cap - q.depth, 0.0))
        dropped = arriving - accepted
        q.push(now, accepted)
        if dropped > _EPS:
            # account the rejection on the queue's conservation ledger
            q.arrived += dropped
            q.dropped += dropped
        else:
            dropped = 0.0
        return accepted, dropped


class ShedOldestAdmit:
    """Bounded staleness: new traffic always enters; overflow sheds the
    oldest backlog (it would have blown its delay budget anyway)."""

    name = "shed-oldest"

    def admit(self, q: FunctionQueue, arriving: float,
              now: float) -> Tuple[float, float]:
        if arriving <= _EPS:
            return 0.0, 0.0
        q.push(now, arriving)
        dropped = 0.0
        if q.depth > q.cap:
            dropped = q.drop_oldest(q.depth - q.cap)
        return arriving, dropped


# ---------------------------------------------------------------------------
# Release stages (how fast the backlog drains into service)
# ---------------------------------------------------------------------------


class GreedyQueueRelease:
    """Drain up to the fleet's full current service rate."""

    name = "greedy"

    def release(self, q: FunctionQueue, capacity_rps: float,
                now: float) -> Released:
        if capacity_rps <= _EPS or q.depth <= _EPS:
            return []
        return q.pop(capacity_rps)


class PacedQueueRelease:
    """Drain to at most ``pace`` of the service rate, keeping headroom
    so a deep backlog cannot re-saturate freshly placed instances the
    tick they appear."""

    name = "paced"

    def __init__(self, pace: float = 0.9):
        self.pace = pace

    def release(self, q: FunctionQueue, capacity_rps: float,
                now: float) -> Released:
        if capacity_rps <= _EPS or q.depth <= _EPS:
            return []
        return q.pop(capacity_rps * self.pace)
