"""Serve a trained policy as a pipeline ``NodeScorer`` stage.

``LearnedScorer`` implements the batched scorer protocol
(``score_batch``): one MLP forward (``train.forward``) over the whole
surviving candidate set per pass, on the device the scorer was given
(the card unless told otherwise), instead of O(candidates) Python
``score`` calls.

Hot-swap contract: ``swap(policy, epoch)`` atomically installs new
weights tagged with the serving epoch they were trained for; the
platform wires a PredictionService retrain listener that re-loads /
re-tags the scorer *inside* the same synchronous callback that bumps
the service epoch, so by the time any post-retrain decision runs the
scorer already matches.  ``ScorerStats.stale_serves`` counts scored
batches whose policy epoch lagged the expected epoch — the analogue of
the service's ``stale_epoch_hits``, and like it, it must stay 0 (the
policy tests assert it across a live retrain).

Until a policy is installed the scorer falls back to a jiagu-like
heuristic (warm nodes first, most-packed first), so the ``"learned"``
stack is runnable straight from a config dict — the platform smoke
builds it alongside the other registered schedulers with no artifact
on disk.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.cluster import Node
from ..core.harvesting import (HarvestBinder, HarvestScaleOutBinder,
                               HarvestingScheduler, QosCooldownFilter)
from ..core.pipeline import (CandidatePass, CapacityTableGate,
                             DecisionContext, MemRoomFilter,
                             SchedulingPipeline, candidate_feature_row)
from ..core.predictor import resolve_device
from ..core.scheduler import register_scheduler
from .train import forward


class ScorerStats:
    """Serving counters (reset on construction, never on swap)."""

    __slots__ = ("batches", "scored_nodes", "swaps", "stale_serves")

    def __init__(self):
        self.batches = 0        # score_batch invocations
        self.scored_nodes = 0   # candidate rows scored
        self.swaps = 0          # policies installed
        self.stale_serves = 0   # batches served at a lagging epoch

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


class LearnedScorer:
    """Batched ``NodeScorer`` over a swappable trained policy, served
    on ``device`` (None: the card)."""

    name = "learned"

    def __init__(self, policy: Optional[Dict[str, np.ndarray]] = None,
                 epoch: int = 0, device=None):
        self.policy: Optional[Dict[str, np.ndarray]] = None
        self.epoch = -1
        #: the serving epoch the world is at (service forest epoch);
        #: kept in lockstep by the platform's retrain listener
        self.expected_epoch = epoch
        self.device = device
        self.stats = ScorerStats()
        #: the installed policy as float32 tensors on the device
        self._weights: Optional[Dict[str, torch.Tensor]] = None
        if policy is not None:
            self.swap(policy, epoch)

    # -- hot swap ---------------------------------------------------------

    def swap(self, policy: Dict[str, np.ndarray], epoch: int) -> None:
        """Atomically install ``policy`` as the scorer for ``epoch``."""
        dev = resolve_device(self.device)
        weights = {k: torch.from_numpy(
            np.ascontiguousarray(v, np.float32)).to(dev)
            for k, v in policy.items()}
        # single-assignment order matters: the weights must be on the
        # device before the epoch tag says they serve
        self._weights = weights
        self.policy = policy
        self.epoch = epoch
        self.expected_epoch = epoch
        self.stats.swaps += 1

    def expect(self, epoch: int) -> None:
        """Declare the epoch serving must match (the retrain listener
        calls ``swap`` instead; this exists so tests can simulate a
        missed swap and watch ``stale_serves`` fire)."""
        self.expected_epoch = epoch

    # -- scoring ----------------------------------------------------------

    def score_batch(self, ctx: DecisionContext,
                    nodes: List[Node]) -> List[float]:
        self.stats.batches += 1
        self.stats.scored_nodes += len(nodes)
        if self.policy is not None and self.epoch != self.expected_epoch:
            self.stats.stale_serves += 1
        if not nodes:
            return []
        if self._weights is None:
            # no trained weights yet: jiagu-like heuristic (warm nodes
            # first, most-packed first) keeps the stack runnable from a
            # bare config dict
            fn = ctx.fn
            return [
                (1e6 if fn in n.funcs else 0.0)
                + 1e3 * (n.funcs[fn].n_sat if fn in n.funcs else 0.0)
                + n.n_instances()
                for n in nodes]
        rows = np.asarray(
            [candidate_feature_row(ctx, n) for n in nodes],
            dtype=np.float32)
        return [float(s) for s in self.scores(rows)]

    def scores(self, rows: np.ndarray) -> np.ndarray:
        """One forward over a batch of candidate rows ([N, F] float32)
        on the policy's device.  Batches run at their own length: the
        reference pads them to a power of two to bound its jit
        recompilations, and eager PyTorch compiles nothing per shape."""
        x = torch.from_numpy(rows).to(self._weights["w1"].device)
        return forward(self._weights, x).cpu().numpy()

    def score(self, ctx: DecisionContext, node: Node) -> float:
        return self.score_batch(ctx, [node])[0]


class LearnedScheduler(HarvestingScheduler):
    """The ``"learned"`` stack: the capacity-table ``PreDecision`` gate
    and the harvesting binders/release machinery, with the hand-tuned
    candidate ordering replaced by the trained scorer.

    The split of responsibilities is deliberate: placement *safety*
    stays with existing stages — the binder's critical-path capacity
    solve bounds every placement at ``harvest_headroom`` of the
    predicted capacity, and QoS-margin breaches release instances and
    put nodes in cooldown — while the policy only chooses *among*
    feasible candidates.  That is the same decoupling the paper draws
    between prediction and decision, and it is what lets a learned
    ordering ship without being able to regress QoS below the
    no-overcommit baseline (the ``BENCH_policy.json`` hard gate)."""

    name = "learned"

    def __init__(self, *args, **kw):
        self.learned_scorer = LearnedScorer()
        super().__init__(*args, **kw)

    def build_pipeline(self) -> SchedulingPipeline:
        cooldown = QosCooldownFilter()
        return SchedulingPipeline(
            pre_decision=CapacityTableGate(filters=(cooldown,)),
            passes=[CandidatePass(
                "learned", HarvestBinder(),
                filters=(cooldown, MemRoomFilter()),
                scorer=self.learned_scorer)],
            scale_out=HarvestScaleOutBinder())


register_scheduler(
    "learned",
    lambda ctx: LearnedScheduler(
        ctx.cluster, ctx.store, ctx.qos, ctx.predictor, m_max=ctx.m_max,
        harvest_headroom=ctx.harvest_headroom,
        qos_release_cooldown_s=ctx.qos_release_cooldown_s),
    needs_predictor=True, dual_staged_default=True)


__all__ = ["ScorerStats", "LearnedScorer", "LearnedScheduler"]
