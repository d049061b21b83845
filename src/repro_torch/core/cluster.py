"""Cluster state: nodes, per-node function instance counts, capacity tables.

Counts, not instance objects: the paper's operations (deploy, release,
logical cold start, migrate, evict) are all count transitions on a
(node, function) pair; instance identity never matters.

Clusters maintain incremental aggregates over those transitions: every
``Node`` mutation notifies its owning cluster (standalone nodes have no
owner and skip the bookkeeping), which keeps per-function sat/cached
totals, a function -> hosting-node index, per-node instance totals and
a dirty set of maybe-empty nodes in sync.  ``sat_count`` /
``cached_count`` / ``total_instances`` are O(1), ``nodes_with`` walks
only hosting nodes, and ``reap_empty`` touches only nodes whose count
actually hit zero — the foundation of the event-driven simulation core
(`core/cells.py`), where idle nodes cost nothing between load changes.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .interference import NodeResources
from .profiles import FunctionSpec


@dataclass
class FuncState:
    n_sat: int = 0
    n_cached: int = 0
    # timestamps for keep-alive bookkeeping (newest-first not needed; the
    # autoscaler tracks per-function timers cluster-wide)

    @property
    def total(self) -> int:
        return self.n_sat + self.n_cached


@dataclass
class CapEntry:
    capacity: int          # max saturated instances of fn on this node
    fresh: bool = True     # False once a *different* function arrived


class Node:
    _ids = itertools.count()

    def __init__(self, res: NodeResources):
        self.id = next(Node._ids)
        self.res = res
        self.funcs: Dict[str, FuncState] = {}
        self.table: Dict[str, CapEntry] = {}
        #: per-function cpu-reservation share in (0, 1] set by the
        #: vertical resizer (``repro.admission``); absent == 1.0 (full
        #: request).  Only ``cpu_requested`` reads it, and entries are
        #: dropped with the function's last instance, so an empty dict
        #: keeps the pre-admission cluster bit-identical.
        self.shares: Dict[str, float] = {}
        self.update_pending_until: float = -1.0
        #: owning Cluster, set by ``Cluster.add_node`` — standalone nodes
        #: (benchmark fixtures, capacity-table unit tests) stay None and
        #: skip aggregate bookkeeping entirely
        self.owner: Optional["Cluster"] = None

    # -- state access ----------------------------------------------------

    def state(self, fn: str) -> FuncState:
        return self.funcs.setdefault(fn, FuncState())

    def colocation(self, specs: Dict[str, FunctionSpec]
                   ) -> Dict[str, Tuple[FunctionSpec, float, float]]:
        return {n: (specs[n], s.n_sat, s.n_cached)
                for n, s in self.funcs.items() if s.total > 0}

    def n_instances(self) -> int:
        return sum(s.total for s in self.funcs.values())

    def mem_used(self, specs: Dict[str, FunctionSpec]) -> float:
        return sum(specs[n].mem_req * s.total for n, s in self.funcs.items())

    def cpu_requested(self, specs: Dict[str, FunctionSpec]) -> float:
        if not self.shares:
            return sum(specs[n].cpu_req * s.total
                       for n, s in self.funcs.items())
        return sum(specs[n].cpu_req * self.shares.get(n, 1.0) * s.total
                   for n, s in self.funcs.items())

    def is_empty(self) -> bool:
        return self.n_instances() == 0

    def _notify(self, fn: str, d_sat: int, d_cached: int):
        if self.owner is not None and (d_sat or d_cached):
            self.owner._on_change(self, fn, d_sat, d_cached)

    # -- mutations (keep table freshness in sync) -------------------------

    def deploy(self, fn: str, k: int = 1):
        self.state(fn).n_sat += k
        for g, e in self.table.items():
            if g != fn:
                e.fresh = False  # their capacity assumed the old count of fn
        self._notify(fn, k, 0)

    def release(self, fn: str, k: int = 1):
        s = self.state(fn)
        k = min(k, s.n_sat)
        s.n_sat -= k
        s.n_cached += k
        # capacities can only have grown -> stale values remain safe
        self._notify(fn, -k, k)
        return k

    def logical_start(self, fn: str, k: int = 1) -> int:
        s = self.state(fn)
        k = min(k, s.n_cached)
        s.n_cached -= k
        s.n_sat += k
        for g, e in self.table.items():
            if g != fn:
                e.fresh = False
        self._notify(fn, k, -k)
        return k

    def add_cached(self, fn: str, k: int = 1):
        """Receive k warm (cached) instances — the migration landing op."""
        self.state(fn).n_cached += k
        self._notify(fn, 0, k)

    def evict_cached(self, fn: str, k: int = 1) -> int:
        s = self.state(fn)
        k = min(k, s.n_cached)
        s.n_cached -= k
        if s.total == 0:
            self.funcs.pop(fn, None)
            self.table.pop(fn, None)
            self.shares.pop(fn, None)
        self._notify(fn, 0, -k)
        return k

    def evict_sat(self, fn: str, k: int = 1) -> int:
        s = self.state(fn)
        k = min(k, s.n_sat)
        s.n_sat -= k
        if s.total == 0:
            self.funcs.pop(fn, None)
            self.table.pop(fn, None)
            self.shares.pop(fn, None)
        self._notify(fn, -k, 0)
        return k


class Cluster:
    """Elastic node pool (paper §6: new server requested when no node fits;
    empty servers are returned).

    ``res_pool`` makes the fleet heterogeneous: newly requested servers
    cycle deterministically through the pool's node shapes (the scenario
    subsystem builds weighted pools from its ``NodeClass`` mix), so the
    same scenario always produces the same node-size sequence."""

    def __init__(self, specs: Dict[str, FunctionSpec],
                 res: Optional[NodeResources] = None,
                 max_nodes: int = 1000,
                 res_pool: Optional[Sequence[NodeResources]] = None):
        if res is not None and res_pool:
            raise ValueError("pass either res (homogeneous fleet) or "
                             "res_pool (heterogeneous mix), not both")
        self.specs = specs
        self.res_pool: Tuple[NodeResources, ...] = \
            tuple(res_pool) if res_pool else ()
        self.res = res or (self.res_pool[0] if self.res_pool
                           else NodeResources())
        self.nodes: Dict[int, Node] = {}
        self.max_nodes = max_nodes
        self.nodes_added = 0
        # -- incremental aggregates, maintained by Node._notify ----------
        self._sat: Dict[str, int] = {}          # fn -> saturated total
        self._cached: Dict[str, int] = {}       # fn -> cached total
        self._hosting: Dict[str, Set[int]] = {}  # fn -> ids with total > 0
        self._node_total: Dict[int, int] = {}   # id -> instance total
        self._node_cached: Dict[int, int] = {}  # id -> cached total (>0 only)
        self._maybe_empty: Set[int] = set()     # ids whose total hit 0
        self._n_instances = 0

    def add_node(self) -> Node:
        res = self.res_pool[self.nodes_added % len(self.res_pool)] \
            if self.res_pool else self.res
        node = Node(res)
        node.owner = self
        self.nodes[node.id] = node
        self.nodes_added += 1
        self._node_total[node.id] = 0
        self._maybe_empty.add(node.id)  # empty until something deploys
        return node

    def _on_change(self, node: Node, fn: str, d_sat: int, d_cached: int):
        """Fold one (node, fn) count transition into the aggregates."""
        self._sat[fn] = self._sat.get(fn, 0) + d_sat
        self._cached[fn] = self._cached.get(fn, 0) + d_cached
        self._n_instances += d_sat + d_cached
        st = node.funcs.get(fn)
        hosting = self._hosting.setdefault(fn, set())
        if st is not None and st.total > 0:
            hosting.add(node.id)
        else:
            hosting.discard(node.id)
        total = self._node_total.get(node.id, 0) + d_sat + d_cached
        self._node_total[node.id] = total
        if total == 0:
            self._maybe_empty.add(node.id)
        cached = self._node_cached.get(node.id, 0) + d_cached
        if cached:
            self._node_cached[node.id] = cached
        else:
            self._node_cached.pop(node.id, None)

    def reap_empty(self) -> int:
        if not self._maybe_empty:
            return 0
        dead = [nid for nid in sorted(self._maybe_empty)
                if nid in self.nodes and self._node_total.get(nid, 0) == 0]
        for nid in dead:
            node = self.nodes.pop(nid)
            node.owner = None
            self._node_total.pop(nid, None)
            self._node_cached.pop(nid, None)
        self._maybe_empty.clear()
        return len(dead)

    def nodes_with(self, fn: str) -> Iterator[Node]:
        """Nodes hosting fn (total > 0), ascending node id — the same
        order the legacy full scan produced (dict insertion order is
        monotonic in id)."""
        ids = self._hosting.get(fn)
        if not ids:
            return
        for nid in sorted(ids):
            node = self.nodes.get(nid)
            if node is not None:
                yield node

    def nodes_with_cached(self) -> List[Node]:
        """Nodes holding any cached instances, ascending id — the only
        possible migration sources, so ``Autoscaler._migrate`` scans
        just these instead of the whole fleet."""
        return [self.nodes[nid] for nid in sorted(self._node_cached)
                if nid in self.nodes]

    def hosting_ids(self, fn: str) -> Set[int]:
        """Ids of nodes hosting fn (live view — copy before mutating)."""
        return self._hosting.get(fn) or set()

    def total_instances(self) -> int:
        return self._n_instances

    def sat_count(self, fn: str) -> int:
        return self._sat.get(fn, 0)

    def cached_count(self, fn: str) -> int:
        return self._cached.get(fn, 0)

    def mem_headroom(self, node: Node, fn: str) -> int:
        """How many more instances of fn fit in (non-overcommitted) memory."""
        spec = self.specs[fn]
        free = node.res.mem_mb - node.mem_used(self.specs)
        return max(0, int(free // spec.mem_req))
