"""Bounded metric collection for cluster-scale runs.

512-node full-trace simulations emit one scheduling-latency sample per
decision and one density sample per tick; unbounded Python lists grow
into hundreds of MB over long traces.  ``Reservoir`` keeps a fixed-size
uniform sample (Vitter's Algorithm R) plus *exact* running aggregates
(count / sum / min / max), so means are always exact and the p50/p99
accessors are exact whenever fewer than ``cap`` values were recorded
(every tier-1 test and the quick benchmarks) and an unbiased estimate
beyond that.

The sampling RNG is seeded per-reservoir, so two simulations that record
the same value sequence retain the same indices — the engine-vs-legacy
A/B parity harness compares ``density_series`` elementwise and stays
valid under bounding.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np


class Reservoir:
    """Fixed-capacity uniform sample with exact running aggregates.

    Supports enough of the list protocol (append / extend / len / iter /
    indexing / numpy conversion) to be a drop-in for the metric lists it
    replaces.  While ``count <= cap`` the retained buffer IS the full
    history, in insertion order; past that point Algorithm R overwrites
    arbitrary slots, so ordered access (``r[-1]``, slices) stops meaning
    "most recent" — use it only on short runs or for order-free reads
    (the aggregate/quantile accessors are always valid).
    """

    __slots__ = ("cap", "count", "total", "_min", "_max", "_items", "_rng")

    def __init__(self, cap: int = 512, seed: int = 0,
                 values: Optional[Iterable[float]] = None):
        if cap <= 0:
            raise ValueError("Reservoir capacity must be positive")
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._items: List[float] = []
        self._rng = np.random.default_rng(seed)
        if values is not None:
            self.extend(values)

    # -- recording --------------------------------------------------------

    def append(self, x: float):
        x = float(x)
        self.count += 1
        self.total += x
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x
        if len(self._items) < self.cap:
            self._items.append(x)
        else:
            # Algorithm R: keep each of the `count` values with equal
            # probability cap/count
            j = int(self._rng.integers(self.count))
            if j < self.cap:
                self._items[j] = x

    def extend(self, xs: Iterable[float]):
        for x in xs:
            self.append(x)

    # -- exact aggregates -------------------------------------------------

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    # -- quantiles (exact until sampling kicks in) ------------------------

    def percentile(self, q: float) -> float:
        """The q-th percentile of the recorded stream.

        While ``count <= cap`` the retained buffer is the complete
        history, so this is the *exact* ``np.percentile`` of every value
        ever appended (the regime all tier-1 tests and the quick
        benchmarks run in).  Once Algorithm R starts sampling
        (``count > cap``) it becomes an unbiased estimate computed over
        the uniform ``cap``-sized sample."""
        if not self._items:
            return 0.0
        return float(np.percentile(np.asarray(self._items, np.float64), q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    # -- histogram export (the telemetry layer's Histogram metric) --------

    def histogram(self, bins: int = 10,
                  lo: Optional[float] = None,
                  hi: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """``(counts, edges)`` over ``bins`` equal-width buckets.

        Bounds default to the *exact* running min/max (so the histogram
        always covers the full recorded range, even values the sample
        dropped).  While ``count <= cap`` the counts are exact integers;
        beyond that each retained value stands for ``count / cap``
        stream values (fractional counts).  Under the default bounds the
        sum invariant ``counts.sum() == count`` holds in both regimes;
        explicit narrower ``lo``/``hi`` exclude out-of-range values from
        the sum, exactly like ``np.histogram``.  Empty reservoir ->
        zero counts over [0, 1]."""
        if bins <= 0:
            raise ValueError("histogram needs a positive bin count")
        if not self._items:
            return (np.zeros(bins, np.float64),
                    np.linspace(0.0, 1.0, bins + 1))
        lo = self._min if lo is None else float(lo)
        hi = self._max if hi is None else float(hi)
        if hi <= lo:
            hi = lo + 1.0
        counts, edges = np.histogram(
            np.asarray(self._items, np.float64), bins=bins,
            range=(lo, hi))
        counts = counts.astype(np.float64)
        if self.count != len(self._items):
            counts *= self.count / len(self._items)
        return counts, edges

    # -- list / numpy protocol -------------------------------------------

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[float]:
        return iter(self._items)

    def __getitem__(self, idx):
        return self._items[idx]

    def __bool__(self) -> bool:
        return self.count > 0

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self._items, dtype=dtype or np.float64)
        return arr.copy() if copy else arr

    def __repr__(self) -> str:
        return (f"Reservoir(cap={self.cap}, count={self.count}, "
                f"mean={self.mean:.4g})")
