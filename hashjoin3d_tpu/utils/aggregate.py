"""Streaming min/max/sum/count aggregate, mirroring ``util/aggregate.hh:12-103``.

Used by the hash-table statistics (``ht_statistics.hh``) exactly as in the
reference: collision-chain-length aggregates over all / non-empty buckets.
Besides the per-value ``step`` protocol there is a vectorized
``Aggregate.from_array`` that folds a whole numpy column at once (the
vectorized way to aggregate a bucket-occupancy histogram).
"""

from __future__ import annotations

import math

import numpy as np

_INT_MAX = (1 << 63) - 1


class Aggregate:
    """min/max/sum/sumsq/count with derived stats (avg, middle, qmiddle, ...)."""

    def __init__(self):
        self.init()

    def init(self):
        self._min = _INT_MAX
        self._max = 0
        self._sum = 0
        self._sumsq = 0
        self._count = 0

    def step(self, x):
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x
        self._sum += x
        self._sumsq += x * x
        self._count += 1

    def fin(self):
        pass

    @classmethod
    def from_array(cls, a: np.ndarray) -> "Aggregate":
        agg = cls()
        if a.size:
            agg._min = int(a.min())
            agg._max = int(a.max())
            agg._sum = int(a.sum(dtype=np.int64))
            agg._sumsq = int((a.astype(np.int64) ** 2).sum(dtype=np.int64))
            agg._count = int(a.size)
        return agg

    def count(self):
        return self._count

    def min(self):
        return self._min

    def max(self):
        return self._max

    def sum(self):
        return self._sum

    def sumsq(self):
        return self._sumsq

    def avg(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def span(self):
        return self._max - self._min

    def middle(self) -> float:
        return (self._min + self._max) / 2.0

    def qmiddle(self) -> float:
        if self._min == 0:
            return math.sqrt(self._max)
        return math.sqrt(self._min * self._max)

    def q_error_of_qmiddle(self) -> float:
        return self._max / self.qmiddle()

    def q_error_of_avg(self) -> float:
        return max(self.avg() / self._min, self._max / self.avg())

    def q_spread(self) -> float:
        return self._max / self._min

    def __repr__(self):
        return (f"Aggregate(min={self._min}, max={self._max}, "
                f"avg={self.avg():.6g}, count={self._count})")
