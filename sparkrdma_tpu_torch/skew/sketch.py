"""Streaming write-side sketches: partition balance and hot keys.

Both sketches live on the writer's record path, so the budget is a few
integer ops per record (or per ``skewSampleStride`` records for the key
sketch).  Neither allocates proportionally to the data: the partition
sketch is two flat arrays indexed by partition id, and the heavy-hitter
sketch is classic Misra-Gries — ``k`` counters guarantee any key with
frequency share above ``1/(k+1)`` of the sampled stream survives, which
is exactly the "is one KEY responsible for this hot partition?"
question the telemetry wants answered.  Sizes are not sketched here:
the writer already knows exact per-partition byte counts at commit
(they become block lengths), so only record counts and key identity
need streaming treatment.
"""

from __future__ import annotations

from array import array
from typing import Any, Dict, List, Optional, Tuple


class PartitionSketch:
    """Per-partition record counters for one map task (single-threaded
    writer path — no lock)."""

    __slots__ = ("num_partitions", "_records", "total_records")

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        self._records = array("q", [0]) * num_partitions
        self.total_records = 0

    def add(self, partition_id: int, n: int = 1) -> None:
        self._records[partition_id] += n
        self.total_records += n

    def records(self) -> List[int]:
        return list(self._records)

    def max_records(self) -> int:
        return max(self._records) if self.num_partitions else 0


class HeavyHitterSketch:
    """Misra-Gries top-k frequency sketch over (sampled) keys.

    ``add`` is O(1) amortised; the decrement sweep fires only when all
    ``k`` slots are full and an unseen key arrives.  ``top`` reports
    estimated shares of the SAMPLED stream — with a uniform
    ``skewSampleStride`` the share is an unbiased estimate of the true
    key share, and the classic error bound (count undercounts by at
    most ``sampled/(k+1)``) keeps the reported share within ``1/(k+1)``
    of truth.
    """

    __slots__ = ("capacity", "_counts", "sampled")

    def __init__(self, capacity: int = 32):
        self.capacity = max(1, capacity)
        self._counts: Dict[Any, int] = {}
        self.sampled = 0

    def add(self, key: Any, weight: int = 1) -> None:
        self.sampled += weight
        c = self._counts
        if key in c:
            c[key] += weight
            return
        if len(c) < self.capacity:
            c[key] = weight
            return
        # decrement-all: evict keys whose counter hits zero
        dec = min(weight, min(c.values()))
        for k in list(c):
            c[k] -= dec
            if c[k] <= 0:
                del c[k]
        if weight > dec:
            c[key] = weight - dec

    def top(self, n: int = 5) -> List[Tuple[Any, float]]:
        """The ``n`` heaviest keys as (key, estimated share of sampled
        stream), heaviest first."""
        if not self.sampled:
            return []
        items = sorted(self._counts.items(), key=lambda kv: -kv[1])[:n]
        return [(k, v / self.sampled) for k, v in items]

    def top_share(self) -> float:
        """Estimated share of the single hottest key (0.0 if nothing
        sampled)."""
        t = self.top(1)
        return t[0][1] if t else 0.0


def median(values: List[int]) -> Optional[int]:
    """Median of a small list (lower of the two middles for even
    length — a conservative skew denominator). None on empty."""
    if not values:
        return None
    s = sorted(values)
    return s[(len(s) - 1) // 2]
