"""Process-global skew registry (the skew control plane).

One :class:`SkewRegistry` per process (the metrics-registry /
tenant-registry shape): managers flip ``enabled`` from conf
``skewEnabled`` before building their node, writers consult it at
commit, and it accumulates per-shuffle detection/split accounting for
``tools/metrics_report.py``'s skew table and the tests.  All state is
bookkeeping — the split decisions themselves live in
:mod:`~sparkrdma_tpu_torch.skew.splitter` (pure functions of sizes + conf),
so disabled runs never take this module's lock on a hot path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.metrics import counter, histogram


class SkewRegistry:
    """Enablement + per-shuffle split accounting."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()  # lock-order: 93
        # shuffle_id -> accumulated split stats across its map tasks
        self._shuffles: Dict[int, Dict[str, float]] = {}  # guarded-by: _lock

    def record_commit(
        self, shuffle_id: int, sizes: List[int],
        split_plan: Optional[Dict[int, list]] = None,
        hot_key_share: float = 0.0,
        records: Optional[List[int]] = None,
    ) -> Dict[str, float]:
        """Fold one map task's commit into the shuffle's skew stats:
        partition-size distribution (the detection histogram), split
        decisions, and the aggregating writer's hot-key share.  Returns
        the per-task snapshot so the caller can ship it as telemetry."""
        nonzero = [n for n in sizes if n > 0]
        h = histogram("skew_partition_bytes")
        for n in nonzero:
            h.observe(n)
        split_plan = split_plan or {}
        split_bytes = sum(
            sizes[pid] for pid in split_plan if pid < len(sizes)
        )
        sub_blocks = sum(len(v) for v in split_plan.values())
        snap: Dict[str, float] = {
            "partitions": len(sizes),
            "partitions_nonzero": len(nonzero),
            "partition_bytes_sum": sum(nonzero),
            "max_partition_bytes": max(nonzero) if nonzero else 0,
            "partitions_split": len(split_plan),
            "sub_blocks": sub_blocks,
            "split_bytes": split_bytes,
            "max_hot_key_share_pct": round(hot_key_share * 100, 2),
        }
        if records is not None:
            snap["max_partition_records"] = max(records) if records else 0
        if split_plan:
            counter("skew_partitions_split_total").inc(len(split_plan))
            counter("skew_sub_blocks_total").inc(sub_blocks)
            counter("skew_split_bytes_total").inc(split_bytes)
            hf = histogram("skew_split_fanout")
            for subs in split_plan.values():
                hf.observe(len(subs))
        with self._lock:
            d = self._shuffles.setdefault(shuffle_id, {})
            for k, v in snap.items():
                if k.startswith("max_"):
                    d[k] = max(d.get(k, 0), v)
                else:
                    d[k] = d.get(k, 0) + v
        return snap

    def shuffle_stats(self, shuffle_id: int) -> Dict[str, float]:
        with self._lock:
            return dict(self._shuffles.get(shuffle_id, {}))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "shuffles": {
                    sid: dict(d) for sid, d in self._shuffles.items()
                },
            }

    def release_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)

    def reset(self) -> None:
        """Drop all accounting (tests)."""
        with self._lock:
            self._shuffles.clear()


# the process-global registry; managers enable it from conf skewEnabled
GLOBAL_SKEW = SkewRegistry(enabled=False)


def get_skew() -> SkewRegistry:
    return GLOBAL_SKEW
