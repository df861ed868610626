"""Skew-adaptive partitioning: hot-partition detection at write time,
sub-block splitting at serializer frame boundaries, and balanced fetch.

Every bench in the suite shuffles uniform keys, but real traffic is
Zipfian — one hot partition serializes the whole reduce side no matter
how fast the fabric is .  The striped transport,
delta-synced block locations and the k-way merge already
provide every mechanism a mitigation layer needs; this package is the
subsystem that DETECTS skew and DRIVES them — the same "mediate above
the transport, don't change the wire" posture as *RDMAvisor*
(PAPERS.md), with *RDMAbox*'s hot/cold load-balancing instincts:

- :mod:`~sparkrdma_tpu_torch.skew.registry` — the process-global
  :class:`SkewRegistry` (the qos/metrics registry shape, flipped by
  conf ``spark.shuffle.tpu.skewEnabled`` before the manager builds its
  node): enablement plus per-shuffle detection/split accounting for
  ``metrics_report.py``'s skew table.
- :mod:`~sparkrdma_tpu_torch.skew.sketch` — the writer's streaming
  per-partition size/record sketch (cheap counters on the existing
  write path) and a Misra-Gries heavy-hitter sketch sampling keys on
  aggregating shuffles (hot-KEY attribution in telemetry).
- :mod:`~sparkrdma_tpu_torch.skew.splitter` — commit-time classification
  (``skewSplitThreshold`` absolute bytes, or ``skewSplitFactor`` x the
  map output's median non-empty partition) and the frame-boundary
  split: ``frame_spans`` walks serializer headers only, so a
  hot partition's payload splits into N independently-deserializable,
  independently-SORTED sub-ranges of the committed segment — zero data
  movement, zero wire-format change.

Sub-blocks register as distinct entries in the map-output table past
the logical partition space (the split partition's own entry becomes a
marker naming its sub-entry range), ship over the epoch/delta-sync
publish plane unchanged, and ride the reader's stripe/lane machinery as
ordinary blocks — interleaved across the fetch plan so hot-partition
bytes spread over lanes and serve-pool credits instead of queueing
behind one giant read.  The k-way merge treats each sub-block as one
more sorted run, in sub-index order, so output is bit-exact with the
unsplit path by the stable-merge argument.  ``skewEnabled=false``
is an identity no-op (the qosEnabled=false precedent).
"""

from sparkrdma_tpu_torch.skew.registry import SkewRegistry, get_skew
from sparkrdma_tpu_torch.skew.sketch import HeavyHitterSketch, PartitionSketch
from sparkrdma_tpu_torch.skew.splitter import (
    SPLIT_MKEY,
    collapse_sub_locations,
    is_split_marker,
    plan_commit_splits,
    split_targets,
    sub_spans,
)

__all__ = [
    "SPLIT_MKEY",
    "HeavyHitterSketch",
    "PartitionSketch",
    "SkewRegistry",
    "collapse_sub_locations",
    "get_skew",
    "is_split_marker",
    "plan_commit_splits",
    "split_targets",
    "sub_spans",
]
