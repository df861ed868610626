"""Commit-time sub-block planning: which partitions split, and where.

All pure functions of (sizes, payload bytes, conf) — the writer calls
:func:`plan_commit_splits` once per commit and hands the resulting span
plan to the resolver, which registers each span as its own map-output
entry.  Splits land ONLY at serializer frame boundaries
(``Serializer.frame_spans``, a header-only walk), so every sub-block is
an independently-deserializable, independently-sorted contiguous range
of the already-committed segment: no bytes move, and the reader's
k-way merge can treat each one as an ordinary sorted run.

Table encoding (zero wire change — the publish plane just sees a wider
table): a split partition's primary entry becomes a MARKER
``BlockLocation(address=aux_start_index, length=num_subs,
mkey=SPLIT_MKEY)`` and the real sub-block locations occupy aux table
rows ``[aux_start_index, aux_start_index + num_subs)`` past the logical
partition count.  mkey 0 is reserved-invalid and real mkeys are
non-negative, so ``SPLIT_MKEY = -2`` can never collide with a
registered memory region; ``length=num_subs >= 2`` keeps markers
distinct from empty entries (``length == 0``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.skew.sketch import median
from sparkrdma_tpu_torch.utils.types import BlockLocation

# Marker mkey for a split partition's primary table entry.  Never a
# valid memory-region key (those are >= 0; 0 itself means "empty").
SPLIT_MKEY = -2

Span = Tuple[int, int]  # (relative offset, length) within the partition


def is_split_marker(loc: BlockLocation) -> bool:
    """True when a map-output entry is a sub-block marker rather than a
    fetchable block: address = first aux row, length = sub count."""
    return loc.mkey == SPLIT_MKEY


def make_marker(aux_start: int, num_subs: int) -> BlockLocation:
    return BlockLocation(address=aux_start, length=num_subs,
                         mkey=SPLIT_MKEY)


def split_targets(
    sizes: Sequence[int], threshold: int, factor: float, max_subs: int,
) -> List[int]:
    """Partition ids classified hot at commit: at or over the absolute
    ``threshold`` bytes, or at or over ``factor`` x the median
    non-empty partition size (relative detection disabled when
    ``factor <= 0``)."""
    if max_subs < 2 or threshold <= 0:
        return []
    med = median([n for n in sizes if n > 0])
    rel_cutoff = int(factor * med) if (factor > 0 and med) else None
    return [
        pid for pid, n in enumerate(sizes)
        if n > 0 and (
            n >= threshold
            or (rel_cutoff is not None and n >= rel_cutoff)
        )
    ]


def sub_spans(
    frame_spans: Sequence[Tuple[int, int]], target: int, max_subs: int,
) -> Optional[List[Span]]:
    """Group a partition's serializer frames into contiguous sub-block
    spans of at most ``target`` bytes each (a frame larger than the
    target gets a span of its own — frames are indivisible).  Greedy
    left-to-right packing; once ``max_subs - 1`` spans are cut, the
    final span absorbs the remainder.  Returns None when the payload
    cannot yield at least two sub-blocks (single frame, or everything
    fits one target)."""
    if len(frame_spans) < 2 or max_subs < 2 or target <= 0:
        return None
    out: List[Span] = []
    run_start = frame_spans[0][0]
    run_end = run_start
    for (a, b) in frame_spans:
        if (
            run_end > run_start
            and run_end - run_start + (b - a) > target
            and len(out) < max_subs - 1
        ):
            out.append((run_start, run_end - run_start))
            run_start = a
        run_end = b
    out.append((run_start, run_end - run_start))
    if len(out) < 2:
        return None
    return out


def plan_commit_splits(
    serializer, payloads: Dict[int, object], sizes: Sequence[int], conf,
) -> Dict[int, List[Span]]:
    """The writer's one-call commit hook: classify hot partitions from
    exact committed ``sizes``, frame-walk only those payloads, and
    return ``{partition_id: [(rel_off, rel_len), ...]}`` for every
    partition that actually yields >= 2 sub-blocks.

    ``payloads`` maps partition id to the final contiguous bytes/view
    being committed; partitions absent from it (e.g. chunked or
    file-backed payloads) are never split.  The sub-block target is
    ``skewSplitThreshold`` clamped to half the partition, so a
    relative-detected partition below the absolute cutoff still splits
    in two.  Unparseable payloads are skipped, never fatal — an unsplit
    hot partition is correct, just slow."""
    threshold = conf.skew_split_threshold
    max_subs = conf.skew_max_sub_blocks
    targets = split_targets(
        sizes, threshold, conf.skew_split_factor, max_subs,
    )
    plan: Dict[int, List[Span]] = {}
    for pid in targets:
        payload = payloads.get(pid)
        if payload is None:
            continue
        try:
            frames = serializer.frame_spans(payload)
        except (ValueError, IndexError):
            continue
        target = min(threshold, -(-sizes[pid] // 2))
        spans = sub_spans(frames, target, max_subs)
        if spans is not None:
            plan[pid] = spans
    return plan


def collapse_sub_locations(subs: Sequence[BlockLocation]) -> BlockLocation:
    """Collapse a marker's sub-block entries back into one whole-span
    location for LOCAL reads: sub-spans tile the partition payload
    contiguously within one segment, so the original block is simply
    (first sub's address, total length).  Remote readers never need
    this — they fetch sub-blocks individually on purpose."""
    total = sum(s.length for s in subs)
    return BlockLocation(address=subs[0].address, length=total,
                         mkey=subs[0].mkey)
