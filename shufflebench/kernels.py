"""Device time by kernel name: which kernels of a trace belong to
which layer.  The name patterns are frozen here, lower case, matched
as substrings of the full kernel name; a per-layer metric reads the
device seconds of its pattern over the traced steps.
"""

from __future__ import annotations

from typing import Optional, Sequence

# torch.sort: CUB's one-sweep radix sort and its histogram and scan
# kernels, segmented and in-place small sorts, and the index fill of
# a sort that returns indices
SORT = ("radixsort", "radix_sort", "sortkvinplace", "segmentedsort",
        "fill_reverse_indices")
# row gathers: x[perm] (index_elementwise), index_select and gather
GATHER = ("index_elementwise", "indexselect", "index_select", "gather")
# NCCL's kernels (all_to_all runs as grouped send/recv)
NCCL = ("nccl",)
# kernel 1, csrc/flagged_scan.cu
SCAN = ("scan_tiles",)


def matches(name: str, patterns: Sequence[str],
            exclude: Sequence[str] = ()) -> bool:
    low = name.lower()
    return any(p in low for p in patterns) and not any(
        x in low for x in exclude)


def seconds_per_step(trace, patterns: Sequence[str],
                     exclude: Sequence[str] = ()) -> Optional[float]:
    """Device seconds a traced step in kernels matching ``patterns``;
    None where the trace has no step or no such kernel."""
    if not trace or not trace["steps"]:
        return None
    total = sum(sec for name, sec in trace["kernels"].items()
                if matches(name, patterns, exclude))
    return total / trace["steps"] if total > 0 else None
