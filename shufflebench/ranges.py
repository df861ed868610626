"""Device time by stage of the program: one Chrome trace of
``torch.profiler`` reduced by the port's stage ranges.

The port opens a profiler range ``sparkrdma.<stage>`` around each stage
of a device step (``sparkrdma_tpu_torch/utils/trace.py``:
``terasort.pad``, ``join.probe``, ``exchange.all_to_all``, ...).
:func:`reduce` gives, over the window :func:`window` finds (the one
``trace.summarize`` reads, from the first recorded step call to the end
of the last recorded wait):

- ``ranges``: device seconds by innermost ``sparkrdma.*`` range.  A
  kernel, copy or memset belongs to the range whose host span contains
  the runtime or driver call that launched it, on the thread that made
  the call, matched by the ``correlation`` argument the operation and
  its launch share.  Device time launched in no range goes under
  :data:`OUTSIDE`.  Each operation is clipped to the window as
  ``summarize`` clips it, so the values add up to the sum of its
  ``kernels``.
- ``range_gaps``: seconds the device sat idle, by the innermost
  ``sparkrdma.*`` range running on any thread when each gap began, or
  :data:`OUTSIDE`.

    python3 -m shufflebench.ranges TRACE.json [TRACE.json ...]

prints one JSON line: the reduction of each trace averaged over the
traces (the ranks of one world), with ``steps`` (recorded step calls,
the fewest of any trace) and ``ranges_ms_per_step``.  A trace with no
recorded step is reduced over the whole of its events.
"""

from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from shufflebench.trace import DEVICE_CATS, STEP, SYNC, _spans, _union

PREFIX = "sparkrdma."
OUTSIDE = "outside the program"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _ends(e) -> Tuple[float, float]:
    a = float(e["ts"])
    return a, a + float(e["dur"])


def window(events) -> Optional[Tuple[float, float]]:
    """The traced window of ``summarize`` (µs), or None without a
    recorded step and wait."""
    marks = _spans(events, ("user_annotation",))
    steps = [e for e in marks if e.get("name") == STEP]
    syncs = [e for e in marks if e.get("name") == SYNC]
    if not steps or not syncs:
        return None
    return (min(_ends(e)[0] for e in steps),
            max(_ends(e)[1] for e in syncs))


def _extent(events) -> Optional[Tuple[float, float]]:
    spans = [_ends(e) for e in events
             if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not spans:
        return None
    return min(a for a, _ in spans), max(b for _, b in spans)


class _Ranges:
    """The program's host ranges, sorted by start."""

    def __init__(self, events):
        self.all = sorted((*_ends(e), str(e["name"]), _thread(e))
                          for e in events)
        self.starts = [r[0] for r in self.all]

    def at(self, t: float, thread=None) -> str:
        """The shortest (innermost) range running at ``t``, on
        ``thread`` if given."""
        best = None
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            a, b, name, th = self.all[i]
            if a <= t < b and (thread is None or th == thread) and (
                    best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else OUTSIDE


def _thread(e):
    return e.get("pid"), e.get("tid")


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def reduce(trace: Dict[str, object],
           span: Optional[Tuple[float, float]] = None) -> Dict[str, object]:
    """``ranges`` and ``range_gaps`` (module docstring) of one Chrome
    trace over ``span`` (µs; default :func:`window`, else the whole
    trace)."""
    events = trace.get("traceEvents", [])
    span = span or window(events) or _extent(events)
    if span is None:
        return {"ranges": {}, "range_gaps": {}}
    start, end = span
    ranges = _Ranges(e for e in _spans(events, ("user_annotation",))
                     if str(e.get("name", "")).startswith(PREFIX))
    launches = {}
    for e in _spans(events, LAUNCH_CATS):
        c = _correlation(e)
        if c is not None:
            launches[c] = e
    by_range: Dict[str, float] = {}
    intervals = []
    for e in _spans(events, DEVICE_CATS):
        a, b = _ends(e)
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        intervals.append((a, b))
        launch = launches.get(_correlation(e))
        name = OUTSIDE if launch is None else ranges.at(
            float(launch["ts"]), _thread(launch))
        by_range[name] = by_range.get(name, 0.0) + (b - a) * 1e-6
    gaps: Dict[str, float] = {}
    edge = start
    for a, b in _union(intervals) + [[end, end]]:
        if a > edge:
            name = ranges.at(edge)
            gaps[name] = gaps.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    return {"ranges": by_range, "range_gaps": gaps}


def mean(reductions: Sequence[Dict[str, Dict[str, float]]]):
    """The mean over the ranks of their reductions, key by key."""
    k = len(reductions)
    out: Dict[str, Dict[str, float]] = {}
    for key in ("ranges", "range_gaps"):
        acc: Dict[str, float] = {}
        for r in reductions:
            for name, sec in r[key].items():
                acc[name] = acc.get(name, 0.0) + sec / k
        out[key] = acc
    return out


def main(paths: List[str]) -> int:
    reductions, steps = [], []
    for path in paths:
        with open(path) as f:
            trace = json.load(f)
        reductions.append(reduce(trace))
        steps.append(sum(1 for e in _spans(trace.get("traceEvents", []),
                                           ("user_annotation",))
                         if e.get("name") == STEP))
    out: Dict[str, object] = dict(mean(reductions))
    n = min(steps)
    out["steps"] = n
    if n:
        out["ranges_ms_per_step"] = {
            name: sec / n * 1e3 for name, sec in sorted(
                out["ranges"].items(), key=lambda kv: -kv[1])}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("usage: python3 -m shufflebench.ranges TRACE.json "
              "[TRACE.json ...]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
