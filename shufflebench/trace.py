"""The traced run's reading of the device: ``torch.profiler`` over a
few steps inside the window, reduced from its Chrome trace to what the
per-layer metrics read.

:class:`StepTracer` profiles steps ``first .. first + warmup + active
- 1`` of the window (the warm-up steps are not recorded) and reduces
the trace with :func:`summarize`.  The harness marks each step call
``shufflebench.step`` and each wait for the device
``shufflebench.synchronize`` (``record_function``); the traced window
runs from the first recorded step's call to the end of the last
recorded wait.

A summary holds, over that window: ``steps`` (recorded step calls),
``window_s``, ``busy_s`` (the union of every kernel, copy and memset
interval, whatever its stream), ``kernels`` (device seconds by full
kernel name) and ``gaps`` (seconds the device sat idle, by the
innermost host operation running when each gap began).
:func:`merge` averages the summaries of the ranks of a world.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence

STEP = "shufflebench.step"
SYNC = "shufflebench.synchronize"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
IDLE_OUTSIDE = "host outside any traced operation"
TOP = 10


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


class StepTracer:
    """Profiles a run of consecutive steps of the window."""

    def __init__(self, first: int, warmup: int, active: int, cuda: bool):
        self.first, self.warmup, self.active = first, warmup, active
        self.cuda = cuda
        self.prof = None
        self.summary: Optional[Dict[str, object]] = None

    def needs(self, i: int) -> bool:
        """Whether step ``i`` or a later one is still to be traced."""
        return i < self.first + self.warmup + self.active

    def covers(self, i: int) -> bool:
        return self.first <= i < self.first + self.warmup + self.active

    def before(self, i: int) -> None:
        if i != self.first:
            return
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(
            activities=acts, on_trace_ready=self._ready,
            schedule=schedule(wait=0, warmup=self.warmup,
                              active=self.active, repeat=1))
        self.prof.__enter__()

    def after(self, i: int) -> None:
        if self.prof is None or not self.covers(i):
            return
        self.prof.step()
        if i == self.first + self.warmup + self.active - 1:
            self.close()

    def close(self) -> None:
        if self.prof is not None:
            prof, self.prof = self.prof, None
            prof.__exit__(None, None, None)

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(prefix="shufflebench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                summary = summarize(json.load(f))
            # the profiler may hand over an empty cycle when it stops
            if self.summary is None:
                self.summary = summary
        finally:
            os.unlink(path)


def _spans(events, cats) -> List[Dict[str, object]]:
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in cats and "dur" in e]


def _union(intervals):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(trace: Dict[str, object]) -> Optional[Dict[str, object]]:
    """The summary (module docstring) of one Chrome trace, or None when
    it recorded no step."""
    events = trace.get("traceEvents", [])
    marks = _spans(events, ("user_annotation",))
    steps = [e for e in marks if e.get("name") == STEP]
    syncs = [e for e in marks if e.get("name") == SYNC]
    if not steps or not syncs:
        return None
    start = min(float(e["ts"]) for e in steps)
    end = max(float(e["ts"]) + float(e["dur"]) for e in syncs)
    kernels: Dict[str, float] = {}
    intervals = []
    for e in _spans(events, DEVICE_CATS):
        a = max(float(e["ts"]), start)
        b = min(float(e["ts"]) + float(e["dur"]), end)
        if b <= a:
            continue
        intervals.append((a, b))
        name = str(e.get("name", "?"))
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(intervals)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    str(e.get("name", "?")))
                   for e in _spans(events, HOST_CATS)),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edge = start
    for a, b in busy + [[end, end]]:
        if a > edge:
            label = _host_at(host, starts, edge)
            gaps[label] = gaps.get(label, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    return {
        "steps": len(steps),
        "window_s": (end - start) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": kernels,
        "gaps": gaps,
    }


def _host_at(host, starts, t: float) -> str:
    """The shortest (innermost) host operation running at ``t``."""
    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        a, b, name = host[i]
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else IDLE_OUTSIDE


def merge(summaries: Sequence[Optional[Dict[str, object]]]):
    """The mean over the ranks of their summaries; None if any rank
    recorded nothing."""
    if not summaries or any(s is None for s in summaries):
        return None
    k = len(summaries)
    out: Dict[str, object] = {
        "steps": min(int(s["steps"]) for s in summaries),
        "window_s": sum(float(s["window_s"]) for s in summaries) / k,
        "busy_s": sum(float(s["busy_s"]) for s in summaries) / k,
    }
    for key in ("kernels", "gaps"):
        acc: Dict[str, float] = {}
        for s in summaries:
            for name, sec in s[key].items():
                acc[name] = acc.get(name, 0.0) + sec / k
        out[key] = acc
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and template or
    argument lists."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    cut = min([i for i in (s.find("<"), s.find("(")) if i > 0] or [len(s)])
    return s[:cut].strip()[:100] or name[:100]


def breakdown(summary) -> Dict[str, List[List[object]]]:
    """The ``breakdown`` of the result line: the device operations that
    took most time (seconds over the traced window, by short name) and
    the idle gaps by what the host was doing."""
    ops: Dict[str, float] = {}
    for name, sec in summary["kernels"].items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + sec
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k[:100], v] for k, v in gaps]}
