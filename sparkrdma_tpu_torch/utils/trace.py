"""Lightweight span tracing (Chrome trace-event format).

The reference's only tracing is inline wall-clock logging
(SURVEY.md §5: connection latency at RdmaNode.java:279,307-308, fetch
timing at RdmaShuffleFetcherIterator.scala:110,140-148).  The rebuild
promotes that to a proper subsystem: nested spans collected per thread,
dumpable as a ``chrome://tracing`` / Perfetto JSON file, enabled by conf
(``spark.shuffle.tpu.trace``) or programmatically.

Spans share one path with the torch profiler.  :func:`stage` marks a
stage of a device step (``terasort.pad``, ``join.probe``, ...) and
:meth:`Tracer.span` a host operation; either opens
``torch.profiler.record_function("sparkrdma." + name)`` while a torch
profiler records, so the kernels a stage launches fall under its range
in the profiler's trace, and records a host span while the tracer is
enabled.  With neither on, both return one shared no-op context after
a read of two flags (the profiler's and the tracer's).

The tracer stamps its events on the profiler's clock: ``ts`` is
microseconds of ``time.time_ns()`` since the tracer's
``base_ns``, which :meth:`Tracer.dump` writes as the document's
``baseTimeNanoseconds``, the field a torch profiler's Chrome trace
gives its own zero.  A dump and a profiler trace of one run line up
once each event's ``ts`` is shifted by the difference of the two bases.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the prefix of every profiler range the port opens
RANGE_PREFIX = "sparkrdma."
_NULL = contextlib.nullcontext()

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiling() -> bool:
        """Whether a torch profiler is recording (one flag read)."""
        return _autograd_profiler._is_profiler_enabled
else:  # releases without the module flag
    profiling = torch._C._autograd._profiler_enabled


class _Span:
    """One open span: the profiler range while the profiler records,
    the tracer's host span while ``tracer`` is given."""

    __slots__ = ("name", "tracer", "args", "rf", "ts")

    def __init__(self, name: str, tracer: Optional["Tracer"], args,
                 profiled: bool):
        self.name, self.tracer, self.args = name, tracer, args
        self.rf = torch.profiler.record_function(RANGE_PREFIX + name) \
            if profiled else None

    def __enter__(self):
        if self.tracer is not None:
            self.ts = self.tracer._now_us()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.tracer is not None:
            self.tracer._append({
                "name": self.name, "ph": "X", "ts": self.ts,
                "dur": self.tracer._now_us() - self.ts,
                "pid": 0, "tid": threading.get_ident() % 100000,
                "args": self.args or {},
            })


class Tracer:
    def __init__(self, enabled: bool = False, process_name: str = "sparkrdma_tpu",
                 max_events: int = 1 << 20):
        self.enabled = enabled
        self.process_name = process_name
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict] = []
        self._lock = threading.Lock()  # lock-order: 92
        self.base_ns = time.time_ns()

    def _append(self, event: Dict) -> None:
        """Bounded append: beyond max_events new events are counted but
        dropped, so an always-on trace can't grow without limit.  Drops
        were once silent (the count surfaced only in the dump's
        metadata); now they tick ``trace_dropped_total`` so a live
        scrape shows a saturated tracer while the run is still up."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                dropped = True
            else:
                self._events.append(event)
                dropped = False
        if dropped:
            # outside the tracer lock (92): the registry's stripe locks
            # rank higher but keeping inc() lock-free here is cheaper
            from sparkrdma_tpu_torch.metrics import counter

            counter("trace_dropped_total").inc()

    def _now_us(self) -> float:
        return (time.time_ns() - self.base_ns) / 1e3

    def span(self, name: str, **args):
        """A host span named ``name`` while the tracer is enabled, and
        the range ``sparkrdma.<name>`` while a torch profiler records
        (module docstring); otherwise a shared no-op context."""
        profiled = profiling()
        if not (self.enabled or profiled):
            return _NULL
        return _Span(name, self if self.enabled else None, args, profiled)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": 0, "tid": threading.get_ident() % 100000,
            "args": args or {},
        })

    def counter(self, name: str, **values) -> None:
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "C", "ts": self._now_us(),
            "pid": 0, "args": values,
        })

    @property
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def dump(self, path: str) -> None:
        """Write a chrome://tracing-compatible JSON file."""
        with self._lock:
            events = list(self._events)
        doc = {
            "traceEvents": events,
            "baseTimeNanoseconds": self.base_ns,
            "metadata": {
                "process_name": self.process_name,
                "dropped_events": self.dropped,
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


# process-global default tracer; managers enable it from conf
GLOBAL_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return GLOBAL_TRACER


def stage(name: str):
    """A stage of a device step, ``with stage("terasort.pad"): ...``:
    the global tracer's :meth:`Tracer.span`, so a shared no-op context
    unless a torch profiler records or the tracer is enabled."""
    return GLOBAL_TRACER.span(name)
