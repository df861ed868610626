"""Lightweight span tracing (Chrome trace-event format).

The reference's only tracing is inline wall-clock logging
(SURVEY.md §5: connection latency at RdmaNode.java:279,307-308, fetch
timing at RdmaShuffleFetcherIterator.scala:110,140-148).  The rebuild
promotes that to a proper subsystem: nested spans collected per thread,
dumpable as a ``chrome://tracing`` / Perfetto JSON file, enabled by conf
(``spark.shuffle.tpu.trace``) or programmatically.

Zero overhead when disabled: ``span()`` returns a no-op context.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List


class Tracer:
    def __init__(self, enabled: bool = False, process_name: str = "sparkrdma_tpu",
                 max_events: int = 1 << 20):
        self.enabled = enabled
        self.process_name = process_name
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict] = []
        self._lock = threading.Lock()  # lock-order: 92
        self._t0 = time.perf_counter()

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
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        ts = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - ts
            self._append({
                "name": name, "ph": "X", "ts": ts, "dur": dur,
                "pid": 0, "tid": threading.get_ident() % 100000,
                "args": args or {},
            })

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
