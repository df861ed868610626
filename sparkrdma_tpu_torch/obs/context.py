"""Distributed trace context: request-scoped ids that cross the wire.

A :class:`TraceContext` is two 64-bit ids — ``trace_id`` names one
logical read (a reducer task's fetch plan), ``span_id`` one unit of
work within it (a fetch group, a serve, a decode).  The reader stamps a
context on every fetch group; the transport carries it to the serving
node (an optional ``<QQ`` tail on read requests, trace fields on the
fetch-status RPC under wire version 2), so the responder's serve /
tier / credit events join the requester's trace in one merged timeline
(tools/trace_report.py).

Zero-overhead when off, like the metrics registry: ``TRACING.start()``
is one attribute check returning ``None``, and every carrier treats a
``None`` context as "emit nothing" — the wire bytes are identical to a
pre-tracing build (golden-frame pinned).

Id 0 is reserved as "no trace" on the wire; generated ids are pid- and
time-salted so independently-started processes do not collide within a
merged fleet trace.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import NamedTuple, Optional

_ID_MASK = (1 << 64) - 1


class TraceContext(NamedTuple):
    """One (trace, span) identity, carried on the wire as two u64s."""

    trace_id: int
    span_id: int

    def child(self) -> "TraceContext":
        """New span under the same trace."""
        return TraceContext(self.trace_id, _next_id())


_counter = itertools.count(1)
_base = 0


def _next_id() -> int:
    """Unique nonzero 64-bit id: pid + coarse start-time salt in the
    high bits, a process-local counter in the low bits."""
    global _base
    if _base == 0:
        _base = (
            ((os.getpid() & 0xFFFF) << 48)
            | ((int(time.time() * 1000.0) & 0xFFFFFFFF) << 16)
        )
    return ((_base + next(_counter)) & _ID_MASK) or 1


class Tracing:
    """Process-global tracing switch + sampler.

    ``enabled`` is flipped by the manager from conf ``traceEnabled``
    (owner-counted so nested managers in one process compose);
    ``sample_stride`` derives from conf ``traceSampleRate`` — a rate of
    1.0 samples every trace, 0.1 every 10th, 0 none.
    """

    __slots__ = ("enabled", "sample_stride", "_seq", "_owners")

    def __init__(self):
        self.enabled = False
        self.sample_stride = 1
        self._seq = itertools.count()
        self._owners = 0

    def retain(self, sample_rate: float = 1.0) -> None:
        self._owners += 1
        if sample_rate <= 0.0:
            self.sample_stride = 0
        else:
            self.sample_stride = max(1, round(1.0 / min(sample_rate, 1.0)))
        self.enabled = True

    def release(self) -> None:
        self._owners = max(0, self._owners - 1)
        if self._owners == 0:
            self.enabled = False

    def start(self) -> Optional[TraceContext]:
        """Root context for one logical read, or None (off/sampled out)."""
        if not self.enabled:
            return None
        stride = self.sample_stride
        if stride == 0 or next(self._seq) % stride:
            return None
        return TraceContext(_next_id(), _next_id())


TRACING = Tracing()
