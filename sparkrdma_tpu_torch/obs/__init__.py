"""Observability plane: distributed trace propagation + flight recorder.

- :mod:`obs.context` — ``TraceContext`` ids stamped on every fetch
  group and carried on the wire (read-request ``<QQ`` tail, RPC trace
  fields) so serve-side spans join the requester's trace.
- :mod:`obs.events` — the single registry of flight-recorder event
  names (lint rule PY12 pins call sites to it).
- :mod:`obs.recorder` — per-plane bounded event rings with counted
  drops, JSON dumps on failure triggers or on demand.
- :mod:`obs.collect` — per-process dump collection + cross-process
  merge for the simfleet/cluster harnesses.

Everything is a no-op while off: ``TRACING.start()`` returns ``None``
and ``fr_event`` is one attribute check — the metrics-registry idiom.
"""

from sparkrdma_tpu_torch.obs.context import TRACING, TraceContext
from sparkrdma_tpu_torch.obs.events import EVENTS
from sparkrdma_tpu_torch.obs.recorder import RECORDER, fr_event

__all__ = [
    "EVENTS",
    "RECORDER",
    "TRACING",
    "TraceContext",
    "fr_event",
]
