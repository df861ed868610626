"""Flight recorder: per-plane bounded rings of structured events.

Each plane (transport, reader, decode, tier, qos, faults — the keys of
``obs.events.EVENTS``) owns ONE fixed-capacity ring of events under its
own lock (lock-striped by plane, so a busy transport plane never
contends with reader events).  An event is a fixed-shape tuple
``(t_epoch_s, name, fields)`` — ``fields`` a small flat dict of
scalars.  A full ring drops the OLDEST event and counts the drop
(``obs_events_dropped_total{plane=...}``) — recording never blocks and
never grows.

Dumps are JSON snapshots of every ring plus process identity, written

- automatically on FetchFailed, breaker trip, ledger leak, or wire
  reject (``auto_dump`` — rate-capped so an error storm costs one file
  per interval, not thousands), and
- on demand via the metrics HTTP server's ``/flightrecorder`` endpoint
  or :func:`sparkrdma_tpu_torch.obs.collect.write_dump` at fixture teardown.

``tools/trace_report.py`` renders a dump (or several merged across
processes) as a text waterfall / Chrome trace.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Dict, Optional

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.obs.events import EVENTS

logger = logging.getLogger(__name__)

#: minimum seconds between automatic dumps (an error storm costs one
#: file per interval, not one per failure)
AUTO_DUMP_INTERVAL_S = 1.0


class _Ring:
    """One plane's bounded event ring (deque drops oldest when full)."""

    __slots__ = ("lock", "events", "dropped", "cap")

    def __init__(self, cap: int):
        self.lock = threading.Lock()  # lock-order: 99
        self.events = deque(maxlen=cap)
        self.dropped = 0  # guarded-by: lock
        self.cap = cap


class FlightRecorder:
    """Process-global recorder; ``enabled`` is the one hot-path check
    (the metrics-registry no-op idiom — ``fr_event`` costs an attribute
    read when off)."""

    def __init__(self):
        self.enabled = False
        self._rings: Dict[str, _Ring] = {}
        self._drop_counters: Dict[str, object] = {}
        self._dump_dir = ""
        self._owners = 0
        self._dump_lock = threading.Lock()  # lock-order: 89
        self._last_auto = 0.0   # guarded-by: _dump_lock
        self._dump_seq = 0      # guarded-by: _dump_lock

    # -- lifecycle (owner-counted, like the fault plane) --------------------
    def retain(self, ring_size: int = 4096, dump_dir: str = "") -> None:
        if self._owners == 0:
            self._rings = {p: _Ring(max(int(ring_size), 1)) for p in EVENTS}
            self._drop_counters = {
                p: counter("obs_events_dropped_total", plane=p)
                for p in EVENTS
            }
            # a fresh recorder lifecycle starts with an open rate-cap
            # window (the dump SEQUENCE keeps advancing so filenames
            # from consecutive lifecycles in one process never collide)
            with self._dump_lock:
                self._last_auto = 0.0
        self._owners += 1
        if dump_dir:
            self._dump_dir = dump_dir
        self.enabled = True

    def release(self) -> None:
        self._owners = max(0, self._owners - 1)
        if self._owners == 0:
            self.enabled = False
            self._dump_dir = ""

    # -- recording (any thread) ---------------------------------------------
    def record(self, plane: str, name: str, fields: dict) -> None:
        ring = self._rings.get(plane)
        if ring is None:
            return
        t = time.time()
        with ring.lock:
            full = len(ring.events) == ring.cap
            ring.events.append((t, name, fields))
            if full:
                ring.dropped += 1
        if full:
            # outside the ring lock: the registry's stripe locks rank
            # below the rings in the hierarchy
            self._drop_counters[plane].inc()

    # -- snapshot / dump -----------------------------------------------------
    def snapshot(self) -> dict:
        planes = {}
        for plane, ring in self._rings.items():
            with ring.lock:
                events = [[t, name, fields] for t, name, fields in ring.events]
                dropped = ring.dropped
            planes[plane] = {"dropped": dropped, "events": events}
        return {
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "time": time.time(),
            "planes": planes,
        }

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write one JSON dump; ``path`` overrides the configured dump
        directory (in which the filename is pid- and sequence-tagged so
        per-process dumps of one fleet never collide)."""
        if path is None:
            if not self._dump_dir:
                return None
            with self._dump_lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = os.path.join(
                self._dump_dir,
                f"flightrec-{os.getpid()}-{seq}-{reason}.json",
            )
        snap = self.snapshot()
        snap["reason"] = reason
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(snap, f)
        except OSError:
            logger.exception("flight-recorder dump to %s failed", path)
            return None
        counter("obs_dumps_total", reason=reason).inc()
        return path

    def auto_dump(self, reason: str) -> Optional[str]:
        """Rate-capped automatic dump (failure-path hook sites)."""
        if not self.enabled or not self._dump_dir:
            return None
        now = time.time()
        with self._dump_lock:
            if now - self._last_auto < AUTO_DUMP_INTERVAL_S:
                return None
            self._last_auto = now
        return self.dump(reason)


RECORDER = FlightRecorder()


def fr_event(plane: str, event: str, **fields) -> None:
    """Record one structured event (no-op when the recorder is off).
    ``plane`` and ``event`` must be string literals declared in
    ``obs.events.EVENTS`` — lint rule PY12 enforces it."""
    rec = RECORDER
    if rec.enabled:
        rec.record(plane, event, fields)
