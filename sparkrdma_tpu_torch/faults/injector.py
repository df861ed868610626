"""Deterministic fault injector (conf ``spark.shuffle.tpu.faultInject``).

Spec grammar — ``;``-separated clauses, each arming one named point::

    connect:p=0.1;read_resp:p=0.05;serve_delay:ms=30;lane_kill:nth=7;seed=42

* ``point:p=0.1``   — fire with probability 0.1 per call,
* ``point:nth=7``   — fire on every 7th call (1-based: calls 7, 14, …),
* ``point:ms=30``   — the action is a 30 ms delay instead of a raise
  (composes with ``p``/``nth``; alone it fires on every call),
* ``seed=N``        — a standalone clause seeding the whole schedule.

Determinism: each point draws from its own ``random.Random`` seeded
``seed ^ crc32(point)`` and keeps its own call counter, so the fault
schedule for a given (spec, per-point call sequence) is reproducible
across runs and independent of unrelated points — the property the
chaos soak's bit-exactness assertions stand on.  ``hash()`` is NOT
used anywhere (it is salted per process).

Call-site contract (the woven points)::

    if FAULTS.enabled:
        FAULTS.check("recv")        # raises FaultInjectedError / sleeps
    ...
    if FAULTS.enabled and FAULTS.fires("lane_kill"):
        victim.stop()               # decision points act themselves

Disabled, every point is a single attribute check — no call, no lock.
Each firing counts ``fault_injected_total{point=}``.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.obs import RECORDER, fr_event

# NOTE: transport.channel is imported at the BOTTOM of this module.
# The transport package's __init__ imports engines that import FAULTS
# from here; importing channel first would re-enter this module while
# FAULTS is still undefined.  Everything the engines need is defined
# before that import runs, which breaks the cycle in both directions.

#: Every fault point woven through the stack, for spec validation and
#: the README fault-point table.  Keep in lockstep with the call sites.
KNOWN_POINTS = (
    "connect",       # network connect entry (tcp + loopback)
    "hello",         # tcp handshake between socket and ack
    "send",          # channel post paths (tcp, async dispatcher, loopback)
    "recv",          # rx frame header (tcp read loop, async rx pump)
    "read_resp",     # read-response frame decode
    "serve",         # serve-side block resolution (both tcp engines + loopback)
    "serve_delay",   # serve-side latency injection (use with ms=)
    "stripe",        # per-lane post in a striped read
    "lane_kill",     # decision point: kill a data lane after its post
    "disk_read",     # tier cold-read from spill
    "decode",        # decode-pool worker
    "publish",       # executor -> driver map-output publish
    "location_rpc",  # reader -> driver location fetch
    "heartbeat",     # decision point: drop a driver heartbeat probe
    "push_merge",    # merger rx: drop an arriving pushed sub-block
    "merge_status",  # merger rx: fail a merge-status query (dead merger)
)


class FaultSpecError(ValueError):
    """Malformed ``faultInject`` spec string."""


class _Clause:
    """One armed point: firing rule + action."""

    __slots__ = ("point", "p", "nth", "ms", "rng", "calls", "fired")

    def __init__(self, point: str, p: Optional[float], nth: Optional[int],
                 ms: Optional[float], seed: int):
        self.point = point
        self.p = p
        self.nth = nth
        self.ms = ms
        self.rng = random.Random(seed ^ zlib.crc32(point.encode("ascii")))
        self.calls = 0  # guarded-by: (injector) _lock
        self.fired = 0  # guarded-by: (injector) _lock

    def decide(self) -> bool:
        """One call's firing decision (caller holds the injector lock)."""
        self.calls += 1
        if self.nth is not None:
            hit = self.calls % self.nth == 0
        elif self.p is not None:
            hit = self.rng.random() < self.p
        else:
            hit = True  # bare delay clause: every call
        if hit:
            self.fired += 1
        return hit


def parse_fault_spec(spec: str) -> Tuple[int, Dict[str, "_Clause"]]:
    """Parse a spec string into ``(seed, {point: clause})``.  Raises
    :class:`FaultSpecError` on unknown points/keys or bad values, so a
    typo'd conf fails the job at manager construction, not silently."""
    seed = 0
    raw: List[Tuple[str, Dict[str, str]]] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            try:
                seed = int(part[5:])
            except ValueError:
                raise FaultSpecError(f"bad seed in fault spec: {part!r}")
            continue
        if ":" not in part:
            raise FaultSpecError(
                f"fault clause {part!r} is not 'point:key=value[,...]'")
        point, _, body = part.partition(":")
        point = point.strip()
        if point not in KNOWN_POINTS:
            raise FaultSpecError(
                f"unknown fault point {point!r} "
                f"(known: {', '.join(KNOWN_POINTS)})")
        kv: Dict[str, str] = {}
        for item in body.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise FaultSpecError(
                    f"fault clause {part!r}: {item!r} is not key=value")
            kv[k.strip()] = v.strip()
        raw.append((point, kv))
    clauses: Dict[str, _Clause] = {}
    for point, kv in raw:
        p = nth = ms = None
        for k, v in kv.items():
            try:
                if k == "p":
                    p = float(v)
                    if not 0.0 <= p <= 1.0:
                        raise ValueError
                elif k == "nth":
                    nth = int(v)
                    if nth < 1:
                        raise ValueError
                elif k == "ms":
                    ms = float(v)
                    if ms < 0:
                        raise ValueError
                else:
                    raise FaultSpecError(
                        f"fault point {point!r}: unknown key {k!r} "
                        f"(use p=, nth=, ms=)")
            except (ValueError, TypeError):
                raise FaultSpecError(
                    f"fault point {point!r}: bad value {k}={v!r}")
        clauses[point] = _Clause(point, p, nth, ms, seed)
    return seed, clauses


class FaultInjector:
    """Process-global deterministic fault plane (see module doc)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()  # lock-order: 91
        self._clauses: Dict[str, _Clause] = {}  # guarded-by: _lock
        self._owners = 0  # guarded-by: _lock
        self.seed = 0

    # -- arming --------------------------------------------------------------
    def arm(self, spec: str) -> None:
        """Compile and install a spec; ``enabled`` flips on iff any
        clause armed.  Re-arming with the SAME spec (a second manager
        in one process, the in-process cluster tests) keeps the live
        schedule — counters keep advancing, so the process-wide fault
        sequence stays one deterministic stream.  Each armer must pair
        with one :meth:`stop`; the last stop disarms."""
        seed, clauses = parse_fault_spec(spec)
        with self._lock:
            self._owners += 1
            if not self._clauses:
                self.seed = seed
                self._clauses = clauses
                self.enabled = bool(clauses)

    def stop(self) -> None:
        """Drop one armer; the last one disarms and clears the spec."""
        with self._lock:
            if self._owners > 0:
                self._owners -= 1
            if self._owners == 0:
                self._clauses = {}
                self.enabled = False

    def reset(self) -> None:
        """Disarm unconditionally and forget all owners (tests)."""
        with self._lock:
            self._clauses = {}
            self._owners = 0
            self.enabled = False

    # -- the woven points ----------------------------------------------------
    def fires(self, point: str) -> bool:
        """Decision-point form: did this call hit?  The caller acts
        (kill a lane, drop a probe) — nothing is raised here."""
        with self._lock:
            c = self._clauses.get(point)
            hit = c.decide() if c is not None else False
        if hit:
            counter("fault_injected_total", point=point).inc()
            if RECORDER.enabled:
                fr_event("faults", "fault_fired", point=point, form="fires")
        return hit

    def check(self, point: str) -> None:
        """Raise-or-delay form: a clause with ``ms=`` sleeps, any
        other firing clause raises :class:`FaultInjectedError`."""
        with self._lock:
            c = self._clauses.get(point)
            hit = c.decide() if c is not None else False
            ms = c.ms if hit else None
        if not hit:
            return
        counter("fault_injected_total", point=point).inc()
        if RECORDER.enabled:
            fr_event(
                "faults", "fault_fired", point=point,
                form="delay" if ms is not None else "raise",
            )
        if ms is not None:
            time.sleep(ms / 1000.0)
            return
        raise FaultInjectedError(point)

    # -- introspection -------------------------------------------------------
    def fired_counts(self) -> Dict[str, int]:
        """Per-point firing totals (tests; metrics-independent)."""
        with self._lock:
            return {p: c.fired for p, c in self._clauses.items() if c.fired}


FAULTS = FaultInjector()

# Deferred import — see the note at the top of the module.  By the time
# this line runs, FAULTS and the injector machinery above are fully
# defined, so the transport engines this import transitively pulls in
# can bind them safely.
from sparkrdma_tpu_torch.transport.channel import TransportError  # noqa: E402


class FaultInjectedError(TransportError):
    """A fault point fired.  Transient by construction — the injector
    models fabric blips, exactly what the retry policy absorbs."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at point '{point}'")
        self.point = point
