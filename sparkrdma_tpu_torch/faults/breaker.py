"""Per-peer failure containment: circuit breaker + stripe health.

Both live on the Node keyed by peer (``node.peer_health``) — NOT on a
ReadGroup, which the failure path destroys (``invalidate_read_group``)
on every error, exactly when history must survive.

:class:`CircuitBreaker` — repeated fetch failures against one peer
trip the breaker OPEN; while open, remaining fetches to that peer fail
fast instead of serially burning the full backoff budget each.  After
``reset_ms`` the breaker goes HALF_OPEN and admits ONE probe fetch:
success closes it, failure re-opens (and restarts the clock).

:class:`StripeHealth` — repeated striped-lane failures demote the
peer's large reads to the unstriped small-read lane for a window
(the dry-pool fallback generalized to a health signal); a
successful read while not demoted clears the strike count.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.statemachine import StateMachine


class CircuitBreaker(StateMachine):
    """Consecutive-failure breaker with half-open probing.

    ``failures=0`` disables the breaker: :meth:`allow` is always true
    and nothing ever trips.  ``clock`` is injectable for tests."""

    MACHINE = "faults.breaker"
    STATES = ("closed", "open", "half-open")
    INITIAL = "closed"
    TERMINAL = ()
    TRANSITIONS = {
        "closed": ("open",),          # strike budget burned: trip
        "open": ("half-open",),       # reset window elapsed: probe
        "half-open": ("closed", "open"),  # probe verdict
    }

    def __init__(self, failures: int, reset_ms: float, name: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.failures = int(failures)
        self.reset_s = float(reset_ms) / 1000.0
        self.name = name
        self._clock = clock
        self._lock = dbg_lock("faults.breaker", 47)
        self._state = "closed"  # state: faults.breaker guarded-by: _lock
        self._strikes = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self.trips = 0  # guarded-by: _lock

    def allow(self) -> bool:
        """May a fetch proceed?  OPEN past ``reset_ms`` transitions to
        HALF_OPEN and admits exactly one probe; a HALF_OPEN breaker
        with its probe outstanding refuses further fetches."""
        if self.failures <= 0:
            return True
        probe = False
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_s:
                    self._transition("half-open")
                    probe = True
                else:
                    return False
            elif self._state == "half-open":
                return False  # probe already out
        if probe:
            if RECORDER.enabled:
                fr_event("faults", "breaker_probe", peer=self.name)
            return True
        return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half-open":
                # the probe came back: close and forget the strikes
                self._strikes = 0
                self._transition("closed")
            elif self._state == "closed":
                self._strikes = 0
            # OPEN: a stale success from a fetch issued BEFORE the trip.
            # Closing here would skip the probe protocol entirely — the
            # peer gets the full parallel fetch load again off one
            # straggler response that predates its failure burst.  The
            # half-open probe is the only path back to closed.

    def record_failure(self) -> None:
        if self.failures <= 0:
            return
        tripped = False
        with self._lock:
            self._strikes += 1
            strikes = self._strikes
            if self._state == "half-open":
                # the probe failed: straight back to OPEN, clock restarts
                self._transition("open")
                self._opened_at = self._clock()
            elif self._state == "closed" and self._strikes >= self.failures:
                self._transition("open")
                self._opened_at = self._clock()
                self.trips += 1
                tripped = True
        if tripped:
            counter("transport_breaker_trips_total", peer=self.name).inc()
            if RECORDER.enabled:
                fr_event(
                    "faults", "breaker_trip",
                    peer=self.name, strikes=strikes,
                )
                # a tripped breaker means a peer just burned its whole
                # failure budget — snapshot the lead-up while the rings
                # still hold it
                RECORDER.auto_dump("breaker_trip")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state


class StripeHealth:
    """Consecutive striped-lane failure tracker driving demotion.

    ``failures=0`` disables demotion.  Demotion lasts ``demote_ms``;
    each demoted read counts ``transport_stripe_demotions_total``
    at the decision site (ReadGroup), not here."""

    def __init__(self, failures: int, demote_ms: float, name: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.failures = int(failures)
        self.demote_s = float(demote_ms) / 1000.0
        self.name = name
        self._clock = clock
        self._lock = dbg_lock("faults.stripe_health", 47)
        self._strikes = 0  # guarded-by: _lock
        self._demoted_until = 0.0  # guarded-by: _lock

    def note_lane_failure(self) -> None:
        if self.failures <= 0:
            return
        with self._lock:
            self._strikes += 1
            if self._strikes >= self.failures:
                self._demoted_until = self._clock() + self.demote_s
                self._strikes = 0

    def note_success(self) -> None:
        with self._lock:
            if self._clock() >= self._demoted_until:
                self._strikes = 0
                self._demoted_until = 0.0

    def demoted(self) -> bool:
        if self.failures <= 0:
            return False
        with self._lock:
            return self._clock() < self._demoted_until


class PeerHealth:
    """One peer's breaker + stripe health, built from conf knobs."""

    __slots__ = ("breaker", "stripes")

    def __init__(self, peer: Tuple[str, int], conf,
                 clock: Callable[[], float] = time.monotonic):
        name = f"{peer[0]}:{peer[1]}"
        self.breaker = CircuitBreaker(
            conf.fetch_breaker_failures, conf.fetch_breaker_reset_ms,
            name=name, clock=clock)
        self.stripes = StripeHealth(
            conf.stripe_demote_failures, conf.stripe_demote_ms,
            name=name, clock=clock)


class PeerHealthRegistry:
    """Node-resident ``peer -> PeerHealth`` map.  Lives on the Node
    (rank 43, below the per-health locks at 47) so health survives
    ReadGroup invalidation across retry attempts."""

    def __init__(self, conf):
        self._conf = conf
        self._lock = dbg_lock("node.peer_health", 43)
        self._peers: Dict[Tuple[str, int], PeerHealth] = {}  # guarded-by: _lock

    def get(self, peer: Tuple[str, int]) -> PeerHealth:
        with self._lock:
            h = self._peers.get(peer)
            if h is None:
                h = self._peers[peer] = PeerHealth(peer, self._conf)
            return h

    def clear(self) -> None:
        with self._lock:
            self._peers.clear()
