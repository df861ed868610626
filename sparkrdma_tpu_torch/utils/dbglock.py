"""Runtime lock sanitizer: rank-checked lock wrappers (conf lockDebug).

The static gate (tools/concheck.py) proves the declared lock hierarchy
acyclic from the ``# lock-order: N`` ranks; this module validates the
SAME hierarchy at runtime, catching the orders statics cannot see —
callbacks run inline under a lock, cross-class call chains, code paths
only a chaos test reaches.  ``LockFactory`` hands out:

- plain ``threading`` primitives while disabled (the default): zero
  steady-state overhead, identity-checkable in tests;
- :class:`DebugLock`-wrapped primitives when conf
  ``spark.shuffle.tpu.lockDebug`` is on (TpuShuffleManager flips the
  process-global factory exactly like the metrics registry), which

  * keep a per-thread acquisition stack (lock, rank, acquire site),
  * assert rank monotonicity at acquire time — taking a lock whose
    rank is <= the highest rank already held by this thread raises
    :class:`LockOrderViolation` (and counts
    ``lock_rank_violations_total``), unless it is a reentrant
    re-acquisition of a lock the thread already owns,
  * record hold-time histograms (``lock_hold_us{lock=...}``) through
    the metrics registry, rendered by tools/metrics_report.py.

Ranks are the canonical hierarchy documented in README "Concurrency
discipline"; a lock may only be acquired with a rank strictly greater
than every lock its thread already holds.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional, Tuple

from sparkrdma_tpu_torch.metrics import counter, histogram

# log-ladder microsecond buckets for lock hold times: 1us .. 10s
HOLD_US_EDGES = [
    float(m * d)
    for d in (1, 10, 100, 1_000, 10_000, 100_000, 1_000_000)
    for m in (1, 2.5, 5)
]


class LockOrderViolation(RuntimeError):
    """A thread acquired a lock out of rank order (potential deadlock)."""


_TLS = threading.local()


def _held_stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def held_locks() -> List[Tuple[str, int, str]]:
    """This thread's acquisition stack: [(name, rank, acquire site)]."""
    return [(e.lock.name, e.lock.rank, e.site) for e in _held_stack()]


def _call_site(depth: int = 2) -> str:
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except (ValueError, AttributeError):
        return "<unknown>"


class _Held:
    """One entry of a thread's acquisition stack."""

    __slots__ = ("lock", "depth", "t0", "site", "released")

    def __init__(self, lock: "DebugLock", site: str):
        self.lock = lock
        self.depth = 1
        self.t0 = time.monotonic()
        self.site = site
        # set by a CROSS-THREAD release (a plain Lock used as a
        # signal): the owner thread purges stale entries lazily
        self.released = False


class DebugLock:
    """Rank-checked wrapper over a ``threading.Lock``/``RLock``.

    Forwards ``_release_save``/``_acquire_restore``/``_is_owned`` so a
    ``threading.Condition`` built over a reentrant DebugLock keeps full
    wait/notify semantics — a ``wait()`` ends the current hold period
    (observing its hold time) and re-entry after wake re-opens one
    without re-running the rank check (the lock was logically held)."""

    __slots__ = ("name", "rank", "_inner", "_reentrant", "_m_hold",
                 "_m_acquires", "_cur")

    def __init__(self, name: str, rank: int, inner, reentrant: bool):
        self.name = name
        self.rank = int(rank)
        self._inner = inner
        self._reentrant = reentrant
        self._cur: Optional[_Held] = None  # current holder's entry
        self._m_hold = histogram(
            "lock_hold_us", edges=HOLD_US_EDGES, lock=name
        )
        self._m_acquires = counter("lock_acquires_total", lock=name)

    # -- rank discipline ----------------------------------------------------
    def _entry(self) -> Optional[_Held]:
        for e in _held_stack():
            if e.lock is self:
                return e
        return None

    def _check_rank(self, site: str) -> None:
        stack = _held_stack()
        worst = None
        for e in stack:
            if e.lock.rank >= self.rank and (
                worst is None or e.lock.rank > worst.lock.rank
            ):
                worst = e
        if worst is None:
            return
        counter("lock_rank_violations_total").inc()
        held = ", ".join(
            f"{e.lock.name}(rank {e.lock.rank}) at {e.site}"
            for e in stack
        )
        raise LockOrderViolation(
            f"acquiring {self.name} (rank {self.rank}) at {site} "
            f"while holding {worst.lock.name} (rank {worst.lock.rank}) "
            f"— lock-order ranks must strictly increase inward; "
            f"held: [{held}]"
        )

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1,
                _site_depth: int = 2) -> bool:
        site = _call_site(_site_depth)
        stack = _held_stack()
        if any(e.released for e in stack):
            # purge entries a cross-thread release marked stale
            stack[:] = [e for e in stack if not e.released]
        entry = self._entry()
        if entry is not None:
            if not self._reentrant:
                counter("lock_rank_violations_total").inc()
                raise LockOrderViolation(
                    f"same-thread recursive acquire of non-reentrant "
                    f"lock {self.name} at {site} (first acquired at "
                    f"{entry.site}) — guaranteed deadlock"
                )
            if self._inner.acquire(blocking, timeout):
                entry.depth += 1
                return True
            return False
        self._check_rank(site)
        if not self._inner.acquire(blocking, timeout):
            return False
        entry = _Held(self, site)
        _held_stack().append(entry)
        self._cur = entry
        self._m_acquires.inc()
        return True

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            e = stack[i]
            if e.lock is self:
                if e.depth > 1:
                    e.depth -= 1
                else:
                    del stack[i]
                    self._cur = None
                    self._m_hold.observe(
                        (time.monotonic() - e.t0) * 1e6
                    )
                self._inner.release()
                return
        # not in this thread's stack: a plain Lock released by another
        # thread (signal usage).  Capture the holder's entry BEFORE
        # releasing (a new holder may acquire the instant the primitive
        # frees, and marking ITS live entry would blind the sanitizer
        # to it), release the primitive (an RLock raises for
        # non-owners, skipping any marking), then flag the captured
        # entry stale so the old holder's thread purges it at its next
        # lock op instead of carrying a phantom hold.
        cur = self._cur
        self._inner.release()
        if cur is not None:
            cur.released = True
            if self._cur is cur:
                self._cur = None

    def __enter__(self) -> "DebugLock":
        self.acquire(_site_depth=3)
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else self._entry() is not None

    # -- Condition integration ----------------------------------------------
    def _release_save(self):
        """Full release for ``Condition.wait``: close the hold period
        (observe hold time, pop the stack entry — PRESERVING its
        reentrant depth in the state token, so a wait under a nested
        hold restores the exact stack shape) and hand the inner state
        back."""
        stack = _held_stack()
        depth = 1
        for i in range(len(stack) - 1, -1, -1):
            e = stack[i]
            if e.lock is self:
                depth = e.depth
                del stack[i]
                self._cur = None
                self._m_hold.observe((time.monotonic() - e.t0) * 1e6)
                break
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        """Re-acquire after ``Condition.wait`` wakes: the lock was
        logically held across the wait, so no rank re-check — but a new
        hold period starts for the hold-time series, at the SAME
        reentrant depth the wait released."""
        inner_state, depth = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        entry = _Held(self, _call_site(3))
        entry.depth = depth
        _held_stack().append(entry)
        self._cur = entry
        self._m_acquires.inc()

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._entry() is not None

    def __repr__(self) -> str:
        return f"DebugLock({self.name}, rank={self.rank})"


class LockFactory:
    """Hands out lock primitives: plain ``threading`` objects while
    ``enabled`` is False (zero overhead), rank-checked debug wrappers
    while True.  One process-global instance, flipped on by
    TpuShuffleManager when conf ``spark.shuffle.tpu.lockDebug`` is set
    — BEFORE any instrumented object creates its locks, mirroring the
    metrics registry's enable flow."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    def lock(self, name: str, rank: int):
        if not self.enabled:
            return threading.Lock()
        return DebugLock(name, rank, threading.Lock(), reentrant=False)

    def rlock(self, name: str, rank: int):
        if not self.enabled:
            return threading.RLock()
        return DebugLock(name, rank, threading.RLock(), reentrant=True)

    def condition(self, name: str, rank: int):
        if not self.enabled:
            return threading.Condition()
        return threading.Condition(
            DebugLock(name, rank, threading.RLock(), reentrant=True)
        )


GLOBAL_LOCK_FACTORY = LockFactory(enabled=False)


def get_lock_factory() -> LockFactory:
    return GLOBAL_LOCK_FACTORY


def dbg_lock(name: str, rank: int):
    """A mutex ranked ``rank`` in the canonical hierarchy (see README
    "Concurrency discipline"); tools/concheck.py reads the rank from
    this call, so no ``# lock-order`` comment is needed."""
    return GLOBAL_LOCK_FACTORY.lock(name, rank)


def dbg_rlock(name: str, rank: int):
    return GLOBAL_LOCK_FACTORY.rlock(name, rank)


def dbg_condition(name: str, rank: int):
    return GLOBAL_LOCK_FACTORY.condition(name, rank)


__all__ = [
    "DebugLock",
    "LockFactory",
    "LockOrderViolation",
    "dbg_condition",
    "dbg_lock",
    "dbg_rlock",
    "get_lock_factory",
    "held_locks",
]
