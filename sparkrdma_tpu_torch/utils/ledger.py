"""Runtime resource-lifecycle sanitizer (conf resourceDebug).

The static gate (tools/flowcheck.py) proves the DECLARED lifecycle of
every credit/token/pin/fd resource balanced — each annotated acquire
has a release on all paths, no path releases twice, nothing releases
what it never owned.  This module validates the SAME lifecycles at
runtime, catching what statics cannot see: callback orderings, races,
chaos-test paths, and arithmetic bugs in the amounts.

``ResourceLedger`` is the dbglock/metrics-registry process-global
shape: disabled (the default) its :func:`ledger_acquire` hands out one
shared no-op ticket — zero steady-state overhead, identity-checkable
in tests; enabled (conf ``spark.shuffle.tpu.resourceDebug``, flipped
by TpuShuffleManager before it builds its node) every acquire returns
a live :class:`ResourceTicket` that

- records the acquisition site (a short caller-frame stack, the
  dbglock ``_call_site`` idiom),
- tracks the outstanding amount per resource
  (``resource_outstanding{resource=}`` gauge,
  ``resource_acquires_total`` counter),
- enforces one-shot release: releasing more than is outstanding,
  releasing a settled ticket again, or using a ticket after its
  ownership was transferred raises :class:`DoubleReleaseError` (and
  counts ``resource_double_release_total``),
- supports partial release down to zero and exactly-once ownership
  handoff (:meth:`ResourceTicket.transfer` — the annotated
  ``# owns: R -> target`` boundary, live-checked),

and :meth:`ResourceLedger.stop` renders the leak report: every ticket
still outstanding counts ``resource_leaked_total{resource=}``, logs
its acquisition-site stack at ERROR, and optionally raises
:class:`ResourceLeakError`.  ``tools/metrics_report.py`` renders the
resource series as a census table in snapshot diffs.

Tickets from a previous ledger epoch (the ledger was stopped/reset
since — e.g. a GC-tied tier pin whose weakref finalizer fires during
interpreter shutdown, after the manager already stopped) release as
silent no-ops: a late finalizer must never raise out of the GC.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.utils.statemachine import StateMachine

logger = logging.getLogger("sparkrdma_tpu_torch.ledger")

_LIVE, _CLOSED, _TRANSFERRED = "live", "closed", "transferred"


class DoubleReleaseError(RuntimeError):
    """A resource was released twice (or past zero) on one path."""


class ResourceLeakError(RuntimeError):
    """Resources were still outstanding when the ledger stopped."""


def _acquire_site(limit: int = 4) -> str:
    """Short caller-frame stack ('a.py:12 < b.py:88'), skipping this
    module's own frames (the dbglock ``_call_site`` idiom, deepened —
    a leak report needs the chain, not just the innermost line)."""
    frames: List[str] = []
    depth = 1
    while len(frames) < limit:
        try:
            f = sys._getframe(depth)
        except ValueError:
            break
        depth += 1
        fname = f.f_code.co_filename
        if fname == __file__:
            continue
        frames.append(f"{fname.rsplit('/', 1)[-1]}:{f.f_lineno}")
    return " < ".join(frames) if frames else "<unknown>"


class ResourceTicket(StateMachine):
    """One outstanding acquisition of ``amount`` units of a resource."""

    __slots__ = ("_ledger", "resource", "outstanding", "site",
                 "_epoch", "_state")

    MACHINE = "ledger.ticket"
    STATES = (_LIVE, _CLOSED, _TRANSFERRED)
    INITIAL = _LIVE
    TERMINAL = (_CLOSED, _TRANSFERRED)
    TRANSITIONS = {
        _LIVE: (_CLOSED, _TRANSFERRED),
    }

    def __init__(self, ledger: "ResourceLedger", resource: str,
                 amount: int, site: str, epoch: int):
        self._ledger = ledger
        self.resource = resource
        self.outstanding = amount  # guarded-by: (ledger) _lock
        self.site = site
        self._epoch = epoch  # guarded-by: (ledger) _lock
        self._state = _LIVE  # state: ledger.ticket guarded-by: ResourceLedger._lock

    def release(self, amount: Optional[int] = None) -> None:
        """Return ``amount`` units (default: all still outstanding).
        Partial releases compose down to zero but leave the ticket
        OPEN — only the no-argument form settles (closes) it, exactly
        once, so a fully-progressed fetch's final ``release()`` is
        clean while a second one raises.  Over-release, releasing a
        settled/transferred ticket, or a negative amount raises
        :class:`DoubleReleaseError`.  ``release(0)`` is always a
        no-op (an idempotent settle path's empty remainder)."""
        self._ledger._release(self, amount)

    def transfer(self) -> "ResourceTicket":
        """Hand the outstanding entry to a new owner EXACTLY once:
        returns a fresh ticket for the same outstanding amount and
        dead-ends this one (any further release/transfer through it
        raises).  The runtime check behind the static
        ``# owns: R -> target`` annotation."""
        return self._ledger._transfer(self)

    def __repr__(self) -> str:
        return (f"ResourceTicket({self.resource}, "
                f"outstanding={self.outstanding}, site={self.site})")


class _NoopTicket:
    """The disabled ledger's shared ticket: every field static, every
    method a no-op — ``ledger_acquire`` is then one attribute check
    plus one return."""

    __slots__ = ()
    resource = ""
    outstanding = 0
    site = "<disabled>"

    def release(self, amount: Optional[int] = None) -> None:
        return None

    def transfer(self) -> "_NoopTicket":
        return self


NOOP_TICKET = _NoopTicket()


class ResourceLedger:
    """Process-global outstanding-resource tracker (see module doc)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()  # lock-order: 97
        self._tickets: set = set()  # guarded-by: _lock
        self._epoch = 0  # guarded-by: _lock
        self._double_releases = 0  # guarded-by: _lock
        self._owners = 0  # guarded-by: _lock

    def retain(self) -> None:
        """Register one owner (a manager enabling resourceDebug).  The
        ledger is process-global, so in a multi-manager process (the
        in-process cluster tests) the FIRST manager to stop must not
        flush it: the other managers' cached channels and pools are
        legitimately still holding resources.  Each owner's
        :meth:`stop` decrements; only the LAST one renders the leak
        report.  A ledger nobody retained (unit tests driving it
        directly) flushes on the first :meth:`stop` as before."""
        with self._lock:
            self._owners += 1

    # -- acquire -------------------------------------------------------------
    def acquire(self, resource: str, amount: int = 1):
        """Record an acquisition of ``amount`` units; returns the
        ticket whose ``release``/``transfer`` settle it.  Disabled,
        returns the shared no-op ticket (identity-testable)."""
        if not self.enabled:
            return NOOP_TICKET
        amount = int(amount)
        site = _acquire_site()
        with self._lock:
            t = ResourceTicket(self, resource, amount, site, self._epoch)
            self._tickets.add(t)
        counter("resource_acquires_total", resource=resource).inc()
        gauge("resource_outstanding", resource=resource).inc(amount)
        return t

    # -- ticket back-ends ----------------------------------------------------
    def _release(self, t: ResourceTicket, amount: Optional[int]) -> None:
        if amount is not None and int(amount) == 0:
            return
        err = None
        with self._lock:
            if t._epoch != self._epoch:  # noqa: CK03 - ledger lock guards tickets
                return  # stale epoch: late GC finalizer, silent no-op
            if t._state == _TRANSFERRED:
                err = (f"{t.resource}: release through a ticket whose "
                       f"ownership was already transferred "
                       f"(acquired at {t.site})")
            elif t._state == _CLOSED:
                err = (f"{t.resource}: double release — ticket already "
                       f"fully settled (acquired at {t.site})")
            else:
                n = t.outstanding if amount is None else int(amount)
                if n < 0:
                    err = (f"{t.resource}: negative release amount {n} "
                           f"(acquired at {t.site})")
                elif n > t.outstanding:
                    err = (f"{t.resource}: released {n} > outstanding "
                           f"{t.outstanding} (acquired at {t.site})")
                else:
                    t.outstanding -= n
                    # only the no-argument settle CLOSES the ticket:
                    # a partial release that drains to zero leaves it
                    # open, because the settle path still owes its
                    # exactly-once final release() (the reader's
                    # per-stripe progress + settle() pairing)
                    if amount is None:
                        t._transition(_CLOSED, frm=_LIVE)
                    if t.outstanding == 0:
                        self._tickets.discard(t)
            if err is not None:
                self._double_releases += 1
        if err is not None:
            counter("resource_double_release_total").inc()
            raise DoubleReleaseError(err)
        gauge("resource_outstanding", resource=t.resource).dec(n)

    def _transfer(self, t: ResourceTicket):
        err = None
        with self._lock:
            if t._epoch != self._epoch:  # noqa: CK03 - ledger lock guards tickets
                return NOOP_TICKET  # stale epoch: nothing left to own
            if t._state != _LIVE:
                err = (f"{t.resource}: ownership transfer of a "
                       f"{'transferred' if t._state == _TRANSFERRED else 'settled'} "
                       f"ticket (acquired at {t.site})")
                self._double_releases += 1
            else:
                t._transition(_TRANSFERRED, frm=_LIVE)
                self._tickets.discard(t)
                nt = ResourceTicket(self, t.resource, t.outstanding,
                                    t.site, self._epoch)
                self._tickets.add(nt)
        if err is not None:
            counter("resource_double_release_total").inc()
            raise DoubleReleaseError(err)
        return nt

    # -- introspection / teardown --------------------------------------------
    def outstanding(self) -> Dict[str, int]:
        """Per-resource outstanding totals over the live tickets."""
        out: Dict[str, int] = {}
        with self._lock:
            for t in self._tickets:
                out[t.resource] = out.get(t.resource, 0) + t.outstanding
        return out

    def double_releases(self) -> int:
        with self._lock:
            return self._double_releases

    def leak_report(self) -> List[str]:
        """One line per leaked ticket: resource, amount, site stack."""
        with self._lock:
            tickets = sorted(
                self._tickets, key=lambda t: (t.resource, t.site)
            )
            return [
                f"{t.resource}: {t.outstanding} outstanding, "
                f"acquired at {t.site}"
                for t in tickets
            ]

    def stop(self, raise_on_leak: bool = False) -> Dict[str, int]:
        """Close the ledger epoch and render the leak report: every
        still-outstanding ticket counts
        ``resource_leaked_total{resource=}`` and logs its
        acquisition-site stack at ERROR.  Tickets from this epoch
        become silent no-ops (late GC finalizers must not raise).
        With ``raise_on_leak`` (tests), leaks raise
        :class:`ResourceLeakError` carrying the report.

        With outstanding owners (see :meth:`retain`) a stop only
        drops one owner; the flush happens at the last one."""
        with self._lock:
            if self._owners > 0:
                self._owners -= 1
                if self._owners > 0:
                    return {}
        report = self.leak_report()
        with self._lock:
            leaked: Dict[str, int] = {}
            for t in self._tickets:
                leaked[t.resource] = (
                    leaked.get(t.resource, 0) + t.outstanding
                )
            self._tickets.clear()
            self._epoch += 1
        for resource, total in sorted(leaked.items()):
            counter("resource_leaked_total", resource=resource).inc(total)
            gauge("resource_outstanding", resource=resource).set(0)
            logger.error("resource leak: %s units of %s still "
                         "outstanding at ledger stop", total, resource)
        for line in report:
            logger.error("  leaked %s", line)
        if leaked:
            # a leak at ledger stop is a lifecycle bug — leave the
            # flight recorder's view of the run's tail next to the
            # leak report (obs/; lazy import keeps utils/ base-level)
            from sparkrdma_tpu_torch.obs import RECORDER, fr_event

            if RECORDER.enabled:
                fr_event(
                    "faults", "ledger_leak",
                    resources=len(leaked), units=sum(leaked.values()),
                )
                RECORDER.auto_dump("ledger_leak")
        if leaked and raise_on_leak:
            raise ResourceLeakError(
                f"{sum(leaked.values())} unit(s) of "
                f"{len(leaked)} resource(s) leaked:\n  "
                + "\n  ".join(report)
            )
        return leaked

    def reset(self) -> None:
        """Drop every ticket and start a fresh epoch (tests)."""
        with self._lock:
            resources = {t.resource for t in self._tickets}
            self._tickets.clear()
            self._epoch += 1
            self._double_releases = 0
            self._owners = 0
        for resource in resources:
            gauge("resource_outstanding", resource=resource).set(0)


GLOBAL_RESOURCE_LEDGER = ResourceLedger(enabled=False)


def get_resource_ledger() -> ResourceLedger:
    return GLOBAL_RESOURCE_LEDGER


def ledger_acquire(resource: str, amount: int = 1):
    """Record an acquisition against the process-global ledger; the
    returned ticket's ``release``/``transfer`` settle it.  Call sites
    carry the matching ``# acquires:``/``# owns:`` annotations that
    tools/flowcheck.py checks statically."""
    return GLOBAL_RESOURCE_LEDGER.acquire(resource, amount)


__all__ = [
    "DoubleReleaseError",
    "NOOP_TICKET",
    "ResourceLedger",
    "ResourceLeakError",
    "ResourceTicket",
    "get_resource_ledger",
    "ledger_acquire",
]
