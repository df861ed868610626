"""Weighted credit brokering + priority-classed dequeue.

The byte-credit pools PRs 3/5/7/8 built (serve pool, decode pool,
reader ``maxBytesInFlight``, tier hot budget) all shared one shape: a
global budget, FIFO waiters, first-come-first-served grants.  Correct
for one consumer, starvation-prone for many: a bulk tenant that keeps
the budget saturated parks every other tenant's work behind its own.
This module is the mediation layer (the RDMAvisor "RDMA as a service"
idiom) those pools now acquire through:

- :class:`CreditLedger` — the caller-locked policy core: per-tenant
  usage against **weighted max-min shares** with work-conservation
  (an idle tenant's share is borrowable; a borrower is reclaimed on
  demand — its further grants pause while a deprived tenant waits),
  plus the per-tenant in-flight quota (``qosTenantMaxInFlight``).
- :class:`WeightedCreditBroker` — the blocking facade over a ledger:
  explicit **FIFO handoff** (grants go to waiters in arrival order —
  within one (class, tenant) stream nothing bypasses the head, so a
  clamped oversized acquisition cannot be starved by a stream of
  small ones), interactive-before-bulk classing with anti-starvation
  **aging** (a bulk waiter older than ``qosAgingMs`` is promoted),
  and release pumps for non-blocking acquirers (the reader window).
- :class:`ClassedTaskQueue` — the pool-worker dequeue with the same
  class/aging policy (the serve pool's FIFO generalized; the
  dedicated small-read lane was the precedent).

With QoS off (no tenant registry attached) both collapse to plain
FIFO semantics over a single budget — byte-for-byte the pre-QoS
behavior, except that credit handoff is now explicitly FIFO (the
serve-pool fairness fix).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.qos.registry import BULK, INTERACTIVE, Tenant

_EMPTY = object()


def weighted_shares(budget: int, qos, usage: Dict[str, int],
                    extra: Optional[Dict[str, Tenant]] = None
                    ) -> Dict[str, float]:
    """THE weighted max-min share formula, shared by every brokered
    budget (credit ledgers, the tier's hot budget): shares split
    ``budget`` by weight over the ACTIVE tenants only — usage > 0 or
    present in ``extra`` (waiters/requesters) — so idle tenants don't
    dilute the split, which is exactly what makes idle shares
    borrowable."""
    active: Dict[str, int] = {}
    if qos is not None:
        for t in qos.tenants():
            if usage.get(t.name, 0) > 0:
                active[t.name] = t.weight
        for name, t in (extra or {}).items():
            active.setdefault(name, t.weight)
    total = sum(active.values())
    if total <= 0:
        return {}
    return {name: budget * w / total for name, w in active.items()}


class CreditLedger:
    """Per-tenant credit accounting over one byte budget.  NOT
    self-locking: every method runs under the owning pool's condition
    (the broker's injected cv, or the decode pool's own) — the ledger
    is the policy, the caller owns the mutual exclusion."""

    __slots__ = ("name", "budget", "free", "qos", "quota_inflight",
                 "_used")

    def __init__(self, name: str, budget: int, qos=None,
                 quota_inflight: bool = False):
        self.name = name
        self.budget = max(int(budget), 1)
        self.free = self.budget
        # the tenant registry when QoS policy is on; None = plain
        # single-budget FIFO credits (the pre-QoS pools)
        self.qos = qos
        # enforce Tenant.max_inflight on this ledger (the reader
        # window's broker; serve/decode budgets have no per-tenant cap)
        self.quota_inflight = quota_inflight
        self._used: Dict[str, int] = {}

    def used(self, tenant: Optional[Tenant]) -> int:
        if tenant is None:
            return self.budget - self.free
        return self._used.get(tenant.name, 0)

    def shares(self, waiting: Optional[Dict[str, Tenant]] = None
               ) -> Dict[str, float]:
        """This budget's weighted max-min shares (see
        :func:`weighted_shares`); ``waiting`` marks tenants active."""
        return weighted_shares(self.budget, self.qos, self._used,
                               waiting)

    def can_take(self, tenant: Optional[Tenant], cost: int,
                 waiting: Optional[Dict[str, Tenant]] = None) -> bool:
        """Grant policy for one acquisition.  Work-conserving: a
        tenant under its share (or with nothing in flight — every
        tenant can always run ONE item) takes freely; a tenant over
        its share may keep borrowing only while no OTHER tenant is
        deprived (waiting with usage below its own share) — that
        pause is the reclaim-on-demand."""
        if self.free < cost:
            return False
        if self.qos is None or tenant is None:
            return True
        used = self._used.get(tenant.name, 0)
        if (self.quota_inflight and tenant.max_inflight > 0
                and used + cost > max(tenant.max_inflight, cost)):
            return False
        shares = self.shares(waiting)
        if used == 0 or used + cost <= shares.get(tenant.name, 0):
            return True
        for name, t in (waiting or {}).items():
            if name == tenant.name:
                continue
            if self._used.get(name, 0) < shares.get(name, 0):
                return False  # reclaim: the deprived waiter goes first
        return True

    def take(self, tenant: Optional[Tenant], cost: int) -> None:
        self.free -= cost
        if tenant is not None:
            self._used[tenant.name] = (
                self._used.get(tenant.name, 0) + cost
            )
            counter("qos_granted_bytes_total", pool=self.name,
                    tenant=tenant.name).inc(cost)
            gauge("qos_in_flight_bytes", pool=self.name,
                  tenant=tenant.name).inc(cost)

    def put(self, tenant: Optional[Tenant], cost: int) -> None:
        self.free = min(self.budget, self.free + cost)
        if tenant is not None:
            left = max(0, self._used.get(tenant.name, 0) - cost)
            if left:
                self._used[tenant.name] = left
            else:
                self._used.pop(tenant.name, None)
            gauge("qos_in_flight_bytes", pool=self.name,
                  tenant=tenant.name).dec(cost)


class _Waiter:
    __slots__ = ("cost", "tenant", "cls", "t0", "granted")

    def __init__(self, cost: int, tenant: Optional[Tenant], cls: str):
        self.cost = cost
        self.tenant = tenant
        self.cls = cls
        self.t0 = time.monotonic()
        self.granted = False


class WeightedCreditBroker:
    """Blocking credit gate over a :class:`CreditLedger` with explicit
    FIFO handoff, priority classes, and aging.  The condition variable
    is INJECTED by the owning pool (node.py / manager.py create it via
    ``dbg_condition`` so the rank lands in the caller's hierarchy)."""

    def __init__(self, name: str, budget: int, cv, qos=None,
                 classed: bool = False, aging_ms: int = 100,
                 quota_inflight: bool = False, wait_counter=None):
        self.name = name
        self.ledger = CreditLedger(
            name, budget, qos=qos, quota_inflight=quota_inflight
        )
        self._cv = cv
        self._classed = bool(classed) and qos is not None
        self._aging_s = max(aging_ms, 0) / 1000.0
        self._waiters: List[_Waiter] = []
        self._pumps: List = []
        self._stopped = False
        # bumped on every release: a NON-BLOCKING acquirer that was
        # denied compares this across its deny-and-requeue window to
        # detect a release whose pump ran before the requeue was
        # visible (the lost-wakeup race), and retries itself
        self.release_seq = 0
        # the owning pool's legacy credit-wait counter (kept so the
        # pre-QoS series keep reporting), plus per-tenant wait time
        self._wait_counter = wait_counter

    @property
    def budget(self) -> int:
        return self.ledger.budget

    @property
    def free(self) -> int:
        with self._cv:
            return self.ledger.free

    def clamp(self, cost: int) -> int:
        """An acquisition larger than the whole budget clamps to it
        and runs alone rather than deadlocking (every pool's
        oversized-item contract)."""
        return min(max(int(cost), 0), self.ledger.budget)

    # -- blocking acquire ---------------------------------------------------
    def acquire(self, cost: int, tenant: Optional[Tenant] = None,
                cls: str = BULK) -> bool:
        """Block until granted (FIFO within (class, tenant), classes
        and shares permitting) or the broker stops; returns False only
        on stop.  Safe to call with no other lock held ONLY."""
        cost = self.clamp(cost)
        waited_t0 = None
        with self._cv:
            w = _Waiter(cost, tenant, cls)
            self._waiters.append(w)
            self._grant_locked()
            while not w.granted and not self._stopped:
                if waited_t0 is None:
                    waited_t0 = time.monotonic()
                    if self._wait_counter is not None:
                        self._wait_counter.inc()
                    if RECORDER.enabled:
                        fr_event(
                            "qos", "credit_block",
                            pool=self.name, bytes=cost,
                            tenant=tenant.name if tenant else "",
                        )
                self._cv.wait(timeout=0.5)
                self._grant_locked()  # periodic re-scan drives aging
            self._waiters.remove(w)
            if w.granted and self._stopped:
                # stop raced the grant: nothing will run — return it
                self.ledger.put(tenant, cost)
                return False
            granted = w.granted
        if waited_t0 is not None and tenant is not None:
            counter("qos_credit_wait_ms_total", pool=self.name,
                    tenant=tenant.name).inc(
                int((time.monotonic() - waited_t0) * 1000)
            )
        return granted

    def try_acquire(self, cost: int, tenant: Optional[Tenant] = None,
                    cls: str = BULK) -> bool:
        """Non-blocking acquire: joins the waiter list for one grant
        scan (so it cannot bypass an earlier waiter of its own class +
        tenant) and leaves immediately if not granted."""
        cost = self.clamp(cost)
        with self._cv:
            if self._stopped:
                return False
            w = _Waiter(cost, tenant, cls)
            self._waiters.append(w)
            self._grant_locked()
            self._waiters.remove(w)
            granted = w.granted
        if not granted and RECORDER.enabled:
            fr_event(
                "qos", "credit_block",
                pool=self.name, bytes=cost,
                tenant=tenant.name if tenant else "",
            )
        return granted

    def release(self, cost: int, tenant: Optional[Tenant] = None) -> None:
        with self._cv:
            self.ledger.put(tenant, self.clamp(cost))
            self.release_seq += 1
            self._grant_locked()
            pumps = list(self._pumps)
        # pumps run OUTSIDE the broker lock: a non-blocking acquirer
        # (the reader window) re-pumps its pending queue from here
        for fn in pumps:
            try:
                fn()
            except BaseException:  # pump must never poison a release
                pass

    # -- pumps (non-blocking acquirers) -------------------------------------
    def add_pump(self, fn) -> None:
        with self._cv:
            if fn not in self._pumps:
                self._pumps.append(fn)

    def remove_pump(self, fn) -> None:
        with self._cv:
            try:
                self._pumps.remove(fn)
            except ValueError:
                pass

    # -- grant scan (cv held) ------------------------------------------------
    def _effective_hi(self, w: _Waiter, now: float) -> bool:
        return w.cls == INTERACTIVE or (
            self._aging_s > 0 and now - w.t0 >= self._aging_s
        )

    def _grant_locked(self) -> None:
        if not self._waiters:
            return
        now = time.monotonic()
        if self._classed:
            hi = [w for w in self._waiters if self._effective_hi(w, now)]
            lo = [w for w in self._waiters
                  if not self._effective_hi(w, now)]
            order = hi + lo
        else:
            order = self._waiters
        waiting = {
            w.tenant.name: w.tenant
            for w in self._waiters
            if w.tenant is not None and not w.granted
        }
        blocked: set = set()
        granted_any = False
        for w in order:
            if w.granted:
                continue
            if self.ledger.qos is None:
                key = ""  # plain mode: STRICT FIFO — no bypass at all
            else:
                # FIFO within the DECLARED (class, tenant) stream —
                # aging must not change the key, or an aged bulk
                # waiter would stop blocking fresh same-stream
                # waiters and could be bypassed forever (the exact
                # starvation this broker exists to fix)
                key = (
                    w.cls if self._classed else "",
                    w.tenant.name if w.tenant is not None else "",
                )
            if key in blocked:
                continue  # FIFO within (class, tenant)
            if self.ledger.can_take(w.tenant, w.cost, waiting):
                self.ledger.take(w.tenant, w.cost)
                w.granted = True
                granted_any = True
                if w.tenant is not None:
                    waiting.pop(w.tenant.name, None)
            else:
                blocked.add(key)
                if (self._effective_hi(w, now)
                        and self.ledger.free < w.cost):
                    # an AGED (or interactive) head short of raw
                    # credits becomes a barrier: nothing behind it may
                    # drain the freed credits it is accumulating —
                    # bounded starvation for clamped oversized work.
                    # Policy blocks (over-share while a deprived
                    # tenant waits) deliberately do NOT barrier: the
                    # deprived waiter behind must stay grantable or
                    # the reclaim could livelock.
                    break
        if granted_any:
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


class ClassedTaskQueue:
    """Pool-worker task queue with interactive-before-bulk dequeue and
    anti-starvation aging; unclassed (the default) it is a plain FIFO
    — byte-identical ordering to the ``queue.Queue`` it replaces.
    ``None`` items are worker-stop sentinels and always dequeue LAST
    (after real work drains), like the pools' stop paths expect.  The
    condition is injected by the owner (rank lands at its creation
    site)."""

    def __init__(self, cv, classed: bool = False, aging_ms: int = 100):
        self._cv = cv
        self._classed = bool(classed)
        self._aging_s = max(aging_ms, 0) / 1000.0
        self._hi: deque = deque()
        self._lo: deque = deque()
        self._sentinels = 0

    def put(self, item, cls: str = BULK) -> None:
        if item is None:
            self.put_sentinel()
            return
        with self._cv:
            q = (
                self._hi if (self._classed and cls == INTERACTIVE)
                else self._lo
            )
            q.append((time.monotonic(), item))
            self._cv.notify_all()

    def put_sentinel(self) -> None:
        with self._cv:
            self._sentinels += 1
            self._cv.notify_all()

    def get(self):
        """Pop the next task by class policy; ``None`` = stop."""
        with self._cv:
            while True:
                item = self._pop_locked()
                if item is not _EMPTY:
                    return item
                if self._sentinels > 0:
                    self._sentinels -= 1
                    return None
                self._cv.wait()

    def _pop_locked(self):
        if self._classed and self._lo and self._aging_s > 0:
            # aged bulk head outranks fresh interactive work: bulk
            # class never starves behind a steady interactive stream
            if time.monotonic() - self._lo[0][0] >= self._aging_s:
                return self._lo.popleft()[1]
        if self._hi:
            return self._hi.popleft()[1]
        if self._lo:
            return self._lo.popleft()[1]
        return _EMPTY

    def drain_nowait(self) -> list:
        """Pop every queued task without blocking (pool stop path)."""
        with self._cv:
            items = [it for _t, it in self._hi]
            items += [it for _t, it in self._lo]
            self._hi.clear()
            self._lo.clear()
            return items

    def qsize(self) -> int:
        with self._cv:
            return len(self._hi) + len(self._lo)


__all__ = [
    "BULK",
    "INTERACTIVE",
    "ClassedTaskQueue",
    "CreditLedger",
    "WeightedCreditBroker",
]
