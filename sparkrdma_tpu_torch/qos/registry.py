"""Tenant registry + admission control (the QoS control plane).

One process-global :class:`TenantRegistry` (the metrics-registry /
lock-factory shape: managers flip ``enabled`` from conf ``qosEnabled``
before building their node, so every pool created after that consults
it).  A tenant is a named share of the node's resources:

- **weight** — its proportion of every brokered byte-credit budget
  under weighted max-min sharing (qos/broker.py),
- **priority class** — ``interactive`` work dequeues ahead of ``bulk``
  on the serve pool and borrows stripe lanes from the reserved slice
  of the lane pool,
- **quotas** — ``max_bytes`` caps the tenant's registered (committed)
  map-output bytes and ``max_inflight`` its brokered in-flight fetch
  bytes; :meth:`TenantRegistry.admit` makes an over-quota tenant QUEUE
  briefly for capacity and then DEGRADE (narrower stripes, cold-tier
  serves — see stripe.py/tier.py) rather than OOM the node.

Shuffles bind to tenants (``bind_shuffle``; conf
``spark.shuffle.tpu.tenant``, default one tenant per shuffle), and the
serve path resolves the tenant of an incoming read from the target
mkey through the node's block stores (``Node.tenant_of_mkey``), so the
responder applies the owner's policy without any wire change.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.utils.ledger import ledger_acquire

#: priority classes on the scheduling edges (qos/broker.py)
INTERACTIVE = "interactive"
BULK = "bulk"


class Tenant:
    """One tenant's policy + live accounting.  ``degraded`` is read
    lock-free on hot paths (a racy read only delays the mode flip by
    one operation — the flag is sticky until admission pressure
    clears)."""

    __slots__ = ("name", "weight", "priority", "max_bytes",
                 "max_inflight", "registered_bytes", "degraded")

    def __init__(self, name: str):
        self.name = name
        self.weight = 1
        self.priority = BULK
        self.max_bytes = 0      # 0 = unlimited registered bytes
        self.max_inflight = 0   # 0 = unlimited brokered in-flight bytes
        self.registered_bytes = 0  # guarded-by: (registry) _cv
        self.degraded = False

    @property
    def interactive(self) -> bool:
        return self.priority == INTERACTIVE

    def __repr__(self) -> str:
        return (
            f"Tenant({self.name!r}, w={self.weight}, {self.priority}"
            f"{', degraded' if self.degraded else ''})"
        )


class TenantRegistry:
    """Process-global tenant table: get-or-create tenants, shuffle →
    tenant bindings, and registered-byte admission control."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        # admission waiters block on this condition only (never under
        # another lock); ranked with the other leaf bookkeeping locks
        self._cv = threading.Condition()  # lock-order: 95
        self._tenants: Dict[str, Tenant] = {}  # guarded-by: _cv
        self._shuffle_tenant: Dict[int, str] = {}  # guarded-by: _cv
        # shuffle → admitted registered bytes (released at unregister)
        self._admitted: Dict[int, int] = {}  # guarded-by: _cv
        # resource: qos.admitted_bytes (per-shuffle admitted quota bytes)
        self._admit_tkts: Dict[int, list] = {}  # guarded-by: _cv

    # -- tenants -------------------------------------------------------------
    def tenant(self, name: str, weight: Optional[int] = None,
               priority: Optional[str] = None,
               max_bytes: Optional[int] = None,
               max_inflight: Optional[int] = None) -> Tenant:
        """Get-or-create ``name``; explicit parameters update the
        tenant (last writer wins — re-registration with new weights is
        how a tenant's policy changes at runtime)."""
        with self._cv:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name)
            if weight is not None:
                t.weight = max(1, int(weight))
            if priority is not None:
                t.priority = (
                    INTERACTIVE if str(priority).lower() == INTERACTIVE
                    else BULK
                )
            if max_bytes is not None:
                t.max_bytes = max(0, int(max_bytes))
            if max_inflight is not None:
                t.max_inflight = max(0, int(max_inflight))
            return t

    def tenants(self) -> List[Tenant]:
        with self._cv:
            return list(self._tenants.values())

    def bind_shuffle(self, shuffle_id: int, tenant: Tenant) -> None:
        with self._cv:
            self._shuffle_tenant[shuffle_id] = tenant.name

    def tenant_of_shuffle(self, shuffle_id) -> Optional[Tenant]:
        if shuffle_id is None:
            return None
        with self._cv:
            name = self._shuffle_tenant.get(shuffle_id)
            return self._tenants.get(name) if name is not None else None

    # -- admission control ---------------------------------------------------
    def admit(self, shuffle_id: int, tenant: Tenant, nbytes: int,
              wait_s: float = 0.0) -> bool:
        """Admit ``nbytes`` of committed map output under ``tenant``'s
        registered-byte quota.  Over quota the caller QUEUES up to
        ``wait_s`` for earlier shuffles to release, then proceeds in
        DEGRADED mode (the output still commits — refusing it would
        fail the map task; degrading sheds the tenant's resource
        appetite instead: stripes narrow and the tier stops promoting
        its blocks).  Returns True when admitted within quota."""
        nbytes = max(int(nbytes), 0)
        with self._cv:
            if tenant.max_bytes > 0:
                deadline = time.monotonic() + max(wait_s, 0.0)
                while (tenant.registered_bytes + nbytes > tenant.max_bytes
                       and not tenant.degraded):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    counter("qos_admission_waits_total",
                            tenant=tenant.name).inc()
                    self._cv.wait(left)
            over = (tenant.max_bytes > 0
                    and tenant.registered_bytes + nbytes > tenant.max_bytes)
            tenant.registered_bytes += nbytes
            self._admitted[shuffle_id] = (
                self._admitted.get(shuffle_id, 0) + nbytes
            )
            # the admitted quota rides the shuffle until unregister
            # owns: qos.admitted_bytes -> release_shuffle
            # owns: qos.admitted_bytes -> reset
            self._admit_tkts.setdefault(shuffle_id, []).append(
                ledger_acquire("qos.admitted_bytes", nbytes)
            )  # acquires: qos.admitted_bytes
            # an admit IS a binding: release_shuffle must find the
            # tenant even if bind_shuffle never ran in this process
            self._shuffle_tenant.setdefault(shuffle_id, tenant.name)
            if over:
                tenant.degraded = True
                counter("qos_admission_rejections_total",
                        tenant=tenant.name).inc()
            gauge("qos_tenant_registered_bytes",
                  tenant=tenant.name).set(tenant.registered_bytes)
            gauge("qos_tenant_degraded", tenant=tenant.name).set(
                1 if tenant.degraded else 0
            )
        return not over

    def release_shuffle(self, shuffle_id: int) -> None:
        """Unregister hook: return the shuffle's admitted bytes and
        clear its binding; a tenant back under quota leaves degraded
        mode and queued admissions re-check."""
        with self._cv:
            nbytes = self._admitted.pop(shuffle_id, 0)
            tkts = self._admit_tkts.pop(shuffle_id, ())
            name = self._shuffle_tenant.pop(shuffle_id, None)
            t = self._tenants.get(name) if name is not None else None
            if t is not None:
                t.registered_bytes = max(0, t.registered_bytes - nbytes)
                if t.degraded and (
                    t.max_bytes <= 0 or t.registered_bytes <= t.max_bytes
                ):
                    t.degraded = False
                gauge("qos_tenant_registered_bytes",
                      tenant=t.name).set(t.registered_bytes)
                gauge("qos_tenant_degraded", tenant=t.name).set(
                    1 if t.degraded else 0
                )
                self._cv.notify_all()
        for tkt in tkts:
            tkt.release()  # releases: qos.admitted_bytes

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-able view for the scrape endpoint's ``/tenants``."""
        with self._cv:
            return {
                "enabled": self.enabled,
                "tenants": [
                    {
                        "name": t.name,
                        "weight": t.weight,
                        "priority": t.priority,
                        "max_bytes": t.max_bytes,
                        "max_inflight": t.max_inflight,
                        "registered_bytes": t.registered_bytes,
                        "degraded": t.degraded,
                    }
                    for t in self._tenants.values()
                ],
                "shuffles": dict(self._shuffle_tenant),
            }

    def reset(self) -> None:
        """Drop every tenant and binding (tests)."""
        with self._cv:
            self._tenants.clear()
            self._shuffle_tenant.clear()
            self._admitted.clear()
            tkts = [t for ts in self._admit_tkts.values() for t in ts]
            self._admit_tkts.clear()
            self._cv.notify_all()
        for tkt in tkts:
            tkt.release()  # releases: qos.admitted_bytes


# the process-global registry; managers enable it from conf qosEnabled
GLOBAL_QOS = TenantRegistry(enabled=False)


def get_qos() -> TenantRegistry:
    return GLOBAL_QOS
