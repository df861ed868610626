"""Multi-tenant QoS: weighted credit brokering, lane/serve priority
classes, admission control, and the live metrics endpoint.

"Millions of users" means many concurrent shuffles sharing one node's
serve pool, decode pool, lane pool and registered memory — and every
one of those credit pools was a single global FIFO, so one bulk tenant
could park all serve credits and starve a latency-sensitive tenant's
RPCs (ROADMAP item 5).  *RDMAvisor* (PAPERS.md) argues a shared RDMA
fabric needs a mediating service layer with per-consumer resource
policy; *fabric-lib* ships priority-aware transfer scheduling.  This
package is that layer over the credit-pool pattern PRs 3/5/7/8
established:

- :mod:`~sparkrdma_tpu_torch.qos.registry` — the process-global
  :class:`TenantRegistry`: every shuffle registers under a tenant id
  (conf ``spark.shuffle.tpu.tenant``, default per-shuffle) with a
  weight and priority class, plus admission control on registration
  (``qosTenantMaxBytes`` — an over-quota tenant queues briefly, then
  DEGRADES: narrower stripes, cold-tier serves — never an OOM).
- :mod:`~sparkrdma_tpu_torch.qos.broker` — :class:`WeightedCreditBroker`
  and :class:`CreditLedger`: the byte-credit pools (serve pool,
  decode pool, reader ``maxBytesInFlight``, tier hot budget) acquire
  credits through a weighted max-min ledger with work-conservation
  (idle tenants' shares are borrowable, reclaimed on demand) and FIFO
  handoff within (class, tenant); :class:`ClassedTaskQueue` dequeues
  interactive-class work (RPC frames, small reads — the dedicated
  small-read lane, generalized) ahead of bulk with anti-starvation
  aging.
- :mod:`~sparkrdma_tpu_torch.qos.http` — :class:`MetricsHttpServer`: the
  stop-time Prometheus dump as an always-on HTTP scrape endpoint
  (conf ``metricsHttpPort``), with per-tenant labels on the brokered
  instruments.

All policy is off by default: with ``qosEnabled=false`` the brokers
compile down to the existing pools (plain FIFO credits, unclassed
queues — A/B-able), and the only behavioral delta from the pre-QoS
tree is the serve pool's explicit FIFO credit handoff (the starvation
fix an oversized clamped serve needed regardless of QoS).
"""

from sparkrdma_tpu_torch.qos.broker import (
    BULK,
    INTERACTIVE,
    ClassedTaskQueue,
    CreditLedger,
    WeightedCreditBroker,
)
from sparkrdma_tpu_torch.qos.registry import (
    Tenant,
    TenantRegistry,
    get_qos,
)

__all__ = [
    "BULK",
    "INTERACTIVE",
    "ClassedTaskQueue",
    "CreditLedger",
    "Tenant",
    "TenantRegistry",
    "WeightedCreditBroker",
    "get_qos",
]
