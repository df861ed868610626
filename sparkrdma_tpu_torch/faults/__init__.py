"""Fault-injection plane + recovery policy (conf faultInject).

The injector is the metrics/dbglock/ledger process-global shape:
disabled (the default) every woven fault point is one attribute check
(``FAULTS.enabled``); armed (conf ``spark.shuffle.tpu.faultInject``,
flipped by TpuShuffleManager before it builds its node) the named
points fire deterministically from a seeded spec.  See injector.py
for the spec grammar, retry.py for the backoff/deadline policy, and
breaker.py for the per-peer circuit breaker + stripe health signal.
"""

from sparkrdma_tpu_torch.faults.injector import (  # noqa: F401
    FAULTS,
    FaultInjectedError,
    FaultInjector,
    FaultSpecError,
    parse_fault_spec,
)
from sparkrdma_tpu_torch.faults.retry import (  # noqa: F401
    RetryPolicy,
    is_transient,
)
from sparkrdma_tpu_torch.faults.breaker import (  # noqa: F401
    CircuitBreaker,
    PeerHealth,
    StripeHealth,
)
