"""Unified observability: the process-wide metrics registry.

``counter()``/``gauge()``/``histogram()`` are the instrumented layers'
entry points — no-ops until a manager enables the global registry from
conf (``spark.shuffle.tpu.metrics``).  See registry.py for the model
and export.py for the Prometheus/JSON snapshot writers.
"""

from sparkrdma_tpu_torch.metrics.registry import (  # noqa: F401
    GLOBAL_REGISTRY,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    default_latency_buckets,
    default_size_buckets,
    gauge,
    get_registry,
    histogram,
)
from sparkrdma_tpu_torch.metrics.export import (  # noqa: F401
    diff_snapshots,
    to_prometheus,
    write_json_snapshot,
    write_prometheus,
)
