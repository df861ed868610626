"""Reader-side observability: remote-fetch latency histograms.

Analog of RdmaShuffleReaderStats (RdmaShuffleReaderStats.scala:29-79):
per-remote-host and global fixed-bucket latency histograms, printed at
manager stop.  Bucket geometry from conf
(fetchTimeBucketSizeInMs × fetchTimeNumBuckets; last bucket is
open-ended).

The bespoke histogram storage is retired onto the metrics registry
(metrics/registry.py): each per-host histogram IS a registry
``shuffle_fetch_latency_ms`` instrument (created with ``force=True``,
since these stats have their own conf gate), so fetch latencies appear
in Prometheus/JSON snapshots; this module keeps only the
print-at-stop FORMAT as a view over those instruments.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from sparkrdma_tpu_torch.conf import TpuShuffleConf
from sparkrdma_tpu_torch.metrics import Histogram, get_registry

logger = logging.getLogger(__name__)


class FetchHistogram:
    """Fixed linear-bucket view over a registry histogram.

    Bucket ``i`` covers ``[i*bucket_ms, (i+1)*bucket_ms)`` — a sample
    exactly on an edge lands in the upper bucket (the reference's
    ``latency // bucket_ms`` placement) — with the last bucket
    open-ended.  ``hist`` may be a shared registry instrument; when
    omitted a standalone one is created (tests)."""

    def __init__(self, bucket_ms: int, num_buckets: int,
                 hist: Optional[Histogram] = None):
        self.bucket_ms = bucket_ms
        self.num_buckets = num_buckets
        edges = [float(bucket_ms * (i + 1)) for i in range(num_buckets - 1)]
        if hist is None:
            hist = Histogram("shuffle_fetch_latency_ms", edges=edges)
        elif list(hist.edges) != edges:
            raise ValueError(
                f"histogram edges {hist.edges} do not match bucket "
                f"geometry {bucket_ms}ms x {num_buckets}"
            )
        self._hist = hist

    def add_sample(self, latency_ms: float) -> None:
        self._hist.observe(latency_ms)

    @property
    def total(self) -> int:
        return self._hist.count

    def to_string(self) -> str:
        counts = self._hist.counts
        parts = []
        for i, c in enumerate(counts):
            lo = i * self.bucket_ms
            if i == self.num_buckets - 1:
                parts.append(f"[{lo}ms+]: {c}")
            else:
                parts.append(f"[{lo}-{lo + self.bucket_ms}ms]: {c}")
        return ", ".join(parts)


class ShuffleReaderStats:
    """Per-remote-host fetch-latency histograms + a global one."""

    def __init__(self, conf: TpuShuffleConf):
        self.conf = conf
        self._bucket_ms = conf.fetch_time_bucket_size_ms
        self._num_buckets = conf.fetch_time_num_buckets
        self._global = self._make("all")
        self._per_host: Dict[str, FetchHistogram] = {}
        self._lock = threading.Lock()  # lock-order: 90

    def _make(self, host: str) -> FetchHistogram:
        edges = [
            float(self._bucket_ms * (i + 1))
            for i in range(self._num_buckets - 1)
        ]
        # geometry rides in the labels: instruments are process-global,
        # and a registry lookup only applies ``edges`` on FIRST
        # creation — without the geometry key, a second manager with a
        # different fetchTime bucket conf in the same process would get
        # the old instrument back and fail FetchHistogram's edge check
        inst = get_registry().histogram(
            "shuffle_fetch_latency_ms", edges=edges, force=True,
            host=host, bucket_ms=self._bucket_ms,
            buckets=self._num_buckets,
        )
        return FetchHistogram(self._bucket_ms, self._num_buckets, hist=inst)

    def update(self, host: str, latency_ms: float) -> None:
        with self._lock:
            hist = self._per_host.get(host)
            if hist is None:
                hist = self._per_host.setdefault(host, self._make(host))
        hist.add_sample(latency_ms)
        self._global.add_sample(latency_ms)

    def print_stats(self) -> str:
        """Log and return the formatted histograms (called at manager
        stop, reference RdmaShuffleManager.scala:349-351)."""
        lines = [f"remote fetch histogram (all hosts): {self._global.to_string()}"]
        with self._lock:
            hosts = dict(self._per_host)
        for host, hist in sorted(hosts.items()):
            lines.append(f"  {host}: {hist.to_string()}")
        text = "\n".join(lines)
        logger.info(text)
        return text
