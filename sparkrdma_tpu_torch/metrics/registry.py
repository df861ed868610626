"""Process-wide metrics registry: counters, gauges, log-scale histograms.

The reference's only runtime observability is the reader-side fetch
histograms printed at manager stop (RdmaShuffleReaderStats.scala:29-79).
RDMA-era systems ship per-transfer counters as a first-class API
(PAPERS.md: fabric-lib exposes transfer counters and completion
latencies; RDMAbox attributes throughput loss to specific stages only
because every stage is counted) — this module is that layer for the
rebuild: one process-wide :class:`MetricsRegistry` of labeled
instruments that every runtime layer (transport, shuffle, memory)
records into.

Design constraints:

- **Zero overhead when disabled** (the default): the module-level
  ``counter()``/``gauge()``/``histogram()`` helpers return shared no-op
  singletons while the global registry is disabled, so instrumented hot
  paths cost one attribute call on a ``pass`` method.  Enabled via conf
  ``spark.shuffle.tpu.metrics`` (TpuShuffleManager flips the global
  registry on, exactly like the tracer).
- **Thread safety**: counters are lock-striped (8 cells, one assigned
  per thread round-robin) so concurrent writers on the transport pools
  don't serialize on one lock; gauges and histograms take one leaf
  lock each.
- **Stable identity**: an instrument is (kind, name, sorted labels);
  repeated lookups return the same object, so call sites may fetch
  handles at construction time or per call.

Snapshots/exposition live in :mod:`sparkrdma_tpu_torch.metrics.export`.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_N_STRIPES = 8

# per-thread stripe index, assigned round-robin on first use.  NOT
# derived from get_ident(): CPython thread ids are aligned pthread
# struct addresses, so ``get_ident() % 8`` is 0 for every thread and
# would collapse the striping onto one lock.
_STRIPE_TLS = threading.local()
_STRIPE_SEQ = itertools.count()


def _stripe() -> int:
    idx = getattr(_STRIPE_TLS, "idx", None)
    if idx is None:
        idx = _STRIPE_TLS.idx = next(_STRIPE_SEQ) % _N_STRIPES
    return idx


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def default_latency_buckets() -> List[float]:
    """Log-scale (1-2.5-5 decade ladder) bucket upper bounds, tuned for
    millisecond latencies: 0.05ms .. 10s, open-ended above."""
    edges: List[float] = []
    for decade in (0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0):
        for m in (0.5, 1.0, 2.5, 5.0):
            edges.append(decade * m)
    # 0.5 * next decade == 5 * this one: dedupe
    return sorted(set(round(x, 6) for x in edges))


def default_size_buckets() -> List[float]:
    """Power-of-4 byte-size ladder: 256B .. 4GiB."""
    return [float(1 << s) for s in range(8, 33, 2)]


class Counter:
    """Monotonic counter, lock-striped across ``_N_STRIPES`` cells."""

    __slots__ = ("name", "labels", "_cells", "_locks")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._cells = [0] * _N_STRIPES
        # metric leaf locks rank LAST (98): instruments record from
        # under every other lock in the process; plain threading (not
        # dbglock) because the sanitizer's own telemetry lands here
        self._locks = [threading.Lock() for _ in range(_N_STRIPES)]  # lock-order: 98

    def inc(self, n: int = 1) -> None:
        i = _stripe()
        with self._locks[i]:
            self._cells[i] += n

    @property
    def value(self) -> float:
        total = 0
        for i in range(_N_STRIPES):
            with self._locks[i]:
                total += self._cells[i]
        return total


class Gauge:
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()  # lock-order: 98

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bucketed distribution.  ``edges`` are EXCLUSIVE upper bounds:
    a sample exactly on an edge lands in the NEXT bucket (matching the
    reference reader-stats placement ``latency // bucket_ms``,
    RdmaShuffleReaderStats.scala:38-44); one overflow bucket catches
    everything past the last edge.  Default edges are the log-scale
    latency ladder."""

    __slots__ = ("name", "labels", "edges", "_counts", "_sum", "_lock")

    def __init__(self, name: str, labels: LabelKey = (),
                 edges: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = labels
        self.edges = list(edges) if edges is not None \
            else default_latency_buckets()
        if sorted(self.edges) != self.edges:
            raise ValueError(f"bucket edges must ascend: {self.edges}")
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()  # lock-order: 98

    def observe(self, v: float) -> None:
        idx = bisect.bisect_right(self.edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v

    @contextlib.contextmanager
    def time(self):
        """Observe the wall-clock milliseconds of the with-block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe((time.perf_counter() - t0) * 1000.0)

    @property
    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _NullCounter:
    """Shared no-op counter handle (registry disabled)."""

    __slots__ = ()
    name = ""
    labels: LabelKey = ()
    value = 0.0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = ""
    labels: LabelKey = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1) -> None:
        pass

    def dec(self, n: float = 1) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = ""
    labels: LabelKey = ()
    edges: List[float] = []
    counts: List[int] = []
    count = 0
    sum = 0.0

    def observe(self, v: float) -> None:
        pass

    @contextlib.contextmanager
    def time(self):
        yield


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Registry of labeled instruments.

    ``enabled`` gates the handle factories: while False they hand back
    the shared no-op singletons (unless ``force=True`` — used by
    subsystems with their own conf gate, e.g. the reader stats).  Real
    instruments created while enabled keep recording even if the flag
    is later cleared — only NEW handle lookups become no-ops."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._instruments: Dict[Tuple[str, str, LabelKey], object] = {}
        self._lock = threading.Lock()  # lock-order: 96

    # -- handle factories ---------------------------------------------------
    def counter(self, name: str, force: bool = False, **labels) -> Counter:
        if not (self.enabled or force):
            return NULL_COUNTER
        return self._get("counter", name, _label_key(labels),
                         lambda k: Counter(name, k))

    def gauge(self, name: str, force: bool = False, **labels) -> Gauge:
        if not (self.enabled or force):
            return NULL_GAUGE
        return self._get("gauge", name, _label_key(labels),
                         lambda k: Gauge(name, k))

    def histogram(self, name: str, edges: Optional[Sequence[float]] = None,
                  force: bool = False, **labels) -> Histogram:
        if not (self.enabled or force):
            return NULL_HISTOGRAM
        return self._get("histogram", name, _label_key(labels),
                         lambda k: Histogram(name, k, edges=edges))

    def _get(self, kind: str, name: str, key: LabelKey, make):
        full = (kind, name, key)
        with self._lock:
            inst = self._instruments.get(full)
            if inst is None:
                inst = self._instruments[full] = make(key)
            return inst

    # -- introspection ------------------------------------------------------
    def instruments(self) -> List[Tuple[str, object]]:
        """[(kind, instrument)] sorted by (kind, name, labels)."""
        with self._lock:
            items = list(self._instruments.items())
        items.sort(key=lambda kv: kv[0])
        return [(kind, inst) for (kind, _n, _l), inst in items]

    def snapshot(self) -> Dict:
        """JSON-able point-in-time dump of every instrument (see
        metrics/export.py for the writers over this)."""
        counters, gauges, histograms = [], [], []
        for kind, inst in self.instruments():
            labels = dict(inst.labels)
            if kind == "counter":
                counters.append({
                    "name": inst.name, "labels": labels,
                    "value": inst.value,
                })
            elif kind == "gauge":
                gauges.append({
                    "name": inst.name, "labels": labels,
                    "value": inst.value,
                })
            else:
                histograms.append({
                    "name": inst.name, "labels": labels,
                    "edges": list(inst.edges),
                    "counts": inst.counts,
                    "sum": inst.sum, "count": inst.count,
                })
        return {
            "ts": time.time(),
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def publish_to_tracer(self, tracer) -> None:
        """Bridge counters/gauges into the ``Tracer.counter()`` event
        stream so they render as counter tracks on the Perfetto
        timeline (one sample per call — call at interesting moments,
        e.g. shuffle unregister and manager stop)."""
        for kind, inst in self.instruments():
            if kind not in ("counter", "gauge"):
                continue
            suffix = ",".join(f"{k}={v}" for k, v in inst.labels)
            name = f"{inst.name}{{{suffix}}}" if suffix else inst.name
            tracer.counter(name, value=inst.value)

    def reset(self) -> None:
        """Drop every instrument (tests)."""
        with self._lock:
            self._instruments.clear()


# the process-global registry; managers enable it from conf
GLOBAL_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    return GLOBAL_REGISTRY


def counter(name: str, **labels) -> Counter:
    return GLOBAL_REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return GLOBAL_REGISTRY.gauge(name, **labels)


def histogram(name: str, edges: Optional[Sequence[float]] = None,
              **labels) -> Histogram:
    return GLOBAL_REGISTRY.histogram(name, edges=edges, **labels)
