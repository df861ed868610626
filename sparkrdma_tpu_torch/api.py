"""Job-level user API: the local[*] driver experience over the stack.

The reference is a plugin inside Spark — its users write
``rdd.reduceByKey`` / ``sortByKey`` and Spark's scheduler drives
registerShuffle / getWriter / getReader (SURVEY.md §3).  This module is
the standalone equivalent of that top layer so the framework is usable
without Spark: a :class:`TpuShuffleContext` owning one driver and N
executor managers (threads in-process by default, real processes over
:class:`TcpNetwork`), and a :class:`Dataset` with the classic wide and
narrow operations, every wide op running through the full
write → publish → resolve → fetch → read shuffle path.

    ctx = TpuShuffleContext(num_executors=3)
    ds = ctx.parallelize(range(10000), num_slices=6)
    counts = ds.map(lambda x: (x % 100, 1)).reduce_by_key(lambda a, b: a + b)
    out = counts.collect()
    ctx.stop()

Every manager runs on one device (``device=``, CUDA unless the caller
asks for the CPU, and an error when CUDA is absent): on the host read
plane each committed map output is a tensor there, and reducers fetch
blocks from it as device-to-host copies.  Device-native workloads
(TeraSorter / WordCounter / KeyedAggregator / the joiners / GroupedTopK)
are exposed as ``ctx.device_sort`` / ``ctx.device_count`` / ... — the
same split the reference has between its record plane and the NIC bulk
plane.  The bulk and windowed read planes (``shuffle/bulk.py``) are not
in this package yet: those ``readPlane`` values raise.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.conf import TpuShuffleConf
from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device
from sparkrdma_tpu_torch.shuffle.manager import (
    NO_DEVICE_PLANE,
    Aggregator,
    ColumnarAggregator,
    TpuShuffleManager,
)
from sparkrdma_tpu_torch.shuffle.partitioner import (
    HashPartitioner,
    Partitioner,
    RangePartitioner,
)
from sparkrdma_tpu_torch.transport import LoopbackNetwork
from sparkrdma_tpu_torch.utils.columns import ColumnBatch

logger = logging.getLogger(__name__)


class TpuShuffleContext:
    """Driver + executor managers + a task pool per executor."""

    def __init__(
        self,
        num_executors: int = 2,
        conf: Optional[TpuShuffleConf] = None,
        network=None,
        base_port: int = 39000,
        tasks_per_executor: int = 4,
        stage_to_device: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        if num_executors <= 0:
            raise ValueError("num_executors must be > 0")
        self.conf = conf or TpuShuffleConf()
        if self.conf.read_plane in ("bulk", "windowed", "collective"):
            raise NotImplementedError(
                NO_DEVICE_PLANE.format(self.conf.read_plane)
            )
        # every manager (driver and executors) runs on this device
        self.device = resolve_device(device)
        self.network = network if network is not None else LoopbackNetwork()
        # stage_to_device=None defers to TpuShuffleManager's
        # plane-aware default
        self.driver = TpuShuffleManager(
            self.conf, is_driver=True, network=self.network,
            port=self.conf.driver_port or base_port,
            stage_to_device=stage_to_device, device=self.device,
        )
        self.executors = [
            TpuShuffleManager(
                self.conf, is_driver=False, network=self.network,
                port=base_port + 100 + i * 10, executor_id=str(i),
                stage_to_device=stage_to_device, device=self.device,
            )
            for i in range(num_executors)
        ]
        self._pools = [
            ThreadPoolExecutor(
                max_workers=tasks_per_executor,
                thread_name_prefix=f"exec-{i}",
            )
            for i in range(num_executors)
        ]
        self._shuffle_ids = itertools.count()
        self._stopped = False

    # -- dataset creation ---------------------------------------------------
    def parallelize(self, data: Iterable[Any],
                    num_slices: Optional[int] = None) -> "Dataset":
        items = list(data)
        n = num_slices or len(self.executors) * 2
        n = max(1, min(n, max(1, len(items))))
        size = (len(items) + n - 1) // n
        parts = [items[i * size : (i + 1) * size] for i in range(n)]
        return Dataset(self, [p for p in parts])

    def parallelize_columns(self, keys, vals,
                            num_slices: Optional[int] = None) -> "Dataset":
        """Columnar dataset from parallel (keys, vals) arrays — the
        record plane's fast path (set conf ``serializer=columnar`` so
        the shuffle stays columnar end to end).  Wide ops on the result
        run as vectorized numpy kernels instead of per-record Python."""
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        whole = ColumnBatch(keys, vals)  # validates shape/dtype
        n = num_slices or len(self.executors) * 2
        n = max(1, min(n, max(1, len(whole))))
        bounds = [(i * len(whole)) // n for i in range(n + 1)]
        parts = [
            ColumnBatch(keys[lo:hi], vals[lo:hi])
            for lo, hi in zip(bounds, bounds[1:])
        ]
        return Dataset(self, parts)

    # -- device-native workloads (the kernel plane) -------------------------
    # ``group=`` (an ExchangeGroup or a torch.distributed process group)
    # runs the model over D ranks, each passing its own shard; without
    # one the model runs on the context's device.
    def device_sort(self, keys, vals=None, group=None):
        """Global sortByKey on the device (TeraSort path)."""
        from sparkrdma_tpu_torch.models.terasort import TeraSorter

        return TeraSorter(device=self.device, group=group).sort(keys, vals)

    def device_count(self, keys, vals=None, group=None) -> Dict[int, int]:
        """reduceByKey(+) on the device (WordCount path)."""
        from sparkrdma_tpu_torch.models.wordcount import WordCounter

        return WordCounter(device=self.device, group=group).count(keys, vals)

    def device_aggregate(self, keys, vals, group=None):
        """aggregateByKey (sum/count/min/max/mean) on the device."""
        from sparkrdma_tpu_torch.models.aggregate import KeyedAggregator

        return KeyedAggregator(device=self.device, group=group).aggregate(
            keys, vals
        )

    def device_join(self, fact_keys, fact_vals, dim_keys, dim_vals,
                    broadcast: bool = False, group=None, how: str = "inner"):
        """Equi-join on the device: exchange (hash) or broadcast
        schedule; ``how`` = inner|left_outer|semi|anti."""
        from sparkrdma_tpu_torch.models.join import BroadcastJoiner, HashJoiner

        joiner = (BroadcastJoiner if broadcast else HashJoiner)(
            device=self.device, group=group
        )
        return joiner.join(fact_keys, fact_vals, dim_keys, dim_vals,
                           how=how)

    def device_top_k(self, keys, vals, k: int, group=None):
        """Grouped top-k on the device (rank/LIMIT per group)."""
        from sparkrdma_tpu_torch.models.topk import GroupedTopK

        return GroupedTopK(device=self.device, group=group).top_k(
            keys, vals, k
        )

    # -- task running -------------------------------------------------------
    def _run_tasks(self, tasks: Sequence[Tuple[int, Callable[[], Any]]]) -> List[Any]:
        """Run (executor_index, thunk) tasks on their executors' pools."""
        futs = [self._pools[e % len(self._pools)].submit(fn) for e, fn in tasks]
        return [f.result() for f in futs]

    # -- the wide operation: one full shuffle -------------------------------
    def run_shuffle(
        self,
        partitions: List[List[Tuple[Any, Any]]],
        partitioner: Partitioner,
        aggregator: Optional[Aggregator] = None,
        map_side_combine: bool = False,
        key_ordering: bool = False,
    ) -> List[List[Tuple[Any, Any]]]:
        """Shuffle ``partitions`` (lists of (k, v)) into
        ``partitioner.num_partitions`` output partitions through the full
        data plane; the scheduler role of Spark's DAGScheduler."""
        shuffle_id = next(self._shuffle_ids)
        handle = self.driver.register_shuffle(
            shuffle_id, len(partitions), partitioner,
            aggregator=aggregator, map_side_combine=map_side_combine,
            key_ordering=key_ordering,
        )
        E = len(self.executors)
        maps_by_host: Dict[Any, List[int]] = defaultdict(list)
        lock = threading.Lock()

        def map_task(map_id: int, records: List[Tuple[Any, Any]]):
            ex = self.executors[map_id % E]
            w = ex.get_writer(handle, map_id)
            w.write(records)
            w.stop(True)
            with lock:
                maps_by_host[ex.local_smid].append(map_id)

        self._run_tasks([
            (m % E, (lambda m=m, recs=recs: map_task(m, recs)))
            for m, recs in enumerate(partitions)
        ])
        mbh = dict(maps_by_host)

        def reduce_task(pid: int) -> List[Tuple[Any, Any]]:
            ex = self.executors[pid % E]
            reader = ex.get_reader(handle, pid, pid + 1, mbh)
            return list(reader.read())

        out = self._run_tasks([
            (p % E, (lambda p=p: reduce_task(p)))
            for p in range(partitioner.num_partitions)
        ])
        self.driver.unregister_shuffle(shuffle_id)
        for ex in self.executors:
            ex.unregister_shuffle(shuffle_id)
        return out

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        # quiesce the driver's failure-detection plane FIRST: stopping
        # executors below is deliberate, not a failure to report
        self.driver.quiesce()
        for p in self._pools:
            self._trim_pool_scratch(p)
            p.shutdown(wait=True)
        for m in self.executors + [self.driver]:
            m.stop()

    @staticmethod
    def _trim_pool_scratch(pool: ThreadPoolExecutor) -> None:
        """Release per-thread native radix scratch on every worker of a
        retiring pool (the scratch is thread_local, so each worker must
        run the trim itself; a barrier makes each take exactly one)."""
        import threading

        from sparkrdma_tpu_torch.memory.staging import native_radix_scratch_trim

        workers = len(pool._threads)
        if not workers:
            return
        barrier = threading.Barrier(workers)

        def _trim():
            try:
                barrier.wait(timeout=5)
            except threading.BrokenBarrierError:
                pass  # a busy/dead worker: trim whoever arrived
            native_radix_scratch_trim()

        for f in [pool.submit(_trim) for _ in range(workers)]:
            try:
                f.result(timeout=10)
            except Exception:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _try_vectorized_pair(f, batch: "ColumnBatch",
                         elementwise: bool = True):
    """Apply ``f`` to the ``(keys, vals)`` column pair and accept the
    result only when it is a clean ``(keys', vals')`` column pair:
    a 2-tuple of 1-D non-object ndarrays of equal length (scalars
    broadcast against the other column).  ``elementwise`` additionally
    requires exactly ``len(batch)`` rows (map); without it any common
    length is accepted (flat_map, whose vectorized form must emit
    outputs in per-record concatenation order).  Returns a ColumnBatch
    or None — the caller re-applies ``f`` per record, so ``f`` must be
    pure."""
    n = len(batch)
    try:
        out = f((batch.keys, batch.vals))
    except Exception:
        return None
    if not (isinstance(out, tuple) and len(out) == 2):
        return None
    k, v = out
    k_arr = isinstance(k, np.ndarray)
    v_arr = isinstance(v, np.ndarray)
    if not (k_arr or v_arr):
        return None
    # ONLY plain Python literals broadcast (the (key, 1) wordcount
    # shape).  A numpy scalar is the result of a column REDUCTION
    # (kv[1].max() etc.) — broadcasting it would silently replace every
    # value with the partition aggregate, so reductions must fall back
    # to the per-record loop where they keep identity semantics.
    scalar_kinds = (bool, int, float, bytes, str)
    if not k_arr:
        if isinstance(k, np.generic) or not isinstance(k, scalar_kinds):
            return None
        k = np.full(len(v), k)
    if not v_arr:
        if isinstance(v, np.generic) or not isinstance(v, scalar_kinds):
            return None
        v = np.full(len(k), v)
    if k.ndim != 1 or v.ndim != 1 or k.shape != v.shape:
        return None
    if k.dtype.hasobject or v.dtype.hasobject:
        return None
    if elementwise and k.shape[0] != n:
        return None
    try:
        return ColumnBatch(k, v)
    except Exception:
        return None


def _try_vectorized(f, arg, n: int, kinds: str = ""):
    """Apply ``f`` to a whole column (or column pair) and accept the
    result only when it is a clean elementwise vector: an ndarray of
    exactly ``n`` rows, non-object dtype, optionally restricted to
    dtype ``kinds`` (numpy kind letters, space-separated groups
    allowed).  Returns None otherwise — the caller re-applies ``f``
    per record, so ``f`` must be pure."""
    try:
        out = f(arg)
    except Exception:
        return None
    if not isinstance(out, np.ndarray):
        return None
    if out.ndim != 1 or out.shape[0] != n or out.dtype.hasobject:
        return None
    if kinds and out.dtype.kind not in kinds.replace(" ", ""):
        return None
    return out


class Dataset:
    """Partitioned collection with Spark-shaped transformations.

    Narrow ops (map/filter/flat_map/map_partitions) are applied lazily
    and fused; wide ops run a real shuffle through the context."""

    def __init__(self, ctx: TpuShuffleContext, partitions: List[List[Any]],
                 transform: Optional[Callable[[List[Any]], List[Any]]] = None):
        self.ctx = ctx
        self._parts = partitions
        self._transform = transform  # fused narrow stage, applied per partition

    # -- narrow transformations (lazy, fused) --------------------------------
    def _chain(self, f: Callable[[List[Any]], List[Any]]) -> "Dataset":
        return self._chain_indexed(lambda part, _pidx, f=f: f(part))

    def _chain_indexed(
        self, f: Callable[[List[Any], int], List[Any]]
    ) -> "Dataset":
        """Chain a narrow transform that also receives the partition
        index (needed by index-seeded ops like sample).

        A transform carrying ``_columnar_ok = True`` promises to accept
        a ColumnBatch as well as a record list and return the same
        kind; a chain where EVERY stage promises this keeps partitions
        columnar end to end (the vectorized narrow plane), otherwise
        _materialize falls back to record lists."""
        prev = self._transform
        if prev is None:
            fused = f
        else:
            def fused(part, pidx, prev=prev, f=f):
                return f(prev(part, pidx), pidx)
            fused._columnar_ok = (
                getattr(prev, "_columnar_ok", False)
                and getattr(f, "_columnar_ok", False)
            )
        return Dataset(self.ctx, self._parts, fused)

    def map(self, f: Callable[[Any], Any]) -> "Dataset":
        """Columnar partitions first try ``f`` VECTORIZED over the
        ``(keys, vals)`` column pair: a key+value producing map like
        ``lambda kv: (kv[0] % 10, kv[1] * 2)`` runs as numpy passes and
        the chain STAYS columnar; anything that doesn't evaluate to a
        clean same-length column pair (including maps to non-pair
        records, e.g. ``keys()``) falls back to the per-record loop.
        ``f`` must be pure — the fallback re-applies it."""

        def m(part, _pidx, f=f):
            if isinstance(part, ColumnBatch):
                out = _try_vectorized_pair(f, part, elementwise=True)
                if out is not None:
                    return out
                part = list(part)
            return [f(x) for x in part]

        m._columnar_ok = True
        return self._chain_indexed(m)

    def filter(self, f: Callable[[Any], bool]) -> "Dataset":
        """Columnar partitions first try ``f`` VECTORIZED over the
        ``(keys, vals)`` column pair (tuple-indexing predicates like
        ``lambda kv: kv[1] > 5`` evaluate to a boolean mask in one
        numpy pass); anything that doesn't vectorize cleanly falls back
        to the per-record loop.  ``f`` must be pure — the fallback
        re-applies it."""

        def fl(part, _pidx, f=f):
            if isinstance(part, ColumnBatch):
                mask = _try_vectorized(f, (part.keys, part.vals),
                                       len(part), kinds="bui f")
                if mask is not None:
                    mask = mask.astype(bool, copy=False)
                    return ColumnBatch(
                        part.keys[mask], part.vals[mask],
                        key_sorted=part.key_sorted,
                    )
                part = list(part)
            return [x for x in part if f(x)]

        fl._columnar_ok = True
        return self._chain_indexed(fl)

    def flat_map(self, f: Callable[[Any], Iterable[Any]]) -> "Dataset":
        """Columnar partitions stay columnar when ``f`` returns a
        :class:`ColumnBatch` (e.g. ``lambda kv: ColumnBatch(
        np.repeat(kv[0], 2), np.repeat(kv[1], 2))``) — the ONE return
        shape whose semantics agree between the vectorized call (whole
        column pair in, batch out) and the per-record fallback
        (iterating a ColumnBatch yields its (key, value) records, so
        ``[y for x in part for y in f(x)]`` flattens to the same
        stream).  A plain tuple return is deliberately NOT treated as
        a column pair: the fallback would flatten it into its two
        elements, a different dataset.  ``f`` must be pure and emit
        outputs in per-record concatenation order."""

        def fm(part, _pidx, f=f):
            if isinstance(part, ColumnBatch):
                try:
                    out = f((part.keys, part.vals))
                except Exception:
                    out = None
                if isinstance(out, ColumnBatch):
                    return out
                part = list(part)
            return [y for x in part for y in f(x)]

        fm._columnar_ok = True
        return self._chain_indexed(fm)

    def map_partitions(self, f: Callable[[List[Any]], Iterable[Any]]) -> "Dataset":
        return self._chain(lambda part: list(f(part)))

    # -- materialization -----------------------------------------------------
    def cache(self) -> "Dataset":
        """Materialize the pending transform chain once and keep the
        result: later actions reuse it instead of re-running the chain
        (Spark's cache/persist at MEMORY_ONLY).  Returns self."""
        if self._transform is not None:
            self._parts = self._materialize()
            self._transform = None
        return self

    def _materialize(self) -> List[List[Any]]:
        if self._transform is None:
            return self._parts
        t = self._transform
        col_ok = getattr(t, "_columnar_ok", False)
        E = len(self.ctx.executors)

        def run(p, i):
            # a fully column-aware chain receives the ColumnBatch
            # itself (vectorized narrow plane); otherwise records
            if col_ok and isinstance(p, ColumnBatch):
                return t(p, i)
            return t(list(p), i)

        out = self.ctx._run_tasks([
            (i % E, (lambda p=p, i=i: run(p, i)))
            for i, p in enumerate(self._parts)
        ])
        return out

    def collect(self) -> List[Any]:
        return [x for part in self._materialize() for x in part]

    def count(self) -> int:
        return sum(len(p) for p in self._materialize())

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    # -- wide transformations ------------------------------------------------
    @property
    def _is_columnar(self) -> bool:
        """True when partitions are ColumnBatch columns and any pending
        narrow transform is fully column-aware (tuple-level transforms
        de-columnarize)."""
        return (
            (self._transform is None
             or getattr(self._transform, "_columnar_ok", False))
            and bool(self._parts)
            and all(isinstance(p, ColumnBatch) for p in self._parts)
        )

    def _shuffled(self, partitioner, **kw) -> "Dataset":
        parts = self._materialize()
        out = self.ctx.run_shuffle(parts, partitioner, **kw)
        return Dataset(self.ctx, out)

    def partition_by(self, num_partitions: int) -> "Dataset":
        return self._shuffled(HashPartitioner(num_partitions))

    def reduce_by_key(self, f,
                      num_partitions: Optional[int] = None) -> "Dataset":
        """``f`` is a binary combiner; a columnar dataset also accepts
        the vectorizable names ``"sum"``/``"min"``/``"max"`` (required
        to stay on the columnar fast path)."""
        n = num_partitions or self.num_partitions
        if isinstance(f, str):
            agg: Aggregator = ColumnarAggregator.reduce(f)
        else:
            agg = Aggregator(
                create_combiner=lambda v: v, merge_value=f, merge_combiners=f
            )
        return self._shuffled(
            HashPartitioner(n), aggregator=agg, map_side_combine=True
        )

    def group_by_key(self, num_partitions: Optional[int] = None) -> "Dataset":
        n = num_partitions or self.num_partitions
        if self._is_columnar:
            # no map-side combine: grouping collects rather than
            # reduces, so combining would only concatenate columns
            return self._shuffled(
                HashPartitioner(n), aggregator=ColumnarAggregator.group(),
            )
        agg = Aggregator(
            create_combiner=lambda v: [v],
            merge_value=lambda c, v: c + [v],
            merge_combiners=lambda a, b: a + b,
        )
        return self._shuffled(
            HashPartitioner(n), aggregator=agg, map_side_combine=True
        )

    def sort_by_key(self, num_partitions: Optional[int] = None,
                    sample_size: int = 400, seed: int = 0) -> "Dataset":
        """Range-partitioned global sort: concatenating the output
        partitions in order yields the sorted data."""
        parts = self._materialize()
        n = num_partitions or self.num_partitions
        rng = random.Random(seed)
        if parts and all(isinstance(p, ColumnBatch) for p in parts):
            all_keys = np.concatenate([p.keys for p in parts])
            if len(all_keys):
                idx = rng.sample(
                    range(len(all_keys)), min(sample_size, len(all_keys))
                )
                sample = all_keys[np.asarray(idx)].tolist()
            else:
                sample = []
        else:
            keys = [k for part in parts for k, _ in part]
            sample = (
                rng.sample(keys, min(sample_size, len(keys))) if keys else []
            )
        ds = Dataset(self.ctx, parts)
        return ds._shuffled(RangePartitioner(n, sample), key_ordering=True)

    def repartition_and_sort_within_partitions(
        self, partitioner=None,
        num_partitions: Optional[int] = None,
    ) -> "Dataset":
        """Spark's repartitionAndSortWithinPartitions: one shuffle that
        both routes rows by the partitioner AND leaves every output
        partition key-sorted (the columnar writer commits key-sorted
        blocks, so readers merge views — no extra sort pass)."""
        n = num_partitions or self.num_partitions
        part = partitioner or HashPartitioner(n)
        return self._shuffled(part, key_ordering=True)

    def map_values(self, f: Callable[[Any], Any]) -> "Dataset":
        """Columnar partitions first try ``f`` VECTORIZED over the
        whole value column (ufunc-style callables like ``lambda v:
        v * 2`` run in one numpy pass and the chain STAYS columnar);
        non-vectorizable callables fall back per record.  ``f`` must be
        pure — the fallback re-applies it."""

        def mv(part, _pidx, f=f):
            if isinstance(part, ColumnBatch):
                out = _try_vectorized(f, part.vals, len(part))
                if out is not None:
                    return ColumnBatch(
                        part.keys, out, key_sorted=part.key_sorted
                    )
                part = list(part)
            return [(k, f(v)) for k, v in part]

        mv._columnar_ok = True
        return self._chain_indexed(mv)

    def keys(self) -> "Dataset":
        return self.map(lambda kv: kv[0])

    def values(self) -> "Dataset":
        return self.map(lambda kv: kv[1])

    def union(self, other: "Dataset") -> "Dataset":
        """Narrow union: partitions of both datasets side by side."""
        return Dataset(
            self.ctx, self._materialize() + other._materialize()
        )

    def take(self, n: int) -> List[Any]:
        out: List[Any] = []
        for part in self._materialize():
            for rec in part:  # ColumnBatch iterates (key, val) records
                out.append(rec)
                if len(out) >= n:
                    return out
        return out

    def first(self) -> Any:
        got = self.take(1)
        if not got:
            raise ValueError("first() on an empty dataset")
        return got[0]

    def sample(self, fraction: float, seed: int = 0) -> "Dataset":
        """Bernoulli sample without replacement.

        Deterministic like Spark's seeded sample: the decision stream
        is re-derived from ``(seed, partition_index)`` on every
        materialization, so repeated actions on the same sampled
        dataset (count() then collect()) see identical rows."""
        if not (0.0 <= fraction <= 1.0):
            raise ValueError(f"fraction must be in [0, 1]: {fraction}")

        def sample_part(part, pidx, seed=seed, fraction=fraction):
            if isinstance(part, ColumnBatch):
                # salt-free seed mix: str hashing is PYTHONHASHSEED-
                # salted and would break cross-process determinism;
                # SeedSequence keeps the FULL seed (no truncation)
                rng = np.random.default_rng(
                    np.random.SeedSequence(
                        [seed & ((1 << 64) - 1), pidx, 0xC0]
                    )
                )
                mask = rng.random(len(part)) < fraction
                return ColumnBatch(
                    part.keys[mask], part.vals[mask],
                    key_sorted=part.key_sorted,
                )
            rng = random.Random(hash((seed, pidx)))
            return [x for x in part if rng.random() < fraction]

        sample_part._columnar_ok = True
        return self._chain_indexed(sample_part)

    def top_k_per_key(self, k: int,
                      num_partitions: Optional[int] = None) -> "Dataset":
        """Top-k values per key, descending (the rank/LIMIT-per-group
        shape; device-plane analog: models/topk.py GroupedTopK)."""
        import heapq

        if k <= 0:
            raise ValueError(f"k must be positive: {k}")
        return self.group_by_key(num_partitions).map_values(
            lambda vs: heapq.nlargest(k, list(vs))
        )

    def combine_by_key(self, create_combiner, merge_value, merge_combiners,
                       num_partitions: Optional[int] = None) -> "Dataset":
        """The general combiner (Spark combineByKey; the reference's
        read-path Aggregator, RdmaShuffleReader.scala:82-97):
        map-side combine with ``create_combiner``/``merge_value``,
        reduce-side merge with ``merge_combiners``."""
        n = num_partitions or self.num_partitions
        agg = Aggregator(
            create_combiner=create_combiner,
            merge_value=merge_value,
            merge_combiners=merge_combiners,
        )
        return self._shuffled(
            HashPartitioner(n), aggregator=agg, map_side_combine=True
        )

    def count_by_key(self) -> Dict[Any, int]:
        """Action: {key: occurrence count} (one reduce_by_key pass)."""
        return dict(
            self.map(lambda kv: (kv[0], 1))
            .reduce_by_key(lambda a, b: a + b)
            .collect()
        )

    def distinct(self, num_partitions: Optional[int] = None) -> "Dataset":
        """Distinct elements via a hash-partitioned nil-value shuffle
        (co-locates duplicates, keeps one per partition)."""
        n = num_partitions or self.num_partitions
        keyed = self.map(lambda x: (x, None))
        return (
            keyed.reduce_by_key(lambda a, b: a, num_partitions=n)
            .map(lambda kv: kv[0])
        )

    def _cogrouped(self, other: "Dataset",
                   num_partitions: Optional[int] = None) -> "Dataset":
        """(k, ([vs], [ws])) — both sides tagged and grouped in ONE
        shuffle (the cogroup narrow dependency)."""
        n = num_partitions or max(self.num_partitions, other.num_partitions)
        tagged = Dataset(
            self.ctx,
            self.map(lambda kv: (kv[0], (0, kv[1])))._materialize()
            + other.map(lambda kv: (kv[0], (1, kv[1])))._materialize(),
        )
        grouped = tagged.group_by_key(n)

        def split(part):
            out = []
            for k, tagged_vals in part:
                left = [v for t, v in tagged_vals if t == 0]
                right = [w for t, w in tagged_vals if t == 1]
                out.append((k, (left, right)))
            return out

        return grouped.map_partitions(split)

    def cogroup(self, other: "Dataset",
                num_partitions: Optional[int] = None) -> "Dataset":
        """Spark cogroup: (k, ([vs], [ws])) for every key on either
        side."""
        return self._cogrouped(other, num_partitions)

    def join(self, other: "Dataset",
             num_partitions: Optional[int] = None,
             how: str = "inner") -> "Dataset":
        """Equi-join: (k, v) ⋈ (k, w) — the exchange shuffle of the
        reference's SQL workloads.  ``how`` is
        inner (→ (k, (v, w))), left_outer (w may be None),
        right_outer (v may be None), full_outer (either may be None),
        semi (→ (k, v) where a match exists), or anti (→ (k, v)
        where none does) — the record-plane analog of the device
        joins (models/join.py JOIN_HOWS)."""
        hows = ("inner", "left_outer", "right_outer", "full_outer",
                "semi", "anti")
        if how not in hows:
            raise ValueError(f"unsupported join how={how!r}")
        cg = self._cogrouped(other, num_partitions)

        def emit(part):
            out = []
            for k, (left, right) in part:
                if how == "semi":
                    if right:
                        out.extend((k, v) for v in left)
                elif how == "anti":
                    if not right:
                        out.extend((k, v) for v in left)
                else:
                    ls = left or (
                        [None] if how in ("right_outer", "full_outer")
                        else []
                    )
                    rs = right or (
                        [None] if how in ("left_outer", "full_outer")
                        else []
                    )
                    for v in ls:
                        out.extend((k, (v, w)) for w in rs)
            return out

        return cg.map_partitions(emit)

    def aggregate_by_key(self, zero, seq_func, comb_func,
                         num_partitions: Optional[int] = None
                         ) -> "Dataset":
        """Spark aggregateByKey: fold each key's values into a fresh
        copy of ``zero`` with ``seq_func`` map-side, merge partials
        with ``comb_func`` (one combine_by_key shuffle)."""
        import copy as _copy

        return self.combine_by_key(
            lambda v: seq_func(_copy.deepcopy(zero), v),
            seq_func,
            comb_func,
            num_partitions=num_partitions,
        )

    def fold_by_key(self, zero, func,
                    num_partitions: Optional[int] = None) -> "Dataset":
        """Spark foldByKey: aggregate_by_key with one function for
        both the fold and the merge."""
        return self.aggregate_by_key(
            zero, func, func, num_partitions=num_partitions
        )

    def subtract_by_key(self, other: "Dataset",
                        num_partitions: Optional[int] = None
                        ) -> "Dataset":
        """Spark subtractByKey: pairs whose key has NO entry in
        ``other`` (one cogroup shuffle — the anti-join over pairs)."""
        return self.join(other, num_partitions=num_partitions, how="anti")
