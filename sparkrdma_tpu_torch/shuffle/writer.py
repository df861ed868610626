"""Map-side shuffle writer: partition → (combine) → serialize → commit → publish.

Analog of RdmaWrapperShuffleWriter (RdmaWrapperShuffleWriter.scala:76-153).
Where the reference wraps Spark's UnsafeShuffleWriter/SortShuffleWriter
and intercepts the commit to mmap+register the produced file, this
writer owns the whole path: bucket records by partitioner, optionally
map-side combine, serialize per partition, commit into a registered HBM
segment via the resolver, and publish the location table to the driver
(the ``stop(success=true)`` publish at
RdmaWrapperShuffleWriter.scala:115-149).
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.memory.staging import native_hash_partition_order
from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.shuffle.map_output import MapTaskOutput
from sparkrdma_tpu_torch.skew import (
    HeavyHitterSketch,
    PartitionSketch,
    get_skew,
    plan_commit_splits,
    sub_spans,
)
from sparkrdma_tpu_torch.shuffle.partitioner import (
    HashPartitioner,
    RangePartitioner,
)
from sparkrdma_tpu_torch.utils.columns import (
    ColumnBatch,
    combine_columns,
    concat_batches,
    stable_key_order,
    take_rows,
)
from sparkrdma_tpu_torch.utils.serde import Record
from sparkrdma_tpu_torch.utils.trace import get_tracer

logger = logging.getLogger(__name__)


def _chunked_payload(length: int, chunks_fn):
    from sparkrdma_tpu_torch.shuffle.resolver import ChunkedPayload

    return ChunkedPayload(length, chunks_fn)


class WriteMetrics:
    def __init__(self):
        self.records_written = 0
        self.bytes_written = 0
        self.write_time_ms = 0.0
        self.spills = 0
        self.bytes_spilled = 0


class ShuffleWriter:
    """One writer per (shuffle, map task)."""

    def __init__(self, manager, handle, map_id: int):
        self.manager = manager
        self.handle = handle
        self.map_id = map_id
        self.metrics = WriteMetrics()
        self._buckets: List[List[Record]] = [
            [] for _ in range(handle.partitioner.num_partitions)
        ]
        self._combined: Optional[List[dict]] = (
            [dict() for _ in range(handle.partitioner.num_partitions)]
            if (handle.aggregator is not None and handle.map_side_combine)
            else None
        )
        self._stopped = False
        # columnar plane: per-partition ColumnBatch runs (created on the
        # first columnar write; a writer is tuple- OR column-mode)
        self._col_buckets: Optional[List[List[ColumnBatch]]] = None
        # pending columnar writes: (batch, order, counts) with the
        # gather DEFERRED — the no-spill commit gathers records straight
        # into the final segment buffer (one copy total); spills
        # materialize first
        self._col_pending: Optional[List[Tuple[ColumnBatch, Optional[Any], Any]]] = None
        # spill state (Spark sort-shuffle spill role; 0 = disabled)
        self._spill_threshold = manager.conf.shuffle_spill_record_threshold
        self._records_in_memory = 0
        self._spill_file = None
        # per partition: [(offset, length)] chunks in the spill file
        self._spilled: List[List[Tuple[int, int]]] = [
            [] for _ in range(handle.partitioner.num_partitions)
        ]
        # per-partition spill layout (conf spillPartitionFiles): one
        # O_DIRECT appender per partition, promoted at commit into the
        # shuffle files themselves (no consolidation rewrite)
        self._spill_appenders = None
        self._spill_io = None  # shared 1-thread flush executor
        self._spill_direct = False
        # skew detection (skew/): streaming per-partition record
        # sketch, plus a Misra-Gries hot-key sketch on aggregating
        # shuffles (hot-KEY attribution in telemetry).  Both None
        # unless skewEnabled, so the default record path pays one
        # predictable None check per record and nothing else
        self._psketch = self._hot_keys = None
        self._skew_stride = 1
        self._skew_seen = 0
        if manager.skew is not None and manager.skew.enabled:
            self._psketch = PartitionSketch(
                handle.partitioner.num_partitions
            )
            self._skew_stride = manager.conf.skew_sample_stride
            if handle.aggregator is not None:
                self._hot_keys = HeavyHitterSketch()

    # -- write --------------------------------------------------------------
    def write(self, records) -> None:
        if isinstance(records, ColumnBatch):
            # the columnar path needs BOTH a column-capable serializer
            # (else ColumnBatch objects would be pickled whole and the
            # reader's tuple unpack breaks) AND either no map-side
            # combine or a vectorizable one; otherwise iterate the
            # batch through the tuple plane (correct, just slow)
            if getattr(self.manager.serializer, "supports_columns", False) \
                    and (self._combined is None or getattr(
                        self.handle.aggregator, "kind", None) is not None):
                return self.write_columns(records)
        self._write_records(records)

    def write_columns(self, batch: ColumnBatch) -> None:
        """Columnar fast path: one vectorized partition pass per batch —
        the unsafe-row analog of keeping the reference's map-side hot
        loop inside Spark's serialized-row writers
        (RdmaWrapperShuffleWriter.scala:85-101).

        Only the (pid, key) PERMUTATION is computed here; the expensive
        record gather is deferred so the commit can gather straight into
        the final segment buffer.  Sorting by key within each bucket
        costs two cheap index sorts (stable_key_order rides the uint16
        radix path for pids, and for modest-range keys) and lets readers
        merge blocks as views instead of re-sorting."""
        t0 = time.monotonic()
        if any(self._buckets) or any(self._combined or []):
            raise TypeError(
                "writer already holds tuple records; one map task must "
                "stay on a single record plane"
            )
        P = self.handle.partitioner.num_partitions
        if self._col_pending is None:
            self._col_pending = []
        n = len(batch)
        if n == 0:
            return
        if P == 1:
            counts = np.array([n], np.int64)
            self._col_pending.append((batch, None, counts))
        else:
            order = counts = None
            is_hash = type(self.handle.partitioner) is HashPartitioner
            if is_hash and np.issubdtype(batch.keys.dtype, np.integer):
                kmin = int(batch.keys.min())
                kmax = int(batch.keys.max())
                krange = kmax - kmin + 1
                # uint64 keys past int64.max cannot ride the int64 fast
                # path (ctypes arg + astype both break); generic
                # partition_array handles them
                if kmax <= np.iinfo(np.int64).max and (
                    krange * P <= (1 << 16)
                ):
                    # modest-cardinality int keys: ONE fused native
                    # pass (splitmix64 + composite counting sort)
                    # replaces hash + two radix argsorts + two index
                    # gathers + bincount — or, without the native lib,
                    # one composite uint16 radix argsort does
                    got = native_hash_partition_order(
                        np.ascontiguousarray(batch.keys, np.int64),
                        P, kmin, krange,
                    )
                    if got is not None:
                        order, counts = got
                    else:
                        pids = self.handle.partitioner.partition_array(
                            batch.keys
                        )
                        # widen BEFORE subtracting: narrow key dtypes
                        # (int8 span 256) overflow on (keys - kmin)
                        comp = (
                            pids.astype(np.uint32) * np.uint32(krange)
                            + (batch.keys.astype(np.int64) - kmin)
                            .astype(np.uint32)
                        ).astype(np.uint16)
                        order = np.argsort(comp, kind="stable")
                        counts = np.bincount(
                            pids, minlength=P
                        ).astype(np.int64)
            if order is None and type(
                self.handle.partitioner
            ) is RangePartitioner:
                # range partitioning: key order IS pid-major order, so
                # ONE key sort suffices and counts fall out of P-1
                # binary searches (no pid column, no second sort)
                spl = self.handle.partitioner.splitters
                try:
                    spl_arr = np.asarray(spl)
                except (TypeError, ValueError):
                    spl_arr = None
                if spl_arr is not None and (
                    spl_arr.dtype != batch.keys.dtype
                    or spl_arr.dtype.hasobject
                ):
                    # dtype mismatch could change comparison semantics
                    # vs the scalar bisect path — stay generic
                    spl_arr = None
                if spl_arr is not None and len(spl_arr) == P - 1:
                    order = stable_key_order(batch.keys)
                    sk = take_rows(batch.keys, order)
                    bounds = np.searchsorted(sk, spl_arr, side="left")
                    counts = np.diff(
                        np.concatenate(([0], bounds, [n]))
                    ).astype(np.int64)
            if (order is None and is_hash
                    and batch.keys.dtype == np.int64
                    and n >= (1 << 14)):
                # wide-RANGE but low-CARDINALITY keys: compress to
                # dense sorted uint16 ranks (size gate matches
                # stable_key_order's — the kernel's 2MB table isn't
                # worth filling for small batches), then ONE composite
                # uint16 radix argsort replaces the two-sort-two-
                # gather chain (pid-major, key-ascending, stable —
                # same order).  uint16 only: numpy's STABLE sort is
                # radix for <=16-bit ints but timsort at 32 bits;
                # past 65536 composites
                # the ranks still replace the key sort in the two-sort
                # chain below
                from sparkrdma_tpu_torch.memory.staging import (
                    native_rank_compress,
                )

                res = native_rank_compress(batch.keys)
                if res is not None:
                    ranks, nr = res
                    pids = self.handle.partitioner.partition_array(
                        batch.keys
                    )
                    # nr < 2**16 is defensive: unreachable today (P==1
                    # short-circuits above, so P>=2 bounds nr<=32768)
                    # but np.uint16(nr) needs it if that ever changes
                    if nr < (1 << 16) and int(P) * nr <= (1 << 16):
                        comp = (
                            pids.astype(np.uint16) * np.uint16(nr)
                            + ranks
                        )
                        order = np.argsort(comp, kind="stable")
                    else:
                        korder = np.argsort(ranks, kind="stable")
                        porder = stable_key_order(pids[korder])
                        order = korder[porder]
                    counts = np.bincount(
                        pids, minlength=P
                    ).astype(np.int64)
            if order is None:
                pids = self.handle.partitioner.partition_array(batch.keys)
                korder = stable_key_order(batch.keys)
                porder = stable_key_order(pids[korder])
                order = korder[porder]  # pid-major, key-sorted within
                counts = np.bincount(pids, minlength=P).astype(np.int64)
            self._col_pending.append((batch, order, counts))
        if self._psketch is not None:
            counts = self._col_pending[-1][2]
            for pid, cnt in enumerate(counts):
                if cnt:
                    self._psketch.add(pid, int(cnt))
            if self._hot_keys is not None:
                # strided key sample (vectorized slice, scalar adds)
                for k in batch.keys[:: self._skew_stride]:
                    self._hot_keys.add(k.item() if hasattr(k, "item") else k)
        self.metrics.records_written += n
        self._records_in_memory += n
        if (self._spill_threshold
                and self._records_in_memory >= self._spill_threshold):
            self.spill()
        self.metrics.write_time_ms += (time.monotonic() - t0) * 1000

    def _materialize_pending(self) -> None:
        """Gather pending columnar writes into per-partition batches
        (the spill / combine / compressed-serializer path)."""
        P = self.handle.partitioner.num_partitions
        if self._col_buckets is None:
            self._col_buckets = [[] for _ in range(P)]
        if not self._col_pending:
            self._col_pending = []
            return
        for batch, order, counts in self._col_pending:
            if order is None:  # P == 1: whole batch, original order
                self._col_buckets[0].append(batch)
                continue
            sk = take_rows(batch.keys, order)
            sv = take_rows(batch.vals, order)
            bounds = np.cumsum(counts)[:-1]
            ksp = np.split(sk, bounds)
            vsp = np.split(sv, bounds)
            for pid in range(P):
                if len(ksp[pid]):
                    self._col_buckets[pid].append(
                        ColumnBatch(ksp[pid], vsp[pid], key_sorted=True)
                    )
        self._col_pending = []

    def _write_records(self, records: Iterable[Record]) -> None:
        t0 = time.monotonic()
        if self._col_buckets is not None or self._col_pending is not None:
            raise TypeError(
                "writer already holds columnar records; one map task "
                "must stay on a single record plane"
            )
        part = self.handle.partitioner.partition
        psk = self._psketch
        if self._combined is not None:
            agg = self.handle.aggregator
            for k, v in records:
                pid = part(k)
                d = self._combined[pid]
                if k in d:
                    d[k] = agg.merge_value(d[k], v)
                else:
                    d[k] = agg.create_combiner(v)
                    self._records_in_memory += 1
                self.metrics.records_written += 1
                if psk is not None:
                    psk.add(pid)
                    self._skew_seen += 1
                    if self._skew_seen % self._skew_stride == 0:
                        self._hot_keys.add(k)
                if (self._spill_threshold
                        and self._records_in_memory >= self._spill_threshold):
                    self.spill()
        else:
            for rec in records:
                pid = part(rec[0])
                self._buckets[pid].append(rec)
                self._records_in_memory += 1
                self.metrics.records_written += 1
                if psk is not None:
                    psk.add(pid)
                if (self._spill_threshold
                        and self._records_in_memory >= self._spill_threshold):
                    self.spill()
        self.metrics.write_time_ms += (time.monotonic() - t0) * 1000

    def _ordered_bucket(self, bucket: List[Record]) -> List[Record]:
        """Tuple-plane map-side ordering: with ``key_ordering`` (and no
        aggregation) each committed/spilled bucket serializes key-
        sorted, so reduce-side blocks are PRE-SORTED RUNS — the decode
        pipeline's streaming k-way merge (and the serial path's
        timsort, which gallops over runs) then merge instead of
        re-sorting, the Spark ``ExternalSorter`` map-side-sort shape.
        Stable, so the merged reduce output is bit-identical to sorting
        unsorted blocks reduce-side (the columnar plane already ships
        ``key_sorted`` batches)."""
        if self.handle.key_ordering and self.handle.aggregator is None:
            return sorted(bucket, key=lambda kv: kv[0])
        return bucket

    # -- spill --------------------------------------------------------------
    def spill(self) -> None:
        """Serialize buffered buckets to the spill file and release the
        memory.  The serializer's framing is concatenation-safe, so the
        commit merges spilled chunks with the final in-memory remainder
        by plain byte concatenation; with map-side combine the reader's
        merge_combiners folds duplicate keys across spilled chunks."""
        if self._records_in_memory == 0:
            return
        if self._col_pending:
            self._materialize_pending()
        serializer = self.manager.serializer
        P = self.handle.partitioner.num_partitions
        pid_layout = (
            0 < P <= self.manager.conf.spill_partition_files
        )
        if self._spill_file is None and self._spill_appenders is None:
            spill_dir = self.manager.conf.spill_dir
            os.makedirs(spill_dir, exist_ok=True)
            if pid_layout:
                from sparkrdma_tpu_torch.memory.direct_io import direct_supported

                mode = self.manager.conf.direct_io
                self._spill_direct = mode == "on" or (
                    mode == "auto" and direct_supported(spill_dir)
                )
                self._spill_appenders = [None] * P
            else:
                fd, path = tempfile.mkstemp(
                    prefix=f"sparkrdma_tpu_spill_"
                           f"{self.handle.shuffle_id}_{self.map_id}_",
                    dir=spill_dir,
                )
                self._spill_file = os.fdopen(fd, "w+b")
                self._spill_path = path
        if self._col_buckets is not None:
            sources = self._columnar_sources()
        elif self._combined is not None:
            sources = [d.items() if d else None for d in self._combined]
        else:
            sources = [
                self._ordered_bucket(b) if b else None
                for b in self._buckets
            ]
        if self._spill_appenders is not None:
            # stream header + column VIEWS straight into the appender's
            # aligned buffers — no per-partition bytes join (each byte
            # is copied once between the batch and the bounce buffer)
            chunked = getattr(serializer, "serialize_chunks", None)
            for pid, src in enumerate(sources):
                if src is None:
                    continue
                app = self._appender(pid)
                if chunked is not None:
                    total_n, chunks = chunked(src)
                    off = app.size
                    for c in chunks():
                        app.append(c)
                    n = total_n
                else:
                    off, n = app.append(serializer.serialize(src))
                self._spilled[pid].append((off, n))
                self.metrics.bytes_spilled += n
        else:
            f = self._spill_file
            f.seek(0, os.SEEK_END)
            for pid, src in enumerate(sources):
                if src is None:
                    continue
                raw = serializer.serialize(src)
                off = f.tell()
                f.write(raw)
                self._spilled[pid].append((off, len(raw)))
                self.metrics.bytes_spilled += len(raw)
        if self._col_buckets is not None:
            self._col_buckets = [[] for _ in self._col_buckets]
        elif self._combined is not None:
            self._combined = [dict() for _ in self._combined]
        else:
            self._buckets = [[] for _ in self._buckets]
        self._records_in_memory = 0
        self.metrics.spills += 1

    def _columnar_sources(self) -> List[Optional[object]]:
        """Per-partition serialize sources: a list of key-sorted batches
        (one frame each — concatenation would cost a copy AND lose the
        sortedness flag readers exploit), or one combined batch for
        reducing aggregators."""
        kind = (
            getattr(self.handle.aggregator, "kind", None)
            if self.handle.map_side_combine else None
        )
        out: List[Optional[object]] = []
        for batches in self._col_buckets:
            if not batches:
                out.append(None)
            elif kind is None or kind == "group":
                out.append(batches)
            else:
                # per-batch combine first: key-sorted batches reduce
                # without a sort, and the re-combine input is tiny
                reduced = [combine_columns(b, kind) for b in batches]
                b = (
                    reduced[0] if len(reduced) == 1
                    else combine_columns(concat_batches(reduced), kind)
                )
                out.append(b if len(b) else None)
        return out

    def _appender(self, pid: int):
        """Lazily create partition ``pid``'s spill appender."""
        app = self._spill_appenders[pid]
        if app is None:
            from concurrent.futures import ThreadPoolExecutor

            from sparkrdma_tpu_torch.memory.direct_io import DirectAppender

            if self._spill_io is None:
                self._spill_io = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="spill-io"
                )
            spill_dir = self.manager.conf.spill_dir
            fd, path = tempfile.mkstemp(
                prefix=f"sparkrdma_tpu_shuffle_"
                       f"{self.handle.shuffle_id}_{self.map_id}_"
                       f"p{pid}_",
                dir=spill_dir,
            )
            os.close(fd)  # DirectAppender reopens with its own flags
            P = self.handle.partitioner.num_partitions
            app = DirectAppender(
                path, use_direct=self._spill_direct,
                buf_bytes=(1 << 20) if P <= 32 else (256 << 10),
                executor=self._spill_io,
                # round-robin appends across P files fragment extents
                # at bounce-buffer size; 32 MiB preallocation steps
                # keep each shuffle file's later sequential read fast
                prealloc_bytes=32 << 20,
            )
            self._spill_appenders[pid] = app
        return app

    def _iter_partition_chunks(self, pid: int, final: bytes):
        """Yield a partition's spilled chunks (read back one at a time)
        followed by the final in-memory remainder — at most one spill
        chunk is ever resident during the commit copy."""
        for off, n in self._spilled[pid]:
            self._spill_file.seek(off)
            yield self._spill_file.read(n)
        if final:
            yield final

    def _close_spill(self) -> None:
        if self._spill_file is not None:
            f, self._spill_file = self._spill_file, None
            try:
                f.close()
            finally:
                try:
                    os.unlink(self._spill_path)
                except OSError:
                    pass
        if self._spill_appenders is not None:
            # still owned here = the commit never promoted them
            # (failure / unsuccessful stop): discard
            apps, self._spill_appenders = self._spill_appenders, None
            for app in apps:
                if app is not None:
                    app.abandon()
        if self._spill_io is not None:
            io, self._spill_io = self._spill_io, None
            io.shutdown(wait=True)

    # -- commit + publish ---------------------------------------------------
    def stop(self, success: bool = True) -> Optional[MapTaskOutput]:
        if self._stopped:
            return None
        self._stopped = True
        if not success:
            self._close_spill()
            return None
        tracer = get_tracer()
        try:
            with tracer.span(
                "shuffle.write.commit",
                shuffle=self.handle.shuffle_id, map=self.map_id,
            ):
                mto = self._commit()
            # QoS admission (qos/registry.py): account the committed
            # bytes under the tenant's registered-byte quota — an
            # over-quota tenant queues briefly for earlier shuffles to
            # release, then proceeds DEGRADED (narrower stripes,
            # cold-tier serves) instead of OOMing the node
            self.manager.qos_admit(self.handle, self.metrics.bytes_written)
            self._record_metrics()
            return mto
        finally:
            self._close_spill()

    def _record_metrics(self) -> None:
        """Flush this map task's write metrics into the registry and
        the manager's per-shuffle telemetry (aggregated at the driver
        alongside the map-output locations)."""
        m = self.metrics
        counter("shuffle_map_tasks_total").inc()
        counter("shuffle_write_bytes_total").inc(m.bytes_written)
        counter("shuffle_write_records_total").inc(m.records_written)
        if m.spills:
            counter("shuffle_spills_total").inc(m.spills)
            counter("shuffle_spill_bytes_total").inc(m.bytes_spilled)
        self.manager.record_shuffle_write(self.handle.shuffle_id, m)

    # -- skew detection + split planning (skew/) -----------------------------
    def _split_plan(self, payloads, sizes):
        """Commit-hook into the skew subsystem: classify hot partitions
        from the EXACT committed sizes and frame-walk their contiguous
        payloads into sub-block spans.  None (no entry changes) unless
        skewEnabled — and only on the pull read plane: the collective
        planes iterate primary table rows and move whole partitions by
        construction, so markers must never reach them."""
        mgr = self.manager
        if mgr.skew is None or not mgr.skew.enabled:
            return None
        if mgr.conf.read_plane != "host":
            return None
        return plan_commit_splits(
            mgr.serializer, payloads, sizes, mgr.conf
        ) or None

    def _record_skew_commit(self, sizes, split_plan) -> None:
        """Fold this task's partition-balance snapshot into the skew
        registry and the per-shuffle telemetry plane — published even
        when splitting is off (or found nothing), so the driver's
        report can show partition balance either way."""
        mgr = self.manager
        if mgr.skew is None and not mgr.conf.metrics_enabled:
            return
        snap = get_skew().record_commit(
            self.handle.shuffle_id, sizes, split_plan,
            hot_key_share=(
                self._hot_keys.top_share() if self._hot_keys else 0.0
            ),
            records=self._psketch.records() if self._psketch else None,
        )
        mgr.record_shuffle_skew(self.handle.shuffle_id, snap)

    # -- push-based merged shuffle (shuffle/push.py) --------------------------
    def _maybe_push(self, payloads) -> None:
        """Push-mode commit hook: AFTER the local commit + publish, cut
        each non-empty contiguous partition payload at serializer frame
        boundaries (the skew splitter's span packer) and push the
        sub-blocks to the partition's deterministic merger.  Strictly
        best-effort — any failure here costs pull traffic, never the
        commit — and strictly additive: the local segments stay
        registered and published, so the pull path can always serve
        every block bit-exactly."""
        mgr = self.manager
        if not mgr.conf.push_enabled:
            return
        try:
            self._push_payloads(payloads)
        except Exception:
            logger.warning(
                "push after commit failed (shuffle=%d map=%d); blocks "
                "will be pulled", self.handle.shuffle_id, self.map_id,
                exc_info=True,
            )

    def _push_payloads(self, payloads) -> None:
        mgr = self.manager
        sid = self.handle.shuffle_id
        target = mgr.conf.push_block_target
        max_subs = mgr.conf.skew_max_sub_blocks
        for pid, payload in payloads.items():
            n = len(payload)
            if not n:
                continue
            host = mgr.push_merger_for(pid)
            if host is None:
                continue
            try:
                spans = sub_spans(
                    mgr.serializer.frame_spans(payload), target, max_subs
                )
            except (ValueError, IndexError):
                spans = None  # unparseable payload: push it whole
            from sparkrdma_tpu_torch.rpc.messages import PushSubBlockMsg

            msgs = [
                PushSubBlockMsg(
                    mgr.local_smid, sid, self.map_id, pid, n, off,
                    bytes(memoryview(payload[off : off + ln])),
                )
                for off, ln in (spans or [(0, n)])
            ]
            counter("push_sub_blocks_sent_total").inc(len(msgs))
            counter("push_bytes_sent_total").inc(n)
            mgr.push_partition(host, msgs)

    def _commit(self) -> MapTaskOutput:
        t0 = time.monotonic()
        serializer = self.manager.serializer
        if self._col_pending is not None or self._col_buckets is not None:
            kind = (
                getattr(self.handle.aggregator, "kind", None)
                if self.handle.map_side_combine else None
            )
            if (
                self._spill_file is None
                and self._spill_appenders is None
                and (self._col_buckets is None
                     or not any(self._col_buckets))
                and (kind is None or kind == "group")
                and getattr(serializer, "frame_header", None) is not None
            ):
                return self._commit_direct(t0)
            self._materialize_pending()
        if self._col_buckets is not None:
            chunked = getattr(serializer, "serialize_chunks", None)
            if chunked is not None and self._spill_file is None \
                    and self._spill_appenders is None:
                # zero-copy commit: headers + uint8 column views stream
                # straight into the resolver's staging buffer
                return self._commit_payloads([
                    _chunked_payload(*chunked(src)) if src is not None
                    else b""
                    for src in self._columnar_sources()
                ], t0)
            finals = [
                serializer.serialize(src) if src is not None else b""
                for src in self._columnar_sources()
            ]
        elif self._combined is not None:
            finals = [
                serializer.serialize(d.items()) if d else b""
                for d in self._combined
            ]
        else:
            finals = [
                serializer.serialize(self._ordered_bucket(b)) if b else b""
                for b in self._buckets
            ]
        if self._spill_appenders is not None:
            return self._commit_spilled_files(finals, t0)
        if self._spill_file is not None:
            # merge = chunk concatenation (both serializers frame
            # concatenation-safely), STREAMED through ChunkedPayload so
            # the spilled output is never fully resident at commit
            from sparkrdma_tpu_torch.shuffle.resolver import ChunkedPayload

            partition_bytes = []
            for pid, final in enumerate(finals):
                spilled_len = sum(n for _, n in self._spilled[pid])
                total_len = spilled_len + len(final)
                if total_len == 0:
                    partition_bytes.append(b"")
                else:
                    partition_bytes.append(ChunkedPayload(
                        total_len,
                        lambda pid=pid, final=final:
                            self._iter_partition_chunks(pid, final),
                    ))
        else:
            partition_bytes = finals
        return self._commit_payloads(partition_bytes, t0)

    def _commit_direct(self, t0: float) -> MapTaskOutput:
        """Zero-intermediate-copy columnar commit: lay all frames out in
        ONE buffer and gather each column straight into place with the
        deferred (pid, key) permutation — records touch host memory once
        between the user's arrays and the registered segment."""
        ser = self.manager.serializer
        P = self.handle.partitioner.num_partitions
        frames = []  # (pid, batch, order, lo, cnt, header)
        pid_sizes = np.zeros(P + 1, np.int64)
        for batch, order, counts in (self._col_pending or []):
            kitem = batch.keys.dtype.itemsize
            vitem = batch.vals.dtype.itemsize
            lo = 0
            for pid in range(P):
                cnt = int(counts[pid]) if pid < len(counts) else 0
                if cnt:
                    header = ser.frame_header(
                        batch.keys.dtype, batch.vals.dtype, cnt,
                        key_sorted=order is not None,
                    )
                    frames.append((pid, batch, order, lo, cnt, header))
                    pid_sizes[pid + 1] += len(header) + cnt * (kitem + vitem)
                lo += cnt
        # partition starts honor the resolver's commit alignment (the
        # collective plane row-gathers arena blocks at ROW_BYTES
        # granularity); sizes stay exact, the gaps are never served
        align = self.manager.resolver.commit_align
        sizes = pid_sizes[1:]
        starts = np.zeros(P + 1, np.int64)
        for p in range(P):
            starts[p + 1] = (
                (starts[p] + sizes[p] + align - 1) // align * align
            )
        total = int(starts[P - 1] + sizes[P - 1]) if P else 0
        # assemble in a POOLED buffer: repeated shuffles reuse warm
        # pages (a fresh np.empty of tens of MB pays first-touch page
        # faults);
        # the GC-tied release returns it to the pool when the shuffle's
        # segment dies
        try:
            buf = self.manager.staging_pool.alloc_gc(max(total, 1))
        except MemoryError:
            buf = np.empty(max(total, 1), np.uint8)
        # zero the alignment gaps so committed segments are
        # deterministic (gap bytes are staged but never served)
        for p in range(P - 1):
            buf[starts[p] + sizes[p] : starts[p + 1]] = 0
        cursors = starts[:P].copy()
        for pid, batch, order, lo, cnt, header in frames:
            c = int(cursors[pid])
            hl = len(header)
            buf[c : c + hl] = np.frombuffer(header, np.uint8)
            c += hl
            for col in (batch.keys, batch.vals):
                nb = cnt * col.dtype.itemsize
                out = buf[c : c + nb].view(col.dtype)
                if order is None:  # P == 1: original order, no gather
                    np.copyto(out, col)
                else:
                    take_rows(col, order[lo : lo + cnt], out=out)
                c += nb
            cursors[pid] = c
        ranges = [(int(starts[p]), int(sizes[p])) for p in range(P)]
        self.metrics.bytes_written = int(sizes.sum())  # payload, not gaps
        psizes = [n for _o, n in ranges]
        split_plan = self._split_plan(
            {
                p: buf[o : o + n]
                for p, (o, n) in enumerate(ranges) if n
            },
            psizes,
        )
        self._record_skew_commit(psizes, split_plan)
        mto = self.manager.resolver.commit_assembled(
            self.handle.shuffle_id, self.map_id, buf[:total], ranges,
            split_spans=split_plan,
        )
        self.manager.publish_map_output(
            self.handle.shuffle_id, self.map_id, mto
        )
        self._maybe_push({
            p: buf[o : o + n] for p, (o, n) in enumerate(ranges) if n
        })
        self.metrics.write_time_ms += (time.monotonic() - t0) * 1000
        return mto

    def _commit_spilled_files(self, finals, t0: float) -> MapTaskOutput:
        """Promote the per-partition spill files into the shuffle files
        (resolver.commit_spilled_files): append each partition's final
        in-memory remainder to its spill file, seal, and register the
        files as the map output's segments — the spilled bytes are
        written to disk exactly ONCE."""
        entries = []
        total = 0
        for pid, final in enumerate(finals):
            if self._spill_appenders[pid] is None and not final:
                entries.append(None)
                continue
            app = self._appender(pid)
            if final:
                app.append(final)
            n = app.finish()
            entries.append((app.path, n))
            total += n
        appenders, self._spill_appenders = self._spill_appenders, None
        # spill-file commits never split (their payloads are on disk,
        # not walkable views) — counted as unsplit in the balance stats
        self._record_skew_commit(
            [0 if e is None else e[1] for e in entries], None
        )
        try:
            mto = self.manager.resolver.commit_spilled_files(
                self.handle.shuffle_id, self.map_id, entries
            )
        except BaseException:
            # resolver cleans up what it registered; unlink the rest
            for app in appenders:
                if app is not None:
                    app.abandon()
            raise
        self.metrics.bytes_written = total
        self.manager.publish_map_output(
            self.handle.shuffle_id, self.map_id, mto
        )
        self.metrics.write_time_ms += (time.monotonic() - t0) * 1000
        return mto

    def _commit_payloads(self, partition_bytes, t0: float) -> MapTaskOutput:
        from sparkrdma_tpu_torch.shuffle.resolver import ChunkedPayload, _payload_len

        sizes = [_payload_len(b) for b in partition_bytes]
        self.metrics.bytes_written = sum(sizes)
        # only contiguous finals are frame-walkable; chunked payloads
        # (spill merges, streamed columnar) commit unsplit
        split_plan = self._split_plan(
            {
                pid: b for pid, b in enumerate(partition_bytes)
                if not isinstance(b, ChunkedPayload) and len(b)
            },
            sizes,
        )
        self._record_skew_commit(sizes, split_plan)
        mto = self.manager.resolver.commit_map_output(
            self.handle.shuffle_id, self.map_id, partition_bytes,
            # spilled output is already on disk: commit via the mmap
            # path so peak memory stays bounded by the spill threshold
            prefer_file_backed=self._spill_file is not None,
            split_spans=split_plan,
        )
        self.manager.publish_map_output(self.handle.shuffle_id, self.map_id, mto)
        # chunked payloads (spill merges, streamed columnar) are not
        # frame-walkable views — their blocks stay pull-served
        self._maybe_push({
            pid: b for pid, b in enumerate(partition_bytes)
            if not isinstance(b, ChunkedPayload) and len(b)
        })
        self.metrics.write_time_ms += (time.monotonic() - t0) * 1000
        return mto
