"""Block resolver: commits map outputs into device memory, serves local reads.

Analog of RdmaShuffleBlockResolver + RdmaMappedFile + RdmaWrapperShuffleData
(SURVEY.md §2 rows 3, 5, 6): where the reference intercepts
``writeIndexFileAndCommit`` to mmap+register the shuffle data file and
build the per-reduce-partition location table
(RdmaMappedFile.java:99-171), here ``commit_map_output`` stages the
serialized partition bytes into a registered device segment and fills
the ``MapTaskOutput`` table with (offset, length, mkey) entries.  With
``stage_to_device`` each committed output is one ``uint8[n]`` tensor on
the resolver's device (a synchronous host-to-device copy), registered as
a ``DeviceSegment``; reducers' reads of it are device-to-host copies.

Local partitions are served straight from the arena without touching the
transport (reference: getLocalRdmaPartition,
RdmaShuffleBlockResolver.scala:73-78).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.memory.arena import ArenaManager, DeviceSegment
from sparkrdma_tpu_torch.memory.device_arena import ROW_BYTES as _ROW_BYTES
from sparkrdma_tpu_torch.metrics import get_registry
from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device
from sparkrdma_tpu_torch.shuffle.map_output import MapTaskOutput
from sparkrdma_tpu_torch.skew.splitter import (
    collapse_sub_locations,
    is_split_marker,
    make_marker,
)
from sparkrdma_tpu_torch.transport.node import Node
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.types import BlockLocation

logger = logging.getLogger(__name__)

# skew sub-block table layout (skew/splitter.py): a split partition's
# primary row is a marker naming aux rows past the logical partition
# count; these helpers keep every commit path emitting that shape
# identically.


def _split_extra(split_spans) -> int:
    """How many aux table rows a commit's split plan needs."""
    return sum(len(v) for v in split_spans.values()) if split_spans else 0


def _put_partition_entry(
    mto: MapTaskOutput, pid: int, off: int, n: int, mkey: int,
    spans, aux: int,
) -> int:
    """Install partition ``pid``'s table entry at payload (off, n) in
    segment ``mkey``: an ordinary location, or — when ``spans`` carries
    the partition's sub-block plan — a marker plus one aux row per
    sub-span.  Returns the advanced aux cursor."""
    if n == 0:
        mto.put(pid, BlockLocation.EMPTY)
        return aux
    if spans:
        mto.put(pid, make_marker(aux, len(spans)))
        for rel, ln in spans:
            mto.put(aux, BlockLocation(off + rel, ln, mkey))
            aux += 1
        return aux
    mto.put(pid, BlockLocation(off, n, mkey))
    return aux


def _resolve_marker(mto: MapTaskOutput, loc: BlockLocation) -> BlockLocation:
    """Collapse a sub-block marker for LOCAL serving: the sub-spans
    tile the partition payload contiguously in one segment, so the
    local read is exactly the unsplit block."""
    if not is_split_marker(loc):
        return loc
    subs = mto.get_locations(loc.address, loc.address + loc.length - 1)
    return collapse_sub_locations(subs)


class ChunkedPayload:
    """Lazily-produced partition bytes for the commit path: total
    length known up front, chunks materialized one at a time.  Lets a
    spilled map output stream into the commit target (host buffer or
    data file) without ever being fully resident in RAM."""

    __slots__ = ("length", "chunks_fn")

    def __init__(self, length: int, chunks_fn):
        self.length = length
        self.chunks_fn = chunks_fn  # () -> Iterator[bytes]


def _payload_len(p) -> int:
    return p.length if isinstance(p, ChunkedPayload) else len(p)


def _payload_chunks(p):
    if isinstance(p, ChunkedPayload):
        yield from p.chunks_fn()
    elif len(p):  # bytes OR ndarray views (no ndarray bool())
        yield p


class _ShuffleData:
    """Per-shuffle write-side state on one executor (the
    RdmaWrapperShuffleData analog)."""

    def __init__(self, shuffle_id: int, num_partitions: int):
        self.shuffle_id = shuffle_id
        self.num_partitions = num_partitions
        # map_id -> (output table, device segment)
        self.outputs: Dict[int, Tuple[MapTaskOutput, DeviceSegment]] = {}


class ShuffleBlockResolver:
    """Executor-local registry of committed map outputs."""

    def __init__(self, arena: ArenaManager, node: Optional[Node] = None,
                 stage_to_device: bool = True, staging_pool=None,
                 file_backed_threshold: int = 0,
                 spill_dir: Optional[str] = None,
                 lazy_staging: bool = False,
                 write_block_size: int = 8 << 20,
                 direct_io: str = "auto",
                 tier_store=None,
                 device: DeviceLike = None):
        self.arena = arena
        self.node = node
        self.stage_to_device = stage_to_device
        # where stage_to_device commits land: CUDA unless the caller
        # asks for the CPU (resolved only when it is needed, so a host
        # plane resolver needs no card)
        self.device = resolve_device(device) if stage_to_device else None
        # always-on staging counters (forced instruments of the metrics
        # registry): bytes and segments staged, and the commits that
        # stayed on the host because the pool or the arena was full
        reg = get_registry()
        dev = self.device.type if self.device is not None else "none"
        self._m_h2d_bytes = reg.counter(
            "staging_h2d_bytes_total", force=True, device=dev
        )
        self._m_dev_segments = reg.counter(
            "staging_device_segments_total", force=True, device=dev
        )
        self._m_pool_fallback = reg.counter(
            "staging_commit_fallbacks_total", force=True,
            reason="pool_exhausted",
        )
        self._m_arena_fallback = reg.counter(
            "staging_commit_fallbacks_total", force=True,
            reason="arena_full",
        )
        # residency manager for file-backed commits (memory/tier.py):
        # when wired, those commits register lazily per span and serve
        # through the hot/cold tiers; None keeps the eager whole-output
        # mmap registration
        self.tier_store = tier_store
        # conf directIO: "off" keeps file-backed READS on the page-
        # cache mmap path too (O_DIRECT bypasses the cache; repeated
        # reads of one block would hit disk every time)
        self.direct_io = direct_io
        # ODP analog (RdmaShuffleConf.scala:68-83,
        # RdmaBufferManager.java:103-110): commits stay in host memory;
        # the first device-plane touch stages the segment into the HBM
        # arena on demand (ensure_staged), optionally swept ahead by
        # prefetch_shuffle (RdmaMappedFile.java:158-168's odp prefetch)
        self.lazy_staging = lazy_staging
        # ranks BELOW the arena/device-arena locks it calls into while
        # staging a segment (ensure_staged holds it across the
        # alloc + write + replace sequence)
        self._stage_lock = dbg_lock("resolver.stage", 32)
        self.staging_pool = staging_pool  # pooled host buffers for concat
        # persistent per-device HBM arena (set when the executor is
        # attached to a collective network); commits then land as arena
        # spans with ROW_BYTES-aligned partitions so the exchange
        # coordinator can row-gather them
        self.device_arena = None
        # commits >= this many bytes go to an mmapped file segment (the
        # RdmaMappedFile path); 0 disables the size trigger — but a
        # writer whose output spilled still commits file-backed via
        # ``prefer_file_backed`` (its data is already on disk)
        self.file_backed_threshold = file_backed_threshold
        self.spill_dir = spill_dir
        # arena-path commits split into segments of at most this many
        # bytes (the reference's chunked mmap+MR registration,
        # RdmaMappedFile.java:95-171): bounded span sizes keep a
        # fragmented arena allocatable and large map outputs from
        # needing one contiguous extent
        self.write_block_size = max(int(write_block_size), 1)
        self._shuffles: Dict[int, _ShuffleData] = {}  # guarded-by: _lock
        self._lock = dbg_lock("resolver.shuffles", 34)

    @property
    def commit_align(self) -> int:
        """Partition-offset alignment writers must honor in assembled
        commits: arena-resident blocks are row-gathered by the
        collective plane, so their offsets must be ROW_BYTES-aligned
        (unaligned blocks still read correctly — they just fall back to
        the host path).  Lazy commits align too: they may be staged
        into the arena later."""
        if self.device_arena is not None and (
                self.stage_to_device or self.lazy_staging):
            return _ROW_BYTES
        return 1

    def _alloc_span_or_none(self, total: int, shuffle_id: int,
                            map_id: int):
        """Arena span for a commit, or None when the budget is
        exhausted — the commit then degrades to a host-resident
        segment instead of failing the write (the larger-than-HBM
        shuffle contract; lazy staging may promote it later)."""
        try:
            return self.device_arena.alloc(max(total, 1))
        except MemoryError:
            logger.warning(
                "device arena full: committing shuffle=%d map=%d "
                "(%dB) host-resident", shuffle_id, map_id, total,
            )
            return None

    # -- lazy staging (the ODP page-fault path) ------------------------------
    def ensure_staged(self, mkey: int):
        """Stage a host-committed segment into the device arena on
        demand, keeping its mkey (published locations stay valid).
        Returns the (possibly already) arena-backed segment, or None
        when this block cannot ride the device plane."""
        if not self.lazy_staging or self.device_arena is None:
            return None
        with self._stage_lock:
            seg = self.arena.get(mkey)
            if seg is None:
                return None
            if getattr(seg, "span", None) is not None:
                return seg  # already staged (racing reader won)
            arr = getattr(seg, "array", None)
            if not isinstance(arr, np.ndarray) or arr.dtype != np.uint8:
                return None  # not host bytes (already a device array)
            span = self.device_arena.alloc(max(int(arr.shape[0]), 1))
            try:
                self.device_arena.write(span, arr)
                new_seg = self.arena.replace_with_span(mkey, span)
            except BaseException:
                span.free()
                raise
            if new_seg is not None:
                # swap the shuffle-output entry too, dropping the last
                # reference to the host copy (local reads now serve from
                # the arena; the host bytes free once views die)
                with self._lock:
                    sd = self._shuffles.get(new_seg.shuffle_id)
                    if sd is not None:
                        for _mid, (_mto, segs) in sd.outputs.items():
                            if mkey in segs:
                                segs[mkey] = new_seg
                                break
            return new_seg

    def prefetch_shuffle(self, shuffle_id: int) -> int:
        """Stage every host-resident segment of one shuffle ahead of
        the reads (the ODP prefetch sweep, RdmaMappedFile.java:158-168).
        Returns how many of the shuffle's segments are arena-resident
        after the sweep."""
        if not self.lazy_staging or self.device_arena is None:
            return 0
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            mkeys = (
                [mk for _, segs in sd.outputs.values() for mk in segs]
                if sd else []
            )
        staged = 0
        for mkey in mkeys:
            try:
                seg = self.ensure_staged(mkey)
            except MemoryError:
                # arena full: skip — the segment keeps serving from
                # host, exactly like the on-demand path's fallback
                logger.warning(
                    "prefetch: staging mkey=%d skipped (arena full)", mkey
                )
                continue
            if seg is not None:
                staged += 1
        return staged

    def _get_or_create(self, shuffle_id: int, num_partitions: int) -> _ShuffleData:
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            if sd is None:
                sd = self._shuffles.setdefault(
                    shuffle_id, _ShuffleData(shuffle_id, num_partitions)
                )
            return sd

    # -- write side ---------------------------------------------------------
    def commit_map_output(
        self,
        shuffle_id: int,
        map_id: int,
        partition_bytes: Sequence,
        prefer_file_backed: bool = False,
        split_spans: Optional[Dict[int, List[Tuple[int, int]]]] = None,
    ) -> MapTaskOutput:
        """Stage one map task's serialized partitions into a registered
        segment and build its location table.  Each partition payload is
        ``bytes`` or a :class:`ChunkedPayload` (spill-merge commits
        stream their chunks — nothing is pre-joined in RAM).

        ``prefer_file_backed`` routes the commit to the mmap path even
        below ``file_backed_threshold`` — set by writers whose output
        already spilled to disk, so the commit never re-materializes in
        one in-memory buffer what spilling was bounding.

        ``split_spans`` is the writer's skew split plan
        (:func:`sparkrdma_tpu_torch.skew.splitter.plan_commit_splits`):
        ``{pid: [(rel_off, rel_len), ...]}`` sub-block spans within the
        partition payload.  Those partitions register a marker entry
        plus one aux table row per sub-block; the payload bytes land
        exactly where they would have anyway."""
        num_partitions = len(partition_bytes)
        sd = self._get_or_create(shuffle_id, num_partitions)
        use_arena = self.stage_to_device and self.device_arena is not None
        # collective plane: partition starts row-aligned for the gather
        align = self.commit_align
        sizes = [_payload_len(b) for b in partition_bytes]
        total = 0
        for n in sizes:
            total = (total + align - 1) // align * align + n
        if prefer_file_backed or (
            self.file_backed_threshold and total >= self.file_backed_threshold
        ):
            return self._commit_file_backed(
                sd, shuffle_id, map_id, partition_bytes, total,
                split_spans=split_spans,
            )
        # arena commits split into write-block-sized segments (chunked
        # registration, RdmaMappedFile.java:95-171): greedy groups of
        # whole partitions, a partition larger than the block gets its
        # own segment.  Host/device-tensor commits keep one segment.
        if use_arena and total > self.write_block_size:
            groups: List[List[int]] = [[]]
            gsize = 0
            for pid, n in enumerate(sizes):
                an = (gsize + align - 1) // align * align + n - gsize
                if groups[-1] and gsize + an > self.write_block_size:
                    groups.append([pid])
                    gsize = n
                else:
                    groups[-1].append(pid)
                    gsize += an
        else:
            groups = [list(range(num_partitions))]
        mto = MapTaskOutput(num_partitions + _split_extra(split_spans))
        aux = num_partitions  # sub-block rows allocated in pid order
        segs: Dict[int, DeviceSegment] = {}
        try:
            for pids in groups:
                g_bytes = [partition_bytes[p] for p in pids]
                g_offsets: List[Tuple[int, int]] = []
                g_total = 0
                for p in pids:
                    g_total = (g_total + align - 1) // align * align
                    g_offsets.append((g_total, sizes[p]))
                    g_total += sizes[p]
                seg = self._commit_partitions_segment(
                    shuffle_id, map_id, g_bytes, g_offsets, g_total,
                    use_arena,
                )
                segs[seg.mkey] = seg
                for p, (o, n) in zip(pids, g_offsets):
                    aux = _put_partition_entry(
                        mto, p, o, n, seg.mkey,
                        split_spans.get(p) if split_spans else None, aux,
                    )
        except BaseException:
            for seg in segs.values():
                if self.node is not None:
                    self.node.unregister_block_store(seg.mkey)
                self.arena.release(seg.mkey)
            raise
        # install, releasing any superseded segments from a task retry
        self._install(sd, map_id, mto, segs)
        return mto

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """One committed map output as a ``uint8[n]`` tensor on the
        resolver's device: a synchronous copy (pool buffers are not
        CUDA-pinned, so a ``non_blocking`` copy from them is unsafe).
        A failed copy raises; nothing falls back to the host."""
        array = torch.from_numpy(host).to(self.device, copy=True)
        self._m_h2d_bytes.inc(int(host.shape[0]))
        self._m_dev_segments.inc()
        return array

    def _commit_partitions_segment(
        self, shuffle_id: int, map_id: int, partition_bytes: Sequence,
        offsets: List[Tuple[int, int]], total: int, use_arena: bool,
    ) -> DeviceSegment:
        """Assemble one group of partitions into a buffer and register
        it (arena span, device array, or host bytes — with arena-full
        and pool-exhausted fallbacks)."""
        staging_buf = None
        if self.stage_to_device and self.staging_pool is not None and total > 0:
            # serialize through the pooled, page-aligned native buffer —
            # the registered-staging path (RdmaBuffer analog).  Host-only
            # commits deliberately AVOID the pool: their segments serve
            # zero-copy read views, and pooled memory may be recycled
            # while a view is still alive; plain numpy buffers are kept
            # alive by the views themselves.
            try:
                staging_buf = self.staging_pool.alloc(total)
                buf = staging_buf.view
            except MemoryError:
                # pool budget exhausted (keepalives pin buffers for the
                # shuffle's lifetime): fall back to a plain host buffer
                # rather than failing the commit
                self._m_pool_fallback.inc()
                buf = np.empty(max(total, 1), dtype=np.uint8)
        else:
            buf = np.empty(max(total, 1), dtype=np.uint8)
        for (off, _n), b in zip(offsets, partition_bytes):
            for chunk in _payload_chunks(b):
                m = len(chunk)
                buf[off : off + m] = np.frombuffer(chunk, np.uint8)
                off += m
        span = (
            self._alloc_span_or_none(total, shuffle_id, map_id)
            if use_arena else None
        )
        arena_full = use_arena and span is None
        use_arena = span is not None
        if arena_full:
            self._m_arena_fallback.inc()
        if arena_full and staging_buf is not None:
            # nothing zero-copy aliases a host fallback segment, so
            # copy once and release the pooled buffer now instead of
            # pinning it for the shuffle's lifetime
            buf = buf[: max(total, 1)].copy()
            staging_buf.free()
            staging_buf = None
        try:
            if use_arena:
                try:
                    self.device_arena.write(span, buf[: max(total, 1)])
                    seg = self.arena.register_arena_span(
                        span, shuffle_id=shuffle_id
                    )
                except BaseException:
                    span.free()
                    raise
                if staging_buf is not None:
                    staging_buf.free()
                    staging_buf = None
            else:
                if self.stage_to_device and not arena_full:
                    array = self._to_device(buf[: max(total, 1)])
                else:
                    # arena-full commits stay on the HOST (an unbudgeted
                    # device copy would defeat the arena's budget)
                    array = np.asarray(buf[: max(total, 1)])
                # the synchronous copy aliases nothing, but the staging
                # buffer lives until the segment is released all the
                # same, so pool statistics and the resource ledger read
                # as in the JAX package (freeing it here is a later
                # optimisation)
                seg = self.arena.register(
                    array, shuffle_id=shuffle_id, keepalive=staging_buf,
                    # host commits are plain numpy (never pooled): reads
                    # may serve refcount-protected views
                    zero_copy_ok=(
                        not self.stage_to_device and staging_buf is None
                    ),
                )
        except BaseException:
            # register never took ownership: return the buffer ourselves
            if staging_buf is not None:
                staging_buf.free()
            raise
        if self.node is not None:
            self.node.register_block_store(seg.mkey, self.arena)
        return seg

    def commit_assembled(
        self, shuffle_id: int, map_id: int, buf: np.ndarray,
        ranges: Sequence[Tuple[int, int]],
        split_spans: Optional[Dict[int, List[Tuple[int, int]]]] = None,
    ) -> MapTaskOutput:
        """Commit a writer-assembled contiguous buffer: ``ranges[pid] =
        (offset, length)`` within ``buf``.  The writer gathered records
        straight into ``buf``, so this path adds NO further copy on the
        host plane (the buffer itself becomes the registered segment);
        device staging is the one host-to-device copy.
        ``split_spans`` as in :meth:`commit_map_output`."""
        sd = self._get_or_create(shuffle_id, len(ranges))
        total = int(buf.shape[0])
        if self.file_backed_threshold and total >= self.file_backed_threshold:
            return self._commit_file_backed(
                sd, shuffle_id, map_id,
                [buf[off : off + n] for off, n in ranges], total,
                split_spans=split_spans,
            )
        span = (
            self._alloc_span_or_none(total, shuffle_id, map_id)
            if self.stage_to_device and self.device_arena is not None
            else None
        )
        if span is not None:
            try:
                self.device_arena.write(span, buf)
                seg = self.arena.register_arena_span(
                    span, shuffle_id=shuffle_id
                )
            except BaseException:
                span.free()
                raise
        else:
            if self.stage_to_device and self.device_arena is None:
                array = self._to_device(buf if total else buf[:1])
                zero_copy = False
            else:
                if self.stage_to_device:
                    self._m_arena_fallback.inc()
                # host plane, or arena-full fallback (an unbudgeted
                # device copy would defeat the arena's budget): the
                # writer hands buf over, so views may serve zero-copy
                array = buf if total else np.zeros(1, np.uint8)
                zero_copy = True
            seg = self.arena.register(
                array, shuffle_id=shuffle_id, zero_copy_ok=zero_copy
            )
        if self.node is not None:
            self.node.register_block_store(seg.mkey, self.arena)
        mto = MapTaskOutput(len(ranges) + _split_extra(split_spans))
        aux = len(ranges)
        for pid, (off, n) in enumerate(ranges):
            aux = _put_partition_entry(
                mto, pid, off, n, seg.mkey,
                split_spans.get(pid) if split_spans else None, aux,
            )
        self._install(sd, map_id, mto, seg)
        return mto

    def _commit_file_backed(
        self, sd: "_ShuffleData", shuffle_id: int, map_id: int,
        partition_bytes: Sequence, total: int,
        split_spans: Optional[Dict[int, List[Tuple[int, int]]]] = None,
    ) -> MapTaskOutput:
        """Large-output commit: stream the map task's partitions into
        one data file and serve it through the tiered block store
        (memory/tier.py) when one is wired — the file stays UNMAPPED
        until a span is resolved or prefetched, hot blocks live in
        budgeted pooled rows, cold reads hit the disk.  Without a tier
        store, the legacy eager path registers the whole read-only
        mmap up front (the RdmaMappedFile mmap+register shape).
        Streamed chunk-by-chunk either way, and NOT debited against
        the arena byte budget — the whole point is holding shuffles
        larger than the in-memory arena."""
        from sparkrdma_tpu_torch.memory.mapped_file import MappedFile

        tiered = self.tier_store is not None
        mf = MappedFile(
            (chunk for b in partition_bytes for chunk in _payload_chunks(b)),
            directory=self.spill_dir,
            direct_write=self.direct_io != "off",
            defer_map=tiered,
        )
        mf.direct_read_enabled = self.direct_io != "off"
        spans: List[Tuple[int, int]] = []
        off = 0
        for b in partition_bytes:
            n = _payload_len(b)
            spans.append((off, n))
            off += n
        try:
            if tiered:
                seg = self.tier_store.adopt(
                    mf, spans, max(total, 1), shuffle_id, self.arena
                )
            else:
                # mmap reads may serve views: MappedFile.free defers
                # closing the mapping while views are exported
                # (BufferError path)
                seg = self.arena.register(
                    mf.array, shuffle_id=shuffle_id, keepalive=mf,
                    budgeted=False, zero_copy_ok=True,
                )
        except BaseException:
            mf.free()
            raise
        if self.node is not None:
            self.node.register_block_store(seg.mkey, self.arena)
        # the tier store keeps whole partitions as its residency blocks
        # (sub-block reads are in-block sub-ranges, which it already
        # serves with promotion), so split plans change only the table
        mto = MapTaskOutput(len(partition_bytes) + _split_extra(split_spans))
        aux = len(partition_bytes)
        for pid, (off, n) in enumerate(spans):
            aux = _put_partition_entry(
                mto, pid, off, n, seg.mkey,
                split_spans.get(pid) if split_spans else None, aux,
            )
        self._install(sd, map_id, mto, seg)
        return mto

    def commit_spilled_files(
        self, shuffle_id: int, map_id: int, files: Sequence,
    ) -> MapTaskOutput:
        """ZERO-COPY commit of per-partition spill files: each file
        registers directly as that partition's mapped segment (the
        spill file IS the shuffle file — no consolidation rewrite, the
        round-4 answer to the writeback-throttled double write).
        ``files[pid]`` is ``(path, logical_length)`` or None for an
        empty partition.  Takes ownership of every path (unlinked on
        segment release, or here on failure/emptiness)."""
        from sparkrdma_tpu_torch.memory.mapped_file import MappedFile

        sd = self._get_or_create(shuffle_id, len(files))
        mto = MapTaskOutput(len(files))
        segs: Dict[int, DeviceSegment] = {}
        done = 0
        try:
            for pid, ent in enumerate(files):
                done = pid + 1
                if ent is None:
                    mto.put(pid, BlockLocation.EMPTY)
                    continue
                path, length = ent
                if length == 0:
                    mto.put(pid, BlockLocation.EMPTY)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                tiered = self.tier_store is not None
                mf = MappedFile.from_path(path, length, defer_map=tiered)
                mf.direct_read_enabled = self.direct_io != "off"
                try:
                    if tiered:
                        # one block per spill file: residency (and the
                        # lazy per-span registration) managed by the
                        # tier store like any file-backed commit
                        seg = self.tier_store.adopt(
                            mf, [(0, length)], length, shuffle_id,
                            self.arena,
                        )
                    else:
                        seg = self.arena.register(
                            mf.array, shuffle_id=shuffle_id, keepalive=mf,
                            budgeted=False, zero_copy_ok=True,
                        )
                except BaseException:
                    mf.free()
                    raise
                if self.node is not None:
                    self.node.register_block_store(seg.mkey, self.arena)
                segs[seg.mkey] = seg
                mto.put(pid, BlockLocation(0, length, seg.mkey))
        except BaseException:
            for seg in segs.values():
                if self.node is not None:
                    self.node.unregister_block_store(seg.mkey)
                self.arena.release(seg.mkey)
            # ownership contract: unlink the files this commit never
            # reached (the failed one cleans itself up via mf.free)
            for ent in files[done:]:
                if ent is not None:
                    try:
                        os.unlink(ent[0])
                    except OSError:
                        pass
            raise
        self._install(sd, map_id, mto, segs)
        return mto

    def _install(self, sd: "_ShuffleData", map_id: int,
                 mto: MapTaskOutput, segs) -> None:
        """Publish (mto, {mkey: segment}) as map_id's output, releasing
        any superseded segments from a task retry/speculation.  A
        single segment may be passed bare."""
        if not isinstance(segs, dict):
            segs = {segs.mkey: segs}
        with self._lock:
            prior = sd.outputs.get(map_id)
            sd.outputs[map_id] = (mto, segs)
        if prior is not None:
            for old_seg in prior[1].values():
                if self.node is not None:
                    self.node.unregister_block_store(old_seg.mkey)
                self.arena.release(old_seg.mkey)

    # -- read side (local short-circuit) ------------------------------------
    def get_local_block(self, shuffle_id: int, map_id: int, reduce_id: int):
        """Serve one partition block as a bytes-LIKE payload — host
        segments hand back zero-copy chunk views (read-only ndarray /
        memoryview over the registered buffer), device segments the
        landed host array; nothing on the serve path materializes
        ``bytes`` (the transport sends any buffer view scatter-gather,
        and the deserializers consume views directly)."""
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            entry = sd.outputs.get(map_id) if sd else None
        if entry is None:
            raise KeyError(
                f"no committed output for shuffle={shuffle_id} map={map_id}"
            )
        mto, segs = entry
        loc = _resolve_marker(mto, mto.get_location(reduce_id))
        if loc.is_empty:
            return b""
        return segs[loc.mkey].read(loc.address, loc.length)

    def get_local_blocks(
        self, shuffle_id: int, map_id: int, reduce_ids
    ) -> List:
        """Serve many of one map output's partition blocks with ONE
        backing-store read (``Segment.read_many`` batches the
        device→host transfer — the bulk plane reads every partition of
        every map, and a per-block fetch pays a device round-trip
        each).  Blocks are chunk VIEWS of the landed cluster buffers,
        never per-block ``bytes`` joins (see
        :func:`sparkrdma_tpu_torch.memory.arena._read_spans_clustered`).
        Empty partitions come back as ``b""``."""
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            entry = sd.outputs.get(map_id) if sd else None
        if entry is None:
            raise KeyError(
                f"no committed output for shuffle={shuffle_id} map={map_id}"
            )
        mto, segs = entry
        locs = [
            _resolve_marker(mto, mto.get_location(r)) for r in reduce_ids
        ]
        # one batched read per backing segment (multi-segment map
        # outputs exist under write_block_size splitting)
        by_seg: Dict[int, List[Tuple[int, int]]] = {}
        for i, loc in enumerate(locs):
            if not loc.is_empty:
                by_seg.setdefault(loc.mkey, []).append(
                    (i, loc.address, loc.length)
                )
        out: List = [b""] * len(locs)
        for mkey, items in by_seg.items():
            blocks = segs[mkey].read_many([(a, ln) for _i, a, ln in items])
            for (i, _a, _ln), blk in zip(items, blocks):
                out[i] = blk
        return out

    def num_partitions(self, shuffle_id: int) -> int:
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
        if sd is None:
            raise KeyError(f"shuffle {shuffle_id} has no committed outputs")
        return sd.num_partitions

    def map_ids(self, shuffle_id: int) -> List[int]:
        """This executor's committed map ids for one shuffle, sorted
        (the canonical order of the bulk-exchange stream assembly)."""
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            return sorted(sd.outputs.keys()) if sd else []

    def get_map_output(self, shuffle_id: int, map_id: int) -> Optional[MapTaskOutput]:
        with self._lock:
            sd = self._shuffles.get(shuffle_id)
            entry = sd.outputs.get(map_id) if sd else None
        return entry[0] if entry else None

    # -- lifecycle ----------------------------------------------------------
    def remove_shuffle(self, shuffle_id: int) -> None:
        """Dispose segments + tables (reference: removeDataByMap/dispose)."""
        with self._lock:
            sd = self._shuffles.pop(shuffle_id, None)
        if sd is not None:
            for _mto, segs in sd.outputs.values():
                for seg in segs.values():
                    if self.node is not None:
                        self.node.unregister_block_store(seg.mkey)
            self.arena.release_shuffle(shuffle_id)

    def stop(self) -> None:
        with self._lock:
            ids = list(self._shuffles.keys())
        for sid in ids:
            self.remove_shuffle(sid)
