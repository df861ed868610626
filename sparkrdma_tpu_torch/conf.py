"""Typed, range-validated configuration for the TPU shuffle framework.

Analog of the reference's RdmaShuffleConf (RdmaShuffleConf.scala:34-126):
namespaced keys under ``spark.shuffle.tpu.*`` with clamped int and
byte-size parsers falling back to defaults.  Every knob from the
reference's `spark.shuffle.rdma.*` namespace has an equivalent here
(SURVEY.md §2 row "Shuffle conf"); knobs that only make sense for
ibverbs (recv WR sizing, ODP) map onto their ICI/arena analogs.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgt]?)b?\s*$", re.IGNORECASE)
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_byte_size(value: object) -> int:
    """Parse '8m', '256k', '10g', 4096 → bytes."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _SIZE_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse byte size: {value!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def parse_time_ms(value: object) -> int:
    """Parse '20s', '50ms', '2s', 120 (seconds) → milliseconds."""
    if isinstance(value, (int, float)):
        return int(value) * 1000
    s = str(value).strip().lower()
    if s.endswith("ms"):
        return int(float(s[:-2]))
    if s.endswith("s"):
        return int(float(s[:-1]) * 1000)
    return int(float(s)) * 1000


def host_core_census() -> int:
    """Cores actually runnable by THIS process.

    ``os.cpu_count()`` reports the machine; a containerized or
    ``taskset``-pinned executor may be allowed far fewer.  Prefer the
    scheduler-affinity mask (which cgroup cpusets and
    ``sched_setaffinity`` both shrink) and fall back to the machine
    count where the platform has no affinity API."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def device_census() -> int:
    """CUDA devices this process can see — the ``host_core_census``
    analog every multi-device default keys off:
    ``torch.cuda.device_count()`` when CUDA is available, else 1, so a
    host without a card can never silently gate (or fake-pass) a
    multi-device-only default."""
    import torch

    if torch.cuda.is_available():
        return max(1, torch.cuda.device_count())
    return 1


class TpuShuffleConf:
    """Config accessor over a plain dict of ``spark.shuffle.tpu.*`` keys.

    Each accessor clamps to a [min, max] range and falls back to a default
    on missing/garbage values, like the reference's getRdmaConfIntInRange /
    getConfBytesInRange (RdmaShuffleConf.scala:36-47).
    """

    PREFIX = "spark.shuffle.tpu."
    LEGACY_PREFIX = "spark.shuffle.rdma."
    # reference knobs (RdmaShuffleConf.scala:34-126) accepted verbatim
    # under the legacy namespace; names that map onto a different TPU
    # analog are translated, the rest alias one-to-one.  An explicit
    # spark.shuffle.tpu.* key always wins over its legacy alias.
    LEGACY_RENAMES = {
        "useOdp": "lazyStaging",          # on-demand registration analog
        # RdmaNode's cpuList pinned the completion-vector THREADS, not
        # devices — it maps onto the dispatcher-thread affinity knob,
        # keeping deviceList free for mesh-device selection
        "cpuList": "dispatcherCpuList",
        # the reference's connect-attempt knob maps onto the jittered
        # retry policy (connectRetries + connectBackoffMs)
        "maxConnectionAttempts": "connectRetries",
    }

    def __init__(self, conf: Optional[Mapping[str, object]] = None):
        self._conf: Dict[str, object] = dict(conf or {})
        # legacy namespace support: a reference user's existing
        # spark.shuffle.rdma.* settings apply unchanged
        for key, value in list(self._conf.items()):
            if not key.startswith(self.LEGACY_PREFIX):
                continue
            short = key[len(self.LEGACY_PREFIX):]
            mapped = self.LEGACY_RENAMES.get(short, short)
            new_key = self.PREFIX + mapped
            self._conf.setdefault(new_key, value)

    # -- raw access ---------------------------------------------------------
    def get(self, short_key: str, default=None):
        return self._conf.get(self.PREFIX + short_key, default)

    def set(self, short_key: str, value: object) -> "TpuShuffleConf":
        self._conf[self.PREFIX + short_key] = value
        return self

    def _int_in_range(self, key: str, default: int, lo: int, hi: int) -> int:
        raw = self.get(key)
        if raw is None:
            return default
        try:
            v = int(raw)
        except (TypeError, ValueError):
            return default
        return max(lo, min(hi, v))

    def _bytes_in_range(self, key: str, default: int, lo: int, hi: int) -> int:
        raw = self.get(key)
        if raw is None:
            return default
        try:
            v = parse_byte_size(raw)
        except ValueError:
            return default
        return max(lo, min(hi, v))

    def _bool(self, key: str, default: bool) -> bool:
        raw = self.get(key)
        if raw is None:
            return default
        if isinstance(raw, bool):
            return raw
        return str(raw).strip().lower() in ("1", "true", "yes", "on")

    def _time_ms(self, key: str, default_ms: int) -> int:
        raw = self.get(key)
        if raw is None:
            return default_ms
        try:
            return parse_time_ms(raw)
        except ValueError:
            return default_ms

    def _float_in_range(self, key: str, default: float, lo: float,
                        hi: float) -> float:
        raw = self.get(key)
        if raw is None:
            return default
        try:
            v = float(raw)
        except (TypeError, ValueError):
            return default
        return max(lo, min(hi, v))

    # -- core census (every cpu_count-derived default reads this) ----------
    @property
    def core_census(self) -> int:
        """The core count that parallelism defaults key off.

        Resolution order: an explicit ``coreCensus`` setting wins
        (> 0); else a ``dispatcherCpuList`` pin implies the executor
        will run on that many cores; else the process affinity mask
        (``host_core_census``), NOT ``os.cpu_count()`` — a CPU-pinned
        containerized executor sees the machine's count but can only
        run on its mask, and sizing decode/serve/spin defaults off the
        machine count oversubscribes the pin (the bug this key fixes).
        Every conf default that used to read ``os.cpu_count()``
        (``decodeThreads``, ``bulkPipelineWindows``,
        ``transportPollSpinUs``, ``tierPrefetch``,
        ``transportNumStripes``, ``transportServeThreads``) now reads
        this."""
        explicit = self._int_in_range("coreCensus", 0, 0, 4096)
        if explicit > 0:
            return explicit
        if self.dispatcher_cpu_list.strip():
            machine = os.cpu_count() or 1
            pinned = self.parse_dispatcher_cpu_list(machine)
            # _parse_index_list answers all-cores for garbage specs;
            # a full-machine answer is not a pin, fall through to the
            # affinity mask
            if pinned and len(pinned) < machine:
                return len(pinned)
        return host_core_census()

    # -- device census (every device_count-derived default reads this) ------
    @property
    def device_census(self) -> int:
        """The device count that multi-device defaults key off
        (``deviceExchangeEnabled``, bench host notes).  An explicit
        ``deviceCensus`` setting wins (> 0); else the module-level
        :func:`device_census` (``torch.cuda.device_count()``, or 1
        without CUDA) — NOT a hardcoded
        mesh size, so a 1-device host can never silently gate (or
        fake-pass) a multi-device-only path."""
        explicit = self._int_in_range("deviceCensus", 0, 0, 1 << 16)
        if explicit > 0:
            return explicit
        return device_census()

    # -- transport / control-plane queues (reference: recv/sendQueueDepth) --
    @property
    def recv_queue_depth(self) -> int:
        return self._int_in_range("recvQueueDepth", 1024, 256, 65535)

    @property
    def send_queue_depth(self) -> int:
        return self._int_in_range("sendQueueDepth", 4096, 256, 65535)

    @property
    def recv_wr_size(self) -> int:
        """Max size of one control-plane message segment (reference: 4 KiB
        registered recv buffers, RdmaShuffleConf recvWrSize)."""
        return self._bytes_in_range("recvWrSize", 4096, 2048, 1 << 20)

    @property
    def sw_flow_control(self) -> bool:
        """Receiver-credit flow control on the control plane (reference:
        credit reports via RDMA_WRITE_WITH_IMM, RdmaChannel.java:508-520)."""
        return self._bool("swFlowControl", True)

    @property
    def trace(self) -> bool:
        """Enable span tracing (chrome://tracing JSON via Tracer.dump)."""
        return self._bool("trace", False)

    @property
    def trace_path(self) -> str:
        """Where manager.stop() dumps the collected trace."""
        return str(self.get("tracePath", "sparkrdma_tpu_trace.json"))

    @property
    def compress(self) -> bool:
        """Compress serialized shuffle blocks (reference: Spark codec
        stream wrapping, RdmaShuffleReader.scala:51-58)."""
        return self._bool("compress", False)

    @property
    def compress_codec(self) -> str:
        return str(self.get("compressCodec", "zlib"))

    @property
    def serializer_name(self) -> str:
        """Record serializer: ``pickle`` (default; arbitrary objects) or
        ``columnar`` (fixed-width key/value columns, the unsafe-row
        analog — the record plane's fast path)."""
        return str(self.get("serializer", "")).lower()

    @property
    def lazy_staging(self) -> bool:
        """ODP analog (reference: useOdp, RdmaShuffleConf.scala:68-83):
        keep committed map output in host memory and stage to HBM on
        demand at exchange time, instead of eagerly at commit."""
        return self._bool("lazyStaging", False)

    @property
    def compress_frame_records(self) -> int:
        """Records per compression frame (CompressedSerializer): one
        frame is the unit of decode parallelism on the reduce side AND
        the unit the 4 GiB frame-length field bounds — lower it when
        individual records are huge (a FrameTooLargeError names this
        knob)."""
        return self._int_in_range(
            "compressFrameRecords", 65536, 1, 1 << 24
        )

    @property
    def decode_threads(self) -> int:
        """Worker threads on the reduce-side decode pool
        (shuffle/decode.py): blocks deserialize/decompress on workers
        AS STRIPES LAND, overlapping fetch, decode and consumption.
        0 keeps the legacy serial decode on the task thread.  Default:
        ``min(4, cpus)`` on multi-core hosts; 0 on a single-core host
        (decode workers would only timeslice against the task thread —
        the ``bulkPipelineWindows`` convention)."""
        ncpu = self.core_census
        return self._int_in_range(
            "decodeThreads", min(4, ncpu) if ncpu > 1 else 0, 0, 64
        )

    @property
    def decode_ahead_bytes(self) -> int:
        """Byte-credit budget of the decode pool: the total encoded
        bytes of blocks decoding or decoded-but-not-yet-consumed is
        capped here, bounding how far decode runs ahead of the task
        thread (the maxBytesInFlight analog for the decode stage).  A
        single block larger than the whole budget clamps to it and
        decodes alone instead of deadlocking."""
        return self._bytes_in_range(
            "decodeAheadBytes", 32 << 20, 64 << 10, 1 << 40
        )

    @property
    def shuffle_spill_record_threshold(self) -> int:
        """Writer spill trigger: when a map task holds this many
        buffered records, serialize current buckets to a spill file and
        release the memory (the role Spark's sort-shuffle spill plays
        inside the writers the reference wraps,
        RdmaWrapperShuffleWriter.scala:85-101).  0 disables spilling."""
        return self._int_in_range("shuffleSpillRecordThreshold", 0, 0, 1 << 31)

    @property
    def spill_dir(self) -> str:
        """Directory for writer spill files and file-backed commits."""
        import tempfile

        return str(self.get("spillDir", tempfile.gettempdir()))

    @property
    def file_backed_commit_bytes(self) -> int:
        """Commit map outputs at or above this size to an mmapped file
        segment instead of memory (the RdmaMappedFile path,
        RdmaMappedFile.java:76-199) — the larger-than-arena escape
        hatch.  0 disables (all commits stay in memory/HBM)."""
        return self._bytes_in_range("fileBackedCommitBytes", 0, 0, 1 << 44)

    # -- memory tiering / out-of-core prefetch (memory/tier.py) -------------
    @property
    def tier_hot_bytes(self) -> int:
        """Byte budget of the tiered block store's HOT tier: promoted
        blocks of file-backed map outputs live in pooled staging rows
        up to this total; promotion past it demotes the LRU unpinned
        blocks back to their cold (on-disk) tier.  The serve path never
        fails on a full hot tier — a block that cannot be promoted is
        served straight from disk.  0 = unbounded (every touched block
        stays hot — the pre-tier behavior for working sets that fit)."""
        return self._bytes_in_range("tierHotBytes", 256 << 20, 0, 1 << 44)

    @property
    def tier_prefetch(self) -> bool:
        """Predictive promotion into the hot tier: serve-side
        sequential readahead plus reader-sent PrefetchHintMsg warming
        (the RdmaMappedFile ODP-prefetch sweep, RdmaMappedFile.java:
        158-168, re-aimed at the disk tier).  ``off`` keeps the tier a
        plain demand cache — every cold block pays its disk read on
        the serve path (the A/B the out-of-core bench measures).
        Default: enabled on multi-core hosts; on a single core the
        warm work only timeslices against the serves it is meant to
        hide (measured net-negative there — the ``decodeThreads`` /
        ``bulkPipelineWindows`` single-core-fallback precedent).  An
        explicit setting always wins."""
        return self._bool("tierPrefetch", self.core_census > 1)

    @property
    def tier_prefetch_blocks(self) -> int:
        """Serve-side readahead depth: a (promoting) read of block i
        schedules async promotion of blocks i+1..i+this of the same
        map output through the serve pool — the request-stream signal
        (shuffle reads are near-sequential per segment)."""
        return self._int_in_range("tierPrefetchBlocks", 2, 0, 64)

    @property
    def tier_hint_blocks(self) -> int:
        """Reader-side prefetch-hint depth: before issuing a grouped
        fetch, the reader sends the serving peer a PrefetchHintMsg
        listing up to this many upcoming block locations from its
        fetch plan, so the responder warms them through its serve-pool
        credits before the read RPCs arrive.  0 disables hints."""
        return self._int_in_range("tierHintBlocks", 16, 0, 4096)

    # -- transport striping / scatter-gather / read serving -----------------
    @property
    def transport_num_stripes(self) -> int:
        """Data channels per peer for striped block reads (the channel
        group's bulk lanes).  Block reads larger than
        ``transportStripeThreshold`` are chunked round-robin across this
        many dedicated READ channels and reassembled zero-copy into one
        pooled destination row; small reads and RPCs keep their own
        channel so metadata never queues behind bulk bytes (the
        reference's RPC vs RDMA_READ channel split, RdmaChannel.java:41,
        extended with fabric-lib-style striping).  1 disables striping
        (single data channel per peer)."""
        return self._int_in_range(
            "transportNumStripes", min(4, self.core_census), 1, 16
        )

    @property
    def transport_stripe_threshold(self) -> int:
        """Block reads strictly larger than this are striped across the
        peer's data channels; smaller reads ride the dedicated
        small-read channel whole."""
        return self._bytes_in_range(
            "transportStripeThreshold", 512 << 10, 64 << 10, 1 << 30
        )

    @property
    def transport_scatter_gather(self) -> bool:
        """Scatter-gather socket I/O on the TCP data path: frames go
        out as ``sendmsg`` iovecs (header + length prefixes + block
        views, no concatenation copy) and read responses land via
        ``recv_into`` pre-sized pooled/destination buffers.  ``off``
        restores the pre-striping concat+``sendall`` wire path (same
        framing — the two interoperate) for A/B measurement."""
        return self._bool("transportScatterGather", True)

    @property
    def transport_async_dispatcher(self) -> bool:
        """Completion-driven transport core (transport/dispatcher.py):
        one ``selectors`` event-loop thread per node owns every TCP
        transport socket in non-blocking mode — sends post as
        descriptors to a submission queue, receives run as partial
        ``recv_into``/``sendmsg`` continuations, and batched completion
        events dispatch to the striped/decode callbacks (the fabric-lib
        / RAMC submission-queue + completion-queue idiom).  Thread
        count per node drops from O(peers × stripes) reader threads to
        O(1).  ``off`` restores the legacy thread-per-lane blocking
        path for A/B and bit-exactness — the two speak the same wire
        format and interoperate."""
        return self._bool("transportAsyncDispatcher", True)

    @property
    def transport_socket_buffer_bytes(self) -> int:
        """Explicit SO_SNDBUF/SO_RCVBUF on async-dispatcher sockets
        (the registered-ring-size analog of the RDMA QP); the kernel
        doubles the requested value and caps it at
        ``net.core.{w,r}mem_max``.  ``0`` — the default — keeps kernel
        autotuning: pinning at 4 MiB was A/B'd ~15% SLOWER than
        autotune on the loopback bench (setting SO_RCVBUF freezes the
        buffer where autotune keeps growing it with the BDP), so the
        knob exists for real fabrics with known ring budgets, not as a
        default."""
        return self._bytes_in_range(
            "transportSocketBufferBytes", 0, 0, 1 << 30
        )

    @property
    def transport_recv_coalesce_bytes(self) -> int:
        """Receive-wakeup coalescing on the async dispatcher (the
        completion-moderation analog of NIC interrupt coalescing):
        while a channel is mid-way through a large response body the
        loop sets ``SO_RCVLOWAT`` to this value, so ``epoll`` wakes it
        once per ~this many queued bytes instead of per arriving
        skb — fewer loop iterations and GIL round-trips per MiB.
        Headers and body tails drop the watermark back to 1 byte, and
        EOF/errors always wake regardless (kernel semantics), so
        dead-peer detection is unaffected.  ``0`` disables."""
        return self._bytes_in_range(
            "transportRecvCoalesceBytes", 1 << 20, 0, 64 << 20
        )

    @property
    def transport_stream_offload_bytes(self) -> int:
        """Lane streaming on the async dispatcher: when a bulk
        channel has at least this many response bytes outstanding, its
        whole recv machine moves to a completion-pool worker doing
        BLOCKING ``recv`` with inline completion delivery (the
        CQ-poller vs completion-worker split of fabric-lib) until the
        lane drains idle, then returns to the event loop.  A busy lane
        gets the threaded reader's exact syscall-and-delivery shape —
        one handoff per burst — while idle lanes cost no thread at
        all; at most a bounded number of lanes stream at a time and the
        rest stay on-loop.  ``0`` disables (every landing stays on the
        loop)."""
        return self._bytes_in_range(
            "transportStreamOffloadBytes", 1 << 20, 0, 1 << 40
        )

    @property
    def transport_poll_spin_us(self) -> int:
        """Adaptive busy-poll window (µs) on the async dispatcher loop:
        after an iteration that did real work the loop re-polls the
        selector non-blocking for this long before re-arming the
        blocking ``select`` — the poll-mode progress engine of the
        RDMA designs this core follows.  Back-to-back events (an RPC
        pong chased by the next ping, successive chunks of a draining
        stripe) are serviced at ``epoll_wait(0)`` cost with no
        sleep/wake transition.  ``0`` disables (always block) — the
        default on single-core hosts, where A/B showed the spin steals
        the very core the peer and the serve workers need (RPC p50
        DOUBLED spinning there); the decodeThreads/bulkPipelineWindows
        single-core-fallback precedent."""
        return self._int_in_range(
            "transportPollSpinUs",
            40 if self.core_census > 1 else 0, 0, 10000,
        )

    @property
    def transport_send_backlog_bytes(self) -> int:
        """Per-channel write backpressure on the async dispatcher: when
        a channel's queued-but-unsent response bytes exceed this, the
        loop stops READING that socket (new requests queue in the
        kernel and eventually in the requester's TCP window) until the
        backlog drains below half — so a requester that never drains
        its responses throttles itself, not the node."""
        return self._bytes_in_range(
            "transportSendBacklogBytes", 16 << 20, 64 << 10, 1 << 40
        )

    @property
    def transport_max_cached_channels(self) -> int:
        """Cap on the node's active-channel cache (``Node._active`` —
        the RdmaNode channel-cache lineage, bounded): when a connect
        would push the cache past this many live channels, the
        idle-coldest cached channels (LRU by last use; never one with
        in-flight ops) are evicted and their sockets closed.
        ``get_channel`` transparently reconnects an evicted key on next
        use, so at datacenter fan-out a node pays O(cap) sockets, not
        O(peers × stripes) — the RDMAvisor bounded-channel design.
        ``0`` disables the cap entirely (the pre-fabric unbounded
        behavior, kept for A/B)."""
        return self._int_in_range(
            "transportMaxCachedChannels", 512, 0, 1 << 20
        )

    @property
    def transport_lane_pool_size(self) -> int:
        """Fixed per-node budget of borrowable data lanes: a striped
        read borrows up to ``transportNumStripes`` lanes from this pool
        for its duration and returns them at completion, so concurrent
        stripe parallelism across ALL peers is bounded here instead of
        costing ``transportNumStripes`` dedicated sockets per peer.
        When the pool is empty a read falls back to the peer's
        dedicated small-read lane, unstriped (correct, just narrower).
        ``0`` disables the budget (every read stripes fully — the
        pre-fabric behavior, kept for A/B)."""
        return self._int_in_range("transportLanePoolSize", 32, 0, 4096)

    @property
    def transport_serve_threads(self) -> int:
        """Worker threads on the node's read-serve pool (one-sided READ
        service).  Serving runs off the channel reader loops so one
        large serve never head-of-line-blocks completions on its
        channel."""
        return self._int_in_range(
            "transportServeThreads", min(4, self.core_census), 1, 64
        )

    @property
    def transport_serve_credit_bytes(self) -> int:
        """Byte-credit budget of the read-serve pool: the total
        requested bytes of serves running concurrently is capped here,
        so a slow reducer draining many bulk responses cannot pin
        unbounded server memory (responder-side flow control; the
        recv-WR credit scheme's serve-side analog)."""
        return self._bytes_in_range(
            "transportServeCreditBytes", 64 << 20, 1 << 20, 1 << 40
        )

    # -- memory / arenas (reference: maxBufferAllocationSize, ODP) ----------
    @property
    def max_buffer_allocation_size(self) -> int:
        return self._bytes_in_range("maxBufferAllocationSize", 10 << 30, 0, 1 << 44)

    @property
    def max_agg_prealloc(self) -> int:
        return self._bytes_in_range("maxAggPrealloc", 0, 0, 1 << 40)

    @property
    def max_agg_block(self) -> int:
        """Cap on one aggregated fetch tile (reference: maxAggBlock 2m)."""
        return self._bytes_in_range("maxAggBlock", 2 << 20, 128 << 10, 1 << 30)

    # -- data plane block sizing -------------------------------------------
    @property
    def shuffle_write_block_size(self) -> int:
        """Arena segment granularity on the write side (reference: 8m
        mmap chunks, shuffleWriteBlockSize)."""
        return self._bytes_in_range("shuffleWriteBlockSize", 8 << 20, 64 << 10, 1 << 30)

    @property
    def shuffle_read_block_size(self) -> int:
        """Target size of one grouped fetch (reference: 256k)."""
        return self._bytes_in_range(
            "shuffleReadBlockSize", 256 << 10, 16 << 10, 1 << 30
        )

    @property
    def max_bytes_in_flight(self) -> int:
        """Reader-side in-flight window (reference: 1m)."""
        return self._bytes_in_range("maxBytesInFlight", 1 << 20, 128 << 10, 1 << 40)

    # -- exchange engine (TPU-specific; no reference analog) ----------------
    @property
    def exchange_tile_bytes(self) -> int:
        """Payload bytes per chip per all_to_all tile round.  The SPMD
        analog of shuffle_read_block_size: every chip contributes exactly
        one padded tile of this size per round."""
        return self._bytes_in_range(
            "exchangeTileBytes", 4 << 20, 64 << 10, 1 << 30
        )

    @property
    def read_plane(self) -> str:
        """Bulk fetch plane: ``host`` (loopback/TCP one-sided byte
        reads), ``windowed`` (the unified device plane — reducers issue
        reads through get_reader and the bytes ride driver-planned
        window collectives, reactive AND multi-process; SURVEY §7
        "one-sided READ pull model" inversion), or ``bulk``
        (bulk-synchronous whole-shuffle exchange via BulkExchangeReader
        — shuffle/bulk.py).  ``collective`` (the in-process
        opportunistic coordinator, tests/collective_read_fixture.py) is a
        test fixture superseded by ``windowed``."""
        return str(self.get("readPlane", "host")).lower()

    @property
    def direct_io(self) -> str:
        """Disk write mode for spills and file-backed commits:
        ``auto`` (O_DIRECT when the spill directory supports it —
        virtualized hosts writeback-throttle buffered writes to a
        fraction of device bandwidth), ``on`` (force, still falls back
        per-file if the open fails), or ``off`` (buffered)."""
        v = str(self.get("directIO", "auto")).lower()
        return v if v in ("auto", "on", "off") else "auto"

    @property
    def spill_partition_files(self) -> int:
        """Spills write one file PER PARTITION up to this many
        partitions (the zero-copy commit: each spill file registers
        directly as the shuffle file, no consolidation rewrite).
        Shuffles with more partitions use the legacy single spill file
        to bound open descriptors; 0 disables the per-partition
        layout."""
        return self._int_in_range("spillPartitionFiles", 64, 0, 4096)

    @property
    def bulk_window_maps(self) -> int:
        """Bulk mode's incremental-plan window: the driver cuts an
        exchange plan every time this many NEW maps have published and
        filled (the last window takes the remainder), so reducers start
        moving bytes while stragglers still write — the collective
        analog of the reference's windowed fetch overlap
        (RdmaShuffleFetcherIterator.scala:241-251 +
        RdmaMapTaskOutput.scala:41-44 partial fills).  0 (default)
        keeps the single all-maps barrier."""
        return self._int_in_range("bulkWindowMaps", 0, 0, 1 << 20)

    @property
    def bulk_pipeline_windows(self) -> bool:
        """Double-buffer the windowed plane: while window N's
        collective runs, window N+1's plan barrier AND stream assembly
        proceed on a background stage into a second pooled source row
        (shuffle/bulk.py).  Abort/poison semantics are unchanged and
        output is bit-identical to the serial loop.  Default: enabled
        on multi-core hosts; a single-core host cannot overlap — the
        stage thread would only timeslice against the collective — so
        it falls back to the serial loop there.  An explicit setting
        always wins."""
        return self._bool(
            "bulkPipelineWindows", self.core_census > 1
        )

    @property
    def bulk_barrier_timeout_ms(self) -> int:
        """How long an in-process bulk-session contributor waits for
        the other participating executors before failing the
        exchange."""
        return self._time_ms("bulkBarrierTimeout", 120_000)

    @property
    def device_arena_bytes(self) -> int:
        """Capacity of each executor's persistent HBM arena on the
        collective plane (all arenas share one capacity so the pack
        program compiles once)."""
        return self._bytes_in_range("deviceArenaBytes", 64 << 20,
                                    1 << 20, 1 << 40)

    @property
    def exchange_flush_ms(self) -> int:
        """How long the exchange coordinator batches pending fetches
        before running a collective round."""
        return self._time_ms("exchangeFlush", 2)

    @property
    def exchange_max_rounds_in_flight(self) -> int:
        """Bounded outstanding exchange rounds (maxBytesInFlight analog
        for the collective data plane)."""
        return self._int_in_range("exchangeMaxRoundsInFlight", 2, 1, 64)

    @property
    def device_exchange_enabled(self) -> bool:
        """Device-native exchange data path
        (``TileExchange.exchange_padded``): staged source rows are
        assembled ONCE into pooled padded device-layout buffers and
        ride the mesh as device arrays — on-device tile staging
        (reshape + index, no per-round host matrix fills) and zero
        intermediate ``bytes`` materialization between the map-output
        store and HBM.  Output is bit-identical to the host-staged
        path.  Default: enabled on ≥2-device hosts; a 1-device mesh
        has no collective to win (the ``decodeThreads`` convention).
        An explicit setting always wins."""
        return self._bool("deviceExchangeEnabled", self.device_census > 1)

    @property
    def device_exchange_window_rounds(self) -> int:
        """Bounded in-flight window of DEVICE exchange tile rounds:
        round k's collective dispatches while round k-1's landed rows
        are collected (and, on the windowed plane, handed to the
        decode pool) — the collective/decode overlap.  0 runs the
        whole exchange as ONE fused program instead (zero-copy result
        views, no per-round collect), trading overlap for the lowest
        total copy cost; the windowed plane wants rounds, bulk batch
        readers want the fused shot."""
        return self._int_in_range("deviceExchangeWindowRounds", 2, 0, 64)

    @property
    def device_bucketize_enabled(self) -> bool:
        """On-device partition prep before the exchange
        (``ops.partition.bucketize_segments``): partition fan-out runs
        as a jit'd bucketize+counts+segment-offsets kernel so the
        collective moves already-bucketed contiguous segments.  Same
        ≥2-device default as ``deviceExchangeEnabled``."""
        return self._bool("deviceBucketizeEnabled", self.device_census > 1)

    @property
    def verify_exchange_integrity(self) -> bool:
        """Opt-in end-to-end CRC of every (src, dst) exchanged stream
        (ExchangeIntegrityError on mismatch).  Costs O(payload) host
        time; healthy ICI links already carry hardware CRC."""
        return self._bool("verifyExchangeIntegrity", False)

    # -- multi-tenant QoS (sparkrdma_tpu_torch/qos/) ------------------------------
    @property
    def qos_enabled(self) -> bool:
        """Multi-tenant QoS policy (qos/): the byte-credit pools
        (serve, decode, reader in-flight window, tier hot budget)
        acquire through weighted max-min credit brokers, the serve
        queue and lane pool honor priority classes, and admission
        control enforces per-tenant quotas.  Off by default — the
        brokers then compile down to the existing pools (plain FIFO
        credits, unclassed queues) for A/B."""
        return self._bool("qosEnabled", False)

    @property
    def tenant(self) -> str:
        """Tenant id this manager's shuffles register under.  Empty
        (the default) gives every shuffle its own tenant
        (``shuffle-<id>``) — isolation without configuration; name a
        tenant to pool several shuffles under one weight/quota."""
        return str(self.get("tenant", ""))

    @property
    def qos_tenant_weight(self) -> int:
        """This tenant's weight in the brokered max-min share of every
        credit budget (a weight-4 tenant gets 4x a weight-1 tenant's
        share under contention; idle shares stay borrowable)."""
        return self._int_in_range("qosTenantWeight", 1, 1, 1_000_000)

    @property
    def qos_tenant_priority(self) -> str:
        """Priority class: ``interactive`` work dequeues ahead of
        ``bulk`` (default) on the serve pool and may borrow from the
        lane pool's reserved slice; anti-starvation aging keeps bulk
        from starving behind a steady interactive stream."""
        v = str(self.get("qosTenantPriority", "bulk")).lower()
        return v if v in ("interactive", "bulk") else "bulk"

    @property
    def qos_tenant_max_bytes(self) -> int:
        """Admission-control quota on the tenant's registered
        (committed) map-output bytes: past it, a commit queues up to
        ``qosAdmissionWait`` then the tenant DEGRADES (narrower
        stripes, cold-tier serves) instead of OOMing the node.  0 (the
        default) = unlimited."""
        return self._bytes_in_range("qosTenantMaxBytes", 0, 0, 1 << 44)

    @property
    def qos_tenant_max_inflight(self) -> int:
        """Per-tenant cap on brokered in-flight fetch bytes across all
        of the tenant's concurrent readers (enforced by the reader
        window's broker).  0 (the default) = unlimited — the weighted
        share alone bounds it under contention."""
        return self._bytes_in_range(
            "qosTenantMaxInFlight", 0, 0, 1 << 40
        )

    @property
    def qos_aging_ms(self) -> int:
        """Anti-starvation aging on the classed edges: a bulk-class
        task or credit waiter older than this is promoted to
        interactive priority, so bulk never starves outright."""
        return self._time_ms("qosAging", 100)

    @property
    def qos_interactive_bytes(self) -> int:
        """Serve-size cutoff for the interactive class: serves at or
        below this many requested bytes (metadata reads, small blocks
        — the small-read-lane lineage) classify interactive regardless
        of tenant; larger serves take the owning tenant's class."""
        return self._bytes_in_range(
            "qosInteractiveBytes", 512 << 10, 0, 1 << 30
        )

    @property
    def qos_lane_reserve(self) -> int:
        """Stripe-lane tokens held back from bulk-class borrows so an
        interactive-class striped read always finds width (the lane
        pool's priority grant).  Clamped to the pool size at use."""
        return self._int_in_range("qosLaneReserve", 4, 0, 4096)

    @property
    def qos_admission_wait_ms(self) -> int:
        """How long an over-quota commit queues for earlier shuffles
        to release registered bytes before proceeding degraded."""
        return self._time_ms("qosAdmissionWait", 100)

    # -- skew-adaptive partitioning (sparkrdma_tpu_torch/skew/) -------------------
    @property
    def skew_enabled(self) -> bool:
        """Skew-adaptive partitioning (skew/): writers classify
        partitions at commit from the streaming size/record sketch, and
        a partition over ``skewSplitThreshold`` (or ``skewSplitFactor``
        x the map output's median partition) commits as independently
        sorted SUB-BLOCKS at serializer frame boundaries — distinct
        map-output entries the reader fetches interleaved across the
        stripe/lane plan and k-way-merges as extra sorted runs.  Off by
        default: the writer commits one block per partition and the
        reader's plan is byte-identical to the pre-skew tree.  Only the
        pull read plane (``readPlane=host``) splits — the collective
        planes move whole partition blocks by construction."""
        return self._bool("skewEnabled", False)

    @property
    def skew_split_threshold(self) -> int:
        """Absolute hot-partition cutoff AND the sub-block target size:
        a partition at least this large always splits, into sub-blocks
        of roughly this many bytes each (whole serializer frames — a
        single frame larger than the target cannot split further)."""
        return self._bytes_in_range("skewSplitThreshold", 8 << 20,
                                    4 << 10, 1 << 40)

    @property
    def skew_split_factor(self) -> float:
        """Relative cutoff: a partition over this multiple of the map
        output's median non-empty partition size also splits (Zipfian
        heads dwarf the median long before any absolute threshold
        trips).  0 disables the relative test."""
        raw = self.get("skewSplitFactor", 4.0)
        try:
            v = float(raw)
        except (TypeError, ValueError):
            return 4.0
        return max(0.0, min(1e6, v))

    @property
    def skew_max_sub_blocks(self) -> int:
        """Cap on sub-blocks per split partition (each costs one
        16-byte location entry and one fetch-plan slot)."""
        return self._int_in_range("skewMaxSubBlocks", 16, 2, 1024)

    @property
    def skew_sample_stride(self) -> int:
        """Heavy-hitter sketch sampling stride on aggregating writers:
        every Nth record's key feeds the Misra-Gries sketch whose top
        share is published in the shuffle's skew telemetry (hot-KEY
        attribution — splitting itself keys off partition bytes)."""
        return self._int_in_range("skewSampleStride", 64, 1, 1 << 20)

    # -- push-based merged shuffle (sparkrdma_tpu_torch/shuffle/push.py) ----------
    @property
    def push_enabled(self) -> bool:
        """Push-based merged shuffle (the magnet idiom): at commit,
        writers push per-partition sub-blocks to deterministic
        per-reduce-partition merger nodes, which append them into one
        merged per-reduce span; readers resolve the merged span first
        and fetch it as ONE large sequential read, pulling only the
        unmerged stragglers block-by-block through the unchanged pull
        path.  Best-effort by construction: a dropped push, a dead
        merger, or an old-wire-version peer only means more pull
        traffic — never wrong bytes.  Off by default: the reader plan
        is then byte-identical to the pure pull tree."""
        return self._bool("pushEnabled", False)

    @property
    def push_block_target(self) -> int:
        """Target size of each pushed sub-block: partition payloads are
        cut at serializer frame boundaries (the skew splitter's
        ``sub_spans``) into chunks of roughly this many bytes before
        being pushed, so no single push RPC carries an unbounded
        frame train."""
        return self._bytes_in_range("pushBlockTarget", 512 << 10,
                                    4 << 10, 1 << 30)

    @property
    def push_merge_timeout_ms(self) -> int:
        """Reader-side bound on the merged-location query: mergers that
        have not answered the merge-status RPC within this window are
        treated as offering no merged coverage and their partitions
        fall back to the pull path (best-effort push, bounded reader
        latency)."""
        return self._time_ms("pushMergeTimeout", 2000)

    @property
    def push_max_merged_bytes(self) -> int:
        """Per-(shuffle, reduce-partition) cap on merged bytes a merger
        will accept.  Sub-blocks arriving over the cap are dropped
        (counted ``push_drops_total{reason="cap"}``) and their map
        outputs served
        by the pull fallback — a merger never balloons past its
        provisioned spill budget because one reduce key ran hot."""
        return self._bytes_in_range("pushMaxMergedBytes", 256 << 20,
                                    1 << 20, 1 << 40)

    # -- observability ------------------------------------------------------
    @property
    def metrics_http_port(self) -> int:
        """Live Prometheus scrape endpoint (qos/http.py): serve
        ``/metrics`` (text exposition), ``/metrics.json`` and
        ``/tenants`` on this port for the manager's lifetime.  -1 (the
        default) disables; 0 binds an ephemeral port (tests/one-off
        runs — the bound address is ``manager.metrics_http.address``).
        Setting it implies ``metrics`` (a scrape endpoint over a
        disabled registry would be an empty page)."""
        return self._int_in_range("metricsHttpPort", -1, -1, 65535)

    @property
    def metrics_http_host(self) -> str:
        """Bind address of the scrape endpoint.  Defaults to loopback
        (a metrics port should be opt-in reachable); set ``0.0.0.0``
        for a fleet scraper to reach executors remotely."""
        return str(self.get("metricsHttpHost", "127.0.0.1"))

    @property
    def metrics_enabled(self) -> bool:
        """Enable the process-wide metrics registry (metrics/registry.py):
        labeled counters/gauges/histograms across transport, shuffle and
        memory.  Off by default — instrumented call sites then hold
        zero-overhead no-op handles.  A live scrape endpoint
        (``metricsHttpPort``) implies metrics."""
        return self._bool("metrics", False) or self.metrics_http_port >= 0

    @property
    def lock_debug(self) -> bool:
        """Runtime lock sanitizer (utils/dbglock.py): rank-checked lock
        wrappers with per-thread acquisition stacks and hold-time
        histograms; raises LockOrderViolation on a same-thread rank
        inversion.  Off by default — the transport/shuffle planes then
        allocate plain ``threading`` primitives (zero overhead).  The
        manager flips the process-global LockFactory on BEFORE building
        its node, so every lock created under it is instrumented."""
        return self._bool("lockDebug", False)

    @property
    def resource_debug(self) -> bool:
        """Runtime resource-lifecycle sanitizer (utils/ledger.py):
        every annotated acquire of a countable resource (serve
        credits, lane tokens, tier pins, window bytes, registered
        bytes, fds, send descriptors) returns a ledger ticket with an
        acquisition-site stack; double releases raise
        DoubleReleaseError and manager.stop() renders a loud leak
        report (``resource_leaked_total{resource=}``).  Off by default
        — call sites then share one no-op ticket (zero overhead).  The
        static half is tools/flowcheck.py; the manager flips the
        process-global ledger on BEFORE building its node."""
        return self._bool("resourceDebug", False)

    @property
    def wire_debug(self) -> bool:
        """Runtime wire-protocol frame validator (utils/wiredbg.py):
        both TCP engines' receive paths and the loopback dispatch plane
        validate every frame as it arrives — header sanity (known
        opcode, bounded length) and full schema-derived decode of RPC
        frames BEFORE the application listener sees them, with
        ``wire_frames_{validated,rejected}_total`` counters labeled by
        engine/opcode and hexdump context on every rejection.  Off by
        default — the receive paths then pay one module-global read
        per frame.  The static half is tools/wirecheck.py; the manager
        flips the process-global validator on BEFORE building its
        node."""
        return self._bool("wireDebug", False)

    @property
    def state_debug(self) -> bool:
        """Runtime lifecycle state-machine validator
        (utils/statemachine.py): every annotated machine's
        ``_transition()`` validates the edge against its declared
        TRANSITIONS table, counts
        ``state_transitions_total{machine=,from=,to=}`` and raises
        IllegalTransition (both states + 4-frame call site) on an
        undeclared edge.  Off by default — transitions then cost one
        module-global read and the plain assignment (identity-tested).
        The static half is tools/statecheck.py; the manager flips the
        process-global validator on BEFORE building its node."""
        return self._bool("stateDebug", False) or self.sched_shake != 0

    @property
    def sched_shake(self) -> int:
        """Deterministic schedule shaker seed (0 = off).  Non-zero
        arms stateDebug and injects a seeded 0-2ms yield/sleep at
        every validated lifecycle transition — widening the race
        window at exactly the points where lifecycle races live.
        Per-machine streams are seeded ``seed ^ crc32(machine)``, so a
        fixed seed replays the same perturbation schedule."""
        return self._int_in_range("schedShake", 0, 0, 2**31 - 1)

    @property
    def metrics_json_path(self) -> str:
        """When set, manager.stop() writes a JSON snapshot of the
        registry here (executors suffix ``.<executor_id>`` so
        multi-process runs don't clobber each other)."""
        return str(self.get("metricsJsonPath", ""))

    @property
    def metrics_prom_path(self) -> str:
        """When set, manager.stop() writes a Prometheus text-exposition
        dump here (same executor suffix rule as metricsJsonPath)."""
        return str(self.get("metricsPromPath", ""))

    @property
    def metrics_trace_bridge(self) -> bool:
        """When metrics AND tracing are both enabled, publish registry
        counters into the Tracer.counter() stream (Perfetto counter
        tracks) at shuffle unregister and manager stop."""
        return self._bool("metricsTraceBridge", True)

    @property
    def trace_enabled(self) -> bool:
        """Distributed fetch tracing (obs/): readers mint a trace
        context per reduce task and stamp every fetch-status RPC and
        read request with it (the v2 wire tail), so serve-side events
        on remote peers join the requester's trace.  Off by default —
        every instrumentation site then short-circuits on one
        attribute read, and all wire frames stay byte-identical to the
        trace-off encoding."""
        return self._bool("traceEnabled", False)

    @property
    def trace_sample_rate(self) -> float:
        """Fraction of reduce tasks that mint a trace context when
        ``traceEnabled`` (1.0 = every task).  Sampled-out tasks pay
        the same near-zero cost as tracing off."""
        return self._float_in_range("traceSampleRate", 1.0, 0.0, 1.0)

    @property
    def flight_recorder(self) -> bool:
        """Flight recorder (obs/recorder.py): per-plane bounded rings
        of structured events (transport, reader, decode, tier, qos,
        faults), dumped to JSON automatically on FetchFailed / breaker
        trip / ledger leak / wire reject and on demand via the metrics
        server's ``/flightrecorder`` endpoint.  On by default — the
        black box should be recording when the incident happens; each
        event costs one deque append under an uncontended per-plane
        lock."""
        return self._bool("flightRecorder", True)

    @property
    def flight_recorder_ring_size(self) -> int:
        """Events retained per plane ring (oldest drop first, drops
        counted in ``obs_events_dropped_total{plane=}``)."""
        return self._int_in_range("flightRecorderRingSize", 4096, 64, 1 << 20)

    @property
    def flight_recorder_dump_path(self) -> str:
        """Directory for flight-recorder dumps (pid- and sequence-
        tagged filenames, so one fleet's processes never collide).
        Empty (the default) disables automatic dumps — the rings still
        record and ``/flightrecorder`` still serves them."""
        return str(self.get("flightRecorderDumpPath", ""))

    @property
    def collect_shuffle_reader_stats(self) -> bool:
        return self._bool("collectShuffleReaderStats", False)

    @property
    def fetch_time_bucket_size_ms(self) -> int:
        return self._int_in_range("fetchTimeBucketSizeInMs", 300, 1, 60000)

    @property
    def fetch_time_num_buckets(self) -> int:
        return self._int_in_range("fetchTimeNumBuckets", 5, 2, 100)

    # -- control plane endpoints / timeouts ---------------------------------
    @property
    def driver_host(self) -> str:
        return str(self.get("driverHost", "127.0.0.1"))

    @property
    def driver_port(self) -> int:
        return self._int_in_range("driverPort", 0, 0, 65535)

    def set_driver_port(self, port: int) -> None:
        """Driver's bound port written back so executors inherit it
        (reference: RdmaShuffleConf.scala:56)."""
        self.set("driverPort", port)

    @property
    def executor_port(self) -> int:
        return self._int_in_range("executorPort", 0, 0, 65535)

    @property
    def port_max_retries(self) -> int:
        return self._int_in_range("portMaxRetries", 16, 1, 1000)

    @property
    def partition_location_fetch_timeout_ms(self) -> int:
        return self._time_ms("partitionLocationFetchTimeout", 120_000)

    @property
    def heartbeat_interval_ms(self) -> int:
        """Driver→executor liveness probe period on the hello/announce
        plane; 0 disables the heartbeat monitor.  Plays the role of RDMA
        CM DISCONNECTED events (RdmaNode.java:176-189) — the transport
        here has no connection-level death notification."""
        return self._time_ms("heartbeatInterval", 5_000)

    @property
    def heartbeat_timeout_ms(self) -> int:
        """How long an executor may go without acking a heartbeat
        before the driver prunes it (remove_executor — the
        onBlockManagerRemoved analog, RdmaShuffleManager.scala:253-263)."""
        return self._time_ms("heartbeatTimeout", 15_000)

    @property
    def connect_timeout_ms(self) -> int:
        """Reference: rdmaCmEventTimeout (20s)."""
        return self._time_ms("connectTimeout", 20_000)

    @property
    def teardown_listen_timeout_ms(self) -> int:
        return self._time_ms("teardownListenTimeout", 50)

    @property
    def connect_retries(self) -> int:
        """Connect attempts per channel before the peer is declared
        unreachable (reference: maxConnectionAttempts, accepted as a
        legacy alias; an older ``spark.shuffle.tpu.maxConnectionAttempts``
        setting still applies when ``connectRetries`` is unset)."""
        legacy = self._int_in_range("maxConnectionAttempts", 5, 1, 100)
        return self._int_in_range("connectRetries", legacy, 1, 100)

    @property
    def connect_backoff_ms(self) -> int:
        """Base backoff between connect attempts; doubles per attempt
        with equal jitter, capped at 16x base.  The wait stays
        stop-interruptible (node teardown never blocks on it)."""
        return self._time_ms("connectBackoffMs", 50)

    # -- fault injection & in-task recovery ---------------------------------
    @property
    def fault_inject(self) -> str:
        """Seeded deterministic fault-injection spec, e.g.
        ``connect:p=0.1;read_resp:p=0.05;serve_delay:ms=30;seed=42``
        (see faults/injector.py for the grammar and the point list).
        Empty (the default) compiles every woven point to a no-op
        bool check."""
        return str(self.get("faultInject", ""))

    @property
    def fetch_retry_count(self) -> int:
        """In-task retries per failed block fetch before converting to
        FetchFailedError (0 = the reference posture: first failure is
        terminal, byte-identical to the pre-retry path)."""
        return self._int_in_range("fetchRetryCount", 3, 0, 100)

    @property
    def fetch_retry_wait_ms(self) -> int:
        """Base fetch-retry backoff; doubles per attempt with equal
        jitter (Spark lineage: spark.shuffle.io.retryWait)."""
        return self._time_ms("fetchRetryWaitMs", 50)

    @property
    def fetch_retry_max_ms(self) -> int:
        """Total retry deadline budget per fetch: attempts stop when
        the elapsed retry time crosses this, whatever fetchRetryCount
        still allows."""
        return self._time_ms("fetchRetryMaxMs", 10_000)

    @property
    def fetch_breaker_failures(self) -> int:
        """Consecutive terminal-bound failures against one peer that
        trip its circuit breaker (further fetches fail fast instead of
        each burning the full backoff budget); 0 disables the
        breaker."""
        return self._int_in_range("fetchBreakerFailures", 4, 0, 1000)

    @property
    def fetch_breaker_reset_ms(self) -> int:
        """Open-breaker hold time before a single half-open probe
        fetch is admitted (success closes, failure re-opens)."""
        return self._time_ms("fetchBreakerResetMs", 2_000)

    @property
    def stripe_demote_failures(self) -> int:
        """Consecutive striped-lane failures against one peer that
        demote its large reads to the unstriped small-read lane; 0
        disables demotion."""
        return self._int_in_range("stripeDemoteFailures", 2, 0, 1000)

    @property
    def stripe_demote_ms(self) -> int:
        """How long a stripe demotion lasts before striped reads are
        re-attempted against the peer."""
        return self._time_ms("stripeDemoteMs", 5_000)

    # -- device placement (reference: cpuList comp-vector pinning) ----------
    @property
    def device_list(self) -> str:
        """Comma/range list restricting which local devices serve the
        exchange, e.g. '0-3,6' (reference: cpuList, RdmaShuffleConf)."""
        return str(self.get("deviceList", ""))

    def parse_device_list(self, n_devices: int) -> list:
        """Expand device_list against n_devices, dropping out-of-range
        entries; empty/invalid → all devices (reference semantics of
        initCpuArrayList, RdmaNode.java:216-273)."""
        return self._parse_index_list(self.device_list, n_devices)

    @property
    def dispatcher_cpu_list(self) -> str:
        """Comma/range CPU list pinning the transport dispatcher and
        bulk-pool threads via ``sched_setaffinity`` (the RdmaThread
        comp-vector affinity, RdmaNode.java:216-273).  The reference's
        ``spark.shuffle.rdma.cpuList`` aliases here.  Distinct from
        ``deviceList`` — that names accelerator devices, this names
        host CPUs."""
        return str(self.get("dispatcherCpuList", ""))

    def parse_dispatcher_cpu_list(self, n_cpus: int) -> list:
        """Expand dispatcher_cpu_list against this host's CPU count;
        empty/invalid → all CPUs (no pinning)."""
        return self._parse_index_list(self.dispatcher_cpu_list, n_cpus)

    @staticmethod
    def _parse_index_list(spec: str, n: int) -> list:
        spec = spec.strip()
        if not spec:
            return list(range(n))
        out = []
        try:
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if "-" in part:
                    a, b = part.split("-", 1)
                    out.extend(range(int(a), int(b) + 1))
                else:
                    out.append(int(part))
        except ValueError:
            return list(range(n))
        out = [d for d in out if 0 <= d < n]
        return out or list(range(n))
