"""Reduce-side reader: async location resolution + windowed block fetch.

Analog of RdmaShuffleReader + RdmaShuffleFetcherIterator
(RdmaShuffleReader.scala:31-127, RdmaShuffleFetcherIterator.scala:39-425),
the reference's critical path (SURVEY.md §3.4):

- local partitions short-circuit to the arena (no transport),
- per remote host: a fetch-status RPC resolves exact block locations
  (with a timeout timer → metadata fetch failure),
- locations are grouped into pending fetches of ≤ shuffle_read_block_size
  (and ≤ max_agg_block), throttled by the max_bytes_in_flight window,
- completions land in a blocking results queue consumed by the record
  iterator; failures convert to :class:`FetchFailedError` so the job
  layer can retry the stage (the reference's FetchFailedException
  bridge),
- then deserialization → aggregation → optional key sort
  (RdmaShuffleReader.scala:82-113).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.faults.retry import RetryPolicy, is_transient
from sparkrdma_tpu_torch.metrics import counter, histogram
from sparkrdma_tpu_torch.obs import RECORDER, TRACING, fr_event
from sparkrdma_tpu_torch.qos import BULK, INTERACTIVE
from sparkrdma_tpu_torch.shuffle.manager import ShuffleHandle
from sparkrdma_tpu_torch.skew import is_split_marker
from sparkrdma_tpu_torch.transport.channel import FnCompletionListener
from sparkrdma_tpu_torch.rpc.messages import FetchMapStatusMsg, FetchMergeStatusMsg
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.serde import Record
from sparkrdma_tpu_torch.utils.trace import get_tracer
from sparkrdma_tpu_torch.utils.types import BlockLocation, ShuffleManagerId

logger = logging.getLogger(__name__)


class FetchFailedError(Exception):
    """Remote block fetch failed; the stage should be retried
    (reference: FetchFailedException conversion,
    RdmaShuffleFetcherIterator.scala:368-373)."""

    def __init__(self, host: str, shuffle_id: int, reason: str):
        super().__init__(
            f"fetch failed from {host} (shuffle {shuffle_id}): {reason}"
        )
        self.host = host
        self.shuffle_id = shuffle_id


class MetadataFetchFailedError(FetchFailedError):
    """Location resolution timed out / failed
    (reference: MetadataFetchFailedException)."""


@dataclass
class ReadMetrics:
    local_blocks: int = 0
    remote_blocks: int = 0
    local_bytes: int = 0
    remote_bytes: int = 0
    records_read: int = 0
    # the fetch-wait split: wire-wait is time the task thread blocked
    # on bytes (the results queue / local backing-store reads);
    # decode-wait is time it spent in — or blocked on — deserialize/
    # decompress (inline on the serial path, ticket waits on the
    # pipelined one).  fetch_wait_ms stays the wire-side series the
    # pre-split consumers (stats, telemetry dashboards) already read.
    fetch_wait_ms: float = 0.0
    decode_wait_ms: float = 0.0


def flush_read_metrics(manager, shuffle_id: int, m: ReadMetrics,
                       owner) -> None:
    """Flush one reduce task's read metrics into the registry and the
    manager's per-shuffle telemetry — at most once per reader (shared
    by the pull and windowed readers; ``owner`` carries the guard)."""
    if getattr(owner, "_metrics_flushed", False):
        return
    owner._metrics_flushed = True
    counter("shuffle_read_bytes_total", source="local").inc(m.local_bytes)
    counter("shuffle_read_bytes_total", source="remote").inc(m.remote_bytes)
    counter("shuffle_blocks_read_total", source="local").inc(m.local_blocks)
    counter("shuffle_blocks_read_total", source="remote").inc(
        m.remote_blocks)
    counter("shuffle_records_read_total").inc(m.records_read)
    counter("shuffle_fetch_wait_ms_total").inc(int(m.fetch_wait_ms))
    counter("shuffle_decode_wait_ms_total").inc(int(m.decode_wait_ms))
    counter("shuffle_reduce_tasks_total").inc()
    manager.record_shuffle_read(shuffle_id, m)


@dataclass
class _PendingFetch:
    """One grouped fetch against one host
    (reference: PendingFetch, RdmaShuffleFetcherIterator.scala:112-127).
    ``qos_granted`` is the brokered in-flight credit this fetch holds
    (qos/) — released per landed stripe, remainder at settle."""

    host: ShuffleManagerId
    locations: List[BlockLocation]
    total_bytes: int
    # aligned with ``locations`` when the group carries skew sub-blocks:
    # ``(map_id, reduce_id, sub_idx, num_subs)`` per split entry, None
    # per ordinary block; None for an all-ordinary group (the default
    # path allocates nothing)
    tags: Optional[List[Any]] = None
    qos_granted: int = 0
    # resource-ledger tickets (utils/ledger.py) for the window bytes /
    # brokered credits this fetch holds while on the wire
    win_tkt: Any = NOOP_TICKET
    qos_tkt: Any = NOOP_TICKET
    # in-task retry state (faults/retry.py): failures observed so far
    # and the monotonic stamp of the first one (the deadline anchor)
    attempts: int = 0
    first_failure_at: float = 0.0
    # push-based merged shuffle (shuffle/push.py): ``(reduce_id,
    # provenance_rows)`` when this fetch is ONE merged per-reduce span.
    # The rows — ``(map_id, rel_off, rel_len)`` — slice the landed span
    # back into per-map blocks, and a failure degrades exactly those
    # (map, reduce) pairs to the pull path instead of failing the stage.
    merged: Optional[Any] = None


class _Result:
    __slots__ = ("blocks", "host", "error", "latency_ms", "tags")

    def __init__(self, blocks=None, host=None, error=None, latency_ms=0.0,
                 tags=None):
        self.blocks = blocks
        self.host = host
        self.error = error
        self.latency_ms = latency_ms
        self.tags = tags  # sub-block tags aligned with blocks (or None)


class ShuffleReader:
    """Reads partitions [start_partition, end_partition) of one shuffle."""

    def __init__(
        self,
        manager,
        handle: ShuffleHandle,
        start_partition: int,
        end_partition: int,
        maps_by_host: Dict[ShuffleManagerId, List[int]],
    ):
        self.manager = manager
        self.handle = handle
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.maps_by_host = maps_by_host
        self.metrics = ReadMetrics()
        self._results: "queue.Queue[_Result]" = queue.Queue()
        self._pending: List[_PendingFetch] = []  # guarded-by: _pending_lock
        self._pending_lock = dbg_lock("reader.pending", 30)
        # resource: reader.inflight_bytes (windowed fetch bytes on the wire)
        self._bytes_in_flight = 0  # guarded-by: _pending_lock
        # non-empty remote blocks not yet delivered
        self._outstanding_blocks = 0  # guarded-by: _pending_lock
        # hosts whose locations are unresolved
        self._awaiting_hosts = 0  # guarded-by: _pending_lock
        self._failed: Optional[FetchFailedError] = None
        # (host, mkey, address) triples already hinted to their serving
        # peer — each upcoming block is announced at most once, and the
        # key MUST carry the host: every executor's arena numbers mkeys
        # from 1 and symmetric outputs land at identical offsets, so a
        # host-less key would collide across peers and silently
        # suppress their hints (memory/tier.py prefetch;
        # guarded-by: _pending_lock)
        self._hinted: set = set()
        self._timers: List[threading.Timer] = []
        self._callback_ids: List[int] = []
        self._metrics_flushed = False
        # decode-ahead stream (shuffle/decode.py): opened by read()
        # when decodeThreads > 0; on_success then submits landed blocks
        # to the pool and the consumer sees tickets instead of raw
        # payloads.  None = the legacy serial task-thread decode.
        self._decode_stream = None
        # multi-tenant QoS (qos/): this reader's tenant and the
        # manager-wide brokered in-flight window — every concurrent
        # reader's fetch bytes share one weighted budget instead of
        # each holding a private maxBytesInFlight (None = QoS off,
        # the per-reader window alone throttles, exactly as before)
        self._tenant = manager.qos_tenant_for(handle)
        # resource: reader.qos_inflight_bytes (brokered fetch credits)
        self._inflight = manager.qos_inflight_broker()
        self._pump_registered = False
        # skew sub-block sequencing (skew/): a split partition's
        # sub-blocks are interleaved across the fetch plan on purpose,
        # but the merge must see the partition as one contiguous
        # in-sub-order stream for the bit-exactness argument to hold —
        # landed sub-blocks park here until the set completes.  Peak
        # residency is bounded by what the unsplit path holds as ONE
        # block payload anyway.
        # resource: reader.skew_reorder_bytes (parked sub-block payloads)
        # (mid, rid) -> {sub index: (payload, ledger ticket)}
        self._sub_buf: Dict[Any, Dict[int, Any]] = {}
        # in-task fetch retry (faults/): transient transport failures
        # back off and requeue through the normal _pump path instead of
        # converting straight to FetchFailedError.  fetchRetryCount=0
        # keeps the reference posture — the first-failure path is then
        # byte-identical to the pre-retry reader (no health recording,
        # no breaker consultation, same conversion)
        conf = manager.conf
        self._retry = RetryPolicy(
            conf.fetch_retry_count, conf.fetch_retry_wait_ms,
            conf.fetch_retry_max_ms,
        )
        # peers this READER already sent through an open breaker as its
        # one probe — the breaker is node-resident and outlives the
        # task, but a fresh reader (a stage retry on a healed fleet)
        # must never be fast-failed on stale state alone: its first
        # fetch per peer always goes out, and only after THAT fails do
        # the remaining fetches take the fast path
        # (guarded-by: _pending_lock)
        self._breaker_probes: set = set()
        # push-based merged shuffle (shuffle/push.py): merged-first plan
        # state — one phase guard on _awaiting_hosts covers the whole
        # merge-status round, so the consumer cannot observe a false
        # idle between the queries going out and the plan settling
        self._push_state: Optional[Dict[str, Any]] = None  # guarded-by: _pending_lock
        self._push_timer: Optional[threading.Timer] = None
        # every map id this reader owes output for — merged provenance
        # rows outside this set (a speculative attempt the map-output
        # tracker never committed) are neither consumed nor counted as
        # coverage, so delivery stays exactly-once per (map, reduce)
        self._expected_maps: set = set()
        self._m_fetch_latency = histogram("shuffle_remote_fetch_ms")
        self._m_local_read = histogram("shuffle_local_read_ms")
        self._m_rpc_rtt = histogram("rpc_roundtrip_ms", op="fetch_status")
        self._m_merge_fanin = histogram("skew_merge_fanin")
        # distributed tracing (obs/): one root context per reduce task;
        # each issued fetch gets a child span that rides the read
        # request's v2 wire tail so serve-side events join this trace.
        # None when tracing is off or this task was sampled out — every
        # site below is a cheap ``is not None`` / RECORDER.enabled gate.
        self._trace_ctx = TRACING.start()

    # -- fetch machinery ----------------------------------------------------
    def _start_remote_fetches(self) -> Iterator:
        """Kick off async location fetches; returns a LAZY iterator of
        local block payloads (startAsyncRemoteFetches,
        RdmaShuffleFetcherIterator.scala:174-311).  Locals must stream
        one map output at a time: a local-heavy reduce of a GB-scale
        partition would otherwise hold every pread copy resident
        before the consumer sees byte one (observed as whole-partition
        RSS on the 50 GB assembled run), while remote fetches overlap
        the local consumption either way."""
        local_map_ids: List[int] = []
        if self._inflight is not None and not self._pump_registered:
            # brokered window: a credit release anywhere re-pumps this
            # reader's pending queue (unregistered at cleanup)
            self._pump_registered = True
            self._inflight.add_pump(self._pump)
        reduce_ids = range(self.start_partition, self.end_partition)
        if self.manager.conf.push_enabled:
            # push-based merged shuffle: EVERY map output — the local
            # short-circuit included — resolves through the merged-first
            # plan, so coverage accounting stays uniform and each
            # (map, reduce) pair is delivered exactly once.  A merged
            # span freely interleaves local and remote maps' bytes;
            # consuming it remotely while also short-circuiting locals
            # would double-deliver, and skipping spans that contain
            # local bytes would forfeit most of the sequential win.
            # Local data rides transport-to-self, same as a reader that
            # happens to BE its reduce partition's merger.
            self._start_push_phase(reduce_ids)
            return iter(())
        for host, map_ids in self.maps_by_host.items():
            if host == self.manager.local_smid:
                local_map_ids.extend(map_ids)
                continue

            pairs = [(mid, rid) for mid in map_ids for rid in reduce_ids]
            if not pairs:
                continue
            with self._pending_lock:
                self._awaiting_hosts += 1
            self._query_locations(
                host, pairs,
                lambda locs, host=host, pairs=pairs:
                    self._on_primary_locations(host, pairs, locs),
            )

        def _iter_local() -> Iterator:
            # local_blocks/local_bytes count in _iter_block_bytes at
            # CONSUMPTION — NOT here, where the decode-ahead wrapper
            # pulls payloads up to decodeAheadBytes early: an abandoned
            # iteration must report only what was actually read (remote
            # counters behave the same — blocks left in the results
            # queue at cleanup were never yielded)
            for mid in local_map_ids:
                # one batched backing-store read per map output
                # (device segments pay a host round-trip per
                # Segment read; read_many fetches the union span)
                t0 = time.monotonic()
                blocks = self.manager.resolver.get_local_blocks(
                    self.handle.shuffle_id, mid, reduce_ids
                )
                # local payloads used to bypass fetch-wait/latency
                # accounting entirely; the backing-store read is this
                # path's wire time, so the wire-wait/decode-wait split
                # stays honest on loopback-heavy reduces
                dt_ms = (time.monotonic() - t0) * 1000
                self.metrics.fetch_wait_ms += dt_ms
                self._m_local_read.observe(dt_ms)
                for data in blocks:
                    if len(data):  # ndarray views: no bool()
                        yield data

        return _iter_local()

    def _on_metadata_timeout(self, host: ShuffleManagerId) -> None:
        self._fail(
            MetadataFetchFailedError(
                host.host, self.handle.shuffle_id,
                f"no location response within "
                f"{self.manager.conf.partition_location_fetch_timeout_ms}ms",
            )
        )

    def _query_locations(self, host: ShuffleManagerId, pairs, on_ok) -> None:
        """One fetch-status round against the driver for ``pairs`` =
        (map_id, table row) index pairs; ``on_ok`` receives the resolved
        locations.  Shared by the primary round (map × reduce pairs) and
        the skew follow-up round, whose rows are sub-block entries in
        the extended table (skew/) — the driver plane serves both
        identically, which is why splitting needs zero wire change."""
        conf = self.manager.conf
        counter("shuffle_fetch_rpcs_total", mode="location").inc()
        t0 = time.monotonic()
        timer = threading.Timer(
            conf.partition_location_fetch_timeout_ms / 1000.0,
            self._on_metadata_timeout,
            args=(host,),
        )
        timer.daemon = True
        self._timers.append(timer)

        def on_locations(locs, timer=timer, t0=t0):
            timer.cancel()
            rtt_ms = (time.monotonic() - t0) * 1000
            self._m_rpc_rtt.observe(rtt_ms)
            logger.debug(
                "locations for %s resolved in %.1fms",
                host.host, rtt_ms,
            )
            on_ok(locs)

        def on_status_failed(reason, timer=timer):
            # driver answered negatively (executor lost / shuffle
            # unregistered): fail NOW, not at the timeout
            timer.cancel()
            self._fail(MetadataFetchFailedError(
                host.host, self.handle.shuffle_id, reason
            ))

        cb_id = self.manager.register_fetch_callback(
            on_locations, on_status_failed
        )
        self._callback_ids.append(cb_id)
        ctx = self._trace_ctx
        msg = FetchMapStatusMsg(
            self.manager.local_smid, host, self.handle.shuffle_id,
            cb_id, pairs,
            trace_id=ctx.trace_id if ctx is not None else 0,
            span_id=ctx.span_id if ctx is not None else 0,
        )
        timer.start()
        try:
            if FAULTS.enabled:
                FAULTS.check("location_rpc")
            # _send_driver_msg retries once if the cached driver
            # channel was evicted from the bounded cache between
            # lookup and post (reconnects transparently)
            self.manager._send_driver_msg(
                msg,
                on_failure=lambda e: self._fail(
                    MetadataFetchFailedError(
                        host.host, self.handle.shuffle_id,
                        f"status rpc failed: {e}",
                    )
                ),
            )
        except Exception as e:
            self._fail(MetadataFetchFailedError(
                host.host, self.handle.shuffle_id, str(e)))

    def _on_primary_locations(self, host: ShuffleManagerId, pairs,
                              locs) -> None:
        """Primary fetch-status response.  A split partition answers
        with a MARKER entry (skew/) naming its sub-block rows in the
        extended table; resolving those costs ONE more fetch-status
        round against the same plane, after which the sub-blocks join
        this host's fetch plan as ordinary blocks.  ``_awaiting_hosts``
        stays elevated across the second round — ``_enqueue_fetches``
        is the sole decrementer and still runs exactly once per host."""
        markers = [
            (i, loc) for i, loc in enumerate(locs) if is_split_marker(loc)
        ]
        if not markers:
            self._enqueue_fetches(host, locs)
            return
        # aux rows in enumeration order, matching the writer's
        # ascending-pid aux allocation (resolver._put_partition_entry)
        aux_pairs = [
            (pairs[i][0], loc.address + j)
            for i, loc in markers
            for j in range(loc.length)
        ]
        self._query_locations(
            host, aux_pairs,
            lambda aux_locs: self._on_aux_locations(
                host, pairs, locs, markers, aux_locs
            ),
        )

    def _on_aux_locations(self, host: ShuffleManagerId, pairs, locs,
                          markers, aux_locs) -> None:
        """Second-round response: substitute each marker's sub-blocks
        and interleave.  Sub-blocks are dealt depth-wise round-robin
        across per-origin queues so one hot partition's bytes spread
        over fetch groups instead of arriving as one serial lump — the
        balanced-fetch half of the skew story — while the
        ``(map, reduce, sub, of)`` tags let the consumer re-sequence
        them for the bit-exact merge."""
        marker_at = dict(markers)
        cursor = 0
        # one queue per origin block: ordinary entries (empties
        # included — _enqueue_fetches skips them but the wake-up /
        # termination accounting wants the full list) are singletons,
        # split partitions contribute their sub-blocks in sub order
        origins: List[List] = []
        for i, loc in enumerate(locs):
            m = marker_at.get(i)
            if m is None:
                origins.append([(loc, None)])
                continue
            mid, rid = pairs[i]
            subs = aux_locs[cursor:cursor + m.length]
            cursor += m.length
            if len(subs) != m.length or any(
                s.is_empty or is_split_marker(s) for s in subs
            ):
                # a sub row that is empty, missing, or itself a marker
                # means the table we resolved against is torn — treat
                # it as a metadata failure so the stage retries
                self._fail(MetadataFetchFailedError(
                    host.host, self.handle.shuffle_id,
                    f"bad sub-block rows for map {mid} partition {rid}",
                ))
                return
            origins.append([
                (sub, (mid, rid, j, m.length))
                for j, sub in enumerate(subs)
            ])
        out_locs: List[BlockLocation] = []
        out_tags: List[Any] = []
        depth = 0
        while True:
            row = [org[depth] for org in origins if depth < len(org)]
            if not row:
                break
            for loc, tag in row:
                out_locs.append(loc)
                out_tags.append(tag)
            depth += 1
        self._enqueue_fetches(host, out_locs, out_tags)

    # -- push-based merged shuffle (shuffle/push.py) -------------------------
    def _start_push_phase(self, reduce_ids) -> None:
        """Merged-first plan: ask each reduce partition's deterministic
        merger (manager.push_merger_for — the writers pushed there) for
        its merged span, then pull only what the answered provenance
        does not cover.  Best-effort throughout: an unreachable, pre-v3,
        timed-out or fault-drilled merger simply contributes no
        coverage, and those pairs ride the unchanged pull path —
        bit-exact always, the stage never retries over push."""
        mgr = self.manager
        self._expected_maps = {
            mid for ids in self.maps_by_host.values() for mid in ids
        }
        mergers: Dict[ShuffleManagerId, List[int]] = {}
        for rid in reduce_ids:
            m = mgr.push_merger_for(rid)
            if m is not None:
                mergers.setdefault(m, []).append(rid)
        state = {
            "remaining": len(mergers),
            "answered": set(),   # mergers already counted (idempotence)
            "coverage": {},      # rid -> (merger, mkey, length, prov)
            "done": False,
        }
        with self._pending_lock:
            self._push_state = state
            # the phase guard: held until _finish_push_phase has planned
            # every merged fetch and pull re-query
            self._awaiting_hosts += 1
        if not mergers:
            self._finish_push_phase({})
            return
        timer = threading.Timer(
            mgr.conf.push_merge_timeout_ms / 1000.0, self._on_push_timeout,
        )
        timer.daemon = True
        self._timers.append(timer)
        self._push_timer = timer
        timer.start()
        for host, rids in mergers.items():
            self._query_merger(host, rids)

    def _query_merger(self, host: ShuffleManagerId, rids: List[int]) -> None:
        """One merge-status round against one merger.  Every failure
        mode — send failure, merger-side MergeUnavailable, pre-v3 peer —
        lands in ``_merger_answered`` with no coverage."""
        mgr = self.manager
        counter("shuffle_fetch_rpcs_total", mode="merge_status").inc()

        def on_status(result, host=host):
            self._merger_answered(host, [
                (rid, mkey, length, prov)
                for rid, (mkey, length, prov) in result.items()
            ])

        def on_error(reason, host=host):
            counter("push_merge_query_failures_total").inc()
            logger.debug("merger %s gave no coverage: %s",
                         host.host, reason)
            self._merger_answered(host, [])

        if host == mgr.local_smid:
            # the reader's own manager is the merger: seal and answer
            # in-process — no reply channel to self needed.  The merged
            # FETCH still rides the transport (to self), keeping the
            # data path uniform.
            try:
                answers = mgr.push_merger.merge_status(
                    self.handle.shuffle_id, rids)
            except Exception as e:
                on_error(str(e))
                return
            self._merger_answered(host, answers)
            return
        cb_id = mgr.register_merge_callback(on_status, on_error)
        self._callback_ids.append(cb_id)
        msg = FetchMergeStatusMsg(
            mgr.local_smid, self.handle.shuffle_id, cb_id, rids,
        )
        mgr.send_merge_query(host, msg,
                             on_failure=lambda e: on_error(str(e)))

    def _merger_answered(self, host: ShuffleManagerId, answers) -> None:
        """Fold one merger's answers into the plan; the LAST answer (or
        the phase timeout, whichever first) settles it."""
        with self._pending_lock:
            state = self._push_state
            if state["done"] or host in state["answered"]:
                return
            state["answered"].add(host)
            for rid, mkey, length, prov in answers:
                if mkey and length > 0:
                    state["coverage"][rid] = (host, mkey, length,
                                              tuple(prov))
            state["remaining"] -= 1
            if state["remaining"] > 0:
                return
            state["done"] = True
            coverage = dict(state["coverage"])
        if self._push_timer is not None:
            self._push_timer.cancel()
        self._finish_push_phase(coverage)

    def _on_push_timeout(self) -> None:
        """The merge-status round overran pushMergeTimeout: settle the
        plan from whatever answered — unanswered mergers contribute no
        coverage and their partitions pull.  Never a stage failure (the
        metadata-timeout analog deliberately does NOT apply: push is
        advisory, the pull plane still owns every block)."""
        with self._pending_lock:
            state = self._push_state
            if state["done"]:
                return
            state["done"] = True
            coverage = dict(state["coverage"])
        counter("push_merge_timeouts_total").inc()
        logger.warning(
            "merge-status round timed out after %dms; "
            "unanswered mergers fall back to pull",
            self.manager.conf.push_merge_timeout_ms,
        )
        self._finish_push_phase(coverage)

    def _finish_push_phase(self, coverage: Dict) -> None:
        """The merged-first plan is settled: enqueue one sequential
        fetch per merged span, route every uncovered (map, reduce) pair
        through the unchanged pull path, release the phase guard."""
        reduce_ids = range(self.start_partition, self.end_partition)
        expected = self._expected_maps
        covered = set()
        for rid, (_h, _mkey, _length, prov) in coverage.items():
            for mid, _off, _ln in prov:
                if mid in expected:
                    covered.add((mid, rid))
        pull_by_host = []
        for host, map_ids in self.maps_by_host.items():
            pairs = [
                (mid, rid)
                for mid in map_ids for rid in reduce_ids
                if (mid, rid) not in covered
            ]
            if pairs:
                pull_by_host.append((host, pairs))
        with self._pending_lock:
            self._awaiting_hosts += len(pull_by_host)
        for host, pairs in pull_by_host:
            self._query_locations(
                host, pairs,
                lambda locs, host=host, pairs=pairs:
                    self._on_primary_locations(host, pairs, locs),
            )
        for rid in sorted(coverage):
            host, mkey, length, prov = coverage[rid]
            self._enqueue_merged(host, rid, mkey, length, prov)
        with self._pending_lock:
            self._awaiting_hosts -= 1  # release the phase guard
        self._results.put(_Result(blocks=[], host=None))
        self._pump()

    def _enqueue_merged(self, host: ShuffleManagerId, rid: int, mkey: int,
                        length: int, prov) -> None:
        """One merged per-reduce span as ONE pending fetch — a single
        sequential read of the whole span, never re-grouped by
        read_block_size (that cap shapes RANDOM pull batches; splitting
        the sequential run would reintroduce exactly the seeks push
        removes).  Outstanding-block accounting counts the per-map
        blocks the span will deliver, matching the consumer's
        per-result decrement."""
        rows = tuple(r for r in prov if r[0] in self._expected_maps)
        if not rows:
            return  # nothing consumable: the pairs pulled above
        loc = BlockLocation(0, length, mkey)
        pf = _PendingFetch(host, [loc], length, merged=(rid, rows))
        with self._pending_lock:
            self._outstanding_blocks += len(rows)
            self._pending.append(pf)
        if RECORDER.enabled:
            ctx = self._trace_ctx
            fr_event(
                "reader", "merged_enqueue",
                trace_id=ctx.trace_id if ctx is not None else 0,
                host=host.host, reduce_id=rid, blocks=len(rows),
                bytes=length,
            )

    def _slice_merged(self, fetch: _PendingFetch, blocks) -> List:
        """Slice one landed merged span back into its per-map blocks
        (zero-copy views) along the provenance rows the plan consumed —
        from here on they are ordinary remote blocks to the decode and
        merge stages."""
        _rid, rows = fetch.merged
        payload = blocks[0]
        view = (
            memoryview(payload)
            if isinstance(payload, (bytes, bytearray)) else payload
        )
        return [view[off:off + ln] for _mid, off, ln in rows]

    def _repull_merged(self, fetch: _PendingFetch, err) -> None:
        """A merged-span fetch failed (the merger died after planning,
        or its breaker is open): degrade exactly its pairs to the pull
        path — never the stage.  The span's provenance names the
        (map, reduce) pairs this fetch owed; re-query their origin
        hosts like a primary round."""
        rid, rows = fetch.merged
        counter("push_merged_fetch_fallbacks_total").inc()
        logger.warning(
            "merged fetch for reduce %d from %s failed (%s); "
            "pulling its %d blocks", rid, fetch.host.host, err, len(rows),
        )
        if RECORDER.enabled:
            root = self._trace_ctx
            fr_event(
                "reader", "merged_fallback",
                trace_id=root.trace_id if root is not None else 0,
                host=fetch.host.host, reduce_id=rid, blocks=len(rows),
            )
        owner = {
            mid: host
            for host, ids in self.maps_by_host.items() for mid in ids
        }
        by_host: Dict[ShuffleManagerId, List] = {}
        for mid, _off, _ln in rows:
            h = owner.get(mid)
            if h is not None:
                by_host.setdefault(h, []).append((mid, rid))
        with self._pending_lock:
            self._outstanding_blocks -= len(rows)
            self._awaiting_hosts += len(by_host)
        for h, pairs in by_host.items():
            self._query_locations(
                h, pairs,
                lambda locs, host=h, pairs=pairs:
                    self._on_primary_locations(host, pairs, locs),
            )
        self._results.put(_Result(blocks=[], host=fetch.host))
        self._pump()

    def _enqueue_fetches(self, host: ShuffleManagerId,
                         locations: Sequence[BlockLocation],
                         tags: Optional[Sequence[Any]] = None) -> None:
        """Group locations into bounded fetches
        (RdmaShuffleFetcherIterator.scala:214-240).  ``tags`` rides
        along per location (skew sub-block identity or None)."""
        conf = self.manager.conf
        group: List[BlockLocation] = []
        gtags: List[Any] = []
        group_bytes = 0
        new_fetches: List[_PendingFetch] = []
        nonempty = 0

        def close_group():
            new_fetches.append(_PendingFetch(
                host, group, group_bytes,
                tags=gtags if any(t is not None for t in gtags) else None,
            ))

        for idx, loc in enumerate(locations):
            if loc.is_empty:
                continue
            nonempty += 1
            if group and (
                group_bytes + loc.length > conf.shuffle_read_block_size
                or group_bytes + loc.length > conf.max_agg_block
            ):
                close_group()
                group, gtags, group_bytes = [], [], 0
            group.append(loc)
            gtags.append(tags[idx] if tags is not None else None)
            group_bytes += loc.length
        if group:
            close_group()
        with self._pending_lock:
            self._outstanding_blocks += nonempty
            self._pending.extend(new_fetches)
            self._awaiting_hosts -= 1
        if RECORDER.enabled:
            ctx = self._trace_ctx
            for pf in new_fetches:
                fr_event(
                    "reader", "fetch_enqueue",
                    trace_id=ctx.trace_id if ctx is not None else 0,
                    host=pf.host.host, blocks=len(pf.locations),
                    bytes=pf.total_bytes,
                )
        # announce the head of this host's fetch plan before the first
        # read is even issued — the responder's tier warms those blocks
        # off disk while the RPCs are still in flight
        self._send_hint(host)
        # deliver a wake-up marker even if everything was empty so the
        # consumer can re-check its termination condition
        self._results.put(_Result(blocks=[], host=host))
        self._pump()

    def _pump(self) -> None:
        """Issue pending fetches within the in-flight byte window
        (RdmaShuffleFetcherIterator.scala:241-251,357-366).  With QoS
        on, each fetch additionally acquires its bytes from the
        manager's brokered in-flight budget (weighted across tenants,
        per-tenant ``qosTenantMaxInFlight`` cap) — a denied fetch goes
        back to the head of the queue and the broker re-pumps this
        reader when credits release."""
        conf = self.manager.conf
        broker = self._inflight
        while True:
            with self._pending_lock:
                if not self._pending:
                    return
                if (
                    self._bytes_in_flight > 0
                    and self._bytes_in_flight + self._pending[0].total_bytes
                    > conf.max_bytes_in_flight
                ):
                    return
                fetch = self._pending.pop(0)
                self._bytes_in_flight += fetch.total_bytes
            # the window reservation rides the fetch: landed stripes
            # release piecewise, the completion/failure settle closes
            # the remainder
            # owns: reader.inflight_bytes -> on_progress
            # owns: reader.inflight_bytes -> settle
            fetch.win_tkt = ledger_acquire(
                "reader.inflight_bytes", fetch.total_bytes
            )  # acquires: reader.inflight_bytes
            if broker is not None:
                granted = broker.clamp(fetch.total_bytes)
                cls = (
                    INTERACTIVE
                    if self._tenant is not None
                    and self._tenant.interactive else BULK
                )
                seq = broker.release_seq
                if not broker.try_acquire(granted, self._tenant, cls):
                    # over share/quota: requeue at the head — the
                    # broker's release pump retries this reader
                    with self._pending_lock:
                        self._bytes_in_flight -= fetch.total_bytes
                        self._pending.insert(0, fetch)
                    tkt, fetch.win_tkt = fetch.win_tkt, NOOP_TICKET
                    tkt.release()  # releases: reader.inflight_bytes
                    if broker.release_seq != seq:
                        # a release's pump fired INSIDE our deny-and-
                        # requeue window and saw an empty queue — that
                        # wakeup was for us; retry now instead of
                        # waiting for a release that may never come
                        continue
                    return
                fetch.qos_granted = granted
                # owns: reader.qos_inflight_bytes -> on_progress
                # owns: reader.qos_inflight_bytes -> settle
                fetch.qos_tkt = ledger_acquire(
                    "reader.qos_inflight_bytes", granted
                )  # acquires: reader.qos_inflight_bytes
            self._issue(fetch)

    def _send_hint(self, host: ShuffleManagerId) -> None:
        """Announce the next blocks of THIS host's fetch plan so its
        tiered store can warm them off disk before the read RPCs land
        (PrefetchHintMsg — the reader knows its whole plan, the
        responder owns the residency).  Each block is hinted once;
        hints are advisory and never fail the fetch."""
        conf = self.manager.conf
        n = conf.tier_hint_blocks
        if n <= 0 or not conf.tier_prefetch:
            return
        # bounded scan: _pending is plan-ordered and shrinks as fetches
        # issue, so the next unhinted blocks live near its head — give
        # up after examining a few hint-windows' worth rather than
        # sweeping the whole remaining plan under the hot-path lock on
        # every issue (the window advances as the head drains)
        scan_budget = 4 * n
        with self._pending_lock:
            fresh: List[BlockLocation] = []
            for pf in self._pending:
                if pf.host != host:
                    continue
                for loc in pf.locations:
                    scan_budget -= 1
                    key = (host, loc.mkey, loc.address)
                    if key not in self._hinted:
                        self._hinted.add(key)
                        fresh.append(loc)
                    if len(fresh) >= n or scan_budget <= 0:
                        break
                if len(fresh) >= n or scan_budget <= 0:
                    break
        if fresh:
            self.manager.send_prefetch_hint(
                host, self.handle.shuffle_id, fresh
            )

    def _issue(self, fetch: _PendingFetch) -> None:
        # warm the blocks we will ask for NEXT while this fetch is on
        # the wire — the disk reads overlap the transfer instead of
        # serializing behind it
        self._send_hint(fetch.host)
        # the push/pull RPC ledger the bench reads: one increment per
        # read RPC actually put on the wire (retries re-count — they
        # ARE another RPC)
        mode = "push" if fetch.merged is not None else "pull"
        counter("shuffle_fetch_rpcs_total", mode=mode).inc()
        counter("shuffle_fetch_rpc_bytes", mode=mode).inc(fetch.total_bytes)
        t0 = time.monotonic()
        # per-fetch child span: carried on the read request's v2 wire
        # tail so the serving peer's events join this reader's trace
        root = self._trace_ctx
        ctx = root.child() if root is not None else None
        if RECORDER.enabled:
            fr_event(
                "reader", "fetch_issue",
                trace_id=ctx.trace_id if ctx is not None else 0,
                span_id=ctx.span_id if ctx is not None else 0,
                host=fetch.host.host, bytes=fetch.total_bytes,
                attempt=fetch.attempts,
            )
        progressed = [0]
        settled = [False]
        done = [False]
        broker = self._inflight
        qos_left = [fetch.qos_granted]
        peer = (fetch.host.host, fetch.host.port)
        # per-peer recovery state, consulted only with retry on (the
        # fetchRetryCount=0 path must stay byte-identical)
        health = (
            self.manager.node.peer_health(peer)
            if self._retry.enabled else None
        )

        def on_progress(n):
            if RECORDER.enabled:
                fr_event(
                    "transport", "stripe_land",
                    trace_id=ctx.trace_id if ctx is not None else 0,
                    span_id=ctx.span_id if ctx is not None else 0,
                    bytes=n,
                )
            # stripe-granular window accounting: each landed stripe (or
            # small block) frees its bytes from the in-flight window
            # IMMEDIATELY, so the next pending fetch can issue while
            # the rest of a big striped block is still crossing the
            # wire — the window throttles bytes, not whole blocks
            with self._pending_lock:
                if settled[0]:
                    # a lane's progress racing the group's completion/
                    # failure must not release bytes settle() already
                    # reclaimed (the window would over-admit)
                    return
                progressed[0] += n
                self._bytes_in_flight -= n
                rel = min(n, qos_left[0])
                qos_left[0] -= rel
            fetch.win_tkt.release(n)  # releases: reader.inflight_bytes
            if rel and broker is not None:
                # brokered credits free per stripe too (outside the
                # pending lock: the release's grant scan runs pumps)
                broker.release(rel, self._tenant)
                fetch.qos_tkt.release(rel)  # releases: reader.qos_inflight_bytes
            self._pump()

        def settle():
            # idempotent: release whatever progress callbacks didn't.
            # EXPLICIT remainders, never the no-arg close: a progress
            # callback claims its n under the lock but releases the
            # ticket after dropping it, so a no-arg settle racing that
            # window closes the ticket first and turns the late
            # release(n) into a double release (the schedule shaker
            # caught exactly this interleaving in the tcp-async soak).
            # With amounts pinned to the under-lock claims the releases
            # sum to the acquisition exactly, in any order.
            with self._pending_lock:
                if settled[0]:
                    return
                settled[0] = True
                left = fetch.total_bytes - progressed[0]
                if left > 0:
                    self._bytes_in_flight -= left
                rel = qos_left[0]
                qos_left[0] = 0
            fetch.win_tkt.release(left)  # releases: reader.inflight_bytes  # one-shot
            if rel and broker is not None:
                broker.release(rel, self._tenant)
            fetch.qos_tkt.release(rel)  # releases: reader.qos_inflight_bytes # one-shot

        def finish_once() -> bool:
            # the group's FIRST outcome wins: a channel torn down while
            # its completion is in flight can fail a listener from both
            # the reads drain and the outstanding drain (or fail after
            # a success already landed) — a second outcome must neither
            # deliver blocks twice nor schedule a second retry timer
            # for the same fetch
            with self._pending_lock:
                if done[0]:
                    return False
                done[0] = True
                return True

        def on_success(blocks):
            if not finish_once():
                return
            latency = (time.monotonic() - t0) * 1000
            settle()
            if health is not None:
                health.breaker.record_success()
            if self.manager.stats is not None:
                self.manager.stats.update(fetch.host.host, latency)
            self._m_fetch_latency.observe(latency)
            get_tracer().instant(
                "shuffle.fetch.complete", host=fetch.host.host,
                bytes=fetch.total_bytes, latency_ms=round(latency, 2),
            )
            if RECORDER.enabled:
                fr_event(
                    "reader", "fetch_land",
                    trace_id=ctx.trace_id if ctx is not None else 0,
                    span_id=ctx.span_id if ctx is not None else 0,
                    host=fetch.host.host, bytes=fetch.total_bytes,
                    us=int(latency * 1000),
                )
            if fetch.merged is not None:
                # merged span: slice back into per-map blocks before
                # the decode stage — downstream sees ordinary blocks
                blocks = self._slice_merged(fetch, blocks)
            stream = self._decode_stream
            if stream is not None:
                # decode-ahead: landed payloads go to the pool NOW,
                # while the task thread may still be consuming earlier
                # results — the consumer receives tickets (len() keeps
                # the byte accounting identical) in the same order
                blocks = [stream.submit_block(b) for b in blocks]
            self._results.put(
                _Result(blocks=blocks, host=fetch.host, latency_ms=latency,
                        tags=fetch.tags)
            )
            self._pump()

        def on_failure(err):
            if not finish_once():
                return
            settle()
            # the peer's striped group just failed a read: drop its
            # cached read group so the retried stage (or the next
            # reader) rebuilds lanes from scratch instead of riding a
            # group whose peer may be gone
            self.manager.node.invalidate_read_group(
                (fetch.host.host, fetch.host.port)
            )
            if fetch.merged is not None:
                # best-effort posture: a dead merger costs pull
                # traffic, never the stage (and never a retry timer —
                # the pull plane re-resolves from live peers directly)
                if health is not None:
                    health.breaker.record_failure()
                self._repull_merged(fetch, err)
                return
            if health is None:
                self._fail(
                    FetchFailedError(
                        fetch.host.host, self.handle.shuffle_id, str(err)
                    )
                )
                return
            health.breaker.record_failure()
            now = time.monotonic()
            if fetch.attempts == 0:
                # the retry deadline is budgeted from the FIRST failure,
                # not per attempt — a peer limping along cannot stretch
                # the task past fetchRetryMaxMs by failing slowly
                fetch.first_failure_at = now
            fetch.attempts += 1
            elapsed_ms = (now - fetch.first_failure_at) * 1000.0
            delay_ms = self._retry.next_delay_ms(fetch.attempts, elapsed_ms)
            if (
                is_transient(err)
                and delay_ms is not None
                and self._failed is None
                and health.breaker.allow()
            ):
                counter("shuffle_fetch_retries_total").inc()
                counter("shuffle_fetch_retry_ms_total").inc(int(delay_ms))
                get_tracer().instant(
                    "shuffle.fetch.retry", host=fetch.host.host,
                    attempt=fetch.attempts, delay_ms=round(delay_ms, 1),
                )
                if RECORDER.enabled:
                    fr_event(
                        "reader", "fetch_retry",
                        trace_id=ctx.trace_id if ctx is not None else 0,
                        host=fetch.host.host, attempt=fetch.attempts,
                        delay_ms=int(delay_ms),
                    )
                tm = threading.Timer(
                    delay_ms / 1000.0, self._requeue, args=(fetch,)
                )
                tm.daemon = True
                with self._pending_lock:
                    self._timers.append(tm)
                tm.start()
                return
            counter("shuffle_fetch_failures_total").inc()
            self._fail(
                FetchFailedError(
                    fetch.host.host, self.handle.shuffle_id, str(err)
                )
            )

        if health is not None and not health.breaker.allow():
            # breaker open: this peer burned its failure budget — fail
            # the remaining fetches fast instead of paying another full
            # connect+backoff cycle against a peer known bad.  But the
            # breaker outlives the task (node-resident by design), and
            # a stage retry's fresh reader must not inherit a fast-fail
            # for a peer that may have healed: each reader's FIRST
            # fetch per open peer goes out as the probe — success
            # closes the breaker, failure arms the fast path for the
            # fetches behind it.
            with self._pending_lock:
                probed = peer in self._breaker_probes
                self._breaker_probes.add(peer)
            if probed:
                settle()
                if fetch.merged is not None:
                    # an open merger breaker is just "no merger":
                    # degrade this span's pairs to pull
                    self._repull_merged(
                        fetch, "circuit breaker open for %s:%d" % peer
                    )
                    return
                counter("shuffle_fetch_failures_total").inc()
                self._fail(
                    FetchFailedError(
                        fetch.host.host, self.handle.shuffle_id,
                        "circuit breaker open for %s:%d" % peer,
                    )
                )
                return
        try:
            group = self.manager.node.get_read_group(
                (fetch.host.host, fetch.host.port),
                self.manager.network.connect,
            )
            group.read_blocks(
                fetch.locations,
                FnCompletionListener(on_success, on_failure),
                on_progress=on_progress,
                tenant=self._tenant,
                ctx=ctx,
            )
        except Exception as e:
            on_failure(e)

    def _fail(self, err: FetchFailedError) -> None:
        self._failed = err
        if RECORDER.enabled:
            root = self._trace_ctx
            fr_event(
                "reader", "fetch_fail",
                trace_id=root.trace_id if root is not None else 0,
                host=err.host, shuffle_id=err.shuffle_id,
                reason=str(err)[:200],
            )
            # the first FetchFailed is exactly the moment the rings
            # still hold the lead-up — dump before the stage unwinds
            RECORDER.auto_dump("fetch_failed")
        self._results.put(_Result(error=err))

    def _requeue(self, fetch: _PendingFetch) -> None:
        # timer callback: the backoff elapsed, put the fetch back at
        # the HEAD of the pending queue (it already waited its turn)
        # and let the normal pump re-acquire window + QoS tickets for
        # the new attempt.  _outstanding_blocks never dropped, so the
        # consumer keeps blocking through the backoff window.
        with self._pending_lock:
            if self._failed is not None:
                return
            self._pending.insert(0, fetch)
        self._pump()

    # -- consumption --------------------------------------------------------
    def _iter_block_bytes(self) -> Iterator:
        """Blocking consume of raw block payloads: local first, then
        remote completions (hasNext/next,
        RdmaShuffleFetcherIterator.scala:332-374).  Payloads are
        bytes-LIKE, not necessarily ``bytes``: local short-circuits and
        pooled receives hand back zero-copy views (ndarray/memoryview),
        exactly like the windowed plane's destination-row slices — the
        deserializers (utils/serde.py) take any of them without
        copying."""
        try:
            local_payloads = self._start_remote_fetches()
            if self._decode_stream is not None:
                # local payloads decode ahead too: the task thread
                # submits up to decodeAheadBytes of blocks before
                # consuming the first ticket, so local decode overlaps
                # the remote fetches already in flight
                from sparkrdma_tpu_torch.shuffle.decode import iter_decoded_ahead

                local_payloads = iter_decoded_ahead(
                    self._decode_stream, local_payloads,
                    self.manager.conf.decode_ahead_bytes,
                )
            for item in local_payloads:
                # consumption-time accounting (tickets report the raw
                # payload size via len()), mirroring the remote side
                self.metrics.local_blocks += 1
                self.metrics.local_bytes += len(item)
                yield item
            while True:
                with self._pending_lock:
                    if (
                        self._awaiting_hosts == 0
                        and self._outstanding_blocks == 0
                        and not self._pending
                    ):
                        break
                t0 = time.monotonic()
                res = self._results.get()
                waited = (time.monotonic() - t0) * 1000
                self.metrics.fetch_wait_ms += waited
                if RECORDER.enabled:
                    root = self._trace_ctx
                    fr_event(
                        "reader", "consume_wait",
                        trace_id=root.trace_id if root is not None else 0,
                        us=int(waited * 1000),
                    )
                if res.error is not None:
                    raise res.error
                if not res.blocks:
                    continue  # wake-up marker
                with self._pending_lock:
                    self._outstanding_blocks -= len(res.blocks)
                for i, data in enumerate(res.blocks):
                    tag = res.tags[i] if res.tags is not None else None
                    if tag is None:
                        self.metrics.remote_blocks += 1
                        self.metrics.remote_bytes += len(data)
                        yield data
                    else:
                        # skew sub-block: deliver in sub-index order so
                        # the merge sees each split partition as the
                        # exact unsplit payload cut at frame boundaries
                        yield from self._sequence_sub_block(tag, data)
        finally:
            # runs on normal exhaustion, fetch failure, AND abandoned
            # iteration (GeneratorExit) — timers and callbacks never leak
            self._cleanup()

    def _sequence_sub_block(self, tag, item) -> Iterator:
        """Park one landed sub-block of a split partition (skew/) and,
        once ALL its siblings have landed, emit the whole partition
        contiguously in sub-index order.  Contiguity — not just sub
        order — is what keeps the merge bit-exact with the unsplit
        path: each sub-run is a stable slice of the map task's sorted
        partition payload, so emitting them back-to-back reconstructs
        the exact record stream of the original block at ONE stream
        position, just as an unsplit fetch would have delivered it;
        draining subs early would interleave the partition's records
        with other blocks and flip equal-key order under the stable
        merge.  Items are raw payloads or decode tickets; both report
        their payload size via ``len()``, and peak parked residency is
        bounded by what the unsplit path holds as one block payload."""
        mid, rid, sub_idx, num_subs = tag
        key = (mid, rid)
        # owns: reader.skew_reorder_bytes -> _sequence_sub_block
        # owns: reader.skew_reorder_bytes -> _cleanup
        tkt = ledger_acquire(
            "reader.skew_reorder_bytes", len(item)
        )  # acquires: reader.skew_reorder_bytes
        buf = self._sub_buf.setdefault(key, {})
        buf[sub_idx] = (item, tkt)
        if len(buf) < num_subs:
            return
        # complete: release every ticket and clear state BEFORE the
        # first yield, so an abandoned iteration (GeneratorExit
        # mid-yield) can't double-release a parked ticket
        del self._sub_buf[key]
        self._m_merge_fanin.observe(num_subs)
        ready = []
        for j in range(num_subs):
            parked, t = buf.pop(j)
            t.release()  # releases: reader.skew_reorder_bytes  # one-shot
            ready.append(parked)
        for it in ready:
            self.metrics.remote_blocks += 1
            self.metrics.remote_bytes += len(it)
            yield it

    def _iter_raw(self) -> Iterator[Record]:
        """Serial decode on the task thread (decodeThreads=0): blocks
        materialize one at a time so the decode half of the wire-wait/
        decode-wait split is measured (block-granular — payloads are
        bounded by maxAggBlock)."""
        deser = self.manager.serializer.deserialize
        for data in self._iter_block_bytes():
            t0 = time.monotonic()
            recs = list(deser(data))
            self.metrics.decode_wait_ms += (time.monotonic() - t0) * 1000
            self.metrics.records_read += len(recs)
            yield from recs

    def _resolve_decoded(self, item):
        """One pipelined block: wait for (or steal) its decode ticket;
        returns the decoded item list.  Ticket wait time is the
        decode-wait half of the fetch-wait split."""
        t0 = time.monotonic()
        items, n = item.get()
        waited = (time.monotonic() - t0) * 1000
        self.metrics.decode_wait_ms += waited
        self.metrics.records_read += n
        if RECORDER.enabled:
            root = self._trace_ctx
            fr_event(
                "reader", "decode_wait",
                trace_id=root.trace_id if root is not None else 0,
                us=int(waited * 1000), records=n,
            )
        return items

    def _iter_record_runs(self) -> Iterator[List[Record]]:
        """Pipelined tuple plane: yields one decoded (and, under
        key_ordering, worker-sorted) record list per block."""
        for item in self._iter_block_bytes():
            yield self._resolve_decoded(item)

    def _cleanup(self) -> None:
        for t in self._timers:
            t.cancel()
        # parked sub-blocks an abandoned or failed iteration never
        # drained still hold reorder-buffer tickets
        for buf in self._sub_buf.values():
            for _item, tkt in buf.values():
                tkt.release()  # releases: reader.skew_reorder_bytes  # one-shot
        self._sub_buf.clear()
        for cb_id in self._callback_ids:
            self.manager.unregister_fetch_callback(cb_id)
        if self._pump_registered:
            self._pump_registered = False
            self._inflight.remove_pump(self._pump)
        if self._decode_stream is not None:
            # poison in-flight decodes: queued tickets cancel, credits
            # release — runs on normal exhaustion, FetchFailedError AND
            # abandoned iteration, so no worker ever hangs on a dead
            # reader
            self._decode_stream.close()
        flush_read_metrics(self.manager, self.handle.shuffle_id,
                           self.metrics, self)

    def _read_columnar(self) -> Iterator[Record]:
        """Columnar read: blocks deserialize to column batches and the
        aggregate/sort stage runs as numpy kernels — the read-side half
        of the unsafe-row analog.  Yields (key, value) pairs where
        group_by_key values are numpy arrays (the columnar stand-in for
        the tuple plane's lists)."""
        deser = self.manager.serializer.deserialize_columns
        batches = []
        if self._decode_stream is not None:
            for item in self._iter_block_bytes():
                batches.extend(self._resolve_decoded(item))
        else:
            for data in self._iter_block_bytes():
                t0 = time.monotonic()
                got = list(deser(data))
                self.metrics.decode_wait_ms += (
                    time.monotonic() - t0
                ) * 1000
                for b in got:
                    self.metrics.records_read += len(b)
                batches.extend(got)
        return postprocess_column_batches(batches, self.handle)

    def read(self) -> Iterator[Record]:
        """Full read path: fetch → (decode-ahead) deserialize →
        aggregate → sort/merge (RdmaShuffleReader.scala:43-113)."""
        from sparkrdma_tpu_torch.shuffle.decode import open_decode_stream
        from sparkrdma_tpu_torch.shuffle.manager import ColumnarAggregator

        agg = self.handle.aggregator
        columnar = getattr(
            self.manager.serializer, "supports_columns", False
        ) and (agg is None or isinstance(agg, ColumnarAggregator))
        self._decode_stream = open_decode_stream(
            self.manager, self.handle, columnar
        )
        if columnar:
            return self._read_columnar()
        if self._decode_stream is not None:
            return postprocess_record_runs(
                self._iter_record_runs(), self.handle,
                presorted=True,  # workers sort per block (decode_fn)
            )
        return postprocess_records(self._iter_raw(), self.handle)


def postprocess_column_batches(batches, handle) -> Iterator[Record]:
    """The columnar aggregate/sort stage on deserialized ColumnBatch
    lists — shared by the pull reader and the bulk-exchange plane."""
    from sparkrdma_tpu_torch.utils.columns import (
        combine_columns,
        concat_batches,
        group_columns,
        sorted_runs_order,
    )

    total = sum(len(b) for b in batches)
    if total == 0:
        return iter(())
    agg = handle.aggregator
    if agg is not None and agg.kind != "group":
        # reduce each block first (key-sorted blocks reduce with no
        # sort), then combine the shrunken remainders
        reduced = [combine_columns(b, agg.kind) for b in batches]
        batch = combine_columns(concat_batches(reduced), agg.kind)
        # combine output is key-sorted, so key_ordering holds too
        return iter(zip(batch.keys.tolist(), batch.vals.tolist()))
    if agg is not None:
        if all(b.key_sorted for b in batches):
            nonempty = [b for b in batches if len(b)]
            # fused native merge: ONE streaming pass copies each
            # key's contiguous run slices into the grouped output
            # (per-key values are then views) — beats both the
            # per-key Python merge and the concat+gather route.
            # A single run needs no merge at all: group_columns /
            # merge_sorted_groups below serve it with zero-copy views
            from sparkrdma_tpu_torch.memory.staging import (
                native_merge_runs_groups,
            )

            res = None
            if len(nonempty) >= 2:
                res = native_merge_runs_groups(
                    [b.keys for b in nonempty],
                    [b.vals for b in nonempty],
                )
            if res is not None:
                uk, merged_vals, offs = res

                def _native_groups():
                    for i, k in enumerate(uk.tolist()):
                        yield k, merged_vals[offs[i]:offs[i + 1]]

                return _native_groups()
            from sparkrdma_tpu_torch.utils.columns import merge_sorted_groups

            per = [group_columns(b) for b in nonempty]
            entries = sum(len(uk) for uk, _ in per)
            # per-key merge beats concat+gather only while the
            # Python loop stays small next to the moved bytes
            if entries <= max(1 << 15, total // 8):
                return merge_sorted_groups(per)
        cat = concat_batches(batches)
        uk, groups = group_columns(
            cat,
            # an already-key_sorted concat takes group_columns' own
            # fast path; computing the (identity) order would only
            # allocate
            order=None if cat.key_sorted
            else sorted_runs_order(batches, cat),
        )
        return iter(zip(uk.tolist(), groups))
    if handle.key_ordering:
        # streaming k-way merge over per-block sorted runs (unsorted
        # stragglers sort once per block inside) — replaces the
        # concat → global sort → whole-partition gather+tolist
        from sparkrdma_tpu_torch.utils.columns import iter_merged_sorted_batches

        return iter_merged_sorted_batches(batches)
    return iter(concat_batches(batches))


def postprocess_record_runs(runs, handle,
                            presorted: bool = False) -> Iterator[Record]:
    """The read-side aggregate → order stage over PER-BLOCK record
    runs — the streaming replacement for materialize-then-sort
    (Spark's ``ExternalSorter`` merge phase, reduce side): with
    ``key_ordering`` and no aggregator the runs (each sorted — by the
    decode workers on the pipelined path, map-side or here otherwise)
    k-way heap-merge lazily, so peak residency is the per-block lists
    plus the heap instead of a second whole-partition sorted copy.
    Stable per-run sort + run-order-stable merge emits the exact
    sequence a stable global sort of the concatenated runs would.
    Aggregation keeps the streaming dict combine (arrival order —
    identical to the serial path's)."""
    import heapq

    agg = handle.aggregator
    if agg is not None:
        combined: Dict[Any, Any] = {}
        if handle.map_side_combine:
            # records are (key, combiner) pairs already
            for run in runs:
                for k, c in run:
                    combined[k] = (
                        agg.merge_combiners(combined[k], c)
                        if k in combined else c
                    )
        else:
            for run in runs:
                for k, v in run:
                    combined[k] = (
                        agg.merge_value(combined[k], v)
                        if k in combined else agg.create_combiner(v)
                    )
        records: Iterator[Record] = iter(combined.items())
        if handle.key_ordering:
            records = iter(sorted(records, key=lambda kv: kv[0]))
        return records
    if not handle.key_ordering:
        return (rec for run in runs for rec in run)
    run_lists: List[List[Record]] = []
    for run in runs:
        if not isinstance(run, list):
            run = list(run)
        elif not presorted:
            run = list(run)  # never mutate a caller's list in place
        if not presorted:
            run.sort(key=lambda kv: kv[0])
        if run:
            run_lists.append(run)
    if not run_lists:
        return iter(())
    if len(run_lists) == 1:
        return iter(run_lists[0])
    return heapq.merge(*run_lists, key=lambda kv: kv[0])


def postprocess_records(records: Iterator[Record], handle) -> Iterator[Record]:
    """The read-side aggregate → sort stage on one flat record iterator
    (RdmaShuffleReader.scala:82-113) — the single-run adapter over
    :func:`postprocess_record_runs`, shared by the serial pull path and
    the bulk-exchange readers."""
    return postprocess_record_runs([records], handle)
