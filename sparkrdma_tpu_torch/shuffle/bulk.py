"""Bulk-synchronous collective shuffle: the multi-host data plane.  The
port of ``sparkrdma_tpu/shuffle/bulk.py``.

The in-process collective plane (tests/collective_read_fixture.py) batches
reader fetches into all_to_all rounds opportunistically; across HOSTS
that requires every process to launch identical collectives, so this
module runs the exchange bulk-synchronously instead — the natural mode
for mesh-resident SPMD jobs (SURVEY.md §7 "pull → collective
inversion"):

1. map phase: every executor writes + publishes normally (the TCP
   control plane carries publishes to the driver across processes),
2. barrier: each host asks the driver for the exchange PLAN
   (FetchExchangePlanMsg); the driver answers once every registered map
   has published — with the canonical host order, the full
   (src × dst) stream-length matrix, and the requester's destination
   manifest,
3. one collective: every host concatenates its local blocks into
   per-destination streams and calls ``TileExchange.exchange_bytes``
   with the agreed lengths — all processes compile the same programs
   and the bytes ride ICI/DCN,
4. each host slices its destination row by the manifest and feeds the
   blocks to the serializer.

Partition ownership is ``reduce_id % n_hosts`` over the plan's
canonical host order — the bulk-mode convention the driver and every
executor share.

The reference has no analog mode (its reducers pull asynchronously);
this is the answer to scaling the shuffle the way NCCL/MPI backends
scale — symmetric collectives instead of per-pair streams.

Where the port differs from the JAX package:

- In one process (``TpuShuffleContext``) the E executors share a
  :class:`BulkShuffleSession` over a co-located ``TileExchange``
  (``TileExchange.colocated(E)``): every source row is local, and the
  collective is a permutation of the stacked rows on the context's
  device, as JAX's single controller runs ``all_to_all`` over
  ``make_mesh(E)``.
- Across processes each process runs ONE executor on its own device,
  and its reader's exchange is rank-local over the ``torch.distributed``
  world (``parallel/multihost.py``); the rank must equal the executor's
  index in the plan's canonical host order.  Ranks issue their
  collectives in the order their window plans land; two shuffles whose
  windows interleave differently on two ranks would pair the wrong
  collectives, so across processes a job runs the windows of one
  shuffle at a time (the JAX multi-controller mode shares this limit).
- The padded device framing (``deviceExchangeEnabled``) runs only when
  the exchange holds every source in this process (co-located, or a
  world of one); across processes the host-staged ``exchange_into``
  runs, as in the JAX package.
- Assembled source rows are pinned on a card (:func:`source_row_alloc`):
  the padded path copies them to the device as they are.  Destination
  rows come from the session's ``out_alloc`` (the first executor's
  staging pool, as in the JAX package): the exchange fills them on the
  host from its own pinned staging buffers, so they are never the
  target of a device copy.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional

import numpy as np

from sparkrdma_tpu_torch.memory.device_arena import DeviceStagingBridge
from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.parallel.exchange import (
    PaddedSourceRow,
    TileExchange,
    row_offsets,
)
from sparkrdma_tpu_torch.parallel.group import world_group
from sparkrdma_tpu_torch.utils.dbglock import dbg_condition, dbg_lock
from sparkrdma_tpu_torch.rpc.messages import FetchExchangePlanMsg
from sparkrdma_tpu_torch.shuffle.reader import (
    FetchFailedError,
    MetadataFetchFailedError,
    flush_read_metrics,
)


def source_row_alloc(manager):
    """The allocator ``nbytes -> uint8 row`` of the source rows that
    ``manager``'s reader assembles: pinned rows on a card, where the
    padded path copies the row to the device as it is (a pageable row
    goes through the driver's bounce buffer at a fraction of the link's
    rate); pooled rows of the manager's ``StagingPool`` on the CPU, as
    in the JAX package (no pool: plain numpy).  Pooled rows recycle when
    the last view of them dies; pinned ones through the caching host
    allocator."""
    pool = None if manager.device.type == "cuda" \
        else getattr(manager, "staging_pool", None)
    return DeviceStagingBridge(manager.device, pool=pool).alloc_row


class BulkShuffleSession:
    """In-process contribution barrier: when several participating
    executors share ONE process (tests, local[*] mode), their rows must
    ride a single collective — each contributes its source row, the
    last contributor runs the exchange, everyone shares the result.

    Across processes this object is unnecessary: the collective itself
    is the barrier (each process fills only its own addressable rows).
    """

    def __init__(self, exchange: TileExchange, n_hosts: int,
                 timeout_s: float = 120.0, out_alloc=None,
                 window_rounds: int = 0):
        self.exchange = exchange
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        # optional pooled allocator for destination rows (e.g. a
        # StagingPool.alloc_gc): zero-copy results then recycle their
        # buffers once the last consumer view dies
        self.out_alloc = out_alloc
        # in-flight collective window for PADDED (device-native) rounds
        # (conf deviceExchangeWindowRounds; 0 = one fused program)
        self.window_rounds = int(window_rounds)
        self._cv = dbg_condition("bulk.session", 26)
        self._rows = {}  # guarded-by: _cv
        self._cbs: list = []  # per-generation on_round callbacks
        self._lengths = None  # guarded-by: _cv
        # results keyed by ROUND generation: a waiter descheduled
        # across a whole subsequent round must still read its own
        # round's outcome, not the latest
        self._results = {}
        self._gen = 0
        # explicitly keyed rounds ((shuffle_id, window) from the
        # windowed plane): CONCURRENT shuffles on one session each get
        # their own barrier instead of cross-contributing rows into a
        # shared generation
        self._keyed: dict = {}
        self._aborted = None  # sticky: a failed participant poisons all

    def abort(self, error: BaseException) -> None:
        """A participant failed before contributing: poison the
        session so waiters (and future contributors) fail immediately
        instead of riding out the barrier timeout."""
        with self._cv:
            self._aborted = error
            self._cv.notify_all()

    def run(self, me: int, row: List[bytes], lengths: np.ndarray,
            round_key=None, on_round=None):
        """Contribute source row ``me``; blocks until every host
        contributed and the one exchange ran.  Returns the shared
        result.

        ``round_key`` (e.g. ``(shuffle_id, window)``) isolates this
        round's barrier: callers that may run several shuffles
        concurrently through ONE session MUST pass it — unkeyed rounds
        share a single generation counter and would cross-contribute.

        ``on_round`` (device-native rounds only) is this contributor's
        per-round landing callback: every contributor may register one
        and the exchange fans each landed round out to ALL of them —
        that is how each in-process executor's decode overlap sees its
        own destination's completed blocks while the next round's
        collective is still in flight."""
        if round_key is not None:
            return self._run_keyed(me, row, lengths, round_key, on_round)
        with self._cv:
            if self._aborted is not None:
                raise RuntimeError(
                    "bulk exchange aborted by a failed participant"
                ) from self._aborted
            gen = self._gen
            if self._lengths is None:
                self._lengths = np.asarray(lengths)
            elif not np.array_equal(self._lengths, lengths):
                raise ValueError(
                    "contributors disagree on the lengths matrix"
                )
            if me in self._rows:
                raise ValueError(f"row {me} contributed twice")
            self._rows[me] = row
            if on_round is not None:
                self._cbs.append(on_round)
            if len(self._rows) == self.n_hosts:
                cbs, self._cbs = self._cbs, []
                try:
                    self._results[gen] = (
                        self._exchange_contributed(
                            self._rows, self._lengths,
                            on_round=_fanout(cbs),
                        ),
                        None,
                    )
                except BaseException as e:
                    self._results[gen] = (None, e)
                self._rows = {}
                self._lengths = None
                self._gen += 1
                # keep only recent rounds (waiters of gen and gen-1
                # may still be draining)
                for g in [g for g in self._results if g < gen - 1]:
                    del self._results[g]
                self._cv.notify_all()
            else:
                while self._gen == gen and self._aborted is None:
                    if not self._cv.wait(timeout=self.timeout_s):
                        raise TimeoutError(
                            f"bulk exchange barrier: not every host "
                            f"contributed within {self.timeout_s:.0f}s "
                            f"(conf spark.shuffle.tpu.bulkBarrierTimeout)"
                        )
                if self._aborted is not None:
                    raise RuntimeError(
                        "bulk exchange aborted by a failed participant"
                    ) from self._aborted
            result, error = self._results[gen]
            if error is not None:
                raise error
            return result

    def _run_keyed(self, me: int, row: List[bytes], lengths: np.ndarray,
                   key, on_round=None) -> object:
        with self._cv:
            if self._aborted is not None:
                raise RuntimeError(
                    "bulk exchange aborted by a failed participant"
                ) from self._aborted
            st = self._keyed.get(key)
            if st is None:
                st = self._keyed[key] = {
                    "rows": {}, "lengths": np.asarray(lengths),
                    "result": None, "error": None, "done": False,
                    "delivered": 0, "cbs": [],
                }
            elif not np.array_equal(st["lengths"], lengths):
                raise ValueError(
                    f"contributors disagree on the lengths matrix "
                    f"(round {key})"
                )
            if me in st["rows"]:
                raise ValueError(
                    f"row {me} contributed twice (round {key})"
                )
            st["rows"][me] = row
            if on_round is not None:
                st["cbs"].append(on_round)
            if len(st["rows"]) == self.n_hosts:
                try:
                    st["result"] = self._exchange_contributed(
                        st["rows"], st["lengths"],
                        on_round=_fanout(st["cbs"]),
                    )
                except BaseException as e:
                    st["error"] = e
                st["done"] = True
                self._cv.notify_all()
            else:
                deadline = time.monotonic() + self.timeout_s
                while not st["done"] and self._aborted is None:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cv.wait(timeout=left):
                        raise TimeoutError(
                            f"bulk exchange barrier (round {key}): not "
                            f"every host contributed within "
                            f"{self.timeout_s:.0f}s (conf "
                            f"spark.shuffle.tpu.bulkBarrierTimeout)"
                        )
                if self._aborted is not None:
                    raise RuntimeError(
                        "bulk exchange aborted by a failed participant"
                    ) from self._aborted
            result, error = st["result"], st["error"]
            st["delivered"] += 1
            if st["delivered"] >= self.n_hosts:
                self._keyed.pop(key, None)  # all participants served
            if error is not None:
                raise error
            return result

    def _exchange_contributed(self, rows: dict, lengths,
                              on_round=None) -> object:
        """Run the one collective over the contributed rows.  Rows come
        in three shapes: :class:`PaddedSourceRow` (the DEVICE-NATIVE
        path — one ``device_put`` per source, the collective consumes
        the padded framing directly via ``exchange_padded``),
        contiguous uint8 arrays (the host zero-copy path —
        ``exchange_into`` into destination row VIEWS), or the legacy
        per-destination ``bytes`` lists (``exchange_bytes``).  Mixed
        contributions (a mid-upgrade cluster) downgrade padded/array
        rows to the least capable shape aboard so one legacy
        participant never deadlocks the round."""
        E = self.n_hosts
        if rows and all(
            isinstance(r, PaddedSourceRow) for r in rows.values()
        ):
            return self.exchange.exchange_padded(
                lengths, dict(rows), local_sources=frozenset(rows),
                out_alloc=self._dst_alloc, on_round=on_round,
                window_rounds=self.window_rounds,
            )
        if rows and all(
            isinstance(r, np.ndarray) for r in rows.values()
        ):
            return self.exchange.exchange_into(
                lengths, dict(rows), local_sources=frozenset(rows),
                out_alloc=self._dst_alloc,
            )
        streams: list = [[b""] * E for _ in range(E)]
        for s, r in rows.items():
            if isinstance(r, PaddedSourceRow):
                streams[s] = [
                    bytes(memoryview(r.stream(d, int(lengths[s, d]))))
                    for d in range(E)
                ]
            elif isinstance(r, np.ndarray):
                offs = row_offsets(lengths[s])
                streams[s] = [
                    bytes(memoryview(
                        r[int(offs[d]):int(offs[d + 1])]
                    ))
                    for d in range(E)
                ]
            else:
                streams[s] = list(r)
        return self.exchange.exchange_bytes(
            streams, lengths=lengths, local_sources=frozenset(rows),
        )

    def _dst_alloc(self, nbytes: int) -> np.ndarray:
        """Destination-row buffer: pooled when the session was given an
        allocator, fresh numpy memory otherwise (or when the pool's
        budget is exhausted — an exchange must not fail on pool
        pressure when plain memory would serve)."""
        if self.out_alloc is not None:
            try:
                return self.out_alloc(nbytes)
            except MemoryError:
                # always on: the card run reports it
                counter("exchange_row_pool_fallbacks_total",
                        force=True).inc()
        return np.empty(nbytes, np.uint8)


def iter_plan_blocks(plan, E: int, row):
    """Walk one exchange result row by its plan manifest: yields
    ``(source, map_id, reduce_id, block payload)`` for every block this
    host received — the ONE offset-slicing loop shared by the windowed
    pump and both bulk consumption paths (a second copy drifting on
    manifest layout would silently misalign block boundaries).  Block
    payloads are zero-copy slices of the row (uint8 views on the
    ``exchange_into`` path, ``bytes`` slices on the legacy one); every
    consumer downstream takes bytes-likes."""
    for s in range(E):
        data = row[s]
        off = 0
        for map_id, reduce_id, n in plan.manifest[s]:
            yield s, map_id, reduce_id, data[off : off + n]
            off += n


def _fanout(cbs: list):
    """Compose contributors' on_round callbacks into the ONE callback
    the exchange takes (None when nobody registered)."""
    cbs = [cb for cb in cbs if cb is not None]
    if not cbs:
        return None
    if len(cbs) == 1:
        return cbs[0]

    def on_round(rnd, lo, hi, rows):
        for cb in cbs:
            cb(rnd, lo, hi, rows)

    return on_round


def _make_round_emitter(plan, E: int, me: int, lengths, sink):
    """Per-round block emitter: the collective/decode overlap of the
    device-native exchange.

    ``exchange_padded`` calls the returned ``on_round(rnd, lo, hi,
    rows)`` after each tile round LANDS; every manifest block of this
    host's destination row that is now fully received (the valid
    prefix ``[0, hi)`` covers it) goes to the plane's round ``sink``
    as a zero-copy view — so the DecodePool deserializes round
    ``rnd``'s blocks while round ``rnd + 1``'s collective is still in
    flight.  The LAST round (``hi`` covering the longest incoming
    stream — also the fused full-shot program) is deliberately left to
    the pump: it delivers the residual as the plan window's own event,
    keeping window accounting and ``final`` semantics exactly where
    they were."""
    manifest = plan.manifest
    next_block = [0] * E      # blocks already emitted, per source
    done_off = [0] * E        # byte offset those blocks covered
    # lengths is [E, E] plan metadata, not payload
    max_len = int(np.asarray(lengths)[:, me].max()) if E else 0  # noqa: PY13

    def on_round(rnd, lo, hi, rows):
        if hi >= max_len:
            return  # final round: the pump owns this window's deliver
        view = rows[me]
        blocks = []
        for s in range(E):
            data = view[s]
            lim = min(hi, len(data))
            off = done_off[s]
            i = next_block[s]
            man = manifest[s]
            while i < len(man):
                map_id, reduce_id, n = man[i]
                if off + n > lim:
                    break
                blocks.append(
                    (s, map_id, reduce_id, data[off : off + n])
                )
                off += n
                i += 1
            next_block[s] = i
            done_off[s] = off
        if blocks:
            payload = sum(len(b) for _s, _m, _r, b in blocks)
            sink(plan, blocks, payload, next_block)

    return on_round


def _iter_residual_blocks(plan, E: int, row, emitted):
    """The blocks :func:`_make_round_emitter` did NOT deliver early
    (``emitted[s]`` = count of source ``s``'s already-emitted manifest
    prefix) — the pump delivers these as the plan window's event."""
    for s in range(E):
        data = row[s]
        off = 0
        for i, (map_id, reduce_id, n) in enumerate(plan.manifest[s]):
            if i >= emitted[s]:
                yield s, map_id, reduce_id, data[off : off + n]
            off += n


class _ShuffleWindows:
    """Per-shuffle receive state shared by every reader on one executor:
    windows of (map_id, reduce_id, block bytes) delivered by the pump,
    a final flag, and a sticky error."""

    def __init__(self):
        self._cv = dbg_condition("bulk.windows", 28)
        self._windows: List[List[tuple]] = []  # guarded-by: _cv
        # (window, t, bytes) per deliver
        self._events: List[tuple] = []  # guarded-by: _cv
        self.hosts = None   # canonical host order, pinned at window 0
        self.me = -1        # this executor's index in hosts
        self._done = False
        self._error: Optional[BaseException] = None

    def deliver(self, blocks: List[tuple], final: bool, hosts,
                me: int, payload_bytes: int) -> None:
        with self._cv:
            if self.hosts is None:
                self.hosts = tuple(hosts)
                self.me = me
            self._windows.append(blocks)
            self._events.append(
                (len(self._windows) - 1, time.monotonic(), payload_bytes)
            )
            if final:
                self._done = True
            self._cv.notify_all()
        counter("shuffle_windows_total").inc()
        counter("shuffle_window_payload_bytes_total").inc(payload_bytes)
        # resident until the plane forgets the shuffle — the occupancy
        # gauge tracks buffered windows across every active pump
        gauge("shuffle_window_occupancy").inc()

    def fail(self, err: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = err
            self._done = True
            self._cv.notify_all()

    def wait_beyond(self, idx: int, timeout_s: float):
        """Block until there are windows past ``idx`` (or the shuffle
        finished/failed); returns (new windows, done)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while len(self._windows) <= idx and not self._done:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    raise TimeoutError(
                        f"no exchange window beyond {idx} within "
                        f"{timeout_s:.0f}s"
                    )
            if self._error is not None:
                raise self._error
            return list(self._windows[idx:]), self._done

    @property
    def window_events(self) -> List[tuple]:
        with self._cv:
            return list(self._events)


class WindowedReadPlane:
    """The unified reactive device plane (readPlane=windowed).

    Reducers issue partition reads through ``manager.get_reader`` —
    the reference's reactive pull model
    (RdmaShuffleFetcherIterator.scala:241-251) — and the bytes move as
    the driver's incremental window plans land: ONE symmetric
    TileExchange collective per window per shuffle, shared by every
    reader on this executor (the window pump).  Reactive AND
    multi-process: the same plan RPCs + collectives the bulk plane
    uses across OS processes, with blocks surfacing to readers
    window-by-window while straggler maps still write.

    This supersedes the in-process-only opportunistic coordinator
    (tests/collective_read_fixture.py, now a test fixture): cross-process
    agreement on collective launches comes from the driver's window
    plans instead of per-process batching heuristics."""

    def __init__(self, manager, exchange: Optional[TileExchange] = None,
                 group=None, session: Optional[BulkShuffleSession] = None):
        self.manager = manager
        self._bulk = BulkExchangeReader(
            manager, exchange=exchange, group=group, session=session
        )
        self._lock = dbg_lock("bulk.plane", 24)
        self._shuffles = {}  # guarded-by: _lock

    # -- reader factory (manager.get_reader hook) ---------------------------
    def reader(self, handle, start_partition: int, end_partition: int):
        return WindowedShuffleReader(
            self, handle, start_partition, end_partition
        )

    def join(self, shuffle_id: int) -> None:
        """Start this executor's window pump for a shuffle even when it
        owns no partitions: every host in the plan must join each
        window's collective (symmetric participation), reader or not."""
        self._state(shuffle_id)

    def forget(self, shuffle_id: int) -> None:
        with self._lock:
            st = self._shuffles.pop(shuffle_id, None)
        if st is not None:
            resident = len(st.window_events)
            if resident:
                gauge("shuffle_window_occupancy").dec(resident)

    def window_events(self, shuffle_id: int) -> List[tuple]:
        """(window, completion time, payload bytes) per landed window —
        the straggler-overlap observability hook."""
        with self._lock:
            st = self._shuffles.get(shuffle_id)
        return st.window_events if st is not None else []

    def stats(self) -> dict:
        """Exchange counters + active pump count (the coordinator-plane
        stats() analog for this plane)."""
        out = dict(self._bulk.exchange.stats())
        with self._lock:
            out["active_shuffles"] = len(self._shuffles)
        return out

    # -- the pump -----------------------------------------------------------
    def _state(self, shuffle_id: int) -> _ShuffleWindows:
        with self._lock:
            st = self._shuffles.get(shuffle_id)
            if st is None:
                st = self._shuffles[shuffle_id] = _ShuffleWindows()
                t = threading.Thread(
                    target=self._pump, args=(shuffle_id, st),
                    name=f"windowed-read-{shuffle_id}", daemon=True,
                )
                t.start()
            return st

    def _pump(self, shuffle_id: int, st: _ShuffleWindows) -> None:
        """One thread per (executor, shuffle): runs the windowed
        exchanges in order (next window's plan fetch overlapping the
        current collective) and feeds received blocks to the readers.

        While a device-native exchange runs MULTI-ROUND, the installed
        round sink delivers each landed round's completed blocks as an
        extra window immediately (decode overlaps the next round's
        collective); this loop then delivers only that plan's RESIDUAL
        blocks, so single-round exchanges — and the host-staged path —
        behave exactly as before."""
        mgr = self.manager
        delivered: dict = {}  # id(plan) -> per-source emitted counts

        def sink(plan, blocks, payload, emitted):
            delivered[id(plan)] = emitted
            me = list(plan.hosts).index(mgr.local_smid)
            st.deliver(blocks, False, plan.hosts, me, payload)

        self._bulk.round_block_sinks[shuffle_id] = sink
        try:
            if mgr.conf.bulk_window_maps <= 0:
                exchanges = iter(
                    [self._bulk._exchange_rows(shuffle_id, window=-1)]
                )
            else:
                exchanges = self._bulk._iter_windowed_exchanges(
                    shuffle_id
                )
            legacy = mgr.conf.bulk_window_maps <= 0
            for plan, E, row in exchanges:
                me = list(plan.hosts).index(mgr.local_smid)
                emitted = delivered.pop(id(plan), None)
                if emitted is None:
                    blocks = list(iter_plan_blocks(plan, E, row))
                else:
                    blocks = list(
                        _iter_residual_blocks(plan, E, row, emitted)
                    )
                payload = sum(len(b) for _s, _m, _r, b in blocks)
                final = legacy or plan.final
                st.deliver(blocks, final, plan.hosts, me, payload)
                if final:
                    return
        except BaseException as e:
            st.fail(e)
        finally:
            self._bulk.round_block_sinks.pop(shuffle_id, None)


class WindowedShuffleReader:
    """Reactive reader over the windowed plane: same ``read()``
    contract as the pull :class:`~sparkrdma_tpu_torch.shuffle.reader
    .ShuffleReader` (deserialize → aggregate → sort), with block
    payloads arriving window-by-window.  Partition ownership follows
    the plan convention ``reduce_id % n_hosts == my index``; asking
    for a partition another host owns fails loudly."""

    def __init__(self, plane: WindowedReadPlane, handle,
                 start_partition: int, end_partition: int):
        from sparkrdma_tpu_torch.shuffle.reader import ReadMetrics

        self.plane = plane
        self.handle = handle
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.metrics = ReadMetrics()

    def _iter_block_bytes(self):
        try:
            yield from self._iter_block_bytes_inner()
        finally:
            # normal exhaustion, fetch failure AND abandoned iteration
            # all flush exactly once
            flush_read_metrics(
                self.plane.manager, self.handle.shuffle_id,
                self.metrics, self,
            )

    def _iter_block_bytes_inner(self):
        mgr = self.plane.manager
        st = self.plane._state(self.handle.shuffle_id)
        timeout_s = max(
            mgr.conf.partition_location_fetch_timeout_ms,
            mgr.conf.bulk_barrier_timeout_ms,
        ) / 1000.0
        idx = 0
        checked = False
        while True:
            t0 = time.monotonic()
            try:
                wins, done = st.wait_beyond(idx, timeout_s)
            except FetchFailedError:
                raise
            except BaseException as e:
                raise FetchFailedError(
                    mgr.local_smid.host, self.handle.shuffle_id, str(e)
                ) from e
            # blocked-on-window time is the plane's fetch-wait analog
            # (RdmaShuffleReaderStats' latency accounting)
            self.metrics.fetch_wait_ms += (
                time.monotonic() - t0
            ) * 1000
            if not checked:
                E = len(st.hosts)
                for rid in range(self.start_partition,
                                 self.end_partition):
                    if rid % E != st.me:
                        raise FetchFailedError(
                            mgr.local_smid.host, self.handle.shuffle_id,
                            f"partition {rid} belongs to host "
                            f"{rid % E} in the exchange plan, not this "
                            f"host ({st.me}) — windowed readers must "
                            f"follow reduce_id % n_hosts ownership",
                        )
                checked = True
            for blocks in wins:
                for s, _map_id, rid, data in blocks:
                    if not (
                        self.start_partition <= rid < self.end_partition
                    ):
                        continue
                    if s == st.me:
                        self.metrics.local_blocks += 1
                        self.metrics.local_bytes += len(data)
                    else:
                        self.metrics.remote_blocks += 1
                        self.metrics.remote_bytes += len(data)
                    yield data
            idx += len(wins)
            if done:
                return

    def read(self):
        """fetch (window-by-window) → deserialize → aggregate → sort.

        With ``decodeThreads`` > 0 the windowed plane reuses the
        manager's decode pool for its assembly-side deserialization:
        a landed window's blocks fan out to the workers while the task
        thread is still draining earlier windows (and while the pump's
        next collective runs), through the same decode-ahead stream
        the pull reader uses — serial fallback and output stay
        bit-exact."""
        from sparkrdma_tpu_torch.shuffle.decode import (
            iter_decoded_ahead,
            open_decode_stream,
        )
        from sparkrdma_tpu_torch.shuffle.manager import ColumnarAggregator
        from sparkrdma_tpu_torch.shuffle.reader import (
            postprocess_column_batches,
            postprocess_record_runs,
            postprocess_records,
        )

        mgr = self.plane.manager
        agg = self.handle.aggregator
        columnar = getattr(
            mgr.serializer, "supports_columns", False
        ) and (agg is None or isinstance(agg, ColumnarAggregator))
        stream = open_decode_stream(mgr, self.handle, columnar)

        def _decoded_runs():
            try:
                for t in iter_decoded_ahead(
                    stream, self._iter_block_bytes(),
                    mgr.conf.decode_ahead_bytes,
                ):
                    t0 = time.monotonic()
                    items, n = t.get()
                    self.metrics.decode_wait_ms += (
                        time.monotonic() - t0
                    ) * 1000
                    self.metrics.records_read += n
                    yield items
            finally:
                stream.close()

        if columnar:
            batches = []
            if stream is not None:
                for items in _decoded_runs():
                    batches.extend(items)
            else:
                deser = mgr.serializer.deserialize_columns
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

        if stream is not None:
            return postprocess_record_runs(
                _decoded_runs(), self.handle, presorted=True,
            )

        def _records():
            deser = mgr.serializer.deserialize
            for data in self._iter_block_bytes():
                t0 = time.monotonic()
                recs = list(deser(data))
                self.metrics.decode_wait_ms += (
                    time.monotonic() - t0
                ) * 1000
                self.metrics.records_read += len(recs)
                yield from recs

        return postprocess_records(_records(), self.handle)


class _StagedWindow:
    """One window's assembled exchange inputs: the plan, this host's
    index, the [E, E] lengths matrix, and the contiguous pooled source
    row — everything the collective stage needs, produced off the
    critical path by the pipelined assembler."""

    __slots__ = ("plan", "E", "me", "lengths", "row")

    def __init__(self, plan, E: int, me: int, lengths: np.ndarray,
                 row: np.ndarray):
        self.plan = plan
        self.E = E
        self.me = me
        self.lengths = lengths
        self.row = row


class _StagingTask:
    """Background plan-wait + assembly for one window (the pipelined
    loop's second buffer).  A daemon thread owns the blocking work;
    ``result()`` joins it, ``cancel()`` unblocks a plan wait in flight
    (the waiter's cancel poisons its event) so an abandoned pipeline
    never strands the assembler until the plan timeout."""

    def __init__(self, reader: "BulkExchangeReader", shuffle_id: int,
                 window: int, overlapped: bool):
        from sparkrdma_tpu_torch.utils.trace import get_tracer

        self._tracer = get_tracer()
        self._reader = reader
        self._shuffle_id = shuffle_id
        self._window = window
        self._overlapped = overlapped
        self._waiter = reader._fetch_plan_async(
            shuffle_id, window=window
        )
        self._done = threading.Event()
        self._out: dict = {}
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"window-stage-{shuffle_id}-{window}",
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            with self._tracer.span(
                "shuffle.windowed.plan_wait",
                shuffle=self._shuffle_id, window=self._window,
            ):
                plan = self._waiter.wait()
            self._out["staged"] = self._reader._assemble(
                self._shuffle_id, plan, window=self._window,
                overlapped=self._overlapped,
            )
        except BaseException as e:
            self._out["error"] = e
        finally:
            self._done.set()

    def result(self) -> _StagedWindow:
        # the plan wait bounds itself (partitionLocationFetchTimeout /
        # cancel); assembly is local work — no extra timer here
        self._done.wait()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["staged"]

    def cancel(self) -> None:
        self._waiter.cancel()


class BulkExchangeReader:
    """Runs steps 2-4 for one executor (one per participating host)."""

    def __init__(self, manager, exchange: Optional[TileExchange] = None,
                 group=None, session: Optional[BulkShuffleSession] = None):
        self.manager = manager
        self.session = session
        if session is not None:
            self.exchange = session.exchange
        elif exchange is not None:
            self.exchange = exchange
        else:
            # one executor per process: the initialised world (a world
            # of one without one) on the manager's device
            self.exchange = TileExchange(
                group if group is not None
                else world_group(manager.device),
                tile_bytes=manager.conf.exchange_tile_bytes,
                max_rounds_in_flight=(
                    manager.conf.exchange_max_rounds_in_flight
                ),
            )
        # (window, monotonic completion time, payload bytes) per
        # completed window exchange — lets tests/metrics observe bytes
        # landing while straggler maps are still writing
        self.window_events: List[tuple] = []
        # shuffle_id -> round sink installed by the windowed pump: the
        # device exchange's per-round landings deliver through it
        # (multiple concurrent shuffles share this reader, hence a
        # dict, not a slot)
        self.round_block_sinks: dict = {}

    # -- step 2: the plan barrier -------------------------------------------
    def _fetch_plan_async(self, shuffle_id: int, window: int = -1):
        """Issue the plan RPC WITHOUT blocking and return a one-shot
        waiter object.  The windowed loops use this to overlap the
        NEXT window's plan barrier (driver-side wait for its maps to
        publish) with the CURRENT window's collective — the
        maxBytesInFlight spirit applied to plans
        (RdmaShuffleFetcherIterator.scala:241-251)."""
        mgr = self.manager
        # the driver pins the plan's host set at the first plan: ask
        # only once it knows every row of this exchange
        rows = (self.session.n_hosts if self.session is not None
                else self.exchange.n_devices)
        try:
            mgr.await_peers(rows, mgr.conf.bulk_barrier_timeout_ms / 1000.0)
        except TimeoutError as e:
            raise MetadataFetchFailedError(
                mgr.local_smid.host, shuffle_id, str(e)) from e
        event = threading.Event()
        box = {}

        def on_plan(plan):
            box["plan"] = plan
            event.set()

        def on_failed(reason):
            box["error"] = reason
            event.set()

        cb_id = mgr.register_plan_callback(on_plan, on_failed)
        try:
            # _send_driver_msg re-resolves once if the cached driver
            # channel was evicted from the bounded cache between
            # lookup and post
            mgr._send_driver_msg(
                FetchExchangePlanMsg(
                    mgr.local_smid, shuffle_id, cb_id, window=window
                ),
                on_failure=lambda e: (
                    box.setdefault("error", str(e)), event.set()
                ),
            )
        except BaseException:
            mgr.unregister_plan_callback(cb_id)
            raise

        class _PlanWaiter:
            def wait(self):
                timeout = (
                    mgr.conf.partition_location_fetch_timeout_ms / 1000.0
                )
                try:
                    if not event.wait(timeout):
                        raise MetadataFetchFailedError(
                            mgr.local_smid.host, shuffle_id,
                            f"no exchange plan within {timeout:.0f}s",
                        )
                finally:
                    mgr.unregister_plan_callback(cb_id)
                if "error" in box:
                    raise MetadataFetchFailedError(
                        mgr.local_smid.host, shuffle_id, str(box["error"])
                    )
                return box["plan"]

            def cancel(self):
                # also unblocks a wait() in flight on another thread
                # (the pipelined assembler): a cancelled waiter must
                # fail NOW, not ride out the full plan timeout
                box.setdefault("error", "plan waiter cancelled")
                event.set()
                mgr.unregister_plan_callback(cb_id)

        return _PlanWaiter()

    def _fetch_plan(self, shuffle_id: int, window: int = -1):
        from sparkrdma_tpu_torch.utils.trace import get_tracer

        with get_tracer().span(
            "shuffle.windowed.plan_wait", shuffle=shuffle_id,
            window=window,
        ):
            return self._fetch_plan_async(shuffle_id, window).wait()

    def _run_exchange(self, shuffle_id: int, me: int, row,
                      lengths, window: int = -1, on_round=None):
        """One collective over this host's contiguous source ``row``
        (laid out per ``lengths[me]``, or a :class:`PaddedSourceRow`
        in the device framing when the device plane staged it)."""
        if self.session is not None:
            # key the in-process barrier by (shuffle, window) so
            # concurrent shuffles through one shared session never
            # cross-contribute rows
            return self.session.run(
                me, row, lengths,
                round_key=(shuffle_id, window), on_round=on_round,
            )
        ex = self.exchange
        if not ex.is_colocated and ex.rank != me:
            # a rank-local exchange ships only THIS rank's source row: a
            # group whose rank order disagrees with the canonical host
            # order would silently exchange zeros
            raise MetadataFetchFailedError(
                self.manager.local_smid.host, shuffle_id,
                f"exchange row {me} (this host's canonical row) is not "
                f"this process's group rank {ex.rank} — order the ranks "
                f"like the plan's host order",
            )
        if isinstance(row, PaddedSourceRow):
            return self.exchange.exchange_padded(
                lengths, {me: row}, local_sources=frozenset({me}),
                out_alloc=self._alloc_row, on_round=on_round,
                window_rounds=(
                    self.manager.conf.device_exchange_window_rounds
                ),
            )
        return self.exchange.exchange_into(
            lengths, {me: row}, local_sources=frozenset({me}),
            out_alloc=self._alloc_row,
        )

    # -- steps 3-4: exchange + consume --------------------------------------
    def _exchange_all(self, shuffle_id: int):
        """Run the shuffle's exchange(s) eagerly and return a list of
        (plan, E, row) — ONE entry for the legacy full barrier, one
        per window when ``bulkWindowMaps`` > 0 (each window's exchange
        runs as soon as its plan lands, overlapping straggler maps)."""
        if self.manager.conf.bulk_window_maps <= 0:
            return [self._exchange_rows(shuffle_id, window=-1)]
        out = []
        for plan, E, row in self._iter_windowed_exchanges(shuffle_id):
            out.append((plan, E, row))
        return out

    def _iter_windowed_exchanges(self, shuffle_id: int):
        """Run each plan window's exchange in order.  With
        ``bulkPipelineWindows`` (the default) the NEXT window's plan
        fetch AND stream assembly both overlap the current collective
        (double-buffered: window N+1 assembles into a second pooled
        row while window N's bytes ride the mesh); disabling the knob
        keeps only the plan-fetch overlap — output is bit-identical
        either way."""
        mgr = getattr(self, "manager", None)
        if mgr is not None and mgr.conf.bulk_pipeline_windows:
            yield from self._iter_windowed_pipelined(shuffle_id)
        else:
            yield from self._iter_windowed_serial(shuffle_id)

    def _iter_windowed_serial(self, shuffle_id: int):
        """The non-pipelined window loop: only the next window's plan
        FETCH overlaps the current collective (the plan barrier
        includes waiting for that window's maps to publish —
        serializing it behind the exchange doubled the per-window
        latency at fine window settings); assembly stays on the
        critical path.

        The whole loop — INCLUDING the yields — runs under one
        try/finally: when the consumer abandons the generator
        mid-iteration (GeneratorExit), or any step raises, the
        prefetched next-window waiter is cancelled instead of leaking
        its registered plan callback on the manager."""
        from sparkrdma_tpu_torch.utils.trace import get_tracer

        w = 0
        waiter = self._fetch_plan_async(shuffle_id, window=0)
        nxt = None
        try:
            while True:
                with get_tracer().span(
                    "shuffle.windowed.plan_wait", shuffle=shuffle_id,
                    window=w,
                ):
                    plan = waiter.wait()
                waiter = None
                if not plan.final:
                    nxt = self._fetch_plan_async(
                        shuffle_id, window=w + 1
                    )
                result = self._exchange_rows(
                    shuffle_id, window=w, plan=plan
                )
                waiter, nxt = nxt, None
                yield result
                if plan.final:
                    return
                w += 1
        finally:
            cancelled = 0
            for pending in (waiter, nxt):
                if pending is not None:
                    pending.cancel()
                    cancelled += 1
            if cancelled:
                counter(
                    "shuffle_plan_waiters_cancelled_total"
                ).inc(cancelled)

    def _iter_windowed_pipelined(self, shuffle_id: int):
        """The double-buffered window loop: while window N's collective
        runs, window N+1's plan barrier AND stream assembly proceed on
        a background stage into a second pooled source row — the
        maxBytesInFlight overlap applied to the whole host-side data
        path, not just the plan RPC.

        Abort/poison semantics are preserved: a poisoned session fails
        the in-flight exchange immediately (session.run re-checks
        under its condition), the error unwinds this generator, and
        the finally cancels the being-assembled window's stage — its
        plan waiter is unblocked by cancel(), so the assembler thread
        exits promptly instead of riding out the plan timeout."""
        w = 0
        prep = _StagingTask(self, shuffle_id, 0, overlapped=False)
        nxt = None
        try:
            while True:
                staged = prep.result()
                prep = None
                if not staged.plan.final:
                    # window w+1 stages (plan barrier + assembly into
                    # the second buffer) while window w exchanges
                    nxt = _StagingTask(
                        self, shuffle_id, w + 1, overlapped=True
                    )
                    counter("exchange_windows_pipelined_total").inc()
                result = self._exchange_staged(
                    shuffle_id, staged, window=w
                )
                prep, nxt = nxt, None
                yield result
                if staged.plan.final:
                    return
                w += 1
        finally:
            cancelled = 0
            for pending in (prep, nxt):
                if pending is not None:
                    pending.cancel()
                    cancelled += 1
            if cancelled:
                counter(
                    "shuffle_plan_waiters_cancelled_total"
                ).inc(cancelled)

    def _exchange_rows(self, shuffle_id: int, window: int = -1,
                       plan=None):
        """Plan barrier + stream assembly + ONE collective exchange;
        all EAGER (a lazily-deferred exchange would leave every other
        participant blocked in the collective).  Returns (plan, E,
        row) where row[s] is the received stream from source s (a
        zero-copy view of this host's destination row)."""
        if plan is None:
            plan = self._fetch_plan(shuffle_id, window=window)
        staged = self._assemble(shuffle_id, plan, window=window)
        return self._exchange_staged(shuffle_id, staged, window=window)

    def _alloc_row(self, nbytes: int) -> np.ndarray:
        """One contiguous source row (:func:`source_row_alloc`): the
        buffer recycles once the last view of it dies, which is what
        makes the double-buffered windows a TWO-buffer steady state
        instead of an allocation per window."""
        return source_row_alloc(self.manager)(nbytes)

    def _assemble(self, shuffle_id: int, plan, window: int = -1,
                  overlapped: bool = False) -> "_StagedWindow":
        """Stage this host's source row for one exchange: map-output
        blocks are gathered ONCE into a single preallocated uint8 row
        laid out per the plan's lengths (map_id asc, reduce_id asc,
        empties skipped — the exact order the driver's plan assumed).
        No per-destination ``bytes`` join, no per-block
        materialization: block views copy straight into their final
        offset.  A host that ran no map tasks still participates (the
        collective needs every member) with an all-empty row.  A
        windowed plan names exactly which of my maps belong to THIS
        window (the driver assigns maps to windows as fills land)."""
        from sparkrdma_tpu_torch.utils.trace import get_tracer

        mgr = self.manager
        hosts = list(plan.hosts)
        E = len(hosts)
        try:
            me = hosts.index(mgr.local_smid)
        except ValueError:
            raise MetadataFetchFailedError(
                mgr.local_smid.host, shuffle_id,
                "this host is not in the exchange plan "
                "(did it hello the driver?)",
            )
        # [E, E] plan metadata, not payload
        lengths = np.asarray(plan.lengths, np.int64).reshape(E, E)  # noqa: PY13
        if window >= 0:
            my_maps = sorted(plan.my_maps)
        else:
            my_maps = mgr.resolver.map_ids(shuffle_id)
        offs = row_offsets(lengths[me])
        total = int(offs[-1])
        # device plane: stage straight into the PADDED framing the
        # collective consumes (stream d at [d*C, d*C+len]) — assembly
        # is the ONLY host pass over the payload; the exchange then
        # does one copy per source row to the device and never builds
        # the per-round [E, E, tile] staging matrices.  Only when the
        # exchange holds every source in this process (co-located, or
        # a world of one): across processes the padded row layout
        # would need cross-process agreement the host-staged path
        # already gives.
        dev_cols = 0
        ex = self.exchange
        if mgr.conf.device_exchange_enabled and (
                ex.is_colocated or ex.n_devices == 1):
            xplan = ex.plan(lengths)
            if xplan.rounds:
                dev_cols = xplan.total_cols
        if dev_cols:
            row = self._alloc_row(E * dev_cols)
            starts = [d * dev_cols for d in range(E)]
            limits = [
                d * dev_cols + int(lengths[me, d]) for d in range(E)
            ]
        else:
            row = self._alloc_row(total)
            starts = [int(offs[d]) for d in range(E)]
            limits = [int(offs[d + 1]) for d in range(E)]
        cursors = list(starts)
        t0 = time.monotonic()
        with get_tracer().span(
            "shuffle.windowed.stream_build", shuffle=shuffle_id,
            window=window, maps=len(my_maps),
        ):
            if my_maps and total:
                from sparkrdma_tpu_torch.memory.staging import (
                    native_gather_blocks,
                )

                num_parts = mgr.resolver.num_partitions(shuffle_id)
                # one batched backing-store read per map output (every
                # partition ships somewhere, so fetch each segment
                # ONCE instead of a device round-trip per block), then
                # gather every block view to its destination offset in
                # ONE native memcpy batch (slice assignment dispatches
                # ~1 us of numpy machinery per block; `keep` pins the
                # views until the copies land)
                addrs: list = []
                lens_l: list = []
                offs_l: list = []
                keep: list = []
                for map_id in my_maps:
                    blocks = mgr.resolver.get_local_blocks(
                        shuffle_id, map_id, range(num_parts)
                    )
                    for d in range(E):
                        cur = cursors[d]
                        for r in range(d, num_parts, E):
                            blk = blocks[r]
                            n = len(blk)
                            if not n:
                                continue
                            if isinstance(blk, np.ndarray) \
                                    and blk.dtype == np.uint8:
                                src = blk
                            else:
                                try:
                                    src = np.frombuffer(blk, np.uint8)
                                except (TypeError, ValueError):
                                    # exotic block store: materialize
                                    # once and COUNT it — the zero-copy
                                    # smoke test pins this at zero
                                    counter(
                                        "exchange_assembly_"
                                        "materialized_blocks_total"
                                    ).inc()
                                    src = np.frombuffer(
                                        bytes(blk), np.uint8
                                    )
                            end = cur + n
                            if end > limits[d]:
                                raise MetadataFetchFailedError(
                                    mgr.local_smid.host, shuffle_id,
                                    f"local stream to dst {d} "
                                    f"overflows its planned "
                                    f"{int(lengths[me, d])}B",
                                )
                            addrs.append(src.ctypes.data)
                            lens_l.append(n)
                            offs_l.append(cur)
                            keep.append(src)
                            cur = end
                        cursors[d] = cur
                if not native_gather_blocks(row, addrs, lens_l, offs_l):
                    for src, cur, n in zip(keep, offs_l, lens_l):
                        row[cur:cur + n] = src
                del keep
        for d in range(E):
            got = cursors[d] - starts[d]
            if got != int(lengths[me, d]):
                raise MetadataFetchFailedError(
                    mgr.local_smid.host, shuffle_id,
                    f"local stream to dst {d} is {got}B, plan says "
                    f"{int(lengths[me, d])}B",
                )
        if dev_cols:
            # pooled rows recycle: the pad spans must ship
            # deterministic zeros, never a previous window's bytes
            for d in range(E):
                row[limits[d] : (d + 1) * dev_cols] = 0
            row = PaddedSourceRow(row, dev_cols)
        # microseconds: whole-ms granularity truncated fast windows to
        # zero and zeroed the overlap ratio on fine window settings
        us = int((time.monotonic() - t0) * 1e6)
        counter("exchange_assembly_us_total").inc(us)
        counter("exchange_assembly_bytes_total").inc(total)
        if overlapped:
            # staged while another window's collective was in flight:
            # this host-side work left the critical path entirely
            counter("exchange_assembly_overlapped_us_total").inc(us)
        return _StagedWindow(plan, E, me, lengths, row)

    def _exchange_staged(self, shuffle_id: int,
                         staged: "_StagedWindow", window: int = -1):
        """Run the one collective for an assembled window; returns
        (plan, E, row) with row = this host's destination-row view."""
        from sparkrdma_tpu_torch.utils.trace import get_tracer

        lengths = staged.lengths
        sink = self.round_block_sinks.get(shuffle_id)
        on_round = None
        if sink is not None and isinstance(staged.row, PaddedSourceRow):
            on_round = _make_round_emitter(
                staged.plan, staged.E, staged.me, lengths, sink
            )
        with get_tracer().span(
            "shuffle.bulk.exchange", shuffle=shuffle_id,
            hosts=staged.E, window=window,
            payload_bytes=int(lengths.sum()),
        ):
            result = self._run_exchange(
                shuffle_id, staged.me, staged.row, lengths,
                window=window, on_round=on_round,
            )
        self.window_events.append(
            (window, time.monotonic(), int(lengths.sum()))
        )
        return staged.plan, staged.E, result[staged.me]

    def read(self, shuffle_id: int) -> Iterator:
        """Blocking bulk read of this host's partitions (the
        exchange(s) run eagerly in this call; the returned iterator
        only deserializes).  Yields records."""
        exchanged = self._exchange_all(shuffle_id)
        deser = self.manager.serializer.deserialize

        def _records():
            for plan, E, row in exchanged:
                for _s, _m, _r, block in iter_plan_blocks(plan, E, row):
                    yield from deser(block)

        return _records()

    def read_partitioned(self, shuffle_id: int) -> dict:
        """Like :meth:`read` but returns ``{reduce_id: [records]}`` for
        every partition this host owns — the shape the job layer's
        per-partition reduce tasks want."""
        deser = self.manager.serializer.deserialize
        out: dict = {}
        for reduce_id, block in self.read_partitioned_blocks(shuffle_id):
            out.setdefault(reduce_id, []).extend(deser(block))
        return out

    def read_partitioned_blocks(self, shuffle_id: int):
        """Lowest-level consumption: yields (reduce_id, raw block
        bytes) pairs after the exchange — lets columnar consumers feed
        blocks straight to ``deserialize_columns`` (the vectorized
        path) instead of per-record tuples.  The exchange(s) run
        eagerly before the first yield."""
        exchanged = self._exchange_all(shuffle_id)

        def _blocks():
            for plan, E, row in exchanged:
                for _s, _m, reduce_id, block in iter_plan_blocks(
                    plan, E, row
                ):
                    yield reduce_id, block

        return _blocks()
