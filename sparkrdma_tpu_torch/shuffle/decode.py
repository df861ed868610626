"""Reduce-side decode-ahead pipeline: parallel deserialize/decompress
overlapped with fetch.

The striped transport makes blocks *land* fast; everything after landing
(deserialize, ``CompressedSerializer`` inflate, per-block sort) ran
serially on the reduce-task thread — the "CPU copy/decode dominates
once the wire is fast" effect RDMAbox (arXiv:2104.12197) and the DMA
Streaming Framework (arXiv:2603.10030) report for post-transport data
paths.  This module adds the consume-side pipeline:

- :class:`DecodePool` — one bounded pool per manager (the
  ``_ServePool`` shape from transport/node.py): ``decodeThreads``
  workers pinned via ``dispatcherCpuList`` drain a FIFO of decode
  tasks under a ``decodeAheadBytes`` byte-credit budget.  A task's
  cost is its encoded size; credits are held until the task thread
  CONSUMES the result, so the budget bounds decoded-ahead memory, not
  just concurrent decodes.  A block larger than the whole budget
  clamps to it and decodes alone rather than deadlocking.
- :class:`DecodeStream` — one per reader: readers submit raw block
  payloads from the transport's ``on_success`` callbacks (decode
  starts AS BLOCKS LAND, while the task thread is still blocked on
  earlier results) and consume :class:`DecodeTicket` results in their
  own order.  Large blocks split at the serializer's frame boundaries
  (``frame_spans``) so one block fans out across workers.
- Deadlock freedom WITHOUT admission ordering: a consumer that reaches
  a ticket whose decode has not started yet STEALS it and decodes
  inline on the task thread (bit-exact same result, no credits
  needed).  The consumer therefore only ever blocks on a decode that
  is actively running; workers blocked on credits always drain once
  the consumer consumes or closes.  ``close()`` poisons the stream
  idempotently: queued tickets cancel, finished-but-unconsumed tickets
  release their credits, in-flight decodes release on completion — a
  mid-decode ``FetchFailedError`` never strands a worker.

Serial fallback: ``decodeThreads=0`` (the default on single-core
hosts, the ``bulkPipelineWindows`` convention) keeps the legacy
task-thread decode; its output is bit-exact with the pipelined path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.qos import CreditLedger
from sparkrdma_tpu_torch.utils.dbglock import dbg_condition
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.serde import as_view
from sparkrdma_tpu_torch.utils.statemachine import StateMachine

# blocks at or above this size are considered for frame-boundary
# splitting across workers; span groups aim for at least _SPLIT_CHUNK
# bytes each so tiny frames don't drown the pool in task overhead
_SPLIT_MIN_BYTES = 1 << 20
_SPLIT_CHUNK_BYTES = 256 << 10

# ticket states (guarded by the pool's condition)
_QUEUED, _DECODING, _STOLEN, _DONE, _CANCELLED = (
    "queued", "decoding", "stolen", "done", "cancelled")


class DecodeTicket(StateMachine):
    """One submitted block (or block fragment) flowing through the
    pool.  ``len(ticket)`` is the encoded payload size, so reader
    byte accounting works on tickets and raw payloads alike."""

    __slots__ = (
        "_pool", "_stream", "_fn", "_data", "cost", "nbytes",
        "_state", "_held", "_event", "_result", "_error", "_abandoned",
        "_tkt",
    )

    MACHINE = "decode.ticket"
    STATES = (_QUEUED, _DECODING, _STOLEN, _DONE, _CANCELLED)
    INITIAL = _QUEUED
    TERMINAL = (_DONE, _CANCELLED)
    TRANSITIONS = {
        "queued": ("decoding", "stolen", "cancelled"),
        "decoding": ("done",),   # worker finishes (even on decode error)
        "stolen": ("done",),     # consumer's inline decode finishes
    }

    def __init__(self, pool: "DecodePool", stream: "DecodeStream",
                 fn: Callable, data, cost: int):
        self._pool = pool
        self._stream = stream
        self._fn = fn
        self._data = data
        self.cost = cost
        self.nbytes = cost
        self._state = _QUEUED  # state: decode.ticket guarded-by: DecodePool._cv
        self._held = 0
        self._tkt = NOOP_TICKET  # this ticket's held-credit reservation
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._abandoned = False

    def __len__(self) -> int:
        return self.nbytes

    def get(self):
        """Block until decoded; returns the decode_fn result, re-raises
        its error.  A ticket whose decode has not been admitted yet is
        decoded INLINE here (the steal that makes the credit budget
        deadlock-free); a ticket already decoded when the consumer
        arrives is a decode-ahead hit."""
        pool = self._pool
        with pool._cv:
            if self._state == _QUEUED:
                self._transition(_STOLEN, frm=_QUEUED)
                pool._cv.notify_all()  # unblock a worker credit-waiting on it
                steal = True
            else:
                steal = False
        if steal:
            pool._m_steals.inc()
            if RECORDER.enabled:
                fr_event("decode", "ticket_steal", bytes=self.nbytes)
            self._run_inline()
        elif self._event.is_set():
            pool._m_ahead_hits.inc()
        self._event.wait()
        with pool._cv:
            self._settle_locked()
        self._fn = self._data = None
        if self._error is not None:
            raise self._error
        result, self._result = self._result, None
        return result

    def _run_inline(self) -> None:
        t0 = time.monotonic()
        try:
            self._result = self._fn(self._data)
        except BaseException as e:
            self._error = e
        self._pool._observe(self.nbytes, time.monotonic() - t0)
        with self._pool._cv:
            self._transition(_DONE, frm=_STOLEN)
        self._event.set()

    def discard(self) -> None:
        """Drop a ticket nobody will consume (a sibling fragment of a
        split block already failed): queued work cancels WITHOUT being
        decoded, finished work releases its credits, in-flight decodes
        release on completion — never burns task-thread CPU the way a
        steal-decode would."""
        pool = self._pool
        with pool._cv:
            if self._state == _QUEUED:
                self._transition(_CANCELLED, frm=_QUEUED)
                self._error = RuntimeError("decode ticket discarded")
                self._settle_locked()
                self._event.set()
            elif self._state in (_DONE, _CANCELLED):
                self._settle_locked()
            else:  # decoding right now: the worker settles it
                self._abandoned = True

    def _settle_locked(self) -> None:
        """Release held credits and drop the stream's reference —
        idempotent, caller holds the pool condition."""
        if self._held:
            self._pool._ledger.put(self._stream._tenant, self._held)
            self._held = 0
            tkt, self._tkt = self._tkt, NOOP_TICKET
            tkt.release()  # releases: decode.credit_bytes  # one-shot
            self._pool._cv.notify_all()
        self._stream._tickets.discard(self)


class _CompositeTicket:
    """A block split at frame boundaries: sub-tickets decode in
    parallel, ``get`` reassembles their results in frame order so
    per-block framing is preserved exactly — by concatenation, or by
    the stream's ``combine_fn`` when fragment results need a real
    merge (the per-fragment sort of a block holding SEVERAL sorted
    runs, e.g. concatenated spill chunks: fragment-wise stable sorts
    concatenate to a non-sorted sequence, but stable-merged in
    fragment order they equal the stable sort of the whole block)."""

    __slots__ = ("_parts", "nbytes", "_combine")

    def __init__(self, parts: List[DecodeTicket], nbytes: int,
                 combine_fn=None):
        self._parts = parts
        self.nbytes = nbytes
        self._combine = combine_fn

    def __len__(self) -> int:
        return self.nbytes

    def get(self):
        results: list = []
        err: Optional[BaseException] = None
        for part in self._parts:
            if err is not None:
                # a sibling already failed: discard instead of get() —
                # undecoded fragments cancel rather than steal-decode
                part.discard()
                continue
            try:
                results.append(part.get())
            except BaseException as e:
                err = e
        if err is not None:
            raise err
        if self._combine is not None:
            return self._combine(results)
        items: list = []
        records = 0
        for got, n in results:
            items.extend(got)
            records += n
        return items, records


class DecodeStream(StateMachine):
    """Per-reader handle onto the shared pool.  ``decode_fn(data)``
    must return ``(items, record_count)`` for one self-contained
    payload; ``split_fn(data)`` (optional — the serializer's
    ``frame_spans``) yields the frame boundaries used to fan one large
    block out across workers."""

    MACHINE = "decode.stream"
    STATES = ("open", "closed")
    INITIAL = "open"
    TERMINAL = ("closed",)
    TRANSITIONS = {"open": ("closed",)}

    def __init__(self, pool: "DecodePool", decode_fn: Callable,
                 split_fn: Optional[Callable] = None,
                 combine_fn: Optional[Callable] = None,
                 tenant=None):
        self._pool = pool
        self._decode_fn = decode_fn
        self._split_fn = split_fn
        self._combine_fn = combine_fn
        # qos/: the reader's tenant — credit admission runs through
        # the pool's weighted ledger under it (None = plain credits)
        self._tenant = tenant
        self._tickets: set = set()  # guarded-by: (pool) _cv
        self._state = "open"  # state: decode.stream guarded-by: DecodePool._cv

    def submit(self, data, cost: Optional[int] = None) -> DecodeTicket:
        """Enqueue one payload for decode; never blocks (transport
        completion callbacks post here)."""
        n = len(data) if cost is None else cost
        t = DecodeTicket(self._pool, self, self._decode_fn, data, n)
        pool = self._pool
        with pool._cv:
            if self._state == "closed" or pool._stopped:
                t._transition(_CANCELLED, frm=_QUEUED)
                t._error = RuntimeError("decode stream closed")
                t._event.set()
                return t
            self._tickets.add(t)
            pool._m_depth.inc()
            pool._queue.put(t)
        return t

    def submit_block(self, data):
        """Submit one block, splitting at the serializer's frame
        boundaries when it is large enough to be worth fanning out."""
        n = len(data)
        if (self._split_fn is None or n < _SPLIT_MIN_BYTES
                or self._pool.workers <= 1):
            return self.submit(data, n)
        try:
            spans = self._split_fn(data)
        except Exception:
            # undecodable framing surfaces through the normal decode
            # path (one ticket) so the error reaches the consumer
            return self.submit(data, n)
        groups = _group_spans(spans, _SPLIT_CHUNK_BYTES)
        if len(groups) <= 1:
            return self.submit(data, n)
        view = as_view(data)
        counter("shuffle_decode_block_splits_total").inc()
        parts = [
            self.submit(view[a:b], b - a) for a, b in groups
        ]
        return _CompositeTicket(parts, n, self._combine_fn)

    def close(self) -> None:
        """Poison the stream: queued decodes cancel, finished ones
        release their credits, in-flight ones release on completion.
        Idempotent; safe from any thread (the reader's cleanup path
        calls it on success, fetch failure AND abandoned iteration)."""
        pool = self._pool
        with pool._cv:
            if self._state == "closed":
                return
            self._transition("closed", frm="open")
            for t in list(self._tickets):
                if t._state == _QUEUED:
                    t._transition(_CANCELLED, frm=_QUEUED)
                    t._error = RuntimeError("decode stream closed")
                    t._event.set()
                t._settle_locked()
            self._tickets.clear()
            pool._cv.notify_all()


class DecodePool:
    """Bounded decode pool shared by every reader of one manager (the
    ``_ServePool`` shape): fixed workers, FIFO task queue, byte-credit
    admission."""

    def __init__(self, name: str, workers: int, credit_bytes: int,
                 init_fn=None, qos=None):
        self.workers = max(1, int(workers))
        self._budget = max(int(credit_bytes), 1)
        # credit policy core (qos/): weighted max-min per-tenant when
        # a registry is attached, a plain budget counter otherwise —
        # all access under _cv
        # resource: decode.credit_bytes (held decode-ahead credits)
        self._ledger = CreditLedger("decode", self._budget, qos=qos)
        # tenants currently credit-waiting (name → (tenant, waiters)):
        # the ledger's reclaim-on-demand needs to see deprived waiters
        self._waiting: Dict[str, tuple] = {}  # guarded-by: _cv
        self._cv = dbg_condition("decode.credits", 51)
        self._queue: "queue.Queue" = queue.Queue()
        self._stopped = False  # guarded-by: _cv
        self._m_depth = gauge("shuffle_decode_queue_depth")
        self._m_tasks = counter("shuffle_decode_tasks_total")
        self._m_us = counter("shuffle_decode_us_total")
        self._m_bytes = counter("shuffle_decode_bytes_total")
        self._m_credit_waits = counter("shuffle_decode_credit_waits_total")
        self._m_ahead_hits = counter("shuffle_decode_ahead_hits_total")
        self._m_steals = counter("shuffle_decode_steals_total")
        self._threads = [
            threading.Thread(
                target=self._run, daemon=True,
                name=f"decode-{name}-{i}", args=(init_fn,),
            )
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    @property
    def _credits(self) -> int:
        """Free credit bytes (the pre-ledger attribute, kept for tests
        and debugging; the condition's lock is reentrant)."""
        with self._cv:
            return self._ledger.free

    def stream(self, decode_fn: Callable,
               split_fn: Optional[Callable] = None,
               combine_fn: Optional[Callable] = None,
               tenant=None) -> DecodeStream:
        return DecodeStream(self, decode_fn, split_fn, combine_fn,
                            tenant=tenant)

    def _waiting_view(self) -> Dict:
        """name → Tenant of currently credit-waiting tenants (cv
        held) — the ledger's deprived-waiter input."""
        w = self._waiting  # noqa: CK03 - caller holds _cv
        return {k: t for k, (t, _n) in w.items()}

    def _waiting_add(self, tenant) -> None:
        t, n = self._waiting.get(tenant.name, (tenant, 0))  # noqa: CK03 - held
        self._waiting[tenant.name] = (t, n + 1)  # noqa: CK03 - held

    def _waiting_remove(self, tenant) -> None:
        t, n = self._waiting.get(tenant.name, (tenant, 1))  # noqa: CK03 - held
        if n <= 1:
            self._waiting.pop(tenant.name, None)  # noqa: CK03 - caller holds _cv
        else:
            self._waiting[tenant.name] = (t, n - 1)  # noqa: CK03 - caller holds _cv

    def _observe(self, nbytes: int, seconds: float) -> None:
        self._m_tasks.inc()
        self._m_bytes.inc(nbytes)
        self._m_us.inc(int(seconds * 1e6))

    def _run(self, init_fn) -> None:
        if init_fn is not None:
            init_fn()
        while True:
            item = self._queue.get()
            if item is None:
                return
            with self._cv:
                self._m_depth.dec()
                if item._state != _QUEUED:
                    continue  # stolen by the consumer, or cancelled
                cost = min(item.cost, self._budget)
                tenant = item._stream._tenant
                waited = False
                while (not self._ledger.can_take(
                            tenant, cost, self._waiting_view())
                       and not self._stopped
                       and item._state == _QUEUED
                       and item._stream._state == "open"):
                    if not waited:
                        waited = True
                        self._m_credit_waits.inc()
                        if RECORDER.enabled:
                            fr_event(
                                "decode", "credit_wait", bytes=cost,
                            )
                        if tenant is not None:
                            self._waiting_add(tenant)
                    self._cv.wait(timeout=0.5)
                if waited and tenant is not None:
                    self._waiting_remove(tenant)
                if item._state != _QUEUED:
                    continue  # stolen mid-wait: the consumer owns it now
                if self._stopped or item._stream._state == "closed":
                    item._transition(_CANCELLED, frm=_QUEUED)
                    item._error = RuntimeError("decode stream closed")
                    item._settle_locked()
                    item._event.set()
                    continue
                self._ledger.take(tenant, cost)
                item._held = cost
                # held until the consumer settles the ticket (get /
                # discard / stream close / worker completion-after-
                # abandon all funnel through _settle_locked)
                # owns: decode.credit_bytes -> _settle_locked
                item._tkt = ledger_acquire(
                    "decode.credit_bytes", cost
                )  # acquires: decode.credit_bytes
                item._transition(_DECODING, frm=_QUEUED)
            t0 = time.monotonic()
            try:
                if FAULTS.enabled:
                    # models a poisoned payload: surfaces through the
                    # ticket's error slot like any decode_fn raise
                    FAULTS.check("decode")
                item._result = item._fn(item._data)
            except BaseException as e:
                item._error = e
            dt = time.monotonic() - t0
            self._observe(item.nbytes, dt)
            if RECORDER.enabled:
                fr_event(
                    "decode", "decode_done",
                    bytes=item.nbytes, us=int(dt * 1e6),
                    err=1 if item._error is not None else 0,
                )
            with self._cv:
                item._transition(_DONE, frm=_DECODING)
                if item._stream._state == "closed" or item._abandoned:
                    # consumer is gone: nobody will get() — release now
                    item._settle_locked()
            item._event.set()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        # cancel abandoned queued tickets and keep the depth gauge
        # honest, then send one sentinel per worker
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            with self._cv:
                self._m_depth.dec()
                if item._state == _QUEUED:
                    item._transition(_CANCELLED, frm=_QUEUED)
                    item._error = RuntimeError("decode pool stopped")
                    item._settle_locked()
                    item._event.set()
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=2.0)


def _group_spans(spans: List[Tuple[int, int]],
                 min_bytes: int) -> List[Tuple[int, int]]:
    """Coalesce adjacent frame spans into contiguous groups of at least
    ``min_bytes`` (the framing is concatenation-safe, so any contiguous
    group decodes independently)."""
    groups: List[Tuple[int, int]] = []
    start = None
    end = 0
    for a, b in spans:
        if start is None:
            start, end = a, b
        else:
            end = b
        if end - start >= min_bytes:
            groups.append((start, end))
            start = None
    if start is not None:
        groups.append((start, end))
    return groups


def open_decode_stream(manager, handle, columnar: bool):
    """Build a reader's decode stream from the manager's pool — or
    ``None`` when ``decodeThreads=0`` (the serial fallback).  The
    decode_fn bakes in the reader's record plane AND the per-block
    transform that parallelizes the read-side sort/combine:

    - tuple plane, ``key_ordering`` with no aggregator: each block's
      records sort once inside the worker (the per-block sorted runs
      the streaming k-way merge consumes),
    - columnar plane, same shape: unsorted batches stable-sort per
      block in the worker (map-side-sorted batches pass through),
    - columnar reducing aggregator: each batch pre-combines in the
      worker (``combine_columns`` is what postprocess would run per
      block anyway — same association, bit-exact result, now parallel).

    Returns ``(items, record_count)`` per payload with record_count
    taken BEFORE any combining, so ``records_read`` matches the serial
    path exactly.
    """
    pool = manager.get_decode_pool()
    if pool is None:
        return None
    tenant = manager.qos_tenant_for(handle)
    serializer = manager.serializer
    agg = handle.aggregator
    split_fn = getattr(serializer, "frame_spans", None)
    if columnar:
        deser = serializer.deserialize_columns
        kind = getattr(agg, "kind", None)
        presort = handle.key_ordering and agg is None
        if kind is not None and kind != "group":
            from sparkrdma_tpu_torch.utils.columns import combine_columns

            def decode_fn(data, _d=deser, _k=kind):
                batches = list(_d(data))
                n = sum(len(b) for b in batches)
                return [combine_columns(b, _k) for b in batches], n
        elif presort:
            from sparkrdma_tpu_torch.utils.columns import sort_batch

            def decode_fn(data, _d=deser):
                batches = list(_d(data))
                n = sum(len(b) for b in batches)
                return [
                    b if b.key_sorted else sort_batch(b) for b in batches
                ], n
        else:
            def decode_fn(data, _d=deser):
                batches = list(_d(data))
                return batches, sum(len(b) for b in batches)
    else:
        deser = serializer.deserialize
        if handle.key_ordering and agg is None:
            import heapq

            def decode_fn(data, _d=deser):
                recs = list(_d(data))
                recs.sort(key=lambda kv: kv[0])
                return recs, len(recs)

            def combine_fn(results):
                # fragments of a SPLIT block sorted independently: a
                # concat is NOT sorted when the block held several
                # sorted runs (spilled map outputs) — stable-merge the
                # fragment results so the composite equals the stable
                # sort of the whole block, which is what the reader's
                # presorted k-way merge downstream relies on
                merged = list(heapq.merge(
                    *[items for items, _n in results],
                    key=lambda kv: kv[0],
                ))
                return merged, sum(n for _i, n in results)

            return pool.stream(decode_fn, split_fn, combine_fn,
                               tenant=tenant)

        def decode_fn(data, _d=deser):
            recs = list(_d(data))
            return recs, len(recs)
    return pool.stream(decode_fn, split_fn, tenant=tenant)


def iter_decoded_ahead(stream: DecodeStream, payloads: Iterator,
                       ahead_bytes: int) -> Iterator:
    """Pull-driven decode-ahead over an iterator of raw payloads (the
    local-block and windowed-plane shape, where the task thread itself
    produces the payloads): submit up to ``ahead_bytes`` of payloads
    before consuming the first ticket, then keep the window full.
    Yields tickets in submission order — the caller's ``get()`` order
    is its consumption order, exactly like the push-driven remote
    path."""
    from collections import deque

    pending: "deque" = deque()
    ahead = 0
    for data in payloads:
        n = len(data)
        while pending and ahead + n > ahead_bytes:
            t = pending.popleft()
            ahead -= len(t)
            yield t
        pending.append(stream.submit_block(data))
        ahead += n
    while pending:
        yield pending.popleft()
