"""Striped multi-channel block reads: per-peer groups over a shared
lane pool.

SparkRDMA's point-to-point perf trick was channel specialization: each
peer pair keeps RPC channels separate from dedicated RDMA_READ
requestor/responder channels so bulk reads never head-of-line-block
control traffic (RdmaChannel.java:41; our ``ChannelType`` mirrors the
split but every peer previously shared ONE serialized socket per
type).  This module extends the split with fabric-lib-style striping:

- a :class:`ReadGroup` per peer owns one SMALL-read lane (slot 0) and
  BORROWS data lanes (slots 1..k) per read from the node's fixed
  :class:`~sparkrdma_tpu_torch.transport.node._LanePool`
  (``transportLanePoolSize``), so concurrent stripe fan-out across all
  peers is bounded node-wide instead of every peer owning
  ``transportNumStripes`` dedicated sockets — idle peers cost zero
  data-lane connections (their cached channels age out of the node's
  LRU channel cache);
- block reads larger than ``transportStripeThreshold`` are chunked and
  issued round-robin across the borrowed lanes as ordinary sub-range
  one-sided reads (a stripe is just a ``BlockLocation`` at
  ``address + offset`` — the responder needs no special handling), each
  landing via ``recv_into`` DIRECTLY in its slice of one pooled
  destination row (``StagingPool.alloc_gc``) — reassembly happens in
  the kernel copy, with no intermediate buffers or joins;
- small reads ride slot 0 whole, so metadata-sized fetches never queue
  behind multi-MB stripes; when the lane pool is dry, bulk reads fall
  back to slot 0 unstriped (narrower, never wrong).

Lane channels come from the node's slot-keyed LRU channel cache, so an
evicted lane transparently reconnects on the next read; a post that
loses the eviction race (channel stopped between cache lookup and the
post) re-resolves through the cache exactly once — see ``_post``.

Failure contract: the first failing sub-read fails the WHOLE group
read exactly once (each lane's ``_fail_outstanding`` covers its
stripes; the combiner fans the first error out to the caller), so a
dead data channel surfaces as a prompt fetch failure, never a hang.
Borrowed lanes are returned exactly once, on the group's completion or
first failure.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.qos import BULK, INTERACTIVE
from sparkrdma_tpu_torch.transport.channel import (
    ChannelType,
    CompletionListener,
    FnCompletionListener,
    TransportError,
)
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.ledger import ledger_acquire
from sparkrdma_tpu_torch.utils.statemachine import StateMachine
from sparkrdma_tpu_torch.utils.types import BlockLocation


def _alloc_row(pool, nbytes: int) -> np.ndarray:
    """Pooled destination row for one striped block (zero-copy slices,
    GC-tied release); plain numpy when no pool is wired or the budget
    is exhausted."""
    from sparkrdma_tpu_torch.memory.staging import alloc_row_gc

    return alloc_row_gc(
        pool, nbytes, "transport_stripe_row_pool_fallbacks_total"
    )


class _GroupRead(StateMachine):
    """Completion combiner for one group read: N sub-reads, one
    caller-facing listener.  First failure wins and suppresses further
    progress reports; success fires once when every sub-read landed.
    ``on_finish`` (borrowed-lane return) runs exactly once, on the
    finished transition, before the caller's listener."""

    __slots__ = ("listener", "out", "rows", "on_progress", "pending",
                 "lock", "_state", "on_finish")

    MACHINE = "stripe.group_read"
    STATES = ("pending", "done", "failed")
    INITIAL = "pending"
    TERMINAL = ("done", "failed")
    TRANSITIONS = {
        "pending": ("done", "failed"),
    }

    def __init__(self, listener: CompletionListener, out: list,
                 rows: List[int], on_progress, pending: int,
                 on_finish=None):
        self.listener = listener
        self.out = out
        self.rows = rows  # indices whose out[] entry is a dest row
        self.on_progress = on_progress
        self.pending = pending  # guarded-by: lock
        self.lock = dbg_lock("stripe.group", 54)
        # read UNLOCKED by progress() as a suppress hint (racy by
        # design — a late progress report is harmless); writes stay
        # under the lock
        self._state = "pending"  # state: stripe.group_read guarded-by: lock
        self.on_finish = on_finish

    def _finish(self) -> None:
        # only the thread that made the finished transition gets here
        cb, self.on_finish = self.on_finish, None
        if cb is not None:
            try:
                cb()
            except BaseException:
                pass

    def progress(self, n: int) -> None:
        cb = self.on_progress
        # racy suppress hint — a late progress report is harmless
        if cb is not None and self._state == "pending":  # noqa: SC03 hint
            cb(n)

    def part_done(self) -> None:
        with self.lock:
            if self._state != "pending":
                return
            self.pending -= 1
            if self.pending:
                return
            self._transition("done", frm="pending")
        self._finish()
        for i in self.rows:
            row = self.out[i]
            if isinstance(row, np.ndarray):
                row.flags.writeable = False
        self.listener.on_success(self.out)

    def fail(self, err: BaseException) -> None:
        with self.lock:
            if self._state != "pending":
                return
            self._transition("failed", frm="pending")
        self._finish()
        self.listener.on_failure(err)


class ReadGroup:
    """One peer's channel group: stripes bulk reads over borrowed
    lanes, keeps small reads on their own lane.  Obtained via
    ``Node.get_read_group``; channels come from the node's slot-keyed
    LRU cache, so lane death/eviction/reconnect rides the existing
    racy-create machinery."""

    def __init__(self, node, peer, connect):
        self.node = node
        self.peer = peer
        self._connect = connect
        conf = node.conf
        self.num_stripes = conf.transport_num_stripes
        self.threshold = max(conf.transport_stripe_threshold, 1)
        self._rr = 0  # guarded-by: _rr_lock
        self._rr_lock = dbg_lock("stripe.rr", 52)
        self._m_stripes = counter("transport_stripes_total")
        self._m_stripe_bytes = counter("transport_stripe_bytes_total")
        self._m_striped_reads = counter("transport_striped_reads_total")
        self._m_evict_races = counter("transport_channel_evict_races_total")

    def channel(self, slot: int = 0):
        return self.node.get_channel(
            self.peer, ChannelType.READ_REQUESTOR, self._connect, slot=slot
        )

    def data_channels(self) -> List:
        """The full-width data lanes (slots 1..num_stripes) — chaos
        tests reach in here to kill one mid-read."""
        return [self.channel(s) for s in range(1, self.num_stripes + 1)]

    def _post(self, slot: int, locs, listener, dest=None,
              on_progress=None, ctx=None) -> None:
        """Post one lane's sub-read, re-resolving the channel exactly
        once if the cached channel was evicted between the cache lookup
        and the post (``read_blocks`` raises synchronously BEFORE
        touching the listener, so a retry can never double-deliver)."""
        if FAULTS.enabled and slot > 0:
            FAULTS.check("stripe")
        for attempt in (0, 1):
            ch = self.channel(slot)
            try:
                if dest is None and on_progress is None and ctx is None:
                    ch.read_blocks(locs, listener)
                else:
                    ch.read_blocks(
                        locs, listener, dest=dest, on_progress=on_progress,
                        ctx=ctx,
                    )
            except TransportError:
                if attempt:
                    raise
                self._m_evict_races.inc()
                continue
            if (FAULTS.enabled and slot > 0
                    and FAULTS.fires("lane_kill")):
                # mid-read lane death: the sub-read was posted, now the
                # lane dies under it — _fail_outstanding surfaces the
                # structured failure exactly like a real cut socket
                ch.stop()
            return

    def read_blocks(
        self,
        locations: Sequence[BlockLocation],
        listener: CompletionListener,
        on_progress=None,
        tenant=None,
        ctx=None,
    ) -> None:
        """Same contract as ``Channel.read_blocks``: completion delivers
        one bytes-like payload per location, in order — striped blocks
        arrive as the full reassembled destination row (read-only
        ndarray), small ones exactly as a plain channel read returns
        them.  ``tenant`` (qos/) shapes the lane borrow: interactive
        tenants draw on the pool's reserved slice, and a DEGRADED
        tenant (over its admission quota) narrows to one data lane —
        correct, just no longer fanned out."""
        locations = list(locations)
        ch0 = self.channel(0)
        scatter = getattr(ch0, "supports_scatter", False)
        striped = (
            [i for i, loc in enumerate(locations)
             if loc.length > self.threshold]
            if scatter and self.num_stripes > 1 else []
        )
        if striped and self.node.peer_health(self.peer).stripes.demoted():
            # repeated lane failures against this peer: demote to the
            # unstriped small-read lane for the health window (the
            # dry-pool fallback below, driven by a health signal)
            counter("transport_stripe_demotions_total").inc()
            striped = []
        lanes_borrowed = 0
        if striped:
            # borrow this read's stripe width from the node-wide pool;
            # a dry pool demotes the read to the small lane, unstriped
            want, cls = self.num_stripes, BULK
            if tenant is not None:
                if tenant.degraded:
                    want = 1  # admission degrade: narrower stripes
                    counter("qos_degraded_reads_total",
                            tenant=tenant.name).inc()
                if tenant.interactive:
                    cls = INTERACTIVE
            lanes_borrowed = self.node.lane_pool.try_borrow(
                want, cls=cls
            )  # acquires: node.lane_tokens
            # owns: node.lane_tokens -> release_lanes
            if lanes_borrowed == 0:
                striped = []
        if not striped:
            if scatter and (on_progress is not None or ctx is not None):
                self._post(
                    0, locations, listener, on_progress=on_progress,
                    ctx=ctx,
                )
            else:
                self._post(0, locations, listener)
            return

        # ONE-SHOT release shared by every owner: the group state's
        # finish transition AND the pre-state exception path below.  A
        # plain release in both places would double-credit the pool
        # when a caller's on_failure raises out of state.fail AFTER
        # the finish transition already returned the tokens.
        owed = [lanes_borrowed]
        tkt = ledger_acquire("node.lane_tokens", lanes_borrowed)

        def release_lanes() -> None:
            n, owed[0] = owed[0], 0
            self.node.lane_pool.release(n)  # releases: node.lane_tokens  # one-shot
            tkt.release(n)

        try:
            self._read_striped(
                locations, striped, lanes_borrowed, listener, on_progress,
                release_lanes, ctx,
            )
        except BaseException:
            release_lanes()
            raise

    def _read_striped(self, locations, striped, width, listener,
                      on_progress, release_lanes, ctx=None) -> None:
        striped_set = set(striped)
        small = [i for i in range(len(locations)) if i not in striped_set]
        out: list = [None] * len(locations)
        # lane -> ([sub-locations], [dest views]); slots 1..width so
        # back-to-back reads reuse the same cached lane channels
        lanes = {s: ([], []) for s in range(1, width + 1)}
        pool = getattr(self.node, "staging_pool", None)
        with self._rr_lock:
            rr = self._rr
            self._rr += sum(
                self._num_chunks(locations[i].length, width)
                for i in striped
            )
        for i in striped:
            loc = locations[i]
            row = _alloc_row(pool, loc.length)
            out[i] = row
            k = self._num_chunks(loc.length, width)
            base, extra = divmod(loc.length, k)
            off = 0
            for j in range(k):
                n = base + (1 if j < extra else 0)
                slot = 1 + (rr % width)
                rr += 1
                locs, dests = lanes[slot]
                locs.append(BlockLocation(loc.address + off, n, loc.mkey))
                dests.append(row[off:off + n])
                off += n
            self._m_stripes.inc(k)
            self._m_stripe_bytes.inc(loc.length)
            self._m_striped_reads.inc()

        live_lanes = [s for s, (locs, _d) in lanes.items() if locs]
        state = _GroupRead(
            listener, out, striped, on_progress,
            pending=len(live_lanes) + (1 if small else 0),
            on_finish=release_lanes,
        )
        health = self.node.peer_health(self.peer).stripes

        def lane_done(_blocks) -> None:
            health.note_success()
            state.part_done()

        def lane_fail(err: BaseException) -> None:
            # striped-lane failure feeds the peer's demotion signal
            # BEFORE the group fails, so the retry attempt already
            # sees the updated health
            health.note_lane_failure()
            state.fail(err)

        def lane_listener():
            return FnCompletionListener(lane_done, lane_fail)

        def small_done(blocks):
            for idx, b in zip(small, blocks):
                out[idx] = b
            state.part_done()

        try:
            if small:
                self._post(
                    0, [locations[i] for i in small],
                    FnCompletionListener(small_done, state.fail),
                    on_progress=state.progress, ctx=ctx,
                )
            for s in live_lanes:
                locs, dests = lanes[s]
                self._post(
                    s, locs, lane_listener(), dest=dests,
                    on_progress=state.progress,
                    ctx=ctx.child() if ctx is not None else None,
                )
        except BaseException as e:
            state.fail(e)

    def _num_chunks(self, length: int, width: int) -> int:
        """Stripes for one block across ``width`` borrowed lanes: every
        chunk stays above half the threshold so tiny tail chunks never
        pay a full round trip."""
        min_chunk = max(self.threshold // 2, 1)
        return max(1, min(width, length // min_chunk))


__all__ = ["ReadGroup"]
