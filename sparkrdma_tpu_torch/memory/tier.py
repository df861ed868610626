"""Tiered block store: hot pooled rows over cold mapped files.

The out-of-core residency manager (ROADMAP item 3, the *DMA Streaming
Framework* / *RDMAbox* direction).  The reference mmaps every shuffle
file and registers it whole, prefetching ODP pages ahead of RDMA reads
(RdmaMappedFile.java:95-171, the prefetch sweep at :158-168); here a
file-backed map output is adopted by a per-node :class:`TieredBlockStore`
that owns the residency state of every partition block:

- **cold tier** — the committed data file itself (write-through at
  commit: the bytes are on disk before the output publishes), read via
  O_DIRECT ``pread`` or a LAZILY created mmap (``defer_map``), so an
  output whose partitions are never read costs the file alone;
- **hot tier** — blocks promoted into pooled ``StagingPool.alloc_gc``
  rows under the ``tierHotBytes`` budget, served as zero-copy read-only
  views (release is GC-tied, so a demotion can never recycle memory
  under a live consumer view);
- **eviction** — promotion past the budget demotes the LRU *unpinned*
  blocks (a block with an in-flight serve holds pins — the
  ``Channel.in_flight()`` refcount precedent — and is skipped, counted
  as a refusal); demotion is free because the cold tier is the source
  of truth;
- **prefetch** — two promotion signals hide the disk reads: the serve
  path's own request stream (a read of block *i* schedules readahead of
  blocks *i+1..i+k* through the node's byte-credited serve pool) and
  reader-sent :class:`~sparkrdma_tpu_torch.rpc.messages.PrefetchHintMsg`
  lists (the reader knows its full fetch plan), warming blocks before
  the read RPCs arrive.

Concurrency: the store lock guards residency metadata only — disk
reads and row copies ALWAYS run outside it (concheck's DISK_BLOCKING
gate pins this down), and concurrent readers of a block mid-promotion
wait on its loading event instead of issuing duplicate disk reads (the
striped sub-range serve shape: every lane's first touch races here).
"""

from __future__ import annotations

import logging
import threading
import weakref
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.memory.staging import alloc_row_gc
from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.transport.channel import TransportError
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.statemachine import StateMachine

logger = logging.getLogger(__name__)

# cold-tier blocks at least this large read O_DIRECT (pread); smaller
# ones fault through the lazy mmap — same split as arena.DIRECT_READ_MIN
# (buffered faults are writeback-throttled on virtualized hosts, but a
# 4 KiB-aligned O_DIRECT round trip is pure overhead for tiny blocks)
TIER_DIRECT_READ_MIN = 1 << 20

# clustered cold reads skip gaps above this (the arena's
# READ_MANY_MAX_GAP policy: a sparse batch must not drag the whole gap
# off disk)
TIER_READ_MAX_GAP = 8 << 20


class _Block(StateMachine):
    """Residency state of one partition block of one map output:
    ``cold`` (disk only) → ``loading`` (one promotion in flight) →
    ``hot`` (pinned row installed), demoting back to ``cold`` on
    eviction or a failed/raced load."""

    __slots__ = ("index", "offset", "length", "row", "pins", "seq",
                 "loading", "prefetched", "touched", "hot_tkt", "_state")

    MACHINE = "tier.block"
    STATES = ("cold", "loading", "hot")
    INITIAL = "cold"
    TERMINAL = ()
    TRANSITIONS = {
        "cold": ("loading",),
        "loading": ("hot", "cold"),  # install, or rollback/raced release
        "hot": ("cold",),            # demote
    }

    def __init__(self, index: int, offset: int, length: int):
        self.index = index
        self.offset = offset
        self.length = length
        # all mutable state below guarded-by the owning store's _lock
        self._state = "cold"  # state: tier.block guarded-by: TieredBlockStore._lock
        self.row: Optional[np.ndarray] = None  # hot: exact-length view
        self.pins = 0  # resource: tier.pins (live consumer views)
        self.hot_tkt = NOOP_TICKET  # this block's hot-byte reservation
        self.seq = 0            # LRU clock at last touch
        self.loading: Optional[threading.Event] = None
        self.prefetched = False  # promoted by prefetch, not yet read
        self.touched = False     # ever served (never-read accounting)


class TierEntry:
    """One adopted map output: its data file + per-block residency.
    ``tenant`` (qos/) is the owning tenant resolved at adoption — the
    hot budget's weighted-share accounting keys on it."""

    __slots__ = ("mf", "nbytes", "shuffle_id", "blocks", "_ends",
                 "mkey", "tenant")

    def __init__(self, mf, spans: Sequence[Tuple[int, int]],
                 nbytes: int, shuffle_id: Optional[int]):
        self.mf = mf
        self.nbytes = nbytes
        self.shuffle_id = shuffle_id
        self.mkey = 0  # assigned at registration
        self.tenant = None  # resolved by the adopting store
        self.blocks: List[_Block] = [
            _Block(i, off, ln)
            for i, (off, ln) in enumerate(spans) if ln > 0
        ]
        # exclusive end offsets for bisect lookup
        self._ends = [b.offset + b.length for b in self.blocks]

    def block_covering(self, lo: int, hi: int) -> Optional[_Block]:
        """The single block containing [lo, hi), or None (a span
        crossing block boundaries serves cold — it cannot be one
        published location)."""
        i = bisect_right(self._ends, lo)
        if i < len(self.blocks):
            b = self.blocks[i]
            if b.offset <= lo and hi <= b.offset + b.length:
                return b
        return None

    def blocks_overlapping(self, lo: int, hi: int) -> List[_Block]:
        i = bisect_right(self._ends, lo)
        out = []
        while i < len(self.blocks) and self.blocks[i].offset < hi:
            out.append(self.blocks[i])
            i += 1
        return out


class TieredSegment:
    """Arena-registered face of one tier entry: duck-types
    DeviceSegment (``ArenaManager.register_external``) so every serve
    path — local short-circuit, TCP/loopback one-sided reads, the bulk
    plane's batched ``read_many`` — resolves through the store's
    residency state without knowing tiers exist."""

    __slots__ = ("mkey", "nbytes", "shuffle_id", "budgeted",
                 "zero_copy_ok", "keepalive", "store", "entry")

    def __init__(self, store: "TieredBlockStore", entry: TierEntry):
        self.mkey = 0  # assigned by ArenaManager.register_external
        self.nbytes = entry.nbytes
        self.shuffle_id = entry.shuffle_id
        self.budgeted = False   # bytes live on disk / in tier-budgeted rows
        self.zero_copy_ok = True  # hot rows are GC-tied, mmaps refcounted
        self.keepalive = None
        self.store = store
        self.entry = entry

    def _check(self, lo: int, hi: int) -> None:
        if lo < 0 or hi > self.nbytes:
            raise TransportError(
                f"read [{lo},{hi}) outside tiered segment "
                f"mkey={self.mkey} of {self.nbytes}B"
            )

    def read(self, offset: int, length: int):
        self._check(offset, offset + length)
        return self.store.read(self.entry, offset, length)

    def read_many(self, spans):
        if not spans:
            return []
        self._check(min(o for o, _l in spans),
                    max(o + _l for o, _l in spans))
        return self.store.read_many(self.entry, spans)

    def _release_keepalive(self) -> None:
        self.store.release_entry(self.entry)


class TieredBlockStore:
    """Per-node residency manager for file-backed map outputs."""

    def __init__(self, staging_pool=None, hot_bytes: int = 0,
                 prefetch_blocks: int = 2, submitter=None, qos=None):
        self.staging_pool = staging_pool
        self.hot_budget = max(int(hot_bytes), 0)  # 0 = unbounded
        self.prefetch_blocks = max(int(prefetch_blocks), 0)
        # multi-tenant QoS (qos/): when a tenant registry is attached,
        # the hot budget splits into weighted max-min shares — an
        # over-share tenant may only displace its own (or other
        # over-share) blocks, a DEGRADED tenant (admission quota) is
        # not promoted at all (its blocks serve cold), and idle shares
        # stay borrowable (work conservation)
        self._qos = qos
        self._hot_by_tenant: Dict[str, int] = {}  # guarded-by: _lock
        # async promotion executor: (fn, args, cost_bytes) — wired to
        # Node.submit_serve so warms ride the serve pool's byte
        # credits; None runs nothing (demand-only cache)
        self._submit = submitter
        # guards every _Block's mutable state + the maps/accounting
        # below; disk reads and row copies NEVER run under it.
        # Deliberately a PLAIN RLock, never a DebugLock: _unpin runs
        # as a weakref.finalize callback, and cyclic GC can fire it on
        # a thread that already holds this lock (or any other) — a
        # rank-checked non-reentrant wrapper would raise inside the
        # finalizer and leak the pin forever (the StagingPool._lock
        # precedent, memory/staging.py)
        self._lock = threading.RLock()  # lock-order: 76
        self._by_mkey: Dict[int, TierEntry] = {}  # guarded-by: _lock
        self._hot_bytes = 0  # resource: tier.hot_bytes  # guarded-by: _lock
        self._hot: Dict[_Block, TierEntry] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._m_hot = gauge("tier_hot_bytes")
        self._m_entries = gauge("tier_entries")
        self._m_hits = counter("tier_hits_total")
        self._m_misses = counter("tier_misses_total")
        self._m_promotes = counter("tier_promotes_total")
        self._m_promote_bytes = counter("tier_promote_bytes_total")
        self._m_demotes = counter("tier_demotes_total")
        self._m_demote_bytes = counter("tier_demote_bytes_total")
        self._m_evict_refusals = counter("tier_evict_refusals_total")
        self._m_cold_bytes = counter("tier_cold_read_bytes_total")
        self._m_prefetch_tasks = counter("tier_prefetch_tasks_total")
        self._m_prefetch_useful = counter("tier_prefetch_useful_total")
        self._m_never_read = counter("tier_bytes_never_read_total")
        self._m_commit_bytes = counter("tier_commit_bytes_total")

    # -- adoption / release --------------------------------------------------
    def adopt(self, mf, spans: Sequence[Tuple[int, int]], nbytes: int,
              shuffle_id: Optional[int], arena) -> TieredSegment:
        """Adopt one committed data file as a tiered segment: registers
        it in ``arena`` (mkey assignment + read dispatch) and indexes
        its partition blocks for residency tracking.  ``spans`` are the
        per-partition (offset, length) pairs; takes ownership of ``mf``
        (freed on segment release)."""
        entry = TierEntry(mf, spans, nbytes, shuffle_id)
        if self._qos is not None:
            entry.tenant = self._qos.tenant_of_shuffle(shuffle_id)
        seg = TieredSegment(self, entry)
        arena.register_external(seg)
        entry.mkey = seg.mkey
        with self._lock:
            self._by_mkey[seg.mkey] = entry
        self._m_entries.inc()
        self._m_commit_bytes.inc(sum(b.length for b in entry.blocks))
        return seg

    def release_entry(self, entry: TierEntry) -> None:
        """Segment released (shuffle unregistered / task retry):
        demote its hot blocks and free the data file.  Counts the
        bytes that were committed but NEVER served — the eager
        registration the lazy per-span path saves."""
        never_read = 0
        with self._lock:
            self._by_mkey.pop(entry.mkey, None)
            for blk in entry.blocks:
                if blk.row is not None:
                    self._demote_locked(blk)
                if not blk.touched:
                    never_read += blk.length
        self._m_entries.dec()
        if never_read:
            self._m_never_read.inc(never_read)
        entry.mf.free()

    def stop(self) -> None:
        """Defensive teardown (entries normally drain via segment
        release through the arena)."""
        with self._lock:
            entries = list(self._by_mkey.values())
        for entry in entries:
            self.release_entry(entry)

    # -- read path -----------------------------------------------------------
    def read(self, entry: TierEntry, offset: int, length: int):
        """Serve one span from whichever tier holds the bytes."""
        return self.read_many(entry, [(offset, length)])[0]

    def read_many(self, entry: TierEntry, spans):
        """Serve many (offset, length) spans: hot blocks hand back
        zero-copy pinned views; a sub-range of a cold block promotes
        the WHOLE block first (one disk read serves every stripe of
        it — concurrent lanes wait on the loading event instead of
        re-reading); whole-block cold reads serve straight from disk,
        clustered by proximity like the arena's batched reads.  Always
        completes — a full hot tier degrades to cold serving, never an
        error or a wait-forever."""
        out: list = [None] * len(spans)
        cold: List[int] = []
        last_block = None
        for i, (off, ln) in enumerate(spans):
            if ln == 0:
                out[i] = b""
                continue
            blk = entry.block_covering(off, off + ln)
            if blk is None:
                # crosses block boundaries: not a published location —
                # serve cold without residency tracking
                cold.append(i)
                continue
            if last_block is None or blk.index > last_block.index:
                last_block = blk
            if ln < blk.length:
                # stripe sub-range: siblings are coming — promote
                out[i] = self._serve_block(
                    entry, blk, off - blk.offset, ln, want_promote=True
                )
            else:
                served = self._try_serve_hot(entry, blk)
                if served is None:
                    cold.append(i)
                else:
                    out[i] = served
        if cold:
            self._serve_cold_clustered(entry, spans, cold, out)
        if last_block is not None:
            self._maybe_readahead(entry, last_block)
        return out

    def _try_serve_hot(self, entry: TierEntry, blk: _Block):
        """Hot hit (or a wait on an in-flight promotion) for a
        whole-block read; None → caller serves cold."""
        for _ in range(8):
            with self._lock:
                self._touch_locked(blk)
                if blk.row is not None:
                    self._m_hits.inc()
                    return self._pinned_view_locked(blk, 0, blk.length)
                ev = blk.loading
            if ev is None:
                return None
            # a promote is in flight (hint warm / stripe sibling):
            # waiting reuses its one disk read; a stuck loader times
            # out into a plain cold serve
            if not ev.wait(timeout=30.0):
                return None
        return None

    def _serve_block(self, entry: TierEntry, blk: _Block, rel: int,
                     length: int, want_promote: bool):
        """Serve one span INSIDE one block, promoting it when asked
        (and the budget allows after eviction)."""
        loaded = False
        for _ in range(64):
            with self._lock:
                self._touch_locked(blk)
                if blk.row is not None:
                    if not loaded:
                        self._m_hits.inc()
                    return self._pinned_view_locked(blk, rel, length)
                ev = blk.loading
                if ev is None and want_promote \
                        and self._reserve_locked(blk.length, entry=entry):
                    blk._transition("loading", frm="cold")
                    blk.loading = threading.Event()
                    blk.hot_tkt = ledger_acquire(
                        "tier.hot_bytes", blk.length
                    )
                    ev = None
                    load = True
                else:
                    load = False
            if load:
                self._m_misses.inc()
                loaded = True
                row = None
                try:
                    row = self._load_row(entry, blk)
                finally:
                    self._finish_load(entry, blk, row)
                # serve OUR loaded row directly: a concurrent demand
                # promote may already have evicted the block again
                # under budget contention, and looping back would
                # re-read the same bytes from disk (thrash, and after
                # enough rounds a spurious convergence error) even
                # though this thread holds them right here.  If the
                # row is still installed, the view pins it; if it was
                # demoted, the view alone keeps it alive (GC chain).
                with self._lock:
                    if blk.row is row:
                        return self._pinned_view_locked(blk, rel, length)
                v = row[rel : rel + length].view()
                v.flags.writeable = False
                return v
            if ev is not None:
                if ev.wait(timeout=30.0):
                    continue
            # cold serve: budget exhausted / oversized / stuck loader
            if not loaded:
                self._m_misses.inc()
            self._m_cold_bytes.inc(length)
            return self._disk_read(entry, blk.offset + rel, length)
        raise TransportError(
            f"tier: block {blk.index} of mkey={entry.mkey} did not "
            f"converge to a servable tier"
        )

    def _serve_cold_clustered(self, entry: TierEntry, spans,
                              idxs: List[int], out: list) -> None:
        """One proximity-clustered disk read per dense run of cold
        spans (the arena ``_read_spans_clustered`` policy against the
        cold tier); served blocks are chunk views of each cluster's
        landed buffer."""
        for i in idxs:
            blk = entry.block_covering(
                spans[i][0], spans[i][0] + spans[i][1]
            )
            if blk is not None:
                with self._lock:
                    self._touch_locked(blk)
            self._m_misses.inc()
            self._m_cold_bytes.inc(spans[i][1])
        order = sorted(idxs, key=lambda i: spans[i][0])
        cluster: List[int] = []
        cend = 0

        def flush() -> None:
            if not cluster:
                return
            clo = spans[cluster[0]][0]
            chi = max(spans[i][0] + spans[i][1] for i in cluster)
            buf = self._disk_read(entry, clo, chi - clo)
            for i in cluster:
                o, ln = spans[i]
                out[i] = buf[o - clo : o - clo + ln]
            cluster.clear()

        for i in order:
            o, ln = spans[i]
            if cluster and o - cend > TIER_READ_MAX_GAP:
                flush()
            cluster.append(i)
            cend = max(cend, o + ln)
        flush()

    # -- promotion / prefetch ------------------------------------------------
    def warm(self, mkey: int, offset: int, length: int) -> int:
        """Promote the blocks covering [offset, offset+length) ahead
        of their reads — the PrefetchHintMsg / readahead entry point.
        Unknown mkeys (released shuffle, non-tiered segment) are a
        no-op.  Returns blocks promoted."""
        with self._lock:
            entry = self._by_mkey.get(mkey)
        if entry is None:
            return 0
        n = 0
        for blk in entry.blocks_overlapping(offset, offset + length):
            n += self._warm_block(entry, blk)
        if n and RECORDER.enabled:
            fr_event("tier", "warm", mkey=mkey, blocks=n)
        return n

    def would_warm(self, mkey: int) -> bool:
        """Cheap guard for hint handlers: is this mkey tiered at all?"""
        with self._lock:
            return mkey in self._by_mkey

    def _warm_block(self, entry: TierEntry, blk: _Block) -> int:
        with self._lock:
            if blk.row is not None or blk.loading is not None:
                return 0
            # a prediction may only recycle CONSUMED budget (touched,
            # unpinned blocks): warming the tail of a long plan must
            # never demote its still-unread head — when the budget is
            # full of unread predictions, warming simply stops and the
            # blocks serve cold on demand
            if not self._reserve_locked(blk.length, prefetch=True,
                                        entry=entry):
                return 0
            self._seq += 1  # noqa: CK03 - held
            blk.seq = self._seq  # noqa: CK03 - held
            blk._transition("loading", frm="cold")
            blk.loading = threading.Event()
            blk.hot_tkt = ledger_acquire("tier.hot_bytes", blk.length)
            blk.prefetched = True
        self._m_prefetch_tasks.inc()
        row = None
        try:
            row = self._load_row(entry, blk)
        except BaseException:
            logger.warning(
                "tier: prefetch of block %d (mkey=%d) failed",
                blk.index, entry.mkey, exc_info=True,
            )
        finally:
            self._finish_load(entry, blk, row)
        return 1 if row is not None else 0

    def _maybe_readahead(self, entry: TierEntry, blk: _Block) -> None:
        """The request-stream signal: serving block i schedules async
        promotion of the next blocks of the same output through the
        serve pool (byte-credited — a prefetch storm cannot pin
        unbounded memory, it queues behind real serves)."""
        k = self.prefetch_blocks
        submit = self._submit
        if k <= 0 or submit is None:
            return
        for nb in entry.blocks[blk.index + 1 : blk.index + 1 + k]:
            with self._lock:
                if (nb.row is not None or nb.loading is not None
                        or entry.mkey not in self._by_mkey):
                    continue
            try:
                submit(self._warm_block, (entry, nb), nb.length)
            except Exception:
                return  # serve pool stopped / saturated: demand-only

    # -- internals (lock held where noted) -----------------------------------
    def _touch_locked(self, blk: _Block) -> None:
        self._seq += 1  # noqa: CK03 - caller holds _lock
        blk.seq = self._seq  # noqa: CK03 - caller holds _lock
        if not blk.touched:
            blk.touched = True
            if blk.prefetched:
                blk.prefetched = False
                # useful only if the prediction actually delivered:
                # the row is resident, or its load is in flight (the
                # reader reuses that disk read via the loading event);
                # a FAILED warm must not inflate the usefulness ratio
                if blk.row is not None or blk.loading is not None:
                    self._m_prefetch_useful.inc()
        elif blk.prefetched and blk.row is not None:
            blk.prefetched = False
            self._m_prefetch_useful.inc()

    def _pinned_view_locked(self, blk: _Block, rel: int, length: int):
        """Zero-copy read-only view of a hot row, pinned until the
        view is collected (the in-flight refcount eviction honors).
        Memory safety does NOT depend on the pin — the alloc_gc base
        chain keeps the row's pages alive under any surviving slice —
        the pin only stops eviction from demoting a block mid-serve."""
        blk.pins += 1  # acquires: tier.pins  # noqa: CK03 - caller holds _lock
        tkt = ledger_acquire("tier.pins")
        v = blk.row[rel : rel + length].view()
        v.flags.writeable = False
        weakref.finalize(v, self._unpin, blk, tkt)  # releases: tier.pins
        return v

    def _unpin(self, blk: _Block, tkt=NOOP_TICKET) -> None:
        with self._lock:
            blk.pins -= 1
        # settled OUTSIDE the store lock: a finalizer firing at
        # interpreter shutdown (after the ledger epoch closed) must be
        # a silent no-op, and a live one must never raise with the
        # store lock held
        tkt.release()

    def _tier_shares_locked(self, extra) -> Dict[str, float]:
        """The hot budget's weighted max-min shares over the tenants
        with hot bytes, plus ``extra`` (the requester) — the SAME
        formula every credit ledger uses (qos/broker.py)."""
        from sparkrdma_tpu_torch.qos.broker import weighted_shares

        return weighted_shares(
            self.hot_budget, self._qos,
            self._hot_by_tenant,  # noqa: CK03 - caller holds _lock
            {extra.name: extra} if extra is not None else None,
        )

    def _drop_hot_tenant_locked(self, tenant, n: int) -> None:
        """Return ``n`` bytes of a tenant's hot usage (demotion or a
        failed/raced load) — caller holds ``_lock``."""
        if tenant is None:
            return
        left = self._hot_by_tenant.get(tenant.name, 0) - n  # noqa: CK03 - held
        if left > 0:
            self._hot_by_tenant[tenant.name] = left  # noqa: CK03 - held
        else:
            self._hot_by_tenant.pop(tenant.name, None)  # noqa: CK03 - held

    def _reserve_locked(self, n: int, prefetch: bool = False,
                        entry: Optional[TierEntry] = None) -> bool:
        """Make budget room for one promotion (evicting LRU unpinned
        hot blocks), reserving ``n`` bytes on success.  A block larger
        than the whole budget is never promoted (it serves cold) —
        the no-deadlock clamp.  ``prefetch`` restricts eviction to
        TOUCHED blocks (served at least once): a demand read may
        displace an unread prediction, a prediction may not — warming
        the tail of a plan must never cannibalize its unread head.
        With QoS on, a DEGRADED tenant never promotes (cold serves —
        the admission-control shed path) and eviction honors weighted
        shares (``_evict_locked``)."""
        tenant = entry.tenant if entry is not None else None
        if self._qos is not None and tenant is not None \
                and tenant.degraded:
            counter("qos_tier_denials_total",
                    tenant=tenant.name).inc()
            return False
        if self.hot_budget:
            if n > self.hot_budget:
                return False
            over = self._hot_bytes + n - self.hot_budget  # noqa: CK03 - held
            if over > 0:
                self._evict_locked(over, touched_only=prefetch,
                                   requester=tenant)
            if self._hot_bytes + n > self.hot_budget:  # noqa: CK03 - held
                return False
        # the reservation's release duty rides the block: installed
        # rows settle through demotion, failed/raced loads roll back
        # owns: tier.hot_bytes -> _demote_locked
        # owns: tier.hot_bytes -> _finish_load
        self._hot_bytes += n  # acquires: tier.hot_bytes  # noqa: CK03 - held
        if tenant is not None:
            self._hot_by_tenant[tenant.name] = (  # noqa: CK03 - held
                self._hot_by_tenant.get(tenant.name, 0) + n  # noqa: CK03 - held
            )
        self._m_hot.inc(n)
        return True

    def _evict_locked(self, need: int, touched_only: bool = False,
                      requester=None) -> None:
        protect_others = False
        shares: Dict[str, float] = {}
        if self._qos is not None and requester is not None:
            # a requester already at/over its weighted share may only
            # displace its OWN blocks (or another over-share tenant's)
            # — an under-share tenant's hot set is protected from it;
            # an under-share requester reclaims from anyone (that IS
            # the reclaim-on-demand of borrowed idle shares)
            shares = self._tier_shares_locked(requester)
            protect_others = (
                self._hot_by_tenant.get(requester.name, 0)  # noqa: CK03 - held
                >= shares.get(requester.name, float("inf"))
            )
        order = sorted(self._hot, key=lambda b: b.seq)  # noqa: CK03 - held
        freed = 0
        for blk in order:
            if freed >= need:
                break
            if touched_only and not blk.touched:
                continue
            if blk.pins > 0:
                # in-flight serve: never demote under a live reader
                self._m_evict_refusals.inc()
                continue
            if protect_others:
                owner = self._hot[blk].tenant  # noqa: CK03 - held
                if (owner is not None
                        and owner.name != requester.name
                        and self._hot_by_tenant.get(owner.name, 0)  # noqa: CK03 - held
                        <= shares.get(owner.name, 0)):
                    self._m_evict_refusals.inc()
                    continue
            freed += blk.length
            self._demote_locked(blk)

    def _demote_locked(self, blk: _Block) -> None:
        entry = self._hot.pop(blk, None)  # noqa: CK03 - caller holds _lock
        blk._transition("cold", frm="hot")
        blk.row = None  # cold tier is the source of truth: no write-back
        tkt, blk.hot_tkt = blk.hot_tkt, NOOP_TICKET
        tkt.release()
        self._hot_bytes -= blk.length  # releases: tier.hot_bytes  # noqa: CK03
        self._drop_hot_tenant_locked(
            entry.tenant if entry is not None else None, blk.length
        )
        self._m_hot.dec(blk.length)
        self._m_demotes.inc()
        self._m_demote_bytes.inc(blk.length)
        if RECORDER.enabled:
            fr_event("tier", "demote", bytes=blk.length)

    def _finish_load(self, entry: TierEntry, blk: _Block,
                     row: Optional[np.ndarray]) -> None:
        """Install a loaded row (or roll back the reservation) and
        wake waiters — exactly once per loading transition."""
        with self._lock:
            ev, blk.loading = blk.loading, None
            if row is not None and entry.mkey in self._by_mkey:
                blk._transition("hot", frm="loading")
                blk.row = row
                self._hot[blk] = entry
            else:
                blk._transition("cold", frm="loading")
                # failed load, or the entry was released mid-load
                tkt, blk.hot_tkt = blk.hot_tkt, NOOP_TICKET
                tkt.release()
                self._hot_bytes -= blk.length  # releases: tier.hot_bytes
                self._drop_hot_tenant_locked(entry.tenant, blk.length)
                self._m_hot.dec(blk.length)
        if ev is not None:
            ev.set()

    def _load_row(self, entry: TierEntry, blk: _Block) -> np.ndarray:
        """One whole-block disk read into a pooled row (NO lock held —
        this is the promotion's actual I/O)."""
        row = alloc_row_gc(
            self.staging_pool, blk.length,
            "tier_row_pool_fallbacks_total",
        )
        data = self._disk_read(entry, blk.offset, blk.length)
        row[: blk.length] = (
            data if isinstance(data, np.ndarray)
            else np.frombuffer(memoryview(data), np.uint8)
        )
        row.flags.writeable = False
        self._m_promotes.inc()
        self._m_promote_bytes.inc(blk.length)
        if RECORDER.enabled:
            fr_event(
                "tier", "promote",
                bytes=blk.length, prefetched=1 if blk.prefetched else 0,
            )
        return row

    def _disk_read(self, entry: TierEntry, offset: int, length: int):
        """Cold-tier read (NO lock held — concheck DISK_BLOCKING):
        O_DIRECT pread for large spans, the lazily created mmap view
        otherwise/fallback."""
        if RECORDER.enabled:
            fr_event("tier", "disk_read", bytes=length)
        if FAULTS.enabled:
            # models a failed/slow spill read: surfaces through the
            # same TransportError path as the freed-entry race below,
            # so the serve side converts it to a retryable failure
            FAULTS.check("disk_read")
        mf = entry.mf
        if length >= TIER_DIRECT_READ_MIN:
            got = mf.pread(offset, length)
            if got is not None:
                return got
        try:
            arr = mf.ensure_mapped()
        except (ValueError, OSError) as e:
            # entry freed under a racing read (task retry superseding
            # the segment): the _freed check raises ValueError, and a
            # free() landing between that check and the np.memmap open
            # surfaces as FileNotFoundError — either way surface the
            # transport-failure type the serve paths convert to a
            # retryable fetch failure
            raise TransportError(str(e)) from e
        view = arr[offset : offset + length].view()
        view.flags.writeable = False
        return view

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._by_mkey),
                "hot_blocks": len(self._hot),
                "hot_bytes": self._hot_bytes,
                "hot_budget": self.hot_budget,
            }


__all__ = ["TieredBlockStore", "TieredSegment", "TierEntry"]
