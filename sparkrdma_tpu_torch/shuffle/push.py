"""Push-based merged shuffle: the per-reduce-partition merger.

The magnet idiom applied to this stack's pull plane: at commit, every
writer pushes its per-partition payload — cut at serializer frame
boundaries into sub-blocks — to the reduce partition's deterministic
merger executor.  The merger assembles each map's partition from its
``(offset, bytes)`` spans, appends completed partitions into ONE
merged per-reduce span, and commits that span through the same
file-backed / tier-store write-through path the resolver's large
commits use (memory/mapped_file.py + memory/tier.py), so readers fetch
one large sequential run instead of M small random blocks.

Correctness contract — best-effort push, bit-exact always:

* **Dedup under retries.**  A retried/speculated map task pushes the
  same partition twice; the merger keeps the FIRST completed copy per
  ``map_id`` and drops the rest (``push_drops_total{reason="dup"}``).
  Map output bytes are deterministic per (shuffle, map, reduce), so
  first-wins is bit-exact.
* **Provenance.**  The merged span records ``(map_id, rel_off,
  rel_len)`` rows, so the reader knows exactly which map outputs the
  span covers — everything else (never pushed, dropped, arrived after
  seal, over the byte cap) rides the unchanged pull path — and can
  slice the span back into per-map blocks for the k-way merge.
* **Seal on first query.**  A merge-status query seals the
  (shuffle, reduce) state: what is complete is committed and served;
  partial assemblies are discarded and later arrivals dropped
  (``reason="late"``), so a span's provenance can never change after a
  reader planned against it.
* **Bounded.**  ``pushMaxMergedBytes`` caps a merger's per-reduce
  footprint; over-cap partitions drop to the pull path
  (``reason="cap"``).

No reference analog: RdmaShuffleWriter commits then serves pulls; this
is the LinkedIn-magnet restructuring of the same commit point, pushed
over the existing RPC channels behind the v3 wire handshake.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.statemachine import StateMachine

logger = logging.getLogger(__name__)

#: Provenance row: (map_id, rel_off, rel_len) within the merged span.
ProvRow = Tuple[int, int, int]


class MergeUnavailable(Exception):
    """This merger cannot answer a merge-status query (fault-injected
    dead-merger drill, or teardown race).  The manager converts it to
    the failed-reply the reader treats as no-coverage → pull."""


class _ReduceMerge(StateMachine):
    """Merge state of ONE (shuffle, reduce partition) on this merger:
    ``accepting`` sub-blocks until the first status query seals it,
    ``committed`` once the merged span is registered and servable (a
    failed commit stays ``sealed`` with no segment — pure pull)."""

    __slots__ = ("pending", "totals", "payloads", "done", "nbytes",
                 "_state", "seg", "length", "provenance")

    MACHINE = "push.merge"
    STATES = ("accepting", "sealed", "committed")
    INITIAL = "accepting"
    TERMINAL = ("committed",)
    TRANSITIONS = {
        "accepting": ("sealed",),
        "sealed": ("committed",),
    }

    def __init__(self):
        self.pending: Dict[int, Dict[int, bytes]] = {}  # map -> off -> bytes
        self.totals: Dict[int, int] = {}                # map -> total_len
        self.payloads: List[Tuple[int, bytes]] = []     # completed, in order
        self.done: set = set()       # map_ids no longer accepted
        self.nbytes = 0              # merged bytes (completed payloads)
        self._state = "accepting"  # state: push.merge guarded-by: PushMerger._lock
        self.seg = None              # registered segment once sealed
        self.length = 0
        self.provenance: Tuple[ProvRow, ...] = ()


class PushMerger:
    """Per-executor merger endpoint: receives pushed sub-blocks, seals
    merged per-reduce spans on first query, serves their locations.

    All handlers run on the manager's receive paths; the single lock
    covers assembly state only — the one slow operation under it (the
    seal's streaming file write + registration) happens once per
    (shuffle, reduce) and keeps seal idempotent under concurrent
    queries from retried reduce tasks."""

    def __init__(self, conf, arena, tier_store=None, node=None,
                 spill_dir: Optional[str] = None, direct_io: str = "off"):
        self.arena = arena
        self.tier_store = tier_store
        self.node = node
        self.spill_dir = spill_dir
        self.direct_io = direct_io
        self.max_merged_bytes = conf.push_max_merged_bytes
        self._lock = dbg_lock("push.merger", 26)
        self._shuffles: Dict[int, Dict[int, _ReduceMerge]] = {}  # guarded-by: _lock

    # -- push side (writer → merger) ----------------------------------------
    def on_sub_block(self, shuffle_id: int, map_id: int, reduce_id: int,
                     total_len: int, offset: int, data: bytes) -> None:
        """Accept one pushed span of a map's partition payload.  Drops
        are silent by design (counted, never raised): push is advisory
        and the pull path serves whatever never merges."""
        counter("push_sub_blocks_total").inc()
        if FAULTS.enabled and FAULTS.fires("push_merge"):
            counter("push_drops_total", reason="fault").inc()
            return
        with self._lock:
            st = self._shuffles.setdefault(shuffle_id, {}).setdefault(
                reduce_id, _ReduceMerge()
            )
            if st._state != "accepting":
                counter("push_drops_total", reason="late").inc()
                return
            if map_id in st.done:
                counter("push_drops_total", reason="dup").inc()
                return
            if st.totals.get(map_id, total_len) != total_len:
                # a retried map re-pushing with a different length can
                # only mean corruption upstream — restart its assembly
                # from the latest generation (last-writer-wins)
                st.pending.pop(map_id, None)
            st.totals[map_id] = total_len
            parts = st.pending.setdefault(map_id, {})
            parts[offset] = bytes(data)
            if not self._complete(parts, total_len):
                return
            st.pending.pop(map_id)
            st.totals.pop(map_id)
            st.done.add(map_id)
            if st.nbytes + total_len > self.max_merged_bytes:
                counter("push_drops_total", reason="cap").inc()
                return
            payload = b"".join(parts[o] for o in sorted(parts))
            st.payloads.append((map_id, payload))
            st.nbytes += total_len
        counter("push_merged_blocks_total").inc()
        counter("push_merged_bytes_total").inc(total_len)

    @staticmethod
    def _complete(parts: Dict[int, bytes], total_len: int) -> bool:
        """Do the spans tile [0, total_len) contiguously?  Offset-keyed
        parts dedup identical resends; a gap means more spans are in
        flight."""
        end = 0
        for off in sorted(parts):
            if off > end:
                return False
            end = max(end, off + len(parts[off]))
        return end >= total_len

    # -- query side (reader → merger) ---------------------------------------
    def merge_status(
        self, shuffle_id: int, reduce_ids
    ) -> List[Tuple[int, int, int, Tuple[ProvRow, ...]]]:
        """Seal and answer: ``(reduce_id, mkey, length, provenance)``
        per queried id; ``mkey == 0`` means no merged data (pull
        everything).  Raises :class:`MergeUnavailable` under the
        dead-merger fault drill."""
        if FAULTS.enabled and FAULTS.fires("merge_status"):
            raise MergeUnavailable("fault-injected merge_status failure")
        out = []
        for rid in reduce_ids:
            mkey, length, prov = self.local_merged(shuffle_id, rid)
            out.append((rid, mkey, length, prov))
        return out

    def local_merged(
        self, shuffle_id: int, reduce_id: int
    ) -> Tuple[int, int, Tuple[ProvRow, ...]]:
        """Seal ONE reduce partition and return ``(mkey, length,
        provenance)`` — ``(0, 0, ())`` when nothing merged.  Idempotent:
        the first call commits, every later call re-reads the sealed
        answer (retried reduce tasks must plan against the same span)."""
        with self._lock:
            st = self._shuffles.get(shuffle_id, {}).get(reduce_id)
            if st is None:
                # seal-by-absence: record the miss so late pushes drop
                st = self._shuffles.setdefault(shuffle_id, {}).setdefault(
                    reduce_id, _ReduceMerge()
                )
            if st._state == "accepting":
                st._transition("sealed")
                st.pending.clear()
                st.totals.clear()
                if st.payloads:
                    try:
                        self._commit_locked(st, shuffle_id)
                    except Exception:
                        logger.warning(
                            "merged-span commit failed for shuffle=%d "
                            "reduce=%d; serving via pull",
                            shuffle_id, reduce_id, exc_info=True,
                        )
                        st.payloads = []
                        st.seg = None
            if st.seg is None:
                return (0, 0, ())
            return (st.seg.mkey, st.length, st.provenance)

    def _commit_locked(self, st: _ReduceMerge, shuffle_id: int) -> None:
        """Commit the completed payloads as one registered merged span —
        the resolver's file-backed commit shape: stream to a spill file,
        adopt into the tier store when one is wired (deferred mapping,
        disk-resident cold tier), else register the read-only mmap."""
        from sparkrdma_tpu_torch.memory.mapped_file import MappedFile

        prov: List[ProvRow] = []
        off = 0
        for map_id, payload in st.payloads:
            prov.append((map_id, off, len(payload)))
            off += len(payload)
        tiered = self.tier_store is not None
        mf = MappedFile(
            (payload for _m, payload in st.payloads),
            directory=self.spill_dir,
            prefix="sparkrdma_tpu_merged_",
            direct_write=self.direct_io != "off",
            defer_map=tiered,
        )
        mf.direct_read_enabled = self.direct_io != "off"
        try:
            if tiered:
                seg = self.tier_store.adopt(
                    mf, [(o, n) for _m, o, n in prov], max(off, 1),
                    shuffle_id, self.arena,
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
        st.seg = seg
        st.length = off
        st.provenance = tuple(prov)
        st._transition("committed", frm="sealed")
        # assembled payloads now live in the committed file
        st.payloads = []

    # -- lifecycle ----------------------------------------------------------
    def remove_shuffle(self, shuffle_id: int) -> None:
        """Release one shuffle's merged segments + assembly state.  Runs
        BEFORE the resolver's ``remove_shuffle`` in the manager's sweep,
        so ``arena.release_shuffle`` never finds these twice."""
        with self._lock:
            states = self._shuffles.pop(shuffle_id, None)
        if not states:
            return
        for st in states.values():
            seg = st.seg
            st.seg = None
            if seg is None:
                continue
            if self.node is not None:
                self.node.unregister_block_store(seg.mkey)
            self.arena.release(seg.mkey)

    def stop(self) -> None:
        with self._lock:
            ids = list(self._shuffles.keys())
        for sid in ids:
            self.remove_shuffle(sid)
