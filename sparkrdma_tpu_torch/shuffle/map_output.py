"""Per-map-task output location table with partial-fill futures.

Analog of the reference's RdmaMapTaskOutput (RdmaMapTaskOutput.scala:26-104):
a compact off-object index of one 16-byte entry ``(address: i64, length: i32,
mkey: i32)`` per reduce partition, supporting partial fills with a
completion future so the driver can await full publication before
answering fetch-status queries (the reference's ``fillFuture``).

Backed by one contiguous ``bytearray`` rather than per-entry objects so a
100k-partition table costs 1.6 MB, not millions of boxed tuples.

Delta sync: the writer side tracks which entries changed since the last
publish (``take_delta`` returns epoch-tagged dirty runs), so a
REpublish after a location change ships O(changed) entry bytes instead
of the whole table — at 256-executor fan-out the driver's publish
inbox scales with churn, not fleet size.  The driver side applies
segments with a per-entry epoch guard (``put_range``'s ``epoch``), so
segments of different publishes may land out of order (the receive
dispatcher is a pool) without a stale segment clobbering newer
locations.
"""

from __future__ import annotations

from array import array
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Tuple

from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.types import (
    LOCATION_ENTRY_SIZE,
    BlockLocation,
    _LOCATION_STRUCT,
)


class MapTaskOutput:
    """Location table for one map task: partitions [0, num_partitions)."""

    def __init__(self, num_partitions: int):
        if num_partitions <= 0:
            raise ValueError(f"num_partitions must be > 0: {num_partitions}")
        self.num_partitions = num_partitions
        self._buf = bytearray(num_partitions * LOCATION_ENTRY_SIZE)
        # distinct-partition fill tracking: re-delivered publish segments
        # (RPC retries, overlapping ranges) must not double-count
        self._filled_flags = bytearray(num_partitions)  # guarded-by: _lock
        self._filled = 0  # guarded-by: _lock
        # entries changed since the last take_delta (writer-side
        # publish cursor; 1 byte per partition like the fill flags)
        self._dirty = bytearray(num_partitions)  # guarded-by: _lock
        self._publish_epoch = 0  # guarded-by: _lock
        # receiver-side per-entry applied epoch, allocated lazily on
        # the first epoch-tagged segment (> 0): single-publish tables —
        # the overwhelmingly common case — never pay the 4B/partition
        self._entry_epochs: Optional[array] = None  # guarded-by: _lock
        self._lock = dbg_lock("map_output.fill", 36)
        self._fill_future: Future = Future()

    # -- write side ---------------------------------------------------------
    def put(self, partition_id: int, location: BlockLocation) -> None:
        self._check_range(partition_id, partition_id)
        _LOCATION_STRUCT.pack_into(
            self._buf,
            partition_id * LOCATION_ENTRY_SIZE,
            location.address,
            location.length,
            location.mkey,
        )
        self._mark_filled(partition_id, partition_id)

    def put_range(self, first: int, last: int, raw: bytes,
                  epoch: int = 0) -> None:
        """Install serialized entries for partitions [first, last]
        (inclusive), e.g. one segment of a publish RPC
        (reference: RdmaMapTaskOutput.putRange).

        ``epoch`` is the sender's publish generation: segments of a
        later publish carry a higher epoch, and an entry is only
        overwritten by a segment of equal-or-newer epoch — so a delta
        republish racing (or re-delivered after) the original full
        publish through the dispatcher pool can never be clobbered by
        the stale full-range entries."""
        self._check_range(first, last)
        n = last - first + 1
        expect = n * LOCATION_ENTRY_SIZE
        if len(raw) != expect:
            raise ValueError(f"putRange payload {len(raw)}B != expected {expect}B")
        start = first * LOCATION_ENTRY_SIZE
        with self._lock:
            if epoch > 0 and self._entry_epochs is None:
                self._entry_epochs = array(
                    "i", bytes(4 * self.num_partitions)
                )
            eps = self._entry_epochs
            if eps is None:
                # no epoch-tagged segment ever seen: bulk fast path
                self._buf[start : start + expect] = raw
            elif epoch >= max(eps[first : last + 1]):
                # whole segment passes the guard (the common case —
                # in-order delivery): one bulk copy, not a 16-byte
                # slice-assign per entry on the RPC dispatch thread
                self._buf[start : start + expect] = raw
                eps[first : last + 1] = array("i", [epoch]) * n
            else:
                for i in range(n):
                    p = first + i
                    if epoch >= eps[p]:
                        eps[p] = epoch
                        lo = p * LOCATION_ENTRY_SIZE
                        ro = i * LOCATION_ENTRY_SIZE
                        self._buf[lo : lo + LOCATION_ENTRY_SIZE] = (
                            raw[ro : ro + LOCATION_ENTRY_SIZE]
                        )
        self._mark_filled(first, last)

    def take_delta(self) -> Tuple[int, List[Tuple[int, int, bytes]]]:
        """Pop the entries changed since the last call as contiguous
        ``(first, last, raw)`` runs, tagged with this publish's epoch —
        the delta-sync publish cursor.  The first call after a fresh
        commit returns the whole table (everything is dirty); a later
        call after relocating a few blocks returns just those runs, so
        republish bytes scale with churn, not partition count."""
        with self._lock:
            d = self._dirty
            runs: List[Tuple[int, int]] = []
            pos = 0
            while True:
                lo = d.find(b"\x01", pos)
                if lo < 0:
                    break
                hi = d.find(b"\x00", lo + 1)
                if hi < 0:
                    hi = self.num_partitions
                runs.append((lo, hi - 1))
                pos = hi
            epoch = self._publish_epoch
            if not runs:
                return epoch, []
            d[:] = bytes(self.num_partitions)
            self._publish_epoch += 1
            out = [
                (
                    lo, hi,
                    bytes(self._buf[
                        lo * LOCATION_ENTRY_SIZE:
                        (hi + 1) * LOCATION_ENTRY_SIZE
                    ]),
                )
                for lo, hi in runs
            ]
        return epoch, out

    def ensure_capacity(self, num_partitions: int) -> None:
        """Grow the table to at least ``num_partitions`` rows (never
        shrinks).  Skew-split map outputs publish EXTRA sub-block rows
        past the logical partition count, but the driver may have
        pre-created this table at the logical size from an early
        fetch-status query — the publish handler calls this with the
        sender's row count before installing segments, so the fill
        threshold is raised to the extended count BEFORE any row can
        land (a table must never complete at the narrow size and then
        widen)."""
        with self._lock:
            extra = num_partitions - self.num_partitions
            if extra <= 0:
                return
            # replace rather than resize in place: readers snapshot
            # memoryview(self._buf) outside the lock, and resizing a
            # bytearray with a live export raises BufferError
            buf = bytearray(num_partitions * LOCATION_ENTRY_SIZE)
            buf[: len(self._buf)] = self._buf
            self._buf = buf
            self._filled_flags = self._filled_flags + bytes(extra)
            self._dirty = self._dirty + bytes(extra)
            if self._entry_epochs is not None:
                self._entry_epochs = self._entry_epochs + array(
                    "i", bytes(4 * extra)
                )
            self.num_partitions = num_partitions

    def mark_dirty(self, first: int, last: int) -> None:
        """Re-flag [first, last] for the next ``take_delta`` — the
        publish path calls this from a send-failure callback so a
        delta run lost on the wire is re-shipped (at a newer epoch) by
        the next publish instead of staying stale forever."""
        self._check_range(first, last)
        with self._lock:
            self._dirty[first : last + 1] = b"\x01" * (last - first + 1)

    def _mark_filled(self, first: int, last: int) -> None:
        n = last - first + 1
        with self._lock:
            # dirty tracking rides the fill path: put() and put_range()
            # both funnel here AFTER the entry bytes are in _buf, so a
            # concurrent take_delta never snapshots a half-written run
            self._dirty[first : last + 1] = b"\x01" * n
            already = self._filled_flags.count(1, first, last + 1)
            complete = False
            if already < n:
                self._filled_flags[first : last + 1] = b"\x01" * n
                self._filled += n - already
                complete = self._filled >= self.num_partitions
        if complete:
            # OUTSIDE the lock: set_result runs done-callbacks inline
            # (the driver's window-plan retrigger takes manager locks
            # ranked far ABOVE this leaf) — firing it under _lock was a
            # latent order inversion, caught by the rank sanitizer.
            # Only the thread that crossed the threshold gets here
            # (fills are monotonic under _lock), so the only possible
            # race is remove_executor's set_exception — tolerate it the
            # same way it tolerates us.
            try:
                self._fill_future.set_result(self)
            except InvalidStateError:
                pass  # lost the race; the failed future stands

    # -- read side ----------------------------------------------------------
    def get_location(self, partition_id: int) -> BlockLocation:
        self._check_range(partition_id, partition_id)
        return BlockLocation.read(
            memoryview(self._buf), partition_id * LOCATION_ENTRY_SIZE
        )

    def get_locations(self, first: int, last: int) -> List[BlockLocation]:
        self._check_range(first, last)
        view = memoryview(self._buf)
        return [
            BlockLocation.read(view, p * LOCATION_ENTRY_SIZE)
            for p in range(first, last + 1)
        ]

    def get_range_bytes(self, first: int, last: int) -> bytes:
        """Raw serialized entries for [first, last] inclusive — the publish
        RPC's segment payload (reference: getByteBuffer range slices)."""
        self._check_range(first, last)
        return bytes(
            self._buf[first * LOCATION_ENTRY_SIZE : (last + 1) * LOCATION_ENTRY_SIZE]
        )

    @property
    def fill_future(self) -> Future:
        """Resolves once every partition entry has been installed."""
        return self._fill_future

    @property
    def is_complete(self) -> bool:
        return self._fill_future.done()

    def total_bytes(self) -> int:
        view = memoryview(self._buf)
        return sum(
            _LOCATION_STRUCT.unpack_from(view, p * LOCATION_ENTRY_SIZE)[1]
            for p in range(self.num_partitions)
        )

    def _check_range(self, first: int, last: int) -> None:
        if not (0 <= first <= last < self.num_partitions):
            raise IndexError(
                f"partition range [{first},{last}] out of bounds "
                f"[0,{self.num_partitions})"
            )
