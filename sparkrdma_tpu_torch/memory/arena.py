"""Arena registry: registered device segments serving block reads.  The
port of ``sparkrdma_tpu/memory/arena.py``.

The device-side half of the memory layer.  Where the reference mmaps a
shuffle data file in ≥write-block-size chunks and registers each chunk as
an ibverbs MR (RdmaMappedFile.java:95-171), here a map task's serialized
output is staged into one or more ``DeviceSegment``s — 1-D uint8 tensors
resident on the card (or numpy arrays on the host) — each tagged with an
``mkey``.  A ``BlockLocation``
then addresses (mkey, byte offset, length) exactly like the reference's
(mkey, address, length) triple.

``ArenaManager`` is the per-process registry: it assigns mkeys, accounts
bytes against ``max_buffer_allocation_size``, serves one-sided reads
(``BlockStore``), and releases segments when a shuffle is unregistered
(dispose path, RdmaMappedFile.java:189-199).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.metrics import NULL_COUNTER, counter, gauge, get_registry
from sparkrdma_tpu_torch.transport.channel import BlockStore, TransportError
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.types import BlockLocation


def _host_copy(x) -> np.ndarray:
    """A host numpy copy of a tensor slice (a device->host copy on a
    card), or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def _dtype_name(array) -> str:
    """``uint8``, ``float32``, ... for a tensor or an array."""
    return str(array.dtype).removeprefix("torch.")


class DeviceSegment:
    """One registered segment (a 1-D uint8 tensor on the device, or a
    numpy array on the host).

    ``keepalive`` holds an underlying host buffer until the segment is
    released; its ``free()`` is called exactly once on release."""

    def __init__(self, mkey: int, array, shuffle_id: Optional[int] = None,
                 keepalive=None, budgeted: bool = True,
                 zero_copy_ok: bool = False):
        self.mkey = mkey
        self.array = array  # torch uint8[nbytes] (or np.ndarray on host)
        self.nbytes = int(array.shape[0])
        self.shuffle_id = shuffle_id
        self.keepalive = keepalive
        self.budgeted = budgeted
        self.zero_copy_ok = zero_copy_ok
        self.created_at = time.monotonic()
        # bytes this segment's tensor copied to the host (set by the
        # registering ArenaManager for tensor segments)
        self.read_meter = NULL_COUNTER

    def _release_keepalive(self) -> None:
        ka, self.keepalive = self.keepalive, None
        if ka is not None:
            try:
                ka.free()
            except Exception:
                pass

    def read(self, offset: int, length: int):
        """Serve one block.  Host-resident segments (plain numpy or
        mmap) return a ZERO-COPY read-only view — safe because the view
        keeps the backing buffer alive by refcount after release (the
        reference's zero-copy DirectByteBuffer serving,
        RdmaMappedFile.java:225-229).  Device segments materialize a
        host copy (the device→host transfer is the copy).  Pool-backed
        host buffers must NOT be registered with ``zero_copy_ok`` —
        the pool reuses freed memory under live views."""
        end = offset + length
        if offset < 0 or end > self.nbytes:
            raise TransportError(
                f"read [{offset},{end}) outside segment mkey={self.mkey} "
                f"of {self.nbytes}B"
            )
        if self.zero_copy_ok:
            ka = self.keepalive
            if length >= DIRECT_READ_MIN and hasattr(ka, "pread"):
                # big file-backed blocks read O_DIRECT: buffered mmap
                # faults are writeback/readahead-throttled on
                # virtualized hosts (~5x slower — memory/direct_io.py)
                got = ka.pread(offset, length)
                if got is not None:
                    return got
            view = self.array[offset:end].view()
            view.flags.writeable = False
            return view
        self.read_meter.inc(length)
        return bytes(_host_copy(self.array[offset:end]))

    def read_many(self, spans):
        """Serve many ``(offset, length)`` blocks with batched
        device→host transfers (a per-block ``read`` costs a device
        slice and a host round trip EACH).  Spans cluster
        by proximity (:func:`_read_spans_clustered`) so one transfer
        covers each dense run while large gaps are skipped.  Host
        segments keep the per-span zero-copy views."""
        if not spans:
            return []
        lo = min(o for o, _l in spans)
        hi = max(o + _l for o, _l in spans)
        if lo < 0 or hi > self.nbytes:
            raise TransportError(
                f"read_many [{lo},{hi}) outside segment "
                f"mkey={self.mkey} of {self.nbytes}B"
            )
        if isinstance(self.array, np.ndarray):
            return [self.read(o, l) for o, l in spans]

        def fetch(a, b):
            self.read_meter.inc(b - a)
            return _host_copy(self.array[a:b])

        return _read_spans_clustered(spans, fetch)


# read_many clusters spans whose gaps exceed this: a sparse batch (two
# small blocks at opposite ends of a big segment) must not materialize
# the whole gap to host
READ_MANY_MAX_GAP = 8 << 20

# blocks at least this large take the O_DIRECT pread path on
# file-backed segments; smaller ones stay zero-copy mmap views
DIRECT_READ_MIN = 1 << 20


def _read_spans_clustered(spans, fetch):
    """Serve ``(offset, length)`` spans via ``fetch(lo, hi)`` range
    reads, one per proximity cluster (gaps above READ_MANY_MAX_GAP are
    skipped rather than transferred).  Returns blocks in input order —
    as zero-copy CHUNK VIEWS of each cluster's landed buffer (the view
    keeps the cluster alive by refcount; re-materializing every block
    as ``bytes`` doubled the serve path's copies)."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out: list = [b""] * len(spans)
    cluster: list = []
    cend = 0

    def flush():
        if not cluster:
            return
        clo = spans[cluster[0]][0]
        chi = max(spans[i][0] + spans[i][1] for i in cluster)
        buf = fetch(clo, chi)
        for i in cluster:
            o, ln = spans[i]
            out[i] = buf[o - clo : o - clo + ln]
        cluster.clear()

    for i in order:
        o, ln = spans[i]
        if cluster and o - cend > READ_MANY_MAX_GAP:
            flush()
        cluster.append(i)
        cend = max(cend, o + ln)
    flush()
    return out


class ArenaSpanSegment:
    """A registered span of the persistent per-device arena
    (memory/device_arena.py) — the collective read plane's MR analog.
    Duck-types DeviceSegment for the ArenaManager bookkeeping; the
    coordinator recognizes it via its ``span`` attribute and resolves
    block locations to absolute arena offsets."""

    __slots__ = ("mkey", "span", "nbytes", "shuffle_id", "budgeted",
                 "zero_copy_ok", "keepalive")

    def __init__(self, mkey: int, span, shuffle_id: Optional[int] = None):
        self.mkey = mkey
        self.span = span
        self.nbytes = span.nbytes
        self.shuffle_id = shuffle_id
        self.budgeted = True
        self.zero_copy_ok = False
        self.keepalive = None

    def _release_keepalive(self) -> None:
        self.span.free()

    def read(self, offset: int, length: int) -> bytes:
        end = offset + length
        if offset < 0 or end > self.nbytes:
            raise TransportError(
                f"read [{offset},{end}) outside arena span mkey={self.mkey} "
                f"of {self.nbytes}B"
            )
        return self.span.arena.read(self.span.offset + offset, length)

    def read_many(self, spans):
        """Clustered arena reads, sliced per block (see
        DeviceSegment.read_many)."""
        if not spans:
            return []
        lo = min(o for o, _l in spans)
        hi = max(o + _l for o, _l in spans)
        if lo < 0 or hi > self.nbytes:
            raise TransportError(
                f"read_many [{lo},{hi}) outside arena span "
                f"mkey={self.mkey} of {self.nbytes}B"
            )
        base = self.span.offset
        return _read_spans_clustered(
            spans,
            lambda a, b: memoryview(
                self.span.arena.read(base + a, b - a)
            ),
        )


class ArenaManager(BlockStore):
    """Per-process registry of device segments, keyed by mkey."""

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = max_bytes
        self._segments: Dict[int, DeviceSegment] = {}  # guarded-by: _lock
        self._lock = dbg_lock("arena.segments", 82)
        self._next_mkey = 1  # 0 is reserved for BlockLocation.EMPTY
        self._total_bytes = 0  # guarded-by: _lock
        # resource: arena.registered_bytes (device + file segment bytes)
        self._tickets: Dict[int, object] = {}  # guarded-by: _lock
        # unbudgeted (file-backed mmap) segment bytes
        self._file_bytes = 0  # guarded-by: _lock
        # stats
        self._registered_ever = 0
        self._released_ever = 0
        self._m_registered = counter("arena_segments_registered_total")
        self._m_released = counter("arena_segments_released_total")
        self._m_alloc_failed = counter("arena_alloc_failures_total")
        # process-wide gauge shared by every ArenaManager: mutate by
        # DELTA so in-process driver+executor arenas aggregate
        self._m_bytes = gauge("arena_registered_bytes")
        # always on: the device-to-host bytes reads of tensor segments
        # copy (the fetch side of a device-staged shuffle)
        self._m_device_read = get_registry().counter(
            "arena_device_read_bytes_total", force=True
        )

    def register(self, array, shuffle_id: Optional[int] = None,
                 keepalive=None, budgeted: bool = True,
                 zero_copy_ok: bool = False) -> DeviceSegment:
        """Register a 1-D uint8 array as a readable segment.

        ``budgeted=False`` registers without debiting the byte budget —
        for file-backed (mmap) segments whose pages live in the OS
        cache, not the arena's memory (their bytes are tracked in the
        ``file_bytes`` stat instead).

        ``zero_copy_ok`` lets reads serve views into ``array`` — ONLY
        safe when the backing memory is never recycled while Python
        references exist (plain numpy buffers, read-only mmaps; NOT
        pooled staging buffers)."""
        if array.ndim != 1 or _dtype_name(array) != "uint8":
            raise ValueError(
                f"segments must be 1-D uint8, got {tuple(array.shape)} "
                f"{_dtype_name(array)}"
            )
        nbytes = int(array.shape[0])
        with self._lock:
            if (budgeted and self.max_bytes
                    and self._total_bytes + nbytes > self.max_bytes):
                self._m_alloc_failed.inc()
                raise MemoryError(
                    f"arena budget exhausted: {self._total_bytes + nbytes}B > "
                    f"{self.max_bytes}B"
                )
            mkey = self._next_mkey
            self._next_mkey += 1
            seg = DeviceSegment(mkey, array, shuffle_id, keepalive=keepalive,
                                budgeted=budgeted, zero_copy_ok=zero_copy_ok)
            if isinstance(array, torch.Tensor):
                seg.read_meter = self._m_device_read
            self._segments[mkey] = seg
            if budgeted:
                self._total_bytes += nbytes
            else:
                self._file_bytes += nbytes
            self._registered_ever += 1
            # the segment's byte reservation rides the registry until an
            # unregister path settles it
            # owns: arena.registered_bytes -> release
            # owns: arena.registered_bytes -> release_shuffle
            # owns: arena.registered_bytes -> stop
            # owns: arena.registered_bytes -> replace_with_span
            self._tickets[mkey] = ledger_acquire(
                "arena.registered_bytes", nbytes
            )  # acquires: arena.registered_bytes
        self._m_registered.inc()
        self._m_bytes.inc(nbytes)
        return seg

    def register_external(self, seg):
        """Register a segment whose storage this arena does NOT manage
        (the tiered block store's file-backed segments, memory/tier.py):
        assigns the mkey, tracks the bytes in the ``file_bytes`` stat
        (never the arena byte budget — the data lives on disk / in
        pooled hot rows the tier itself budgets), and dispatches reads
        to the segment like any other.  ``seg`` must duck-type
        DeviceSegment (nbytes / shuffle_id / budgeted=False /
        read / read_many / _release_keepalive)."""
        with self._lock:
            mkey = self._next_mkey
            self._next_mkey += 1
            seg.mkey = mkey
            self._segments[mkey] = seg
            self._file_bytes += seg.nbytes
            self._registered_ever += 1
            # owns: arena.registered_bytes -> release
            self._tickets[mkey] = ledger_acquire(
                "arena.registered_bytes", seg.nbytes
            )  # acquires: arena.registered_bytes
        self._m_registered.inc()
        self._m_bytes.inc(seg.nbytes)
        return seg

    def register_arena_span(self, span, shuffle_id: Optional[int] = None
                            ) -> ArenaSpanSegment:
        """Register an allocated device-arena span as a readable
        segment (its device memory is real, so it debits the byte budget; the
        span is freed back to its arena on release)."""
        with self._lock:
            if (self.max_bytes
                    and self._total_bytes + span.nbytes > self.max_bytes):
                self._m_alloc_failed.inc()
                raise MemoryError(
                    f"arena budget exhausted: "
                    f"{self._total_bytes + span.nbytes}B > {self.max_bytes}B"
                )
            mkey = self._next_mkey
            self._next_mkey += 1
            seg = ArenaSpanSegment(mkey, span, shuffle_id)
            self._segments[mkey] = seg
            self._total_bytes += seg.nbytes
            self._registered_ever += 1
            # owns: arena.registered_bytes -> release
            self._tickets[mkey] = ledger_acquire(
                "arena.registered_bytes", seg.nbytes
            )  # acquires: arena.registered_bytes
        self._m_registered.inc()
        self._m_bytes.inc(seg.nbytes)
        return seg

    def replace_with_span(self, mkey: int, span
                          ) -> Optional[ArenaSpanSegment]:
        """Swap a host-resident segment for a device-arena span under
        the SAME mkey — the on-demand registration step of the lazy
        staging (ODP) path: published BlockLocations keep working
        because the mkey never changes.  Returns the new segment, or
        None (freeing ``span``) when the mkey is gone."""
        with self._lock:
            old = self._segments.get(mkey)
            if old is None:
                released = None
            else:
                freed = old.nbytes if old.budgeted else 0
                if (self.max_bytes and self._total_bytes - freed
                        + span.nbytes > self.max_bytes):
                    self._m_alloc_failed.inc()
                    raise MemoryError(
                        f"arena budget exhausted staging mkey={mkey}: "
                        f"{self._total_bytes - freed + span.nbytes}B > "
                        f"{self.max_bytes}B"
                    )
                seg = ArenaSpanSegment(mkey, span, old.shuffle_id)
                self._segments[mkey] = seg
                if old.budgeted:
                    self._total_bytes -= old.nbytes
                else:
                    self._file_bytes -= old.nbytes
                self._total_bytes += seg.nbytes
                released = old
                old_tkt = self._tickets.pop(mkey, NOOP_TICKET)
                # owns: arena.registered_bytes -> release
                self._tickets[mkey] = ledger_acquire(
                    "arena.registered_bytes", seg.nbytes
                )  # acquires: arena.registered_bytes
        if released is None:
            span.free()
            return None
        self._m_bytes.inc(seg.nbytes - released.nbytes)
        old_tkt.release()  # releases: arena.registered_bytes
        released._release_keepalive()
        return seg

    def get(self, mkey: int) -> Optional[DeviceSegment]:
        with self._lock:
            return self._segments.get(mkey)

    def release(self, mkey: int) -> None:
        with self._lock:
            seg = self._segments.pop(mkey, None)
            if seg is not None:
                if seg.budgeted:
                    self._total_bytes -= seg.nbytes
                else:
                    self._file_bytes -= seg.nbytes
                self._released_ever += 1
            tkt = self._tickets.pop(mkey, NOOP_TICKET)
        if seg is not None:
            self._m_released.inc()
            self._m_bytes.dec(seg.nbytes)
            tkt.release()  # releases: arena.registered_bytes
            seg._release_keepalive()

    def release_shuffle(self, shuffle_id: int) -> int:
        """Release all segments belonging to one shuffle (unregister path,
        reference: RdmaShuffleManager.unregisterShuffle → dispose)."""
        with self._lock:
            doomed = [k for k, s in self._segments.items()
                      if s.shuffle_id == shuffle_id]
            segs = [self._segments.pop(k) for k in doomed]
            tkts = [self._tickets.pop(k, NOOP_TICKET) for k in doomed]
            for seg in segs:
                if seg.budgeted:
                    self._total_bytes -= seg.nbytes
                else:
                    self._file_bytes -= seg.nbytes
                self._released_ever += 1
        if segs:
            self._m_released.inc(len(segs))
            self._m_bytes.dec(sum(s.nbytes for s in segs))
        for tkt in tkts:
            tkt.release()  # releases: arena.registered_bytes
        for seg in segs:
            seg._release_keepalive()
        return len(segs)

    # -- BlockStore ---------------------------------------------------------
    def read_block(self, location: BlockLocation) -> bytes:
        seg = self.get(location.mkey)
        if seg is None:
            raise TransportError(f"no segment registered for mkey={location.mkey}")
        return seg.read(location.address, location.length)

    def read_blocks(self, locations) -> list:
        """Serve many blocks, batching per backing segment
        (``Segment.read_many``: one device→host transfer per segment
        instead of per block — the one-sided READ service groups
        fetches, and a grouped fetch usually hits one map segment)."""
        by_key: Dict[int, list] = {}
        for i, loc in enumerate(locations):
            by_key.setdefault(loc.mkey, []).append(i)
        out: list = [b""] * len(locations)
        for mkey, idxs in by_key.items():
            seg = self.get(mkey)
            if seg is None:
                raise TransportError(
                    f"no segment registered for mkey={mkey}"
                )
            blocks = seg.read_many(
                [(locations[i].address, locations[i].length)
                 for i in idxs]
            )
            for i, b in zip(idxs, blocks):
                out[i] = b
        return out

    # -- stats --------------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "segments": len(self._segments),
                "total_bytes": self._total_bytes,
                "file_bytes": self._file_bytes,
                "registered_ever": self._registered_ever,
                "released_ever": self._released_ever,
            }

    def stop(self) -> None:
        with self._lock:
            segs = list(self._segments.values())
            self._segments.clear()
            tkts = list(self._tickets.values())
            self._tickets.clear()
            self._total_bytes = 0
            self._file_bytes = 0
        if segs:
            self._m_released.inc(len(segs))
            self._m_bytes.dec(sum(s.nbytes for s in segs))
        for tkt in tkts:
            tkt.release()  # releases: arena.registered_bytes
        for seg in segs:
            seg._release_keepalive()
