"""Persistent per-device arenas: the registered-MR pool the collective
data plane reads from.  The port of ``sparkrdma_tpu/memory/device_arena.py``.

The reference registers each shuffle file's chunks as ibverbs MRs and
reducers pull byte ranges with one-sided READs against (addr, len, key)
(RdmaMappedFile.java:95-171, RdmaChannel.java:441-474).  The analog
here: ONE persistent uint8 device tensor per executor device — commits
sub-allocate spans and copy their bytes in place into the arena's rows
— so every committed block on a device is addressable as (arena,
offset, length).

Allocation is a first-fit free list with coalescing (the
RdmaBufferManager role for device memory); writes are padded to the
span's size class, as in the JAX package (where the classes bound the
number of compiled update programs; here they keep the two packages'
arenas byte for byte alike).

Host memory on a card is pinned (:func:`host_bytes`): a write stages
its bytes in a pinned buffer and copies them in with ``non_blocking``
(the caching host allocator keeps the buffer until the copy has
landed), and a read is a copy back on the same stream, so it never
races a pending write.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock

WRITE_ALIGN = 4096  # commit padding granularity (4 KiB, the mmap analog)


def _size_class(nbytes: int) -> int:
    """Span size class >= WRITE_ALIGN: the next {2^k, 1.5*2^k} value
    (shared by alloc and write).  Two classes per octave cap allocation
    waste at ~33%."""
    n = int(nbytes)
    if n <= WRITE_ALIGN:
        return WRITE_ALIGN
    p = 1 << (n - 1).bit_length()  # next pow2
    threeq = (p >> 1) + (p >> 2)   # 1.5*(p/2) = 0.75*p
    if n <= threeq and threeq % WRITE_ALIGN == 0:
        return threeq
    return p


def host_bytes(device: torch.device, shape) -> torch.Tensor:
    """A uint8 host buffer for copies to and from ``device``: pinned on
    a card, where the caching host allocator also hands the same
    resident pages to the next caller (a fresh ``np.empty`` faults
    every page in again on first touch); plain memory on the CPU."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


# gather granularity of the collective read plane: block offsets within
# an arena must be multiples of this; WRITE_ALIGN is a multiple, so span
# starts are always row-aligned
ROW_BYTES = 128


class ArenaSpan:
    """One allocated byte range of a device arena."""

    __slots__ = ("arena", "offset", "nbytes", "freed")

    def __init__(self, arena: "DeviceArena", offset: int, nbytes: int):
        self.arena = arena
        self.offset = offset
        self.nbytes = nbytes
        self.freed = False

    def free(self) -> None:
        self.arena.free(self)


class DeviceArena:
    """One persistent uint8 tensor ``[rows, ROW_BYTES]`` on a single
    device (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, capacity: int, device: DeviceLike = None):
        capacity = (capacity + WRITE_ALIGN - 1) // WRITE_ALIGN * WRITE_ALIGN
        self.capacity = capacity
        self.rows = capacity // ROW_BYTES
        self.device = resolve_device(device)
        self.array = torch.zeros((self.rows, ROW_BYTES), dtype=torch.uint8,
                                 device=self.device)
        self._lock = dbg_lock("device_arena.free_list", 80)
        # first-fit free list: sorted non-adjacent (offset, nbytes)
        self._free: List[Tuple[int, int]] = [(0, capacity)]  # guarded-by: _lock
        self.allocated_bytes = 0
        self.peak_bytes = 0
        self.writes = 0

    # -- allocation ---------------------------------------------------------
    def alloc(self, nbytes: int) -> ArenaSpan:
        """First-fit allocate a size-classed span (the buffer-manager
        size classes, RdmaBufferManager.java:88,135-147)."""
        need = _size_class(nbytes)
        with self._lock:
            for i, (off, size) in enumerate(self._free):
                if size >= need:
                    if size == need:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + need, size - need)
                    self.allocated_bytes += need
                    self.peak_bytes = max(self.peak_bytes, self.allocated_bytes)
                    return ArenaSpan(self, off, need)
        raise MemoryError(
            f"device arena exhausted: need {need}B, "
            f"{self.capacity - self.allocated_bytes}B free (fragmented)"
        )

    def free(self, span: ArenaSpan) -> None:
        with self._lock:
            if span.freed:
                return
            span.freed = True
            self.allocated_bytes -= span.nbytes
            # insert sorted + coalesce with neighbors
            entry = (span.offset, span.nbytes)
            lo, hi = 0, len(self._free)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._free[mid][0] < entry[0]:
                    lo = mid + 1
                else:
                    hi = mid
            self._free.insert(lo, entry)
            i = max(0, lo - 1)
            while i < len(self._free) - 1:
                off, size = self._free[i]
                noff, nsize = self._free[i + 1]
                if off + size == noff:
                    self._free[i] = (off, size + nsize)
                    self._free.pop(i + 1)
                else:
                    if i >= lo:
                        break
                    i += 1

    # -- data movement ------------------------------------------------------
    def write(self, span: ArenaSpan, data: np.ndarray) -> None:
        """Write host bytes into the span: an in-place copy into the
        arena's rows, the data zero-padded to the next size class within
        the span (as the JAX package's donated update writes it).  On a
        card the bytes go through a pinned buffer, asynchronously."""
        n = int(data.shape[0])
        if n > span.nbytes:
            raise ValueError(f"write of {n}B exceeds span of {span.nbytes}B")
        chunk_n = min(span.nbytes, _size_class(n))
        host = host_bytes(self.device, chunk_n)
        staged = host.numpy()
        staged[:n] = data
        staged[n:] = 0
        r0 = span.offset // ROW_BYTES
        with self._lock:
            self.writes += 1
            self.array[r0:r0 + chunk_n // ROW_BYTES].copy_(
                host.view(-1, ROW_BYTES), non_blocking=True)

    def read(self, offset: int, length: int) -> bytes:
        """Host read: one device->host copy of just the covering row
        range into pinned memory on a card, on the stream the writes ran
        on (so after them), under the arena lock."""
        end = offset + length
        if offset < 0 or end > self.capacity:
            raise ValueError(
                f"read [{offset},{end}) outside arena of {self.capacity}B"
            )
        r0 = offset // ROW_BYTES
        r1 = (end + ROW_BYTES - 1) // ROW_BYTES
        host = host_bytes(self.device, (r1 - r0) * ROW_BYTES)
        with self._lock:
            host.copy_(self.array[r0:r1].reshape(-1))
        lo = offset - r0 * ROW_BYTES
        return bytes(host.numpy()[lo : lo + length])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "allocated_bytes": self.allocated_bytes,
                "peak_bytes": self.peak_bytes,
                "free_extents": len(self._free),
                "writes": self.writes,
            }


class DeviceStagingBridge:
    """Staging rows -> device tensors: the H2D seam of the device-native
    exchange.

    The reference stages shuffle bytes through registered MRs so the
    NIC can DMA them without a bounce copy (RdmaBuffer /
    RdmaBufferManager).  On a card the analog of registered memory is
    pinned host memory: :meth:`alloc_row` hands out pinned rows, which
    :meth:`to_device` copies at the link's rate (a pageable row goes
    through a bounce buffer at a fraction of it).  Counter
    ``device_exchange_h2d_bytes_avoided_total`` tracks the host fill
    traffic the padded layout eliminated.  On the CPU rows are plain
    numpy.

    ``pool`` (a :class:`~sparkrdma_tpu_torch.memory.staging.StagingPool`)
    makes :meth:`alloc_row` hand out pooled rows instead, as the JAX
    bridge does: recycled when the last view of them dies, and plain
    numpy (counted under ``exchange_row_pool_fallbacks_total``) when the
    pool's budget is spent.  Pool rows are pageable host memory, so on a
    card a copy to or from one runs through the driver's bounce buffer;
    the read planes keep pinned rows there (``shuffle/bulk.py``).

    Framing helper ``as_words`` keeps the layout rule in ONE place:
    rows are uint8, lane-aligned to the exchange's ``TILE_ALIGN``, and
    reinterpreted as 4-byte words for the collective.
    """

    WORD = 4  # collective element width: 4-byte words over uint8 lanes

    def __init__(self, device: DeviceLike = None, pool=None):
        self.device = resolve_device(device)
        self.pool = pool

    # -- framing ------------------------------------------------------------
    @staticmethod
    def as_words(row: np.ndarray):
        """Reinterpret a lane-aligned uint8 row as uint32 words, or None
        when its size or base address defeats the 4-byte view — callers
        then ship uint8."""
        if row.nbytes % DeviceStagingBridge.WORD:
            return None
        if row.ctypes.data % DeviceStagingBridge.WORD:
            return None
        try:
            return row.view(np.uint32)
        except ValueError:
            return None

    # -- staging rows -------------------------------------------------------
    def alloc_row(self, nbytes: int) -> np.ndarray:
        """One uint8 staging row of ``nbytes``: a pooled row when the
        bridge has a pool, else pinned on a card (a numpy view that
        keeps its pinned tensor alive) and plain numpy on the CPU."""
        if self.pool is not None:
            from sparkrdma_tpu_torch.memory.staging import alloc_row_gc

            return alloc_row_gc(
                self.pool, nbytes, "exchange_row_pool_fallbacks_total"
            )
        if nbytes <= 0:
            return np.empty(0, np.uint8)
        return host_bytes(self.device, nbytes).numpy()

    # -- H2D ---------------------------------------------------------------
    def to_device(self, row: np.ndarray, device,
                  avoided_bytes: int = 0, out=None) -> torch.Tensor:
        """Copy one host row onto ``device`` (into ``out`` when given, a
        device tensor of the row's size and type); returns the device
        tensor (a copy, never a view of ``row``), with the copy done, so
        the row is free again on return.  ``avoided_bytes`` reports
        how many bytes of host staging-matrix fill the padded layout
        made unnecessary for this row — the bridge's whole reason to
        exist, so it is counted here at the seam."""
        from sparkrdma_tpu_torch.metrics import counter

        if avoided_bytes > 0:
            counter("device_exchange_h2d_bytes_avoided_total").inc(
                avoided_bytes
            )
        if out is not None:
            return out.copy_(torch.from_numpy(row))
        return torch.from_numpy(row).to(device, copy=True)
