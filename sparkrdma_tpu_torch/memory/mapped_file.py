"""File-backed registered segments: the RdmaMappedFile analog.

The reference commits each map task's shuffle file by mmapping it in
4 KiB-aligned chunks and registering every chunk as an ibverbs MR, with
``deleteOnExit`` + explicit dispose (RdmaMappedFile.java:76-199).  Here
a committed byte stream can be written to disk and served through a
read-only ``np.memmap`` registered in the arena: the OS page cache
plays the registered-memory role, reads go straight from the mapping,
and the file is unlinked when the segment is released (the
deleteOnExit/dispose pair).

This is the larger-than-memory commit path — HBM staging
(resolver default) serves the hot exchange; file-backed segments hold
shuffles whose working set exceeds the arena budget.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


_COMMIT_IO = None
_COMMIT_IO_LOCK = threading.Lock()  # lock-order: 86


def _commit_io_executor():
    """Shared 1-thread flush executor for commit-time DirectAppenders:
    overlaps the chunk producer (often a spill read-back) with the
    O_DIRECT pwrites, like the writer's spill appenders do.  Module-
    level and never shut down, so commits issued during manager
    teardown can't hit 'cannot schedule new futures'.  Double-checked
    lock: two first-commit threads racing here must share ONE flush
    thread (the single-flush-thread property the writers rely on)."""
    global _COMMIT_IO
    if _COMMIT_IO is None:
        with _COMMIT_IO_LOCK:
            if _COMMIT_IO is None:
                from concurrent.futures import ThreadPoolExecutor

                _COMMIT_IO = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="commit-io"
                )
    return _COMMIT_IO


def _advise_sequential(arr) -> None:
    """MADV_SEQUENTIAL on the backing mmap: shuffle blocks are read
    front-to-back, and aggressive readahead is worth 2-4x over default
    page faulting on the O_DIRECT-written (cache-cold) files."""
    import mmap as _mmap

    mm = getattr(arr, "_mmap", None)
    if mm is not None and hasattr(mm, "madvise"):
        try:
            mm.madvise(_mmap.MADV_SEQUENTIAL)
        except (OSError, ValueError):
            pass


class MappedFile:
    """One shuffle data file: write once, then serve reads via mmap.

    ``chunks`` is any iterable of byte strings, written STREAMING so a
    spilled map output never needs to be resident in RAM at commit
    (each chunk is materialized alone).  Pass the instance as
    ``keepalive`` to ``ArenaManager.register`` — ``free()`` is called
    exactly once on segment release and unlinks the file."""

    def __init__(self, chunks, directory: Optional[str] = None,
                 prefix: str = "sparkrdma_tpu_shuffle_",
                 direct_write: bool = True, defer_map: bool = False):
        if isinstance(chunks, (bytes, bytearray, memoryview)):
            chunks = (chunks,)
        directory = directory or tempfile.gettempdir()
        os.makedirs(directory, exist_ok=True)
        fd, self.path = tempfile.mkstemp(prefix=prefix, dir=directory)
        try:
            total = self._write_chunks(fd, chunks, directory, direct_write)
            if defer_map:
                # tiered commits (memory/tier.py) defer the read-only
                # mapping until a span is actually resolved/prefetched:
                # an output whose partitions are never read costs the
                # data file alone, no VMA and no faulted pages
                self.array = None
                self._length = total
            else:
                self._map(total)
        except BaseException:
            self._unlink()
            raise
        self._freed = False

    def _write_chunks(self, fd: int, chunks, directory: str,
                      direct_write: bool) -> int:
        """Stream ``chunks`` to disk, O_DIRECT when the fs supports it:
        commits are exactly the writes the virtualized hosts' buffered
        writeback throttles to a fraction of device bandwidth, and the
        file is mmap'd/pread back cache-cold either way."""
        from sparkrdma_tpu_torch.memory.direct_io import (
            DirectAppender,
            direct_supported,
        )

        total = 0
        if direct_write and direct_supported(directory):
            os.close(fd)  # DirectAppender reopens with its own flags
            app = DirectAppender(self.path, prealloc_bytes=32 << 20,
                                 executor=_commit_io_executor())
            try:
                for chunk in chunks:
                    _, n = app.append(chunk)
                    total += n
                if total == 0:
                    # mmap of a zero-byte file is invalid: pad to one
                    # byte so an all-empty-partitions commit still
                    # maps (the segment serves only EMPTY locations)
                    app.append(b"\x00")
            finally:
                app.finish()
            return total
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                total += len(chunk)
            if total == 0:
                f.write(b"\x00")
        return total

    # set False (e.g. conf directIO=off) to force the mmap view path
    direct_read_enabled = True

    def pread(self, offset: int, length: int):
        """O_DIRECT read of ``[offset, offset+length)`` into a fresh
        page-aligned buffer, bypassing the buffered fault path that
        virtualized hosts throttle to a fraction of device bandwidth.
        Returns a read-only uint8
        array, or None when O_DIRECT is unavailable/disabled (caller
        falls back to the mmap view).

        The descriptor is opened PER CALL by path: a concurrent
        ``free()`` (segment superseded by a task retry) at worst makes
        the open fail — never an fd-reuse read of the wrong file — and
        the fallback mmap view keeps the old loud-failure semantics."""
        import mmap as _mmap

        from sparkrdma_tpu_torch.memory.direct_io import ALIGN

        if (self._freed or not self.direct_read_enabled
                or not hasattr(os, "O_DIRECT")):
            return None
        try:
            fd = os.open(self.path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            return None
        lo = offset // ALIGN * ALIGN
        hi = (offset + length + ALIGN - 1) // ALIGN * ALIGN
        mm = _mmap.mmap(-1, hi - lo)
        pos = 0
        want = hi - lo
        need = (offset - lo) + length
        view = memoryview(mm)
        try:
            while pos < need:
                n = os.preadv(fd, [view[pos:want]], lo + pos)
                if n <= 0:
                    break  # EOF inside the final alignment block
                pos += n
        except OSError:
            pos = -1
        finally:
            view.release()
            try:
                os.close(fd)
            except OSError:
                pass
        if pos < need:
            mm.close()
            return None  # failed / short before the span ended
        arr = np.frombuffer(mm, np.uint8)[
            offset - lo : offset - lo + length
        ]
        arr.flags.writeable = False
        return arr

    @classmethod
    def from_path(cls, path: str, length: int,
                  defer_map: bool = False) -> "MappedFile":
        """Adopt an EXISTING data file (e.g. a per-partition spill file
        written through the O_DIRECT appender) as a registered mapped
        segment — the zero-copy commit: spilled bytes are never
        rewritten, the spill file IS the shuffle file.  Takes ownership
        (unlinked on free)."""
        mf = cls.__new__(cls)
        mf.path = path
        try:
            if defer_map:
                mf.array = None
                mf._length = length
            else:
                mf._map(length)
        except BaseException:
            mf._unlink()
            raise
        mf._freed = False
        return mf

    def ensure_mapped(self) -> np.ndarray:
        """Create the deferred read-only mapping on first use (the
        per-span registration step of the tiered store's cold reads
        when O_DIRECT preads are unavailable).  Racy-create is benign:
        two mappers of the same file both get valid views; one VMA
        wins the attribute slot.  Returns the mapped uint8 array."""
        arr = self.array
        if arr is None:
            if self._freed:
                raise ValueError(f"mapped file {self.path} already freed")
            self._map(self._length)
            arr = self.array
            if arr is None:
                # free() landed between the check above and this read
                raise ValueError(f"mapped file {self.path} freed while "
                                 "it was being mapped")
        return arr

    def _map(self, length: int) -> None:
        """Shared read-only mapping setup (serves get_local_block /
        transport reads without a resident copy; page cache backs it)."""
        self.array = np.memmap(
            self.path, dtype=np.uint8, mode="r", shape=(max(length, 1),)
        )
        _advise_sequential(self.array)

    def _unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            logger.warning("could not unlink %s", self.path, exc_info=True)

    def free(self) -> None:
        """Dispose: drop the mapping and delete the file
        (RdmaMappedFile.java:189-199).

        The mapping is NOT closed here.  ``np.memmap`` takes no buffer
        export of its ``mmap``, so ``mmap.close()`` succeeds under live
        views and unmaps the pages they point at: a tier warm or a
        serve still copying from a view (``TieredBlockStore._load_row``
        on a drain thread) then reads unmapped memory and the process
        dies of SIGSEGV.  Dropping the reference leaves the unmap to
        the last view's collection (every slice's base chain holds the
        memmap); the unlinked file's pages live until then."""
        if self._freed:
            return
        self._freed = True
        self.array = None
        self._unlink()
