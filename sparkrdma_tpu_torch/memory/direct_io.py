"""O_DIRECT append writers, the spill path: a copy of
``sparkrdma_tpu/memory/direct_io.py``, unchanged in function.

The JAX module imports only the standard library, but importing it
loads ``sparkrdma_tpu``, which imports JAX, so the port keeps its own
copy (the external sort's bucket spills use it).

- ``DirectAppender`` opens with ``O_DIRECT`` when the directory's
  filesystem supports it (probed once per directory by
  :func:`direct_supported`; tmpfs and other mounts fall back to
  buffered writes),
- copies payload into page-aligned anonymous-mmap bounce buffers and
  writes only block-aligned spans (the O_DIRECT contract),
- double-buffers: the previous block's ``pwrite`` runs on a shared IO
  executor while the caller fills the next buffer,
- ``finish()`` pads the tail to the alignment block, waits for
  in-flight writes, and truncates the file to its exact logical size.

Readback goes through a plain buffered descriptor.
"""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# raw Linux fallocate(2) via libc: unlike os.posix_fallocate, it FAILS
# (EOPNOTSUPP) on filesystems without extent preallocation instead of
# glibc silently zero-filling the range (2x write traffic for nothing)
try:
    _libc = ctypes.CDLL(None, use_errno=True)
    _fallocate = _libc.fallocate
    _fallocate.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_long,
    ]
    _fallocate.restype = ctypes.c_int
except (OSError, AttributeError):  # non-Linux libc
    _fallocate = None

# O_DIRECT demands offset/length/memory alignment at the logical block
# size; 4096 covers every sector size in practice
ALIGN = 4096

_support_cache: Dict[str, bool] = {}
_support_lock = threading.Lock()  # lock-order: 88


def direct_supported(directory: str) -> bool:
    """Whether files in ``directory`` accept O_DIRECT (probed once)."""
    if not hasattr(os, "O_DIRECT"):
        return False
    key = os.path.abspath(directory)
    with _support_lock:
        cached = _support_cache.get(key)
    if cached is not None:
        return cached
    ok = False
    probe = None
    try:
        import tempfile

        fd, probe = tempfile.mkstemp(prefix=".directio_probe_", dir=directory)
        os.close(fd)
        fd = os.open(probe, os.O_WRONLY | os.O_DIRECT)
        try:
            buf = mmap.mmap(-1, ALIGN)
            try:
                os.pwrite(fd, memoryview(buf), 0)
                ok = True
            finally:
                buf.close()
        finally:
            os.close(fd)
    except OSError:
        ok = False
    finally:
        if probe is not None:
            try:
                os.unlink(probe)
            except OSError:
                pass
    with _support_lock:
        _support_cache[key] = ok
    return ok


class DirectAppender:
    """Append-only writer with O_DIRECT + aligned double buffering.

    ``append(data)`` returns the (logical offset, length) of the
    payload; ``finish()`` makes the file exactly ``size`` bytes long
    and closes the write descriptor.  Not thread-safe (one writer per
    file); the async flush runs on the shared ``executor``.
    """

    def __init__(self, path: str, use_direct: bool = True,
                 buf_bytes: int = 1 << 20,
                 executor: Optional[ThreadPoolExecutor] = None,
                 prealloc_bytes: int = 0):
        if buf_bytes % ALIGN:
            raise ValueError(f"buf_bytes must be {ALIGN}-aligned")
        self.path = path
        self.size = 0            # logical bytes appended
        self._file_off = 0       # aligned bytes already on disk
        self._executor = executor
        self._pending: Optional[Future] = None
        # extent preallocation: interleaved appends across many files
        # (one per partition) otherwise fragment each file into
        # bounce-buffer-sized extents, degrading the later sequential
        # read; fallocate in prealloc_bytes steps keeps extents large
        # (finish() ftruncates, returning the unused tail).  0 = off.
        self._prealloc = int(prealloc_bytes)
        self._allocated = 0
        flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
        self.direct = bool(use_direct) and hasattr(os, "O_DIRECT")
        if self.direct:
            try:
                self._fd = os.open(path, flags | os.O_DIRECT, 0o600)
            except OSError:
                self.direct = False
                self._fd = os.open(path, flags, 0o600)
        else:
            self._fd = os.open(path, flags, 0o600)
        # page-aligned bounce buffers (the O_DIRECT memory contract);
        # two so a fill can overlap the previous block's pwrite
        self._bufs = [mmap.mmap(-1, buf_bytes), mmap.mmap(-1, buf_bytes)]
        self._cur = 0
        self._fill = 0
        self._closed = False

    # -- write side ---------------------------------------------------------
    def append(self, data) -> Tuple[int, int]:
        if self._closed:
            raise ValueError(f"appender for {self.path} is finished")
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        off = self.size
        n = len(mv)
        buf = self._bufs[self._cur]
        cap = len(buf)
        pos = 0
        while pos < n:
            take = min(n - pos, cap - self._fill)
            buf[self._fill : self._fill + take] = mv[pos : pos + take]
            self._fill += take
            pos += take
            if self._fill == cap:
                self._flush_block(cap)
                buf = self._bufs[self._cur]
        self.size += n
        return off, n

    def _flush_block(self, nbytes: int) -> None:
        """Write the current buffer's first ``nbytes`` (ALIGN-multiple)
        at the current aligned file offset, then rotate buffers."""
        buf = self._bufs[self._cur]
        file_off = self._file_off
        fd = self._fd
        if self._prealloc and file_off + nbytes > self._allocated:
            grow = max(self._prealloc, nbytes)
            if _fallocate is not None and _fallocate(
                fd, 0, self._allocated, grow
            ) == 0:
                self._allocated += grow
            else:
                self._prealloc = 0  # fs/libc without fallocate(2)

        def _write(buf=buf, nbytes=nbytes, file_off=file_off, fd=fd):
            view = memoryview(buf)[:nbytes]
            pos = 0
            while pos < nbytes:
                pos += os.pwrite(fd, view[pos:], file_off + pos)

        self._file_off += nbytes
        if self._executor is not None:
            self._wait_pending()
            self._pending = self._executor.submit(_write)
        else:
            _write()
        # rotating is safe: the buffer rotated TO had its write waited
        # by the _wait_pending above (at most one write in flight)
        self._cur ^= 1
        self._fill = 0

    def _wait_pending(self) -> None:
        if self._pending is not None:
            f, self._pending = self._pending, None
            f.result()

    def finish(self) -> int:
        """Flush the tail, trim to the logical size, close the write
        descriptor.  Returns the logical size."""
        if self._closed:
            return self.size
        self._closed = True
        if self._fill:
            # pad to the alignment block; the ftruncate below trims it
            padded = (self._fill + ALIGN - 1) // ALIGN * ALIGN
            buf = self._bufs[self._cur]
            buf[self._fill : padded] = b"\x00" * (padded - self._fill)
            self._flush_block(padded)
        self._wait_pending()
        os.ftruncate(self._fd, self.size)
        self._release_fd_and_bufs()
        return self.size

    def abandon(self) -> None:
        """Failure path: close and unlink."""
        if not self._closed:
            self._closed = True
            try:
                self._wait_pending()
            except OSError:
                pass
            self._release_fd_and_bufs()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def _release_fd_and_bufs(self) -> None:
        try:
            os.close(self._fd)
        finally:
            for b in self._bufs:
                try:
                    b.close()
                except BufferError:
                    pass
            self._bufs = []

    # -- read side ----------------------------------------------------------
    def open_read(self):
        """Buffered read descriptor (valid after finish())."""
        return open(self.path, "rb")
