"""Host staging pool: ctypes binding over the native allocator.

The write path serializes shuffle partitions into these page-aligned,
size-class-pooled host buffers before staging them into device memory
— the role the reference's registered off-heap buffers play for the
NIC (RdmaBufferManager.java:35-209, RdmaBuffer.java:32-107).  Backed by
the repo's ``native/staging_allocator.cpp``, which this module builds
with ``g++`` at first use (never at import) into
``sparkrdma_tpu_torch/_build/staging-<hash>/``, keyed by a hash of the
source and flags.  A failed build raises :class:`StagingBuildError`;
``StagingPool(force_python=True)`` keeps the pure-Python pool with the
same policy.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.metrics import counter

logger = logging.getLogger(__name__)

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR.parent / "native" / "staging_allocator.cpp"
BUILD_DIR = _PKG_DIR / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIB_NAME = "_staging.so"

MIN_BLOCK_SIZE = 16 * 1024

STAT_FIELDS = ("owned", "in_use", "idle", "num_classes", "failed_allocs",
               "total_allocs")


class StagingBuildError(RuntimeError):
    """``g++`` is missing, the source is missing, or the build failed."""


_BUILD_LOCK = threading.Lock()  # lock-order: 85
_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def source_hash() -> str:
    if not SOURCE.is_file():
        raise StagingBuildError(f"native source not found: {SOURCE}")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: pathlib.Path) -> pathlib.Path:
    """Compile the allocator into a temporary directory and move it
    into ``out_dir`` atomically (concurrent builds race harmlessly)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise StagingBuildError("g++ not found (set CXX or put it on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        lib = tmp / LIB_NAME
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode:
            raise StagingBuildError(f"g++ failed:\n{proc.stdout}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).is_file():
                raise
        return out_dir / LIB_NAME
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def _lib() -> ctypes.CDLL:
    """The native library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            out_dir = BUILD_DIR / f"staging-{source_hash()}"
            path = out_dir / LIB_NAME
            BUILD_INFO["cached"] = path.is_file()
            if not path.is_file():
                t0 = time.monotonic()
                path = _build(out_dir)
                BUILD_INFO["seconds"] = time.monotonic() - t0
            BUILD_INFO["path"] = str(path)
            _LIB = _load_native(path)
        return _LIB


def _load_native(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.staging_pool_create.restype = ctypes.c_void_p
    lib.staging_pool_create.argtypes = [ctypes.c_uint64]
    lib.staging_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.staging_alloc.restype = ctypes.c_void_p
    lib.staging_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.staging_free.restype = ctypes.c_int
    lib.staging_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.staging_block_size.restype = ctypes.c_uint64
    lib.staging_block_size.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.staging_pool_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
    ]
    lib.staging_pool_trim.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    if hasattr(lib, "row_gather"):
        lib.row_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_uint64,
        ]
    if hasattr(lib, "radix_argsort_i64"):
        lib.radix_argsort_i64.restype = ctypes.c_int
        lib.radix_argsort_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ]
    if hasattr(lib, "hash_partition_order"):
        lib.hash_partition_order.restype = ctypes.c_int
        lib.hash_partition_order.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
    if hasattr(lib, "radix_scratch_trim"):
        lib.radix_scratch_trim.restype = None
        lib.radix_scratch_trim.argtypes = []
    if hasattr(lib, "kway_merge_i64"):
        lib.kway_merge_i64.restype = ctypes.c_int
        lib.kway_merge_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
    if hasattr(lib, "rank_compress_i64"):
        lib.rank_compress_i64.restype = ctypes.c_int64
        lib.rank_compress_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ]
    if hasattr(lib, "merge_runs_groups_i64"):
        lib.merge_runs_groups_i64.restype = ctypes.c_int64
        lib.merge_runs_groups_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    if hasattr(lib, "frame_spans_lp"):
        lib.frame_spans_lp.restype = ctypes.c_int64
        lib.frame_spans_lp.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
    if hasattr(lib, "columnar_frame_spans"):
        lib.columnar_frame_spans.restype = ctypes.c_int64
        lib.columnar_frame_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
    if hasattr(lib, "crc32_spans"):
        lib.crc32_spans.restype = None
        lib.crc32_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
    if hasattr(lib, "gather_blocks"):
        lib.gather_blocks.restype = ctypes.c_int64
        lib.gather_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
    return lib



def native_row_gather(src: np.ndarray, idx: np.ndarray,
                      out: np.ndarray) -> bool:
    """``out[i] = src[idx[i]]`` via the prefetching C gather.  Returns
    False (caller falls back to ``np.take``) when the native lib is
    absent or the arrays don't qualify: src/out must be 1-D, same
    dtype, contiguous (an unaligned uint8-view is fine — only the
    stride matters); idx must be contiguous int64 within range."""
    if not hasattr(_lib(), "row_gather"):
        return False
    if (
        src.ndim != 1 or out.ndim != 1 or idx.ndim != 1
        or src.dtype != out.dtype
        or idx.dtype != np.int64
        or out.shape[0] != idx.shape[0]
        or src.strides[0] != src.dtype.itemsize
        or out.strides[0] != out.dtype.itemsize
        or idx.strides[0] != 8
    ):
        return False
    _lib().row_gather(
        src.ctypes.data, out.ctypes.data, idx.ctypes.data,
        idx.shape[0], src.dtype.itemsize,
    )
    return True


def native_radix_argsort(keys: np.ndarray):
    """Stable argsort of an int64 column via the native LSD radix
    (4 x 16-bit passes, constant digits skipped) for wide-range int64
    keys.  Returns the int64 order
    or None when unavailable/ineligible (caller falls back)."""
    if not hasattr(_lib(), "radix_argsort_i64"):
        return None
    if keys.ndim != 1 or keys.dtype != np.int64 or (
        len(keys) and keys.strides[0] != 8
    ):
        return None
    order = np.empty(keys.shape[0], np.int64)
    rc = _lib().radix_argsort_i64(
        keys.ctypes.data, keys.shape[0], order.ctypes.data
    )
    if rc != 0:
        return None
    return order


def native_kway_merge(keys: np.ndarray, run_offsets: np.ndarray):
    """Stable merge order over concatenated PRE-SORTED int64 runs (the
    loser tree in staging_allocator.cpp) — bit-exact with numpy's
    stable argsort of the concatenation.  Returns the int64 gather order or None
    when unavailable/ineligible (caller falls back)."""
    if not hasattr(_lib(), "kway_merge_i64"):
        return None
    if (
        keys.ndim != 1 or keys.dtype != np.int64
        or (len(keys) and keys.strides[0] != 8)
        or run_offsets.ndim != 1 or run_offsets.dtype != np.int64
        or run_offsets.strides[0] != 8
        or len(run_offsets) < 1
        or run_offsets[0] != 0 or run_offsets[-1] != len(keys)
        or (np.diff(run_offsets) < 0).any()
    ):
        return None
    order = np.empty(len(keys), np.int64)
    rc = _lib().kway_merge_i64(
        keys.ctypes.data, run_offsets.ctypes.data,
        len(run_offsets) - 1, order.ctypes.data,
    )
    if rc != 0:
        return None
    return order


def native_rank_compress(keys: np.ndarray):
    """Dense sorted-rank compression of a wide-range, low-cardinality
    int64 column (staging_allocator.cpp rank_compress_i64): returns
    ``(ranks, n_distinct)`` — a uint16 rank array whose stable argsort
    equals the keys' stable argsort, plus the exact distinct count the
    kernel already knows (so callers never rescan for it) — or None
    when unavailable/ineligible/cardinality > 65536 (the kernel aborts
    its scan at the 65537th distinct, so the failed probe is cheap on
    high-cardinality data)."""
    if not hasattr(_lib(), "rank_compress_i64"):
        return None
    if (
        keys.ndim != 1 or keys.dtype != np.int64
        or (len(keys) and keys.strides[0] != 8)
    ):
        return None
    ranks = np.empty(len(keys), np.uint16)
    g = _lib().rank_compress_i64(
        keys.ctypes.data, len(keys), ranks.ctypes.data
    )
    if g < 0:
        return None
    return ranks, int(g)


def native_merge_runs_groups(key_runs, val_runs):
    """Fused group-by-key merge over key-sorted runs (one streaming C
    pass; staging_allocator.cpp merge_runs_groups_i64).  ``key_runs``
    are contiguous int64 key columns, ``val_runs`` the matching
    contiguous fixed-itemsize value columns.  Returns ``(uniq_keys,
    merged_vals, group_offs)`` — group ``i``'s values are the VIEW
    ``merged_vals[group_offs[i]:group_offs[i+1]]``, ordered run-0's
    rows first (bit-exact with the per-key Python merge's batch
    order) — or None when unavailable/ineligible."""
    if not hasattr(_lib(), "merge_runs_groups_i64"):
        return None
    if len(key_runs) != len(val_runs) or not key_runs:
        return None
    vdt = val_runs[0].dtype
    if vdt.hasobject:
        # memcpy'ing PyObject* rows would duplicate references
        # without INCREF — double-free on collection
        return None
    for k, v in zip(key_runs, val_runs):
        if (
            k.ndim != 1 or k.dtype != np.int64
            or (len(k) and k.strides[0] != 8)
            or v.ndim != 1 or v.dtype != vdt
            or (len(v) and v.strides[0] != vdt.itemsize)
            or len(k) != len(v)
        ):
            return None
    n = sum(len(k) for k in key_runs)
    out_vals = np.empty(n, vdt)
    out_keys = np.empty(n, np.int64)
    out_offs = np.empty(n + 1, np.int64)
    nruns = len(key_runs)
    kptrs = (ctypes.c_void_p * nruns)(*[k.ctypes.data for k in key_runs])
    vptrs = (ctypes.c_void_p * nruns)(*[v.ctypes.data for v in val_runs])
    lens = (ctypes.c_int64 * nruns)(*[len(k) for k in key_runs])
    g = _lib().merge_runs_groups_i64(
        kptrs, vptrs, lens, nruns, vdt.itemsize,
        out_vals.ctypes.data, out_keys.ctypes.data, out_offs.ctypes.data,
    )
    if g < 0:
        return None
    # copy the (small) group-level slices so the full n-sized scratch
    # isn't pinned behind the views for the consumer's lifetime
    return out_keys[:g].copy(), out_vals, out_offs[: g + 1].copy()


def _flat_u8(data):
    """Flat uint8 view of any contiguous bytes-like (no copy), or None
    when the buffer protocol won't yield one."""
    try:
        return np.frombuffer(data, np.uint8)
    except (TypeError, ValueError, BufferError):
        return None


def native_frame_spans(data, prefix: int):
    """(start, end) spans of length-prefixed frames (``prefix`` opaque
    bytes + 4B LE length + body) in one C walk — the serde
    frame-walking loops (PickleSerializer prefix=0, CompressedSerializer
    prefix=1) pay one interpreted iteration PER FRAME otherwise.
    Returns an int64 [n, 2] span array, or None when the native lib is
    absent, the buffer won't view flat, or the stream is truncated —
    the caller re-walks in Python (raising its detailed error)."""
    if not hasattr(_lib(), "frame_spans_lp"):
        return None
    arr = _flat_u8(data)
    if arr is None:
        return None
    total = arr.shape[0]
    if total == 0:
        return np.empty((0, 2), np.int64)
    # frames are typically >= hundreds of bytes; grow on the rare -2
    cap = max(64, total // 256)
    while True:
        spans = np.empty((cap, 2), np.int64)
        n = _lib().frame_spans_lp(
            arr.ctypes.data, total, prefix, spans.ctypes.data, cap
        )
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            return None
        return spans[:n]


def native_columnar_frame_spans(data):
    """(start, end) spans of columnar frames (serde.ColumnarSerializer
    0xC2/0xC3 framing) in one C walk, parsing the fixed-width dtype
    headers natively.  Returns an int64 [n, 2] span array, or None on
    lib-absent / truncation / exotic dtype strings / bad magic — the
    Python walker is the authority for every error path."""
    if not hasattr(_lib(), "columnar_frame_spans"):
        return None
    arr = _flat_u8(data)
    if arr is None:
        return None
    total = arr.shape[0]
    if total == 0:
        return np.empty((0, 2), np.int64)
    cap = max(64, total // 256)
    while True:
        spans = np.empty((cap, 2), np.int64)
        n = _lib().columnar_frame_spans(
            arr.ctypes.data, total, spans.ctypes.data, cap
        )
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            return None
        return spans[:n]


def native_crc32_spans(data, spans):
    """``out[i] = zlib.crc32(data[a_i:b_i])`` batched into ONE call —
    per-span zlib.crc32 pays Python call + buffer-protocol overhead
    per frame, which dominates for the small-frame shapes the decode
    plane checksums.  ``spans`` is any [n, 2] int-convertible array.
    Returns a uint32 array (bit-exact with zlib.crc32) or None when
    unavailable/ineligible (caller falls back to the zlib loop)."""
    if not hasattr(_lib(), "crc32_spans"):
        return None
    arr = _flat_u8(data)
    if arr is None:
        return None
    sp = np.ascontiguousarray(spans, np.int64)
    if sp.ndim != 2 or sp.shape[1] != 2:
        return None
    n = sp.shape[0]
    if n == 0:
        return np.empty(0, np.uint32)
    # the kernel trusts the spans: bounds-check them here
    if (
        bool((sp[:, 0] < 0).any())
        or bool((sp[:, 1] < sp[:, 0]).any())
        or int(sp[:, 1].max()) > arr.shape[0]
    ):
        return None
    out = np.empty(n, np.uint32)
    _lib().crc32_spans(arr.ctypes.data, sp.ctypes.data, n, out.ctypes.data)
    return out


def native_gather_blocks(dst: np.ndarray, src_addrs, lens, dst_offs) -> bool:
    """Batched ``dst[off:off+n] = block`` memcpy: ONE call assembles a
    whole exchange source row instead of one numpy slice assignment
    per map-output block (bulk._assemble).  ``src_addrs`` are raw
    buffer addresses — the CALLER keeps the owning arrays alive across
    the call.  Returns False (caller runs the slice-assignment loop)
    when unavailable or ineligible; every span is re-checked against
    ``dst`` before the memcpys run."""
    if not hasattr(_lib(), "gather_blocks"):
        return False
    if dst.ndim != 1 or dst.dtype != np.uint8 or (
        dst.shape[0] and dst.strides[0] != 1
    ):
        return False
    a = np.ascontiguousarray(src_addrs, np.uint64)
    ln = np.ascontiguousarray(lens, np.int64)
    off = np.ascontiguousarray(dst_offs, np.int64)
    n = a.shape[0]
    if ln.shape[0] != n or off.shape[0] != n:
        return False
    if n == 0:
        return True
    if (
        bool((ln < 0).any()) or bool((off < 0).any())
        or int((off + ln).max()) > dst.shape[0]
    ):
        return False
    _lib().gather_blocks(
        a.ctypes.data, ln.ctypes.data, dst.ctypes.data, off.ctypes.data, n
    )
    return True


def native_radix_scratch_trim() -> None:
    """Release the CALLING thread's radix-sort scratch (scratch above
    64 MiB is auto-freed after each sort; this hook drops the warm
    sub-threshold pages too — call it when a writer thread retires)."""
    if hasattr(_lib(), "radix_scratch_trim"):
        _lib().radix_scratch_trim()


def native_hash_partition_order(keys: np.ndarray, num_partitions: int,
                                kmin: int, krange: int):
    """Fused splitmix64 %P + stable pid-major key-asc counting-sort
    order for int64 key columns (requires ``num_partitions * krange <=
    65536``).  Returns ``(order int64[n], counts int64[P])`` or None
    when the native lib is absent / the column doesn't qualify —
    callers fall back to the numpy two-sort path.  Bit-exact with
    HashPartitioner.partition_array + the composite radix argsort."""
    if not hasattr(_lib(), "hash_partition_order"):
        return None
    if (
        keys.ndim != 1 or keys.dtype != np.int64
        or keys.strides[0] != 8
        or num_partitions * krange > (1 << 16)
    ):
        return None
    n = keys.shape[0]
    order = np.empty(n, np.int64)
    counts = np.empty(num_partitions, np.int64)
    rc = _lib().hash_partition_order(
        keys.ctypes.data, n, num_partitions, kmin, krange,
        counts.ctypes.data, order.ctypes.data,
    )
    if rc != 0:
        return None
    return order, counts


def alloc_row_gc(pool, nbytes: int, fallback_counter: str) -> np.ndarray:
    """One pooled contiguous row sized exactly ``nbytes`` whose release
    is tied to GC of the returned view (``StagingPool.alloc_gc``) —
    shared by the bulk-exchange source rows and the striped-transport
    destination rows.  Falls back to a plain numpy buffer (counting the
    fallback under ``fallback_counter``) when no pool is wired or its
    budget is exhausted."""
    if nbytes <= 0:
        return np.empty(0, np.uint8)
    if pool is not None:
        try:
            return pool.alloc_gc(nbytes)[:nbytes]
        except MemoryError:
            counter(fallback_counter).inc()
    return np.empty(nbytes, np.uint8)


class StagingBuffer:
    """One pooled, page-aligned host buffer exposed as a numpy view."""

    def __init__(self, pool: "StagingPool", address: int, capacity: int,
                 view: np.ndarray):
        self._pool = pool
        self.address = address
        self.capacity = capacity
        self.view = view  # uint8[capacity], zero-copy over the native block
        self._freed = False

    def free(self) -> None:
        if not self._freed:
            self._freed = True
            self._pool._free(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


class StagingPool:
    """Size-class pooled host buffers with a byte budget and LRU trim.

    Native-backed (``is_native``; the library builds on first use or
    raises) unless ``force_python``, which takes a Python pool with
    identical policy: power-of-two classes (min 16 KiB),
    trim idle blocks when idle bytes exceed 90% of the budget, down to
    65% (reference policy, RdmaBufferManager.java:150-188).
    """

    def __init__(self, max_bytes: int = 0, force_python: bool = False):
        self.max_bytes = max_bytes
        self.is_native = not force_python
        kind = "native" if self.is_native else "python"
        self._m_allocs = counter("staging_allocs_total", pool=kind)
        self._m_alloc_bytes = counter("staging_alloc_bytes_total", pool=kind)
        self._m_failed = counter("staging_failed_allocs_total", pool=kind)
        # hit = pooled block reused, miss = fresh memory; only the
        # python pool sees its free lists (the native pool recycles
        # internally), so hits/misses stay zero under the native pool
        self._m_hits = counter("staging_hits_total", pool=kind)
        self._m_misses = counter("staging_misses_total", pool=kind)
        # RLock: a cyclic-GC pass triggered INSIDE a locked region can
        # run an alloc_gc finalizer on the same thread, which takes
        # this lock again — re-entrant entry is safe (counter updates;
        # destroy needs _closed, impossible mid-alloc).  Deliberately a
        # PLAIN RLock, never a DebugLock: GC can fire the finalizer
        # while the triggering thread holds ANY lock, so rank checks
        # here would flag inversions that are not real lock-ordering
        # commitments.
        self._lock = threading.RLock()  # lock-order: 84
        self._closed = False
        # outstanding alloc_gc buffers: close() must DEFER destroying
        # the native pool until the last one is collected (destroying
        # frees the pages a live consumer view still reads)
        self._gc_live = 0
        if self.is_native:
            self._handle = _lib().staging_pool_create(
                ctypes.c_uint64(max_bytes)
            )
            if not self._handle:
                raise MemoryError("staging_pool_create failed")
        else:
            # python fallback pool
            self._free_lists: Dict[int, list] = {}
            self._owned = 0
            self._in_use = 0
            self._tick = 0
            self._last_use: Dict[int, int] = {}
            self._failed = 0
            self._total_allocs = 0

    # -- public API ---------------------------------------------------------
    def alloc(self, size: int) -> StagingBuffer:
        if size <= 0:
            raise ValueError(f"alloc size must be > 0: {size}")
        if self._closed:
            raise MemoryError("pool closed")
        self._m_allocs.inc()
        self._m_alloc_bytes.inc(size)
        if self.is_native:
            ptr = _lib().staging_alloc(self._handle, ctypes.c_uint64(size))
            if not ptr:
                self._m_failed.inc()
                raise MemoryError(
                    f"staging pool budget exhausted allocating {size}B "
                    f"(budget {self.max_bytes}B)"
                )
            cap = _lib().staging_block_size(self._handle, ctypes.c_void_p(ptr))
            raw = (ctypes.c_uint8 * cap).from_address(ptr)
            view = np.frombuffer(raw, dtype=np.uint8)
            return StagingBuffer(self, ptr, cap, view)
        return self._py_alloc(size)

    def alloc_gc(self, size: int) -> np.ndarray:
        """Pooled buffer whose RELEASE is tied to garbage collection of
        the returned uint8 view and every numpy slice of it — the
        BufferReleasingInputStream analog
        (RdmaShuffleFetcherIterator.scala:377-406): consumers receive
        zero-copy slices of one pooled buffer and the buffer returns to
        the pool only when the last slice dies, so no explicit release
        call can free memory under a live view.

        Native pool: the block physically returns for reuse.  Python
        fallback: the memory goes back to the OS and only the
        accounting is adjusted (numpy owns the pages)."""
        if size <= 0:
            raise ValueError(f"alloc size must be > 0: {size}")
        self._m_allocs.inc()
        self._m_alloc_bytes.inc(size)
        if self.is_native:
            # closed-check, alloc, and the live-count publication happen
            # under ONE lock hold: close() destroys the native pool when
            # _gc_live == 0, so a gap here would let it free the handle
            # mid-allocation
            with self._lock:
                if self._closed or self._handle is None:
                    raise MemoryError("pool closed")
                ptr = _lib().staging_alloc(
                    self._handle, ctypes.c_uint64(size)
                )
                if not ptr:
                    self._m_failed.inc()
                    raise MemoryError(
                        f"staging pool budget exhausted allocating {size}B "
                        f"(budget {self.max_bytes}B)"
                    )
                cap = _lib().staging_block_size(
                    self._handle, ctypes.c_void_p(ptr)
                )
                self._gc_live += 1
            raw = (ctypes.c_uint8 * cap).from_address(ptr)

            def _ret(pool=self, address=ptr):
                # runs when raw (kept alive by every slice's base chain)
                # is collected; the handle stays valid after close()
                # because destroy is deferred to the LAST of us.  Free
                # and the destroy decision happen under ONE lock hold —
                # two finalizers racing could otherwise free into a
                # just-destroyed pool.
                with pool._lock:
                    handle = pool._handle
                    if handle is not None:
                        _lib().staging_free(
                            handle, ctypes.c_void_p(address)
                        )
                    pool._gc_live -= 1
                    destroy = (
                        pool._closed and pool._gc_live == 0
                        and handle is not None
                    )
                    if destroy:
                        pool._handle = None
                if destroy:
                    _lib().staging_pool_destroy(handle)

            weakref.finalize(raw, _ret)
            return np.frombuffer(raw, dtype=np.uint8)
        # python fallback: fresh numpy memory, GC frees it to the OS
        if self._closed:
            raise MemoryError("pool closed")
        cls = self._round_class(size)
        self._m_misses.inc()
        with self._lock:
            self._py_reserve(size, cls)
            self._owned += cls
            self._in_use += cls
        view = np.empty(cls, dtype=np.uint8)

        def _reclaim(pool=self, cls=cls):
            with pool._lock:
                pool._owned -= cls
                pool._in_use -= cls

        weakref.finalize(view, _reclaim)
        return view

    def stats(self) -> Dict[str, int]:
        if self.is_native:
            arr = (ctypes.c_uint64 * 6)()
            # hold the lock across the native call: the deferred-destroy
            # finalizer must not tear the handle down mid-read
            with self._lock:
                if self._handle:
                    _lib().staging_pool_stats(self._handle, arr)
            return dict(zip(STAT_FIELDS, (int(x) for x in arr)))
        with self._lock:
            idle = self._owned - self._in_use
            return {
                "owned": self._owned, "in_use": self._in_use, "idle": idle,
                "num_classes": len(self._free_lists),
                "failed_allocs": self._failed,
                "total_allocs": self._total_allocs,
            }

    def prealloc(self, total_bytes: int, block_size: int) -> int:
        """Warm the pool with ``total_bytes`` worth of ``block_size``
        blocks (reference: executor-side async preallocation of
        maxAggBlock buffers, RdmaBufferManager.java:112-120).  Returns
        the number of blocks preallocated."""
        if total_bytes <= 0 or block_size <= 0:
            return 0
        n = max(1, total_bytes // block_size)
        bufs = []
        try:
            for _ in range(n):
                bufs.append(self.alloc(block_size))
        except MemoryError:
            pass  # budget hit: keep what we got
        count = len(bufs)
        for b in bufs:
            b.free()
        return count

    def trim(self, target_idle_bytes: int = 0) -> None:
        if self.is_native:
            _lib().staging_pool_trim(
                self._handle, ctypes.c_uint64(target_idle_bytes)
            )
        else:
            with self._lock:
                self._py_trim(target_idle_bytes)

    def close(self) -> None:
        if self._closed:
            return
        handle = None
        with self._lock:
            self._closed = True
            if self.is_native and self._gc_live == 0:
                handle, self._handle = self._handle, None
            # else (gc_live > 0): the LAST outstanding alloc_gc
            # buffer's finalizer destroys the pool — destroying now
            # would free pages a live consumer view still reads
        if handle:
            _lib().staging_pool_destroy(handle)
        if not self.is_native:
            self._free_lists.clear()

    # -- internals ----------------------------------------------------------
    def _free(self, buf: StagingBuffer) -> None:
        if self._closed:
            return
        if self.is_native:
            rc = _lib().staging_free(self._handle, ctypes.c_void_p(buf.address))
            if rc != 0:
                logger.warning("staging_free: unknown/double-freed buffer")
        else:
            self._py_free(buf)

    @staticmethod
    def _round_class(size: int) -> int:
        c = MIN_BLOCK_SIZE
        while c < size:
            c <<= 1
        return c

    def _py_reserve(self, size: int, cls: int) -> None:
        """Account one allocation and ensure budget headroom for a NEW
        ``cls``-sized block (lock held; shared by _py_alloc and the
        python alloc_gc path so the trim/budget policy lives once)."""
        self._tick += 1
        self._total_allocs += 1
        self._last_use[cls] = self._tick
        if self.max_bytes and self._owned + cls > self.max_bytes:
            self._py_trim(0)
            if self._owned + cls > self.max_bytes:
                self._failed += 1
                self._m_failed.inc()
                raise MemoryError(
                    f"staging pool budget exhausted allocating {size}B"
                )

    def _py_alloc(self, size: int) -> StagingBuffer:
        cls = self._round_class(size)
        with self._lock:
            lst = self._free_lists.setdefault(cls, [])
            if lst:
                self._tick += 1
                self._total_allocs += 1
                self._last_use[cls] = self._tick
                view = lst.pop()
                hit = True
            else:
                self._py_reserve(size, cls)
                view = np.zeros(cls, dtype=np.uint8)
                self._owned += cls
                hit = False
            self._in_use += cls
        (self._m_hits if hit else self._m_misses).inc()
        return StagingBuffer(self, view.ctypes.data, cls, view)

    def _py_free(self, buf: StagingBuffer) -> None:
        cls = buf.capacity
        with self._lock:
            self._tick += 1
            self._last_use[cls] = self._tick
            self._free_lists.setdefault(cls, []).append(buf.view)
            self._in_use -= cls
            if self.max_bytes:
                idle = self._owned - self._in_use
                if idle > 0.9 * self.max_bytes:
                    self._py_trim(int(0.65 * self.max_bytes))

    def _py_trim(self, target_idle: int) -> None:
        # assumes lock held
        idle = self._owned - self._in_use
        order = sorted(
            (s for s in self._free_lists if self._free_lists[s]),
            key=lambda s: self._last_use.get(s, 0),
        )
        for cls in order:
            if idle <= target_idle:
                break
            n = len(self._free_lists[cls])
            self._free_lists[cls] = []
            self._owned -= n * cls
            idle -= n * cls

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
