"""External TeraSort, sortByKey for datasets larger than device memory:
the port of ``sparkrdma_tpu/models/external_sort.py``.

A two-pass sample sort whose working set per device step is ONE chunk
or ONE bucket, never the whole dataset:

1. **Partition pass**: each input chunk is sorted on the device
   (``TeraSorter.sort``), sampled, and split by global range splitters
   into per-bucket runs appended to bucket spill files (sequential host
   IO through ``memory/direct_io.py``, O_DIRECT where the filesystem
   takes it).  Splitters come from the first chunk's sample.
2. **Merge pass**: bucket files are loaded in range order and sorted on
   the device; concatenating the bucket outputs yields the global sort.
   A bucket that outgrew the working-set bound (adversarial input order
   froze the splitters on an unrepresentative sample) is re-split
   recursively with splitters sampled from its own file.

Peak device memory: O(max(chunk, bucket)); disk holds the rest.

It runs on one device.  Over a group of D > 1 ranks its chunk sorts
would be rank-local runs, and its bucket boundaries and spill files
need a design of their own (:data:`EXTERNAL_SORT_ITEM`).
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.memory.direct_io import DirectAppender, direct_supported
from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.parallel.group import as_group

EXTERNAL_SORT_ITEM = (
    "ROADMAP.md, 'Next, in order', item 3: ExternalTeraSorter over a "
    "group of D > 1 ranks"
)


class ExternalTeraSorter:
    """Streaming sortByKey: ``sort_chunks`` consumes (keys, vals) numpy
    chunk pairs and yields globally sorted (keys, vals) chunks, one per
    range bucket."""

    def __init__(
        self,
        device=None,
        num_buckets: int = 64,
        sample_per_chunk: int = 4096,
        spill_dir: Optional[str] = None,
        max_split_depth: int = 4,
        direct_io: str = "auto",
        group=None,
    ):
        ranks = 1 if group is None else as_group(group).size
        if ranks > 1:
            raise NotImplementedError(
                f"ExternalTeraSorter over {ranks} ranks is not ported yet "
                f"({EXTERNAL_SORT_ITEM})")
        self.sorter = TeraSorter(device)
        self.device = self.sorter.device
        self.num_buckets = int(num_buckets)
        self.sample_per_chunk = int(sample_per_chunk)
        self.spill_dir = spill_dir
        # conf.directIO analog for this model-level API ("off" keeps
        # bucket spills buffered)
        self.direct_io = direct_io
        # recursion guard for oversized-bucket re-splitting
        self.max_split_depth = int(max_split_depth)
        # stats (observability parity: spill volumes, bucket skew)
        self.chunks_in = 0
        self.bytes_spilled = 0
        self.max_bucket_records = 0
        self.buckets_resplit = 0

    # -- pass 1 helpers -----------------------------------------------------
    def _device_sort(self, keys: np.ndarray, vals: np.ndarray):
        return self.sorter.sort(keys, vals)

    def sort_chunks(
        self, chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
        preset_splitters: Optional[np.ndarray] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Two-pass external sort.  ``chunks`` may be a one-shot
        generator: chunk data is retained in per-bucket spill files, so
        nothing is iterated twice.  Yields (sorted_keys, sorted_vals)
        per bucket in ascending global range order.

        ``preset_splitters`` skips the sampling sweep — used by the
        oversized-bucket re-split, where the data is already on disk and
        a whole-file sample is available up front."""
        from concurrent.futures import ThreadPoolExecutor

        with tempfile.TemporaryDirectory(
            prefix="sparkrdma_tpu_extsort_", dir=self.spill_dir
        ) as tmp, ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="extsort-io"
        ) as io:
            paths = [os.path.join(tmp, f"bucket_{r}.bin")
                     for r in range(self.num_buckets)]
            # bucket spills ride O_DIRECT (buffered writeback throttles
            # to ~1/6 device bandwidth on virtualized hosts); small
            # bounce buffers — many buckets share one flush thread
            use_direct = self.direct_io != "off" and (
                self.direct_io == "on" or direct_supported(tmp)
            )
            files = [
                DirectAppender(
                    p, use_direct=use_direct, buf_bytes=256 << 10,
                    executor=io,
                )
                for p in paths
            ]
            samples = []
            staged = []  # sorted chunks awaiting splitters
            dtype = None
            try:
                # One subtlety: splitters need a GLOBAL sample, so the
                # first chunks are staged (sorted, in memory) until the
                # sample stabilizes.  To keep memory bounded we fix the
                # splitters after the FIRST chunk's sample plus any
                # staged chunks — for uniformly shuffled inputs one
                # chunk's quantiles are already unbiased; pathological
                # (sorted/clustered) orderings skew bucket fill, which
                # pass 2 repairs by recursively re-splitting any bucket
                # that outgrew the per-step working-set bound.
                splitters = preset_splitters
                max_chunk_records = 0  # per-call (reuse must not inflate)
                total_records = 0
                for keys, vals in chunks:
                    keys = np.asarray(keys)
                    vals = np.asarray(vals)
                    if dtype is None:
                        dtype = (keys.dtype, vals.dtype)
                    self.chunks_in += 1
                    max_chunk_records = max(max_chunk_records, len(keys))
                    total_records += len(keys)
                    sk, sv = self._device_sort(keys, vals)
                    n = len(sk)
                    if n and splitters is None:
                        # samples are only ever consumed to MAKE the
                        # splitters; once fixed (or preset) skip the work
                        step = max(1, n // self.sample_per_chunk)
                        samples.append(sk[::step])
                    if splitters is None:
                        staged.append((sk, sv))
                        if sum(len(s) for s, _ in staged) >= 1:
                            splitters = self._make_splitters(samples)
                            for s, v in staged:
                                self._spill(files, s, v, splitters)
                            staged = []
                    else:
                        self._spill(files, sk, sv, splitters)
                if splitters is None:
                    # zero or empty chunks only
                    splitters = self._make_splitters(samples)
                    for s, v in staged:
                        self._spill(files, s, v, splitters)
            finally:
                for f in files:
                    f.finish()
            if dtype is None:
                return
            # pass 2: per-bucket device sort, in range order.  A bucket
            # that outgrew the working-set bound (adversarial input order
            # froze the splitters on an unrepresentative sample) is NOT
            # loaded whole: it is recursively re-split with splitters
            # sampled from its own data, keeping every device step at
            # O(max(chunk, balanced bucket)).
            kd, vd = dtype
            item = np.dtype([("k", kd), ("v", vd)])
            # the promised working-set bound: a balanced bucket (with 2x
            # slack for benign imbalance) or one chunk, whichever is
            # larger — balanced buckets never re-split, only skew does
            cap = max(
                max_chunk_records,
                2 * total_records // self.num_buckets,
                1,
            )
            for p in paths:
                size = os.path.getsize(p)
                if size == 0:
                    continue
                n_rec = size // item.itemsize
                if (n_rec > cap and self.num_buckets > 1
                        and self.max_split_depth > 0):
                    yield from self._resplit_bucket(p, item, cap)
                    continue
                rec = np.fromfile(p, dtype=item)
                self.max_bucket_records = max(
                    self.max_bucket_records, len(rec)
                )
                yield self._device_sort(rec["k"], rec["v"])

    def _resplit_bucket(
        self, path: str, item: np.dtype, cap: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Re-sort one oversized bucket file through a child sorter,
        streaming it back in ≤cap-record chunks.  Unlike the parent
        (which froze splitters on its first chunk's sample), the child
        gets splitters from a strided sample of the ENTIRE file — the
        data is already on disk, so a representative sample is one
        sequential scan away and re-split buckets come out balanced even
        for sorted/clustered input."""
        child = ExternalTeraSorter(
            self.device,
            num_buckets=self.num_buckets,
            sample_per_chunk=self.sample_per_chunk,
            spill_dir=self.spill_dir,
            max_split_depth=self.max_split_depth - 1,
            direct_io=self.direct_io,
        )
        n_rec = os.path.getsize(path) // item.itemsize
        want = self.sample_per_chunk * self.num_buckets
        stride = max(1, n_rec // max(want, 1))
        # memmap so sampling pages in only the touched records, not the
        # whole oversized file (that being too big is why we're here)
        mm = np.memmap(path, dtype=item, mode="r")
        keys = np.array(mm["k"][::stride])
        del mm
        splitters = child._make_splitters([np.sort(keys)])
        if len(splitters) == 0 or (splitters == splitters[0]).all():
            # duplicate-heavy bucket: identical splitters would route
            # everything into one child bucket again — recursion makes
            # no progress, so load-and-sort whole without burning
            # max_split_depth passes of disk churn first
            rec = np.fromfile(path, dtype=item)
            self.max_bucket_records = max(self.max_bucket_records, len(rec))
            yield self._device_sort(rec["k"], rec["v"])
            return
        self.buckets_resplit += 1

        def chunk_reader():
            with open(path, "rb") as f:
                while True:
                    raw = f.read(cap * item.itemsize)
                    if not raw:
                        return
                    rec = np.frombuffer(raw, dtype=item)
                    yield rec["k"], rec["v"]

        yield from child.sort_chunks(
            chunk_reader(), preset_splitters=splitters
        )
        self.max_bucket_records = max(
            self.max_bucket_records, child.max_bucket_records
        )
        self.bytes_spilled += child.bytes_spilled
        self.buckets_resplit += child.buckets_resplit

    def _make_splitters(self, samples) -> np.ndarray:
        if not samples:
            return np.zeros(0, np.int64)
        cat = np.sort(np.concatenate(samples))
        idx = (np.arange(1, self.num_buckets) * len(cat)) // self.num_buckets
        return cat[np.clip(idx, 0, len(cat) - 1)]

    def _spill(self, files, sk: np.ndarray, sv: np.ndarray,
               splitters: np.ndarray) -> None:
        """Append each splitter range of the SORTED chunk to its bucket
        file (ranges are contiguous slices — sequential IO only)."""
        edges = np.concatenate([
            [0], np.searchsorted(sk, splitters, side="right"), [len(sk)]
        ]).astype(np.int64)
        # an empty sample (all chunks empty so far) yields no splitters:
        # everything lands in bucket 0
        for r in range(len(edges) - 1):
            lo, hi = edges[r], edges[r + 1]
            if hi <= lo:
                continue
            item = np.dtype([("k", sk.dtype), ("v", sv.dtype)])
            rec = np.empty(hi - lo, dtype=item)
            rec["k"] = sk[lo:hi]
            rec["v"] = sv[lo:hi]
            files[r].append(rec.view(np.uint8).reshape(-1))
            self.bytes_spilled += rec.nbytes

    def sort(self, keys, vals) -> Tuple[np.ndarray, np.ndarray]:
        """Convenience non-streaming wrapper (array in, array out)."""
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        outs = list(self.sort_chunks([(keys, vals)]))
        if not outs:
            return keys[:0], vals[:0]
        return (
            np.concatenate([k for k, _ in outs]),
            np.concatenate([v for _, v in outs]),
        )
