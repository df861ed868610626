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

Over a group of D > 1 ranks (``group=``, one process per GPU) the model
is rank-local, like every model of the port: each rank feeds its own
chunk stream (ranks may hold different numbers of chunks, or none) and
gets what it owns.

- **Splitters.** Each rank sorts its first non-empty chunk on its own
  device and samples it; the ranks then make ONE ``all_gather`` of the
  samples, padded to the most a sample holds (``2 *
  sample_per_chunk``), with each rank's dtypes (a rank without a chunk
  contributes none), and every rank computes the same splitters.  After
  it the partition pass makes no collective, since a collective per
  chunk would deadlock ranks with different chunk counts.
- **Spills.** Each rank writes its own bucket files.
- **Merge pass.** One ``all_gather`` of the per-bucket record counts
  (and each rank's largest chunk) gives every rank the same global
  sizes, and from those alone every rank decides which buckets are
  empty, the working-set cap and which buckets re-split.  For every
  non-empty bucket in range order every rank joins a D-rank
  ``TeraSorter.sort`` of its own bucket file, even an empty one, and
  yields its owned range of that bucket (possibly empty): output i of
  every rank comes from the same bucket, and the global sort is the
  concatenation over buckets of the concatenation over ranks.
- **Re-split.** An oversized bucket re-splits over the same group, with
  splitters from one ``all_gather`` of a sample of every rank's file for
  that bucket.

Every rank must consume the whole of ``sort_chunks``: the collectives
run as its output is drawn.  At D = 1 every collective is the identity
and the model is the JAX package's.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.memory.direct_io import DirectAppender, direct_supported
from sparkrdma_tpu_torch.models.terasort import TeraSorter

# dtypes the ranks agree on in the splitter gather, by code (index + 1;
# 0 is a rank with no chunk)
_DTYPES = tuple(np.dtype(t) for t in (
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64"))


def _dtype_code(dt) -> int:
    dt = np.dtype(dt)
    if dt not in _DTYPES:
        raise ValueError(f"the external sort takes {[str(d) for d in _DTYPES]}"
                         f", got {dt}")
    return _DTYPES.index(dt) + 1


class ExternalTeraSorter:
    """Streaming sortByKey: ``sort_chunks`` consumes (keys, vals) numpy
    chunk pairs and yields globally sorted (keys, vals) chunks, one per
    range bucket (at D > 1, this rank's owned range of each bucket)."""

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
        #: each bucket's sort in the merge pass, over the group's D ranks
        self.sorter = TeraSorter(device, group=group)
        self.group = self.sorter.group
        self.device = self.sorter.device
        #: each chunk's sort in the partition pass, on this rank's device
        self.chunk_sorter = self.sorter if self.group.size == 1 else \
            TeraSorter(self.device)
        self.num_buckets = int(num_buckets)
        self.sample_per_chunk = int(sample_per_chunk)
        self.spill_dir = spill_dir
        # conf.directIO analog for this model-level API ("off" keeps
        # bucket spills buffered)
        self.direct_io = direct_io
        # recursion guard for oversized-bucket re-splitting
        self.max_split_depth = int(max_split_depth)
        # stats (observability parity: spill volumes, bucket skew);
        # chunks_in and bytes_spilled are this rank's, the bucket stats
        # the group's
        self.chunks_in = 0
        self.bytes_spilled = 0
        self.max_bucket_records = 0
        self.buckets_resplit = 0

    # -- collectives (each the identity at D = 1) ---------------------------
    def _gather_keys(self, keys: Optional[np.ndarray], bound: int, dtype):
        """One ``all_gather`` of every rank's ``keys`` (at most
        ``bound``; None for a rank with none) and dtypes.  Returns the
        ranks' keys concatenated (int64) and the agreed (key, value)
        dtypes, None where no rank has a chunk.  Ranks that feed
        different dtypes all raise ``ValueError``."""
        g = self.group
        buf = torch.zeros(3 + bound, dtype=torch.int64)
        if keys is not None:
            if len(keys) > bound:
                raise AssertionError(f"{len(keys)} keys over bound {bound}")
            buf[0] = len(keys)
            buf[3:3 + len(keys)] = torch.from_numpy(keys.astype(np.int64))
        if dtype is not None:
            buf[1], buf[2] = _dtype_code(dtype[0]), _dtype_code(dtype[1])
        rows = g.all_gather(buf.to(g.device)).cpu().numpy()
        codes = {(int(r[1]), int(r[2])) for r in rows if r[1]}
        if len(codes) > 1:
            names = sorted((str(_DTYPES[k - 1]), str(_DTYPES[v - 1]))
                           for k, v in codes)
            raise ValueError(
                f"the ranks feed different (key, value) dtypes: {names}")
        agreed = None
        if codes:
            k, v = codes.pop()
            agreed = (_DTYPES[k - 1], _DTYPES[v - 1])
        return np.concatenate([r[3:3 + r[0]] for r in rows]), agreed

    def _agree_splitters(self, sk: Optional[np.ndarray], dtype):
        """The partition pass's one gather: the range splitters from every
        rank's sample of its first non-empty sorted chunk ``sk`` (None
        where a rank has none), and the agreed dtypes.  A chunk's sample
        holds at most ``2 * sample_per_chunk`` keys."""
        sample = None
        if sk is not None:
            sample = sk[::max(1, len(sk) // self.sample_per_chunk)]
        cat, dtype = self._gather_keys(sample, 2 * self.sample_per_chunk,
                                       dtype)
        # no sample anywhere: no splitters (everything in bucket 0)
        samples = [cat.astype(dtype[0])] if len(cat) else []
        return self._make_splitters(samples), dtype

    def _agree_counts(self, counts, max_chunk: int):
        """The merge pass's one gather: the global record count of each
        bucket, and the largest chunk of any rank."""
        g = self.group
        mine = torch.tensor([*counts, max_chunk], dtype=torch.int64)
        rows = g.all_gather(mine.to(g.device)).cpu()
        return rows[:, :-1].sum(0).tolist(), int(rows[:, -1].max())

    def sort_chunks(
        self, chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Two-pass external sort.  ``chunks`` may be a one-shot
        generator: chunk data is retained in per-bucket spill files, so
        nothing is iterated twice.  Yields (sorted_keys, sorted_vals)
        per bucket in ascending global range order (at D > 1, this
        rank's owned range of each non-empty bucket)."""
        return self._sort_chunks(chunks, None, None)

    def _sort_chunks(self, chunks, preset_splitters, dtype):
        """:meth:`sort_chunks`; an oversized bucket's re-split passes the
        splitters and the (key, value) dtypes it agreed on over the group
        (``preset_splitters`` skips the sampling gather, and this rank's
        file may be empty), so every rank takes the same branches."""
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
            staged = []  # sorted chunks awaiting splitters
            try:
                # Splitters need a GLOBAL sample, so the first chunks are
                # staged (sorted, in memory) until this rank's first
                # non-empty chunk, whose sample every rank gathers (one
                # collective, joined by a rank without one at the end of
                # its stream).  For uniformly shuffled inputs one chunk's
                # quantiles are already unbiased; pathological (sorted/
                # clustered) orderings skew bucket fill, which pass 2
                # repairs by recursively re-splitting any bucket that
                # outgrew the per-step working-set bound.
                splitters = preset_splitters
                max_chunk_records = 0  # per-call (reuse must not inflate)
                for keys, vals in chunks:
                    keys = np.asarray(keys)
                    vals = np.asarray(vals)
                    if dtype is None:
                        dtype = (keys.dtype, vals.dtype)
                    self.chunks_in += 1
                    max_chunk_records = max(max_chunk_records, len(keys))
                    sk, sv = self.chunk_sorter.sort(keys, vals)
                    if splitters is not None:
                        self._spill(files, sk, sv, splitters)
                        continue
                    staged.append((sk, sv))
                    if len(sk):
                        splitters, dtype = self._agree_splitters(sk, dtype)
                        for s, v in staged:
                            self._spill(files, s, v, splitters)
                        staged = []
                if splitters is None:
                    # no non-empty chunk here: join the gather with none
                    splitters, dtype = self._agree_splitters(None, dtype)
            finally:
                for f in files:
                    f.finish()
            if dtype is None:
                return  # no rank had a chunk
            # pass 2: per-bucket device sort, in range order.  A bucket
            # that outgrew the working-set bound (adversarial input order
            # froze the splitters on an unrepresentative sample) is NOT
            # loaded whole: it is recursively re-split with splitters
            # sampled from its own data, keeping every device step at
            # O(max(chunk, balanced bucket)).  Every decision reads the
            # agreed global counts only.
            kd, vd = dtype
            item = np.dtype([("k", kd), ("v", vd)])
            counts, max_chunk = self._agree_counts(
                [os.path.getsize(p) // item.itemsize for p in paths],
                max_chunk_records)
            # the promised working-set bound: a balanced bucket (with 2x
            # slack for benign imbalance) or one chunk of each rank,
            # whichever is larger — balanced buckets never re-split,
            # only skew does
            cap = max(
                self.group.size * max_chunk,
                2 * sum(counts) // self.num_buckets,
                1,
            )
            for p, n_rec in zip(paths, counts):
                if n_rec == 0:
                    continue
                if (n_rec > cap and self.num_buckets > 1
                        and self.max_split_depth > 0):
                    yield from self._resplit_bucket(p, item, cap, n_rec)
                    continue
                rec = np.fromfile(p, dtype=item)
                self.max_bucket_records = max(self.max_bucket_records, n_rec)
                yield self.sorter.sort(rec["k"], rec["v"])

    def _resplit_bucket(
        self, path: str, item: np.dtype, cap: int, n_rec: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Re-sort one oversized bucket (``n_rec`` records over the
        group) through a child sorter over the same group, streaming
        this rank's file back in ≤cap-record chunks.  Unlike the parent
        (which froze splitters on its first chunks' samples), the child
        gets splitters from a strided sample of the ENTIRE bucket, every
        rank's file — the data is already on disk, so a representative
        sample is one sequential scan away and re-split buckets come out
        balanced even for sorted/clustered input."""
        child = ExternalTeraSorter(
            self.device,
            num_buckets=self.num_buckets,
            sample_per_chunk=self.sample_per_chunk,
            spill_dir=self.spill_dir,
            max_split_depth=self.max_split_depth - 1,
            direct_io=self.direct_io,
            group=self.group,
        )
        want = self.sample_per_chunk * self.num_buckets
        stride = max(1, n_rec // max(want, 1))
        keys = np.zeros(0, item["k"])
        if os.path.getsize(path):
            # memmap so sampling pages in only the touched records, not
            # the whole oversized file (that being too big is why we're
            # here)
            mm = np.memmap(path, dtype=item, mode="r")
            keys = np.array(mm["k"][::stride])
            del mm
        # a stride from the global count keeps every rank's sample under
        # 2 * want keys
        cat, _ = self._gather_keys(keys, 2 * max(want, 1),
                                   (item["k"], item["v"]))
        splitters = child._make_splitters([np.sort(cat.astype(item["k"]))])
        if len(splitters) == 0 or (splitters == splitters[0]).all():
            # duplicate-heavy bucket: identical splitters would route
            # everything into one child bucket again — recursion makes
            # no progress, so load-and-sort whole without burning
            # max_split_depth passes of disk churn first
            rec = np.fromfile(path, dtype=item)
            self.max_bucket_records = max(self.max_bucket_records, n_rec)
            yield self.sorter.sort(rec["k"], rec["v"])
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

        yield from child._sort_chunks(chunk_reader(), splitters,
                                      (item["k"], item["v"]))
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
        """Convenience non-streaming wrapper (array in, array out): at
        D > 1 this rank's shard in, what this rank owns out."""
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        outs = list(self.sort_chunks([(keys, vals)]))
        if not outs:
            return keys[:0], vals[:0]
        return (
            np.concatenate([k for k, _ in outs]),
            np.concatenate([v for _, v in outs]),
        )
