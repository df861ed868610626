"""Record serialization for the host record path.

The reference delegates serialization to Spark's SerializerInstance
inside the wrapped sort-shuffle writers (RdmaWrapperShuffleWriter.scala:85-101)
and wraps fetched streams for decompression on read
(RdmaShuffleReader.scala:51-58).  Here serializers are pluggable; the
default pickles record batches with a small length-prefixed framing so
partitions can be concatenated and sliced bytewise.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np

Record = Tuple[Any, Any]

_LEN = struct.Struct("<I")


class FrameTooLargeError(ValueError):
    """A single compression frame's body exceeds the 4-byte framing
    limit.  Structured: carries the offending sizes so callers (and the
    error message) can say exactly which knob to turn instead of a
    generic 'value too large'."""

    def __init__(self, frame_bytes: int, record_count: int,
                 frame_records: int, limit: int):
        self.frame_bytes = int(frame_bytes)
        self.record_count = int(record_count)
        self.frame_records = int(frame_records)
        self.limit = int(limit)
        per_record = self.frame_bytes // max(self.record_count, 1)
        super().__init__(
            f"compressed frame body of {self.frame_bytes}B exceeds the "
            f"{self.limit}B framing limit: {self.record_count} record(s) "
            f"averaging ~{per_record}B serialized each — lower "
            f"spark.shuffle.tpu.compressFrameRecords (currently "
            f"{self.frame_records}) so one frame holds fewer records"
        )


def as_view(data) -> memoryview:
    """Normalize any bytes-like block payload (``bytes``, ``bytearray``,
    ``memoryview``, contiguous uint8 ndarray) to a flat memoryview
    WITHOUT copying — the zero-copy exchange hands deserializers views
    of its destination rows, and every frame walker below slices this
    one view instead of materializing ``bytes``."""
    if isinstance(data, memoryview):
        return data.cast("B") if data.format != "B" else data
    return memoryview(data)


class Serializer:
    # True when the serializer offers ``deserialize_columns`` (the
    # columnar fast path); readers route on this flag.  ``data``
    # arguments throughout are bytes-like: deserializers must accept
    # memoryview/uint8-ndarray slices of an exchange destination row,
    # not just materialized ``bytes``.
    supports_columns = False

    def serialize(self, records: Iterable[Record]) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def deserialize(self, data) -> Iterator[Record]:  # pragma: no cover
        raise NotImplementedError

    def frame_spans(self, data) -> List[Tuple[int, int]]:
        """(start, end) byte spans of this serializer's self-contained
        frames inside ``data`` — the frame-parallel decode entry point
        (shuffle/decode.py): every serializer here frames
        concatenation-safely, so any contiguous GROUP of spans
        deserializes independently via ``deserialize(data[a:b])`` and
        one large block can fan out across decode workers.  Base
        serializers treat the whole payload as one frame."""
        return [(0, len(as_view(data)))]


class PickleSerializer(Serializer):
    """Batched pickle with 4-byte batch length prefixes."""

    def __init__(self, batch_size: int = 4096):
        self.batch_size = batch_size

    def serialize(self, records: Iterable[Record]) -> bytes:
        out = bytearray()
        batch: List[Record] = []
        for rec in records:
            batch.append(rec)
            if len(batch) >= self.batch_size:
                raw = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
                out += _LEN.pack(len(raw))
                out += raw
                batch = []
        if batch:
            raw = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
            out += _LEN.pack(len(raw))
            out += raw
        return bytes(out)

    def deserialize(self, data) -> Iterator[Record]:
        view = as_view(data)
        off = 0
        while off < len(view):
            if off + _LEN.size > len(view):
                raise ValueError(f"truncated batch header at offset {off}")
            (n,) = _LEN.unpack_from(view, off)
            off += _LEN.size
            if off + n > len(view):
                raise ValueError(
                    f"truncated batch: need {n}B at {off}, have {len(view) - off}B"
                )
            for rec in pickle.loads(view[off : off + n]):
                yield rec
            off += n

    def frame_spans(self, data) -> List[Tuple[int, int]]:
        """One span per length-prefixed pickle batch.  The walk is one
        native call when ``_staging.so`` is present (interpreter cost
        per BLOCK, not per frame); the Python loop is the fallback and
        the authority for truncation errors."""
        from sparkrdma_tpu_torch.memory.staging import native_frame_spans

        view = as_view(data)
        walked = native_frame_spans(view, 0)
        if walked is not None:
            return list(zip(walked[:, 0].tolist(),
                            walked[:, 1].tolist()))
        spans: List[Tuple[int, int]] = []
        off = 0
        while off < len(view):
            if off + _LEN.size > len(view):
                raise ValueError(f"truncated batch header at offset {off}")
            (n,) = _LEN.unpack_from(view, off)
            end = off + _LEN.size + n
            if end > len(view):
                raise ValueError(
                    f"truncated batch: need {n}B at {off + _LEN.size}, "
                    f"have {len(view) - off - _LEN.size}B"
                )
            spans.append((off, end))
            off = end
        return spans


class ColumnarSerializer(Serializer):
    """Raw-column frames for fixed-width records — the unsafe-row analog
    (the reference wraps Spark's ``UnsafeShuffleWriter`` precisely to
    keep record bytes off slow object paths,
    RdmaWrapperShuffleWriter.scala:85-101).

    Frame layout (concatenation-safe like every serializer here):

        1B magic (0xC2) | 1B flags (bit 0: key-sorted) |
        1B key-dtype len | key dtype str |
        1B val-dtype len | val dtype str | 4B record count |
        raw key column | raw val column

    ``serialize`` accepts a :class:`ColumnBatch`, an iterable of
    batches, or a plain iterable of (k, v) tuples (packed into one
    batch, dtypes inferred).  Records that cannot pack into fixed-width
    columns (ragged lists from a tuple-plane group combine, arbitrary
    objects) fall back to a PICKLE frame (magic 0xC3) so a
    manager-global columnar serializer never breaks the tuple plane;
    ``deserialize`` yields (k, v) tuples for generic-plane interop;
    ``deserialize_columns`` is the fast path, yielding zero-copy
    :class:`ColumnBatch` views over the input buffer (a pickle frame
    there is re-packed, or raises if unpackable)."""

    MAGIC = 0xC2
    MAGIC_PICKLE = 0xC3
    supports_columns = True

    def serialize(self, records) -> bytes:
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        if isinstance(records, ColumnBatch):
            batches = [records]
        else:
            records = list(records) if not isinstance(records, list) else records
            if records and all(isinstance(b, ColumnBatch) for b in records):
                batches = records
            elif records:
                try:
                    batches = [ColumnBatch.from_records(records)]
                except (TypeError, ValueError):
                    # not fixed-width packable (ragged combiners,
                    # arbitrary objects): pickle frame
                    raw = pickle.dumps(
                        records, protocol=pickle.HIGHEST_PROTOCOL
                    )
                    return (
                        bytes([self.MAGIC_PICKLE]) + _LEN.pack(len(raw)) + raw
                    )
            else:
                batches = []
        out = bytearray()
        for b in batches:
            if len(b) == 0:
                continue
            header, kv, vv = self._frame_parts(b)
            out += header
            out += kv.data  # memoryview: bytearray += ndarray would
            out += vv.data  # dispatch to numpy broadcasting instead
        return bytes(out)

    def frame_header(self, key_dtype, val_dtype, count: int,
                     key_sorted: bool) -> bytes:
        """One frame's header bytes — exposed so the writer's
        direct-assembly commit can lay frames out in its own buffer and
        gather columns straight into place (zero intermediate copies)."""
        kd = np.dtype(key_dtype).str.encode("ascii")
        vd = np.dtype(val_dtype).str.encode("ascii")
        if len(kd) > 255 or len(vd) > 255:
            raise ValueError("dtype string too long to frame")
        flags = 1 if key_sorted else 0
        return (
            bytes([self.MAGIC, flags, len(kd)]) + kd + bytes([len(vd)]) + vd
            + _LEN.pack(count)
        )

    def _frame_parts(self, b) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """(header, key bytes view, val bytes view) for one batch —
        the views are uint8 reinterpretations, NOT copies."""
        header = self.frame_header(
            b.keys.dtype, b.vals.dtype, len(b), b.key_sorted
        )
        return (
            header,
            np.ascontiguousarray(b.keys).view(np.uint8),
            np.ascontiguousarray(b.vals).view(np.uint8),
        )

    def serialize_chunks(self, records):
        """Zero-copy serialize: returns ``(total_length, chunks_fn)``
        where the chunks are small headers plus uint8 views over the
        column buffers — the commit path copies each byte ONCE, straight
        into its staging buffer (``ChunkedPayload`` contract,
        resolver.commit_map_output)."""
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        batches = (
            [records] if isinstance(records, ColumnBatch)
            else [b for b in records]
        )
        parts = []
        total = 0
        for b in batches:
            if len(b) == 0:
                continue
            header, kv, vv = self._frame_parts(b)
            parts.append((header, kv, vv))
            total += len(header) + kv.shape[0] + vv.shape[0]

        def chunks():
            for header, kv, vv in parts:
                yield header
                yield kv
                yield vv

        return total, chunks

    def deserialize_columns(self, data):
        """Fast path: yields :class:`ColumnBatch` per frame (pickle
        frames are re-packed into columns, or raise if unpackable)."""
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        for item in self._iter_items(data):
            if isinstance(item, ColumnBatch):
                yield item
            else:
                try:
                    yield ColumnBatch.from_records(item)
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        "stream holds records that cannot pack into "
                        "columns; read through deserialize() or use the "
                        "pickle serializer"
                    ) from e

    def _iter_items(self, data):
        """Walk frames: yields a ColumnBatch per columnar frame, a raw
        record list per pickle-fallback frame.  ``data`` may be any
        bytes-like; column arrays come out as zero-copy views over it
        (keep the backing row alive while the batches are)."""
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        view = as_view(data)
        off = 0
        total = len(view)
        while off < total:
            if view[off] == self.MAGIC_PICKLE:
                (n,) = _LEN.unpack_from(view, off + 1)
                off += 1 + _LEN.size
                yield pickle.loads(view[off : off + n])
                off += n
                continue
            if view[off] != self.MAGIC:
                raise ValueError(
                    f"bad columnar frame magic {view[off]:#x} at {off} "
                    "(mixed-serializer stream?)"
                )
            off += 1
            flags = view[off]
            off += 1
            nk = view[off]
            off += 1
            kd = np.dtype(bytes(view[off : off + nk]).decode("ascii"))
            off += nk
            nv = view[off]
            off += 1
            vd = np.dtype(bytes(view[off : off + nv]).decode("ascii"))
            off += nv
            (count,) = _LEN.unpack_from(view, off)
            off += _LEN.size
            kbytes = count * kd.itemsize
            vbytes = count * vd.itemsize
            if off + kbytes + vbytes > total:
                raise ValueError(
                    f"truncated columnar frame: need {kbytes + vbytes}B "
                    f"at {off}, have {total - off}B"
                )
            keys = np.frombuffer(view, dtype=kd, count=count, offset=off)
            off += kbytes
            vals = np.frombuffer(view, dtype=vd, count=count, offset=off)
            off += vbytes
            yield ColumnBatch(keys, vals, key_sorted=bool(flags & 1))

    def deserialize(self, data) -> Iterator[Record]:
        # ColumnBatch and raw record lists both iterate as (k, v)
        for item in self._iter_items(data):
            yield from item

    def frame_spans(self, data) -> List[Tuple[int, int]]:
        """One span per columnar/pickle frame: a header-only walk (no
        column views built) so splitting a block across decode workers
        costs O(frames), not O(bytes) — and one NATIVE call when
        ``_staging.so`` is present (the C side parses the fixed-width
        dtype headers; exotic dtypes fall back here)."""
        from sparkrdma_tpu_torch.memory.staging import native_columnar_frame_spans

        view = as_view(data)
        walked = native_columnar_frame_spans(view)
        if walked is not None:
            return list(zip(walked[:, 0].tolist(),
                            walked[:, 1].tolist()))
        spans: List[Tuple[int, int]] = []
        off = 0
        total = len(view)
        while off < total:
            start = off
            if view[off] == self.MAGIC_PICKLE:
                (n,) = _LEN.unpack_from(view, off + 1)
                off += 1 + _LEN.size + n
            elif view[off] == self.MAGIC:
                off += 2  # magic + flags
                nk = view[off]
                kd = np.dtype(bytes(view[off + 1 : off + 1 + nk]).decode("ascii"))
                off += 1 + nk
                nv = view[off]
                vd = np.dtype(bytes(view[off + 1 : off + 1 + nv]).decode("ascii"))
                off += 1 + nv
                (count,) = _LEN.unpack_from(view, off)
                off += _LEN.size + count * (kd.itemsize + vd.itemsize)
            else:
                raise ValueError(
                    f"bad columnar frame magic {view[off]:#x} at {off} "
                    "(mixed-serializer stream?)"
                )
            if off > total:
                raise ValueError(
                    f"truncated columnar frame at {start}: frame ends at "
                    f"{off}, stream holds {total}B"
                )
            spans.append((start, off))
        return spans


class CompressedSerializer(Serializer):
    """Compression wrapper over any serializer — the analog of the
    reference's read-side stream wrapping for codec support
    (``wrapStream`` reflection, RdmaShuffleReader.scala:51-58,117-127),
    applied symmetrically on write.  Codecs: ``zlib`` (default) and
    ``lzma``; payloads below ``min_size`` are stored raw (codec tag 0)
    since small-block compression costs more than it saves.

    Framing is ``1B tag + 4B length + body`` per serialize() call, so
    outputs are CONCATENATION-SAFE like the inner serializer's — the
    writer's spill-merge and any block concatenation rely on this
    (plain ``zlib.decompress`` would silently discard trailing frames).

    Wire-format versioning: this framed layout is
    ``WIRE_FORMAT_VERSION`` 2 (v1 was unframed ``1B tag + body``).  Any
    future layout change MUST claim fresh codec tag values so that
    mixed-version data fails fast on the existing "unknown codec tag"
    check instead of decoding garbage — tags 0-2 are forever v2.
    """

    WIRE_FORMAT_VERSION = 2
    _RAW, _ZLIB, _LZMA = 0, 1, 2

    # hard framing ceiling of the 4B length field (class attribute so
    # the structured-error unit test can lower it without manufacturing
    # a 4 GiB frame)
    MAX_FRAME_BODY = (1 << 32) - 1

    def __init__(self, inner: Serializer = None, codec: str = "zlib",
                 level: int = 1, min_size: int = 256,
                 frame_records: Optional[int] = None):
        self.inner = inner or PickleSerializer()
        if codec not in ("zlib", "lzma"):
            raise ValueError(f"unknown codec: {codec!r}")
        self.codec = codec
        self.level = level
        self.min_size = min_size
        if frame_records is not None:
            self.frame_records = max(1, int(frame_records))
        self.supports_columns = getattr(self.inner, "supports_columns", False)

    # one frame per this many records: bounds frame bodies far below the
    # 4B length field's 4 GiB ceiling for sane record sizes, and sets
    # the granularity of frame-parallel decode (conf
    # spark.shuffle.tpu.compressFrameRecords overrides per manager)
    frame_records = 65536

    def serialize(self, records: Iterable[Record]) -> bytes:
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        if isinstance(records, ColumnBatch):
            # columnar fast path: one frame per frame_records-sized
            # sub-batch (zero-copy column views), no per-record walk —
            # bounding frames keeps decompression splittable at frame
            # boundaries (one giant batch would serialize into a
            # single monolithic frame no decode worker can share)
            out = bytearray()
            for sub in self._iter_frame_batches(records):
                out += self._frame(self.inner.serialize(sub), len(sub))
            if not out:
                out += self._frame(self.inner.serialize(records), 0)
            return bytes(out)
        out = bytearray()
        batch: List[Record] = []
        for rec in records:
            if isinstance(rec, ColumnBatch):
                if batch:
                    out += self._frame(self.inner.serialize(batch), len(batch))
                    batch = []
                for sub in self._iter_frame_batches(rec):
                    out += self._frame(self.inner.serialize(sub), len(sub))
                continue
            batch.append(rec)
            if len(batch) >= self.frame_records:
                out += self._frame(self.inner.serialize(batch), len(batch))
                batch = []
        if batch or not out:
            out += self._frame(self.inner.serialize(batch), len(batch))
        return bytes(out)

    def _iter_frame_batches(self, b):
        """Slice one ColumnBatch into ≤ frame_records sub-batches —
        column VIEWS, no copies; sortedness carries over."""
        from sparkrdma_tpu_torch.utils.columns import ColumnBatch

        n = len(b)
        fr = self.frame_records
        if n == 0:
            return
        if n <= fr:
            yield b
            return
        for lo in range(0, n, fr):
            yield ColumnBatch(
                b.keys[lo : lo + fr], b.vals[lo : lo + fr],
                key_sorted=b.key_sorted,
            )

    def _frame(self, raw: bytes, record_count: int = -1) -> bytes:
        if len(raw) < self.min_size:
            tag, body = self._RAW, raw
        elif self.codec == "zlib":
            import zlib

            tag, body = self._ZLIB, zlib.compress(raw, self.level)
        else:
            import lzma

            tag, body = self._LZMA, lzma.compress(raw)
        if len(body) > self.MAX_FRAME_BODY:
            raise FrameTooLargeError(
                len(body), record_count, self.frame_records,
                self.MAX_FRAME_BODY,
            )
        return bytes([tag]) + _LEN.pack(len(body)) + body

    def frame_spans(self, data) -> List[Tuple[int, int]]:
        """One span per ``tag + length + body`` frame — decompression
        splits at these boundaries, so one large block's inflate fans
        out across decode workers (each span group is decoded
        independently through ``deserialize``/``deserialize_columns``).
        Walked natively when ``_staging.so`` is present (1-byte tag
        prefix + 4B length, the same layout the pickle walk uses)."""
        from sparkrdma_tpu_torch.memory.staging import native_frame_spans

        view = as_view(data)
        walked = native_frame_spans(view, 1)
        if walked is not None:
            return list(zip(walked[:, 0].tolist(),
                            walked[:, 1].tolist()))
        spans: List[Tuple[int, int]] = []
        off = 0
        while off < len(view):
            if off + 1 + _LEN.size > len(view):
                raise ValueError(f"truncated frame header at offset {off}")
            (n,) = _LEN.unpack_from(view, off + 1)
            end = off + 1 + _LEN.size + n
            if end > len(view):
                raise ValueError(
                    f"truncated frame: need {n}B at {off + 1 + _LEN.size}, "
                    f"have {len(view) - off - 1 - _LEN.size}B"
                )
            spans.append((off, end))
            off = end
        return spans

    def _iter_frames(self, data) -> Iterator[bytes]:
        view = as_view(data)
        off = 0
        while off < len(view):
            if off + 1 + _LEN.size > len(view):
                raise ValueError(f"truncated frame header at offset {off}")
            tag = view[off]
            (n,) = _LEN.unpack_from(view, off + 1)
            off += 1 + _LEN.size
            if off + n > len(view):
                raise ValueError(
                    f"truncated frame: need {n}B at {off}, "
                    f"have {len(view) - off}B"
                )
            # zero-copy: codecs and the inner deserializers all take
            # buffer views — materializing ``bytes`` here would copy
            # every compressed body once more on the decode hot path
            body = view[off : off + n]
            off += n
            if tag == self._RAW:
                yield body
            elif tag == self._ZLIB:
                import zlib

                yield zlib.decompress(body)
            elif tag == self._LZMA:
                import lzma

                yield lzma.decompress(body)
            else:
                raise ValueError(f"unknown codec tag {tag}")

    def deserialize(self, data) -> Iterator[Record]:
        for raw in self._iter_frames(data):
            yield from self.inner.deserialize(raw)

    def deserialize_columns(self, data: bytes):
        """Columnar read path through the codec wrapper (only valid when
        ``supports_columns`` — i.e. the inner serializer is columnar)."""
        for raw in self._iter_frames(data):
            if raw:
                yield from self.inner.deserialize_columns(raw)
