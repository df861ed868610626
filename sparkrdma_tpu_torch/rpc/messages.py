"""Compact binary control-plane RPC messages, declared as wire schemas.

The reference frames every control message as ``4B length + 4B type``
followed by a type-specific payload, and *segments* large payloads into
recv-WR-sized registered buffers so they ride fixed-size RDMA SENDs
(reference: RdmaRpcMsg.scala:31-87, toRdmaByteBufferManagedBuffers).

Same scheme here: :meth:`RpcMsg.encode_segments` yields one or more
independently-decodable frames, each at most ``max_segment_size`` bytes.
Segmentable messages (announce / publish / fetch-status / response) split
their element lists across frames; each frame is a complete message of the
same type covering a sub-range, so the receiver just applies them in any
order (the publish path lands each sub-range via
``MapTaskOutput.put_range``).

Every message class declares its wire layout as a ``WIRE_SCHEMA`` — an
ordered tuple of :class:`WireField` specs (name, struct code,
variable-length section rule).  For fixed-layout messages the codec pair
(``_payload`` / ``_decode_payload``) is DERIVED from the schema, so
pack/unpack symmetry is true by construction; the one hand-written codec
(:class:`ExchangePlanMsg`, whose manifest nests rows) declares its
sections as ``custom`` fields and is checked for symmetry by the static
gate (tools/wirecheck.py, WC01).  Schema-driven decode validates every
count/length field against the received buffer BEFORE allocating or
looping (WC05's runtime contract), and all malformed input surfaces as
:class:`WireFormatError` — a ``ValueError`` carrying the message type
and a hexdump context, so one bad frame never costs more than itself.

The first five message types mirror the reference's set
(RdmaRpcMsg.scala:31-35); types 6-7 carry the failure-detection plane
the reference gets from RDMA CM DISCONNECTED events + Spark's
onBlockManagerRemoved listener (RdmaNode.java:176-189,
RdmaShuffleManager.scala:253-263), which have no transport-level analog
here:

====  =====================================  ===========================
type  class                                  direction
====  =====================================  ===========================
 1    HelloMsg                               executor → driver
 2    AnnounceShuffleManagersMsg             driver → all executors
 3    PublishMapTaskOutputMsg                executor → driver
 4    FetchMapStatusMsg                      executor → driver
 5    FetchMapStatusResponseMsg              driver → executor
 6    FetchMapStatusFailedMsg                driver → executor
 7    HeartbeatMsg                           driver ↔ executor
 8    FetchExchangePlanMsg                   executor → driver
 9    ExchangePlanMsg                        driver → executor
 10   PublishShuffleMetricsMsg               executor → driver
 11   PrefetchHintMsg                        reader → serving executor
 12   CleanShuffleMsg                        driver → all executors
 13   PushSubBlockMsg                        writer → merger executor
 14   FetchMergeStatusMsg                    reader → merger executor
 15   MergeStatusResponseMsg                 merger → reader
====  =====================================  ===========================

Types 8-9 carry the BULK-SYNCHRONOUS collective shuffle plan: after the
map phase, every participating host asks the driver for the globally
agreed (src host × dst host) stream-length matrix plus its own
destination manifest, so all hosts can launch ONE symmetric collective
exchange (SPMD needs identical shapes everywhere — SURVEY.md §7
"pull → collective inversion" across hosts).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Type

from sparkrdma_tpu_torch.utils.types import (
    LOCATION_ENTRY_SIZE,
    BlockLocation,
    BlockManagerId,
    ShuffleManagerId,
)

_HEADER = struct.Struct("<ii")  # (frame_length, msg_type)
HEADER_SIZE = _HEADER.size

# The named structs every codec builds from — sizes always come from
# these (``.size``), never from integer literals (wirecheck WC04).
_I32 = struct.Struct("<i")
_Q64 = struct.Struct("<q")
_PAIR_II = struct.Struct("<ii")      # (map_id, reduce_id)
_PLAN_BLOCK = struct.Struct("<iiq")  # (map_id, reduce_id, length)
_PLAN_TAIL = struct.Struct("<iBi")   # (window, final, len(my_maps))

# Smallest possible serialized ShuffleManagerId (all-empty strings) —
# the count-validation floor for smid lists.
_SMID_MIN_SIZE = ShuffleManagerId(
    "", 0, BlockManagerId("", "", 0)
).serialized_length()


def hex_context(data, limit: int = 32) -> str:
    """First ``limit`` bytes as a hexdump fragment for error context."""
    view = bytes(memoryview(data)[:limit])
    dump = view.hex(" ")
    suffix = "…" if len(data) > limit else ""
    return f"{len(data)}B [{dump}{suffix}]"


class WireFormatError(ValueError):
    """A frame that violates the wire contract — truncated, oversized
    length field, unknown type.  Subclasses ``ValueError`` so existing
    decode-contract callers keep working; carries enough structure for
    the receive paths to count and scope the failure to ONE frame."""

    def __init__(self, message: str, *, msg_type=None,
                 unknown_type: bool = False):
        super().__init__(message)
        self.msg_type = msg_type
        self.unknown_type = unknown_type


def _require(view: memoryview, off: int, need: int) -> None:
    """Bounds guard: the next ``need`` bytes must exist at ``off``."""
    if need < 0 or off + need > len(view):
        raise WireFormatError(
            f"truncated payload: need {need}B at offset {off}, "
            f"have {len(view) - off}B"
        )


def _check_count(n: int, min_elem: int, view: memoryview,
                 off: int) -> int:
    """Validate a wire-supplied element count against the bytes that
    actually follow, BEFORE any allocation or loop sized by it — a
    lying count must cost nothing (no multi-GiB list from a 20-byte
    frame)."""
    if n < 0 or n * min_elem > len(view) - off:
        raise WireFormatError(
            f"bad element count {n} (×{min_elem}B min) with "
            f"{len(view) - off}B remaining"
        )
    return n


class WireField:
    """One field of a message's wire layout, in wire order.

    kind:
      ``scalar``      one struct code (e.g. ``<i``)
      ``bool``        struct-coded int carrying a bool
      ``smid``        a ShuffleManagerId (self-delimiting)
      ``list``        ``<i`` count + count elements (elem: ``smid``,
                      ``loc``, or a struct code like ``<ii``)
      ``bytes``       ``<i`` length + raw bytes
      ``str``         ``<i`` length + UTF-8, truncated to ``max_len``
      ``bytes_rest``  raw bytes to end of payload (last field only)
      ``custom``      hand-written codec section; ``code`` documents the
                      layout and wirecheck audits the methods (WC01/05)

    ``since`` > 1 marks an OPTIONAL-TAIL field added at that wire
    generation: scalar fields after every base field, defaulting to 0.
    The derived codec emits the tail only when the negotiated wire
    version allows it AND some tail value is non-zero — so a message
    with all-default tail values encodes byte-identically to its
    pre-tail generation (golden-frame pinned), and v1 peers never see
    bytes they would reject as trailing garbage.  Decode accepts the
    tail present or absent (absent → defaults), which is unambiguous
    because the last base field of any tailed schema is
    self-delimiting (count-prefixed).
    """

    __slots__ = ("name", "kind", "code", "st", "n_values", "max_len",
                 "since")

    def __init__(self, name: str, kind: str, code=None, max_len=None,
                 since: int = 1):
        self.name = name
        self.kind = kind
        self.code = code
        self.max_len = max_len
        self.since = since
        if since > 1 and kind != "scalar":
            raise ValueError(
                f"wire field {name!r}: optional-tail fields must be "
                f"scalars (got {kind!r})"
            )
        self.st = None
        self.n_values = 0
        if kind in ("scalar", "bool") or (
            kind == "list" and code not in ("smid", "loc")
        ):
            if not (isinstance(code, str) and code.startswith("<")):
                raise ValueError(
                    f"wire field {name!r}: struct code {code!r} must be "
                    f"explicit little-endian ('<'-prefixed)"
                )
            self.st = struct.Struct(code)
            self.n_values = len(self.st.unpack(bytes(self.st.size)))

    # -- readable constructors ----------------------------------------------
    @classmethod
    def i32(cls, name):
        return cls(name, "scalar", "<i")

    @classmethod
    def scalar(cls, name, code, since: int = 1):
        return cls(name, "scalar", code, since=since)

    @classmethod
    def bool_i32(cls, name):
        return cls(name, "bool", "<i")

    @classmethod
    def smid(cls, name):
        return cls(name, "smid")

    @classmethod
    def list(cls, name, elem):
        return cls(name, "list", elem)

    @classmethod
    def bytes_i32(cls, name):
        return cls(name, "bytes")

    @classmethod
    def str_i32(cls, name, max_len):
        return cls(name, "str", max_len=max_len)

    @classmethod
    def bytes_rest(cls, name):
        return cls(name, "bytes_rest")

    @classmethod
    def custom(cls, name, layout):
        return cls(name, "custom", layout)


F = WireField


def _schema_is_derived(schema) -> bool:
    return all(f.kind != "custom" for f in schema)


def _tail_fields(schema):
    """The optional-tail fields (``since`` > 1), validated to sit after
    every base field — a tail in the middle would be ambiguous."""
    tail = tuple(f for f in schema if f.since > 1)
    if tail and schema[-len(tail):] != tail:
        raise ValueError("optional-tail fields must be last in schema")
    return tail


def _emit_tail(msg: "RpcMsg", tail, wire_version) -> bool:
    """Whether to encode the optional tail: the negotiated generation
    must allow it (None → current) and some value must be non-zero."""
    if not tail:
        return False
    if wire_version is not None and any(
        wire_version < f.since for f in tail
    ):
        return False
    return any(getattr(msg, f.name) for f in tail)


def _encode_field(buf: bytearray, f: WireField, v) -> None:
    kind = f.kind
    if kind == "scalar":
        buf += f.st.pack(v)
    elif kind == "bool":
        buf += f.st.pack(int(bool(v)))
    elif kind == "smid":
        v.write(buf)
    elif kind == "list":
        buf += _I32.pack(len(v))
        if f.code in ("smid", "loc"):
            for e in v:
                e.write(buf)
        elif f.n_values == 1:
            for e in v:
                buf += f.st.pack(e)
        else:
            for e in v:
                buf += f.st.pack(*e)
    elif kind == "bytes":
        buf += _I32.pack(len(v))
        buf += v
    elif kind == "str":
        raw = v.encode("utf-8")[: f.max_len]
        buf += _I32.pack(len(raw))
        buf += raw
    elif kind == "bytes_rest":
        buf += v
    else:  # pragma: no cover - schema validated at class definition
        raise TypeError(f"cannot derive encoder for {f.kind!r} field")


def _field_size(f: WireField, v) -> int:
    kind = f.kind
    if kind in ("scalar", "bool"):
        return f.st.size
    if kind == "smid":
        return v.serialized_length()
    if kind == "list":
        if f.code == "smid":
            return _I32.size + sum(e.serialized_length() for e in v)
        if f.code == "loc":
            return _I32.size + LOCATION_ENTRY_SIZE * len(v)
        return _I32.size + f.st.size * len(v)
    if kind == "bytes":
        return _I32.size + len(v)
    if kind == "str":
        return _I32.size + len(v.encode("utf-8")[: f.max_len])
    if kind == "bytes_rest":
        return len(v)
    raise TypeError(f"cannot size {f.kind!r} field")  # pragma: no cover


def _decode_field(f: WireField, view: memoryview, off: int):
    """Decode one schema field at ``off``; returns (value, new offset).
    Every wire-supplied length/count is validated against the buffer
    before it sizes a read, loop, or allocation."""
    kind = f.kind
    if kind == "scalar":
        _require(view, off, f.st.size)
        vals = f.st.unpack_from(view, off)
        return (vals[0] if f.n_values == 1 else vals), off + f.st.size
    if kind == "bool":
        _require(view, off, f.st.size)
        (v,) = f.st.unpack_from(view, off)
        return bool(v), off + f.st.size
    if kind == "smid":
        return ShuffleManagerId.read(view, off)
    if kind == "list":
        _require(view, off, _I32.size)
        (n,) = _I32.unpack_from(view, off)
        off += _I32.size
        if f.code == "smid":
            _check_count(n, _SMID_MIN_SIZE, view, off)
            out = []
            for _ in range(n):
                e, off = ShuffleManagerId.read(view, off)
                out.append(e)
            return out, off
        if f.code == "loc":
            _check_count(n, LOCATION_ENTRY_SIZE, view, off)
            out = []
            for _ in range(n):
                out.append(BlockLocation.read(view, off))
                off += LOCATION_ENTRY_SIZE
            return out, off
        _check_count(n, f.st.size, view, off)
        out = []
        for _ in range(n):
            vals = f.st.unpack_from(view, off)
            out.append(vals[0] if f.n_values == 1 else vals)
            off += f.st.size
        return out, off
    if kind == "bytes":
        _require(view, off, _I32.size)
        (n,) = _I32.unpack_from(view, off)
        off += _I32.size
        _require(view, off, n)
        return bytes(view[off : off + n]), off + n
    if kind == "str":
        _require(view, off, _I32.size)
        (n,) = _I32.unpack_from(view, off)
        off += _I32.size
        _require(view, off, n)
        return bytes(view[off : off + n]).decode("utf-8", "replace"), off + n
    if kind == "bytes_rest":
        return bytes(view[off:]), len(view)
    raise TypeError(f"cannot decode {f.kind!r} field")  # pragma: no cover


class RpcMsg:
    """Base class: framing + segmentation + schema-derived codecs."""

    MSG_TYPE: int = 0
    WIRE_SCHEMA: Tuple[WireField, ...] = ()

    # -- schema-derived codec ------------------------------------------------
    def _payload(self, wire_version=None) -> bytes:
        """Serialize per the schema.  ``wire_version`` pins the target
        generation (None → current): optional-tail fields (``since`` >
        1) are emitted only when the generation allows them and some
        tail value is non-zero, keeping all-default encodings
        byte-identical across generations."""
        schema = type(self).WIRE_SCHEMA
        if not _schema_is_derived(schema):  # pragma: no cover
            raise NotImplementedError(
                f"{type(self).__name__} has custom wire sections and "
                f"must hand-write _payload"
            )
        tail = _emit_tail(self, _tail_fields(schema), wire_version)
        buf = bytearray()
        for f in schema:
            if f.since > 1 and not tail:
                continue
            _encode_field(buf, f, getattr(self, f.name))
        return bytes(buf)

    def _payload_size(self, wire_version=None) -> int:
        """Cheap payload-size estimate used to decide splitting without
        serializing — derived from the schema field by field."""
        schema = type(self).WIRE_SCHEMA
        tail = _emit_tail(self, _tail_fields(schema), wire_version)
        return sum(
            _field_size(f, getattr(self, f.name))
            for f in schema
            if f.since == 1 or tail
        )

    @classmethod
    def _decode_payload(cls, view: memoryview) -> "RpcMsg":
        schema = cls.WIRE_SCHEMA
        if not _schema_is_derived(schema):  # pragma: no cover
            raise NotImplementedError(
                f"{cls.__name__} has custom wire sections and must "
                f"hand-write _decode_payload"
            )
        kwargs = {}
        off = 0
        for f in schema:
            if f.since > 1 and off == len(view):
                # optional tail absent (an older-generation or
                # all-default frame): defaults apply
                kwargs[f.name] = 0
                continue
            kwargs[f.name], off = _decode_field(f, view, off)
        if off != len(view):
            raise WireFormatError(
                f"{cls.__name__}: {len(view) - off}B of trailing garbage"
            )
        return cls(**kwargs)

    def _split(self, max_payload: int) -> Sequence["RpcMsg"]:
        """Split into messages whose payloads each fit max_payload.
        Default: no splitting supported."""
        return (self,)

    # -- framing ------------------------------------------------------------
    def _frame(self, payload: bytes) -> bytes:
        return _HEADER.pack(HEADER_SIZE + len(payload), self.MSG_TYPE) + payload

    def encode(self, wire_version=None) -> bytes:
        return self._frame(self._payload(wire_version))

    def encode_segments(self, max_segment_size: int,
                        wire_version=None) -> List[bytes]:
        """Encode into frames each ≤ max_segment_size bytes.
        ``wire_version`` pins the peer's negotiated generation (None →
        current) so optional-tail fields stay off frames bound for
        older peers."""
        max_payload = max_segment_size - HEADER_SIZE
        if max_payload <= 0:
            raise ValueError(f"segment size too small: {max_segment_size}")
        size = self._payload_size(wire_version)
        if size <= max_payload:
            return [self._frame(self._payload(wire_version))]
        parts = self._split(max_payload)
        if len(parts) == 1:
            raise ValueError(
                f"{type(self).__name__} payload {size}B exceeds segment "
                f"size {max_segment_size}B and cannot be split further"
            )
        out: List[bytes] = []
        for p in parts:
            psize = p._payload_size(wire_version)
            if psize > max_payload:
                # an atomic element (e.g. one id with a very long hostname,
                # or a fixed header) alone exceeds the segment size
                raise ValueError(
                    f"{type(self).__name__} segment payload {psize}B still "
                    f"exceeds segment size {max_segment_size}B"
                )
            out.append(p._frame(p._payload(wire_version)))
        return out


def decode_msg(data: bytes) -> RpcMsg:
    """Decode one frame (dispatch by type header,
    reference: RdmaRpcMsg.scala:67-87).

    Every malformed input — truncated header, length mismatch, unknown
    type, bad field — raises :class:`WireFormatError` (a ``ValueError``),
    never anything the receive paths would mistake for an engine fault:
    the blast radius of a bad frame is exactly that frame."""
    if len(data) < HEADER_SIZE:
        raise WireFormatError(
            f"frame too short: {hex_context(data)}"
        )
    length, msg_type = _HEADER.unpack_from(data, 0)
    if length != len(data):
        raise WireFormatError(
            f"frame length {length} != buffer length {len(data)}",
            msg_type=msg_type,
        )
    cls = MSG_TYPES.get(msg_type)
    if cls is None:
        raise WireFormatError(
            f"unknown RPC message type {msg_type}: {hex_context(data)}",
            msg_type=msg_type, unknown_type=True,
        )
    try:
        return cls._decode_payload(memoryview(data)[HEADER_SIZE:])
    except WireFormatError as e:
        if e.msg_type is None:
            e.msg_type = msg_type
        raise
    except (struct.error, ValueError) as e:
        # malformed frames must surface as ValueError, the decode contract
        raise WireFormatError(
            f"malformed {cls.__name__} frame: {e}", msg_type=msg_type
        ) from e


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HelloMsg(RpcMsg):
    """Executor advertises itself to the driver on startup
    (reference: RdmaShuffleManagerHelloRpcMsg, RdmaRpcMsg.scala:90-119)."""

    shuffle_manager_id: ShuffleManagerId
    channel_port: int  # port the driver should connect back to

    MSG_TYPE = 1
    WIRE_SCHEMA = (
        F.smid("shuffle_manager_id"),
        F.i32("channel_port"),
    )


@dataclass(frozen=True)
class AnnounceShuffleManagersMsg(RpcMsg):
    """Driver broadcasts the current membership so executors pre-connect
    the full mesh (reference: RdmaAnnounceRdmaShuffleManagersRpcMsg,
    RdmaRpcMsg.scala:121-180)."""

    shuffle_manager_ids: Tuple[ShuffleManagerId, ...]

    MSG_TYPE = 2
    WIRE_SCHEMA = (
        F.list("shuffle_manager_ids", "smid"),
    )

    def __init__(self, shuffle_manager_ids: Sequence[ShuffleManagerId]):
        object.__setattr__(self, "shuffle_manager_ids", tuple(shuffle_manager_ids))

    def _split(self, max_payload: int) -> Sequence["AnnounceShuffleManagersMsg"]:
        parts: List[AnnounceShuffleManagersMsg] = []
        cur: List[ShuffleManagerId] = []
        cur_len = _I32.size
        for smid in self.shuffle_manager_ids:
            n = smid.serialized_length()
            if cur and cur_len + n > max_payload:
                parts.append(AnnounceShuffleManagersMsg(cur))
                cur, cur_len = [], _I32.size
            cur.append(smid)
            cur_len += n
        if cur:
            parts.append(AnnounceShuffleManagersMsg(cur))
        return parts


@dataclass(frozen=True)
class PublishMapTaskOutputMsg(RpcMsg):
    """Executor publishes a map task's location table to the driver,
    possibly as several sub-range segments
    (reference: RdmaPublishMapTaskOutputRpcMsg, RdmaRpcMsg.scala:182-276).

    ``entries`` holds the raw 16-byte location entries for partitions
    [first_reduce_id, last_reduce_id] inclusive.  ``epoch`` tags which
    publish generation of the map task's table this segment belongs to
    (delta-sync: a republish after a location change ships only the
    changed runs at a higher epoch, and the driver's per-entry epoch
    guard keeps out-of-order segment application from resurrecting
    stale locations — MapTaskOutput.put_range).
    """

    shuffle_manager_id: ShuffleManagerId
    shuffle_id: int
    map_id: int
    total_num_partitions: int
    first_reduce_id: int
    last_reduce_id: int
    entries: bytes
    epoch: int = 0

    MSG_TYPE = 3
    WIRE_SCHEMA = (
        F.smid("shuffle_manager_id"),
        F.i32("shuffle_id"),
        F.i32("map_id"),
        F.i32("total_num_partitions"),
        F.i32("first_reduce_id"),
        F.i32("last_reduce_id"),
        F.i32("epoch"),
        F.bytes_rest("entries"),
    )

    def __post_init__(self):
        expect = (self.last_reduce_id - self.first_reduce_id + 1) * LOCATION_ENTRY_SIZE
        if len(self.entries) != expect:
            raise ValueError(
                f"entries {len(self.entries)}B != expected {expect}B for range "
                f"[{self.first_reduce_id},{self.last_reduce_id}]"
            )

    def _split(self, max_payload: int) -> Sequence["PublishMapTaskOutputMsg"]:
        fixed = self._payload_size() - len(self.entries)
        per_seg = max(1, (max_payload - fixed) // LOCATION_ENTRY_SIZE)
        parts: List[PublishMapTaskOutputMsg] = []
        first = self.first_reduce_id
        while first <= self.last_reduce_id:
            last = min(first + per_seg - 1, self.last_reduce_id)
            lo = (first - self.first_reduce_id) * LOCATION_ENTRY_SIZE
            hi = (last - self.first_reduce_id + 1) * LOCATION_ENTRY_SIZE
            parts.append(
                PublishMapTaskOutputMsg(
                    self.shuffle_manager_id,
                    self.shuffle_id,
                    self.map_id,
                    self.total_num_partitions,
                    first,
                    last,
                    self.entries[lo:hi],
                    self.epoch,
                )
            )
            first = last + 1
        return parts


@dataclass(frozen=True)
class FetchMapStatusMsg(RpcMsg):
    """Executor asks the driver for the locations of a set of
    (map_id, reduce_id) blocks served by one remote host; the response is
    routed through ``callback_id``
    (reference: RdmaFetchMapStatusRpcMsg, RdmaRpcMsg.scala:279-367).

    Wide requests split across segments: each segment is an independent
    request carrying ``total`` (the whole logical request's block count)
    and ``index`` (offset of this segment's first block), and the driver's
    per-segment responses reuse those so the requester reassembles one
    answer of ``total`` locations.
    """

    requester: ShuffleManagerId
    host: ShuffleManagerId  # whose map outputs we want
    shuffle_id: int
    callback_id: int
    block_ids: Tuple[Tuple[int, int], ...]  # (map_id, reduce_id) pairs
    total: int = -1  # blocks in the whole logical request; -1 → len(block_ids)
    index: int = 0   # offset of block_ids[0] within the logical request
    trace_id: int = 0  # v2 optional tail: distributed trace correlation
    span_id: int = 0

    MSG_TYPE = 4
    WIRE_SCHEMA = (
        F.smid("requester"),
        F.smid("host"),
        F.i32("shuffle_id"),
        F.i32("callback_id"),
        F.i32("total"),
        F.i32("index"),
        F.list("block_ids", "<ii"),
        F.scalar("trace_id", "<Q", since=2),
        F.scalar("span_id", "<Q", since=2),
    )

    def __init__(self, requester, host, shuffle_id, callback_id, block_ids,
                 total=-1, index=0, trace_id=0, span_id=0):
        object.__setattr__(self, "requester", requester)
        object.__setattr__(self, "host", host)
        object.__setattr__(self, "shuffle_id", shuffle_id)
        object.__setattr__(self, "callback_id", callback_id)
        object.__setattr__(self, "block_ids", tuple(tuple(b) for b in block_ids))
        object.__setattr__(self, "total", len(self.block_ids) if total < 0 else total)
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "trace_id", trace_id)
        object.__setattr__(self, "span_id", span_id)

    def _split(self, max_payload: int) -> Sequence["FetchMapStatusMsg"]:
        fixed = self._payload_size() - _PAIR_II.size * len(self.block_ids)
        per_seg = max(1, (max_payload - fixed) // _PAIR_II.size)
        parts: List[FetchMapStatusMsg] = []
        for start in range(0, len(self.block_ids), per_seg):
            parts.append(
                FetchMapStatusMsg(
                    self.requester, self.host, self.shuffle_id, self.callback_id,
                    self.block_ids[start : start + per_seg],
                    total=self.total, index=self.index + start,
                    trace_id=self.trace_id, span_id=self.span_id,
                )
            )
        return parts


@dataclass(frozen=True)
class FetchMapStatusResponseMsg(RpcMsg):
    """Driver's answer: one BlockLocation per requested block, in request
    order, split across segments when large.  ``index`` is the offset of
    this segment's first location within the full answer, ``total`` the
    full answer's length (reference: RdmaFetchMapStatusResponseRpcMsg,
    RdmaRpcMsg.scala:369-446)."""

    callback_id: int
    total: int
    index: int
    locations: Tuple[BlockLocation, ...]

    MSG_TYPE = 5
    WIRE_SCHEMA = (
        F.i32("callback_id"),
        F.i32("total"),
        F.i32("index"),
        F.list("locations", "loc"),
    )

    def __init__(self, callback_id, total, index, locations):
        object.__setattr__(self, "callback_id", callback_id)
        object.__setattr__(self, "total", total)
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "locations", tuple(locations))

    def _split(self, max_payload: int) -> Sequence["FetchMapStatusResponseMsg"]:
        fixed = self._payload_size() - LOCATION_ENTRY_SIZE * len(self.locations)
        per_seg = max(1, (max_payload - fixed) // LOCATION_ENTRY_SIZE)
        parts: List[FetchMapStatusResponseMsg] = []
        for start in range(0, len(self.locations), per_seg):
            parts.append(
                FetchMapStatusResponseMsg(
                    self.callback_id,
                    self.total,
                    self.index + start,
                    self.locations[start : start + per_seg],
                )
            )
        return parts


@dataclass(frozen=True)
class FetchMapStatusFailedMsg(RpcMsg):
    """Driver tells a requester its fetch-status CANNOT be answered —
    unregistered shuffle, or the publishing executor was lost before its
    table filled.  The requester converts this to a metadata fetch
    failure immediately instead of riding out the full location timeout
    (the fast stage-retry path; reference reducers discover the same
    condition only via FetchFailedException after timeouts)."""

    callback_id: int
    reason: str

    MSG_TYPE = 6
    WIRE_SCHEMA = (
        F.i32("callback_id"),
        F.str_i32("reason", max_len=1024),
    )


@dataclass(frozen=True)
class HeartbeatMsg(RpcMsg):
    """Liveness probe on the hello/announce plane: the driver pings
    each executor; the executor echoes with ``is_ack=True``.  A missed
    ack window (or an outright send failure) drives automatic
    ``remove_executor`` — the role RDMA CM DISCONNECTED events play in
    the reference (RdmaNode.java:176-189)."""

    shuffle_manager_id: ShuffleManagerId
    seq: int
    is_ack: bool

    MSG_TYPE = 7
    WIRE_SCHEMA = (
        F.smid("shuffle_manager_id"),
        F.i32("seq"),
        F.bool_i32("is_ack"),
    )


@dataclass(frozen=True)
class FetchExchangePlanMsg(RpcMsg):
    """Host asks the driver for the bulk-exchange plan of one shuffle.

    ``window == -1`` requests the legacy single plan (answered once
    EVERY registered map has published — the full barrier).  ``window
    >= 0`` requests incremental plan number ``window``: the driver
    answers once ``bulkWindowMaps`` new maps (or the remainder) have
    published AND filled, so reducers exchange early windows while
    stragglers still write (the collective analog of the reference's
    windowed fetch overlap,
    RdmaShuffleFetcherIterator.scala:241-251)."""

    requester: ShuffleManagerId
    shuffle_id: int
    callback_id: int
    window: int = -1

    MSG_TYPE = 8
    WIRE_SCHEMA = (
        F.smid("requester"),
        F.i32("shuffle_id"),
        F.i32("callback_id"),
        F.i32("window"),
    )


@dataclass(frozen=True)
class PublishShuffleMetricsMsg(RpcMsg):
    """Executor publishes one shuffle's telemetry snapshot (a flat
    ``{metric name: number}`` dict, JSON-encoded) to the driver at
    unregister time — riding the same control plane the map-output
    location publishes use, so the driver can aggregate per-shuffle
    write/read/fetch totals across hosts (metrics/ tentpole; no
    reference analog — RdmaShuffleReaderStats stays executor-local)."""

    shuffle_manager_id: ShuffleManagerId
    shuffle_id: int
    payload: bytes  # JSON {metric: number}

    MSG_TYPE = 10
    WIRE_SCHEMA = (
        F.smid("shuffle_manager_id"),
        F.i32("shuffle_id"),
        F.bytes_i32("payload"),
    )


@dataclass(frozen=True)
class PrefetchHintMsg(RpcMsg):
    """Reader → serving peer: the next block locations this reader's
    fetch plan will request, so the responder's tiered block store
    (memory/tier.py) can promote them from disk through its serve-pool
    credits BEFORE the read RPCs arrive — the reader-side half of the
    RdmaMappedFile ODP-prefetch sweep (RdmaMappedFile.java:158-168),
    inverted: the requester knows the plan, the responder owns the
    residency.  Purely advisory: a dropped/failed hint costs nothing
    but the hidden disk latency, and unknown mkeys are ignored."""

    shuffle_id: int
    locations: Tuple[BlockLocation, ...]
    trace_id: int = 0  # v2 optional tail: distributed trace correlation
    span_id: int = 0

    MSG_TYPE = 11
    WIRE_SCHEMA = (
        F.i32("shuffle_id"),
        F.list("locations", "loc"),
        F.scalar("trace_id", "<Q", since=2),
        F.scalar("span_id", "<Q", since=2),
    )

    def __init__(self, shuffle_id: int, locations, trace_id=0, span_id=0):
        object.__setattr__(self, "shuffle_id", shuffle_id)
        object.__setattr__(self, "locations", tuple(locations))
        object.__setattr__(self, "trace_id", trace_id)
        object.__setattr__(self, "span_id", span_id)

    def _split(self, max_payload: int) -> Sequence["PrefetchHintMsg"]:
        fixed = self._payload_size() - LOCATION_ENTRY_SIZE * len(self.locations)
        per_seg = max(1, (max_payload - fixed) // LOCATION_ENTRY_SIZE)
        return [
            PrefetchHintMsg(
                self.shuffle_id, self.locations[i : i + per_seg],
                trace_id=self.trace_id, span_id=self.span_id,
            )
            for i in range(0, len(self.locations), per_seg)
        ]


@dataclass(frozen=True)
class CleanShuffleMsg(RpcMsg):
    """Driver tells every executor one shuffle is unregistered, so each
    releases its OWN side of that shuffle — registered arena segments,
    block-store mkeys, QoS-admitted quota bytes.  Without this the
    executor's resources for a finished shuffle survive until manager
    stop (the resource ledger flagged exactly that: committed map
    segments outstanding long after the driver forgot the shuffle).
    The reference gets this for free — Spark's ContextCleaner invokes
    unregisterShuffle on every executor — but this control plane has
    no external cleaner, so the driver's unregister broadcasts."""

    shuffle_id: int

    MSG_TYPE = 12
    WIRE_SCHEMA = (
        F.i32("shuffle_id"),
    )


@dataclass(frozen=True)
class ExchangePlanMsg(RpcMsg):
    """The driver's bulk-exchange plan: the canonical host order, the
    full (src × dst) stream-length matrix every host must agree on, and
    the requester's destination manifest — for each source host, the
    (map_id, reduce_id, length) blocks concatenated into that source's
    stream toward the requester, in order.

    The manifest nests per-host rows, so this is the one HAND-WRITTEN
    codec: the ``custom`` schema fields document the layout, and
    tools/wirecheck.py audits encode/decode symmetry (WC01) and bounds
    discipline (WC05) instead of deriving them."""

    callback_id: int
    hosts: Tuple[ShuffleManagerId, ...]          # canonical order
    lengths: Tuple[int, ...]                     # row-major [E * E]
    manifest: Tuple[Tuple[Tuple[int, int, int], ...], ...]  # [E][blocks]
    window: int = -1            # -1: full-barrier plan; >=0: window no.
    final: bool = True          # True: no window follows this one
    my_maps: Tuple[int, ...] = ()  # requester's map_ids in this window

    MSG_TYPE = 9
    WIRE_SCHEMA = (
        F.custom("callback_id", "<i"),
        F.custom("hosts", "<i count + count × smid"),
        F.custom("lengths", "<{E*E}q row-major matrix, no count prefix"),
        F.custom("manifest", "per host row: <i count + count × <iiq"),
        F.custom("window", "<i (first of <iBi tail)"),
        F.custom("final", "<B (second of <iBi tail)"),
        F.custom("my_maps", "<i count (third of tail) + count × <i"),
    )

    def __init__(self, callback_id, hosts, lengths, manifest,
                 window: int = -1, final: bool = True, my_maps=()):
        object.__setattr__(self, "callback_id", callback_id)
        object.__setattr__(self, "hosts", tuple(hosts))
        object.__setattr__(self, "lengths", tuple(int(x) for x in lengths))
        object.__setattr__(
            self, "manifest",
            tuple(tuple(tuple(b) for b in row) for row in manifest),
        )
        object.__setattr__(self, "window", int(window))
        object.__setattr__(self, "final", bool(final))
        object.__setattr__(
            self, "my_maps", tuple(int(m) for m in my_maps)
        )
        e = len(self.hosts)
        if len(self.lengths) != e * e or len(self.manifest) != e:
            raise ValueError(
                f"plan shape mismatch: {e} hosts, {len(self.lengths)} "
                f"lengths, {len(self.manifest)} manifest rows"
            )

    def _payload(self, wire_version=None) -> bytes:
        buf = bytearray(_PAIR_II.pack(self.callback_id, len(self.hosts)))
        for h in self.hosts:
            h.write(buf)
        for x in self.lengths:
            buf += _Q64.pack(x)
        for row in self.manifest:
            buf += _I32.pack(len(row))
            for map_id, reduce_id, length in row:
                buf += _PLAN_BLOCK.pack(map_id, reduce_id, length)
        buf += _PLAN_TAIL.pack(
            self.window, int(self.final), len(self.my_maps)
        )
        for m in self.my_maps:
            buf += _I32.pack(m)
        return bytes(buf)

    def _payload_size(self, wire_version=None) -> int:
        return (
            _PAIR_II.size
            + sum(h.serialized_length() for h in self.hosts)
            + _Q64.size * len(self.lengths)
            + sum(
                _I32.size + _PLAN_BLOCK.size * len(row)
                for row in self.manifest
            )
            + _PLAN_TAIL.size + _I32.size * len(self.my_maps)
        )

    @staticmethod
    def _decode_payload(view: memoryview) -> "ExchangePlanMsg":
        _require(view, 0, _PAIR_II.size)
        callback_id, e = _PAIR_II.unpack_from(view, 0)
        off = _PAIR_II.size
        _check_count(e, _SMID_MIN_SIZE, view, off)
        hosts = []
        for _ in range(e):
            h, off = ShuffleManagerId.read(view, off)
            hosts.append(h)
        _require(view, off, _Q64.size * e * e)
        lengths = struct.unpack_from(f"<{e * e}q", view, off) if e else ()
        off += _Q64.size * e * e
        manifest = []
        for _ in range(e):
            _require(view, off, _I32.size)
            (cnt,) = _I32.unpack_from(view, off)
            off += _I32.size
            _check_count(cnt, _PLAN_BLOCK.size, view, off)
            row = []
            for _ in range(cnt):
                m, r, n = _PLAN_BLOCK.unpack_from(view, off)
                off += _PLAN_BLOCK.size
                row.append((m, r, n))
            manifest.append(tuple(row))
        _require(view, off, _PLAN_TAIL.size)
        window, final, n_my = _PLAN_TAIL.unpack_from(view, off)
        off += _PLAN_TAIL.size
        _check_count(n_my, _I32.size, view, off)
        my_maps = struct.unpack_from(f"<{n_my}i", view, off) if n_my else ()
        off += _I32.size * n_my
        if off != len(view):
            raise WireFormatError(
                f"ExchangePlanMsg: {len(view) - off}B of trailing garbage"
            )
        return ExchangePlanMsg(
            callback_id, hosts, lengths, manifest,
            window=window, final=bool(final), my_maps=my_maps,
        )


#: Wire generation that introduced the push/merge messages (types
#: 13-15).  Senders gate on the channel's NEGOTIATED version — an older
#: peer never merges, every one of its blocks rides the pull path
#: (``wire_version`` 0 = unversioned/in-process = current build).
PUSH_MIN_WIRE_VERSION = 3


@dataclass(frozen=True)
class PushSubBlockMsg(RpcMsg):
    """Writer pushes one span of a map task's partition payload to that
    reduce partition's deterministic merger executor (the magnet idiom;
    lineage: the reference's RdmaShuffleWriter commits then serves pull
    reads — push inverts the data motion at the same commit point).

    The merger assembles purely by ``(offset, data)`` against
    ``total_len``: a message carries bytes ``[offset, offset+len(data))``
    of the partition's full payload, so re-segmentation (``_split``),
    duplicated frames from a retried map task, and out-of-order arrival
    all converge to the same assembled bytes.  NEW wire type (v3): sends
    are gated on the peer's negotiated wire version, and an old peer
    that somehow receives one drops it as an unknown-type frame —
    best-effort push, never a protocol error."""

    sender: ShuffleManagerId
    shuffle_id: int
    map_id: int
    reduce_id: int
    total_len: int
    offset: int
    data: bytes

    MSG_TYPE = 13
    WIRE_SCHEMA = (
        F.smid("sender"),
        F.i32("shuffle_id"),
        F.i32("map_id"),
        F.i32("reduce_id"),
        F.i32("total_len"),
        F.i32("offset"),
        F.bytes_rest("data"),
    )

    def __post_init__(self):
        if not (0 <= self.offset
                and self.offset + len(self.data) <= self.total_len):
            raise ValueError(
                f"push span [{self.offset},{self.offset + len(self.data)})"
                f" outside total_len {self.total_len}"
            )

    def _split(self, max_payload: int) -> Sequence["PushSubBlockMsg"]:
        fixed = self._payload_size() - len(self.data)
        per_seg = max(1, max_payload - fixed)
        parts: List[PushSubBlockMsg] = []
        for start in range(0, len(self.data), per_seg):
            parts.append(
                PushSubBlockMsg(
                    self.sender, self.shuffle_id, self.map_id,
                    self.reduce_id, self.total_len,
                    self.offset + start,
                    self.data[start : start + per_seg],
                )
            )
        return parts


@dataclass(frozen=True)
class FetchMergeStatusMsg(RpcMsg):
    """Reader asks a merger executor which of ``reduce_ids`` it holds
    merged spans for; the answer (one :class:`MergeStatusResponseMsg`
    per reduce id, or a :class:`FetchMapStatusFailedMsg`) is routed
    through ``callback_id``.  Querying seals the merged spans: the
    merger commits what it has and pushes arriving late sub-blocks to
    the pull path from then on."""

    requester: ShuffleManagerId
    shuffle_id: int
    callback_id: int
    reduce_ids: Tuple[int, ...]

    MSG_TYPE = 14
    WIRE_SCHEMA = (
        F.smid("requester"),
        F.i32("shuffle_id"),
        F.i32("callback_id"),
        F.list("reduce_ids", "<i"),
    )

    def __init__(self, requester, shuffle_id, callback_id, reduce_ids):
        object.__setattr__(self, "requester", requester)
        object.__setattr__(self, "shuffle_id", shuffle_id)
        object.__setattr__(self, "callback_id", callback_id)
        object.__setattr__(self, "reduce_ids",
                           tuple(int(r) for r in reduce_ids))

    def _split(self, max_payload: int) -> Sequence["FetchMergeStatusMsg"]:
        fixed = self._payload_size() - _I32.size * len(self.reduce_ids)
        per_seg = max(1, (max_payload - fixed) // _I32.size)
        return [
            FetchMergeStatusMsg(
                self.requester, self.shuffle_id, self.callback_id,
                self.reduce_ids[i : i + per_seg],
            )
            for i in range(0, len(self.reduce_ids), per_seg)
        ]


@dataclass(frozen=True)
class MergeStatusResponseMsg(RpcMsg):
    """Merger's answer for ONE reduce partition, following the
    fetch-status response convention: ``total`` is the queried reduce-id
    count, ``index`` this answer's position, so the requester knows when
    the set is complete regardless of arrival order.  ``mkey == 0``
    means no merged data for this reduce id (everything pulls).
    ``provenance`` lists the merged span's constituent map outputs as
    ``(map_id, rel_off, rel_len)`` rows — relative to the span start —
    so the reader both knows which (map, reduce) blocks the span covers
    (the rest fall back to pull) and can slice the fetched span back
    into per-map blocks for the bit-exact k-way merge.

    Wide provenance splits across segments: every fragment repeats the
    fixed header and carries ``rows_total`` (the whole span's row
    count), so the requester accumulates rows until a reduce id's set
    is full — same sub-range scheme the publish path uses."""

    callback_id: int
    total: int
    index: int
    reduce_id: int
    mkey: int
    length: int
    provenance: Tuple[Tuple[int, int, int], ...]  # (map_id, rel_off, rel_len)
    rows_total: int = -1  # rows in the whole answer; -1 → len(provenance)

    MSG_TYPE = 15
    WIRE_SCHEMA = (
        F.i32("callback_id"),
        F.i32("total"),
        F.i32("index"),
        F.i32("reduce_id"),
        F.i32("mkey"),
        F.scalar("length", "<q"),
        F.i32("rows_total"),
        F.list("provenance", "<iqq"),
    )

    def __init__(self, callback_id, total, index, reduce_id, mkey,
                 length, provenance, rows_total=-1):
        object.__setattr__(self, "callback_id", callback_id)
        object.__setattr__(self, "total", total)
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "reduce_id", reduce_id)
        object.__setattr__(self, "mkey", mkey)
        object.__setattr__(self, "length", length)
        object.__setattr__(
            self, "provenance",
            tuple(tuple(int(x) for x in row) for row in provenance),
        )
        object.__setattr__(
            self, "rows_total",
            len(self.provenance) if rows_total < 0 else rows_total,
        )

    def _split(self, max_payload: int) -> Sequence["MergeStatusResponseMsg"]:
        st_size = struct.calcsize("<iqq")
        fixed = self._payload_size() - st_size * len(self.provenance)
        per_seg = max(1, (max_payload - fixed) // st_size)
        return [
            MergeStatusResponseMsg(
                self.callback_id, self.total, self.index, self.reduce_id,
                self.mkey, self.length,
                self.provenance[i : i + per_seg],
                rows_total=self.rows_total,
            )
            for i in range(0, len(self.provenance), per_seg)
        ]


MSG_TYPES: Dict[int, Type[RpcMsg]] = {
    cls.MSG_TYPE: cls
    for cls in (
        HelloMsg,
        AnnounceShuffleManagersMsg,
        PublishMapTaskOutputMsg,
        FetchMapStatusMsg,
        FetchMapStatusResponseMsg,
        FetchMapStatusFailedMsg,
        HeartbeatMsg,
        FetchExchangePlanMsg,
        ExchangePlanMsg,
        PublishShuffleMetricsMsg,
        PrefetchHintMsg,
        CleanShuffleMsg,
        PushSubBlockMsg,
        FetchMergeStatusMsg,
        MergeStatusResponseMsg,
    )
}
