"""Core identifier and location types.

TPU-native analogs of the reference's id/location vocabulary
(reference: RdmaUtils.scala:26-138):

- ``BlockLocation`` — where one (map, reduce) block lives.  The reference
  encodes ``(address: i64, length: i32, mKey: i32)`` where ``address`` is a
  raw mmap'd virtual address and ``mKey`` the ibverbs memory-region key.
  Here ``address`` is a byte offset inside the owner's HBM arena segment
  and ``mkey`` is the arena segment id (epoch-tagged so stale locations
  are detectable) — same 16-byte wire entry, same role.
- ``BlockManagerId`` — (executor_id, host, port) triple identifying a
  block-serving endpoint, with a compact UTF-8 wire format.
- ``ShuffleManagerId`` — (host, port, BlockManagerId) identifying one
  shuffle-manager instance, with an interning cache so the driver's maps
  hold one object per peer (reference: RdmaUtils.scala:121-138).
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

# One location entry on the wire: little-endian (address: i64, length: i32,
# mkey: i32) == 16 bytes, matching the reference's ENTRY_SIZE
# (RdmaMapTaskOutput.scala:27).
_LOCATION_STRUCT = struct.Struct("<qii")
LOCATION_ENTRY_SIZE = _LOCATION_STRUCT.size  # 16

# String/port wire pieces — offsets always advance by these ``.size``
# constants, never by integer literals (wirecheck WC04).
_U16 = struct.Struct("<H")
_I32 = struct.Struct("<i")


@dataclass(frozen=True, slots=True)
class BlockLocation:
    """Address of one shuffle block inside a registered memory domain.

    address: byte offset within the owning arena segment (device HBM).
    length:  block length in bytes.
    mkey:    arena segment key — identifies which registered segment of the
             owning executor holds the block (0 == EMPTY/no data).
    """

    address: int
    length: int
    mkey: int

    def write(self, buf: bytearray) -> None:
        buf += _LOCATION_STRUCT.pack(self.address, self.length, self.mkey)

    @staticmethod
    def read(view: memoryview, offset: int = 0) -> "BlockLocation":
        a, l, k = _LOCATION_STRUCT.unpack_from(view, offset)
        return BlockLocation(a, l, k)

    def pack(self) -> bytes:
        return _LOCATION_STRUCT.pack(self.address, self.length, self.mkey)

    @property
    def is_empty(self) -> bool:
        return self.length == 0


# Sentinel for "partition produced no bytes" — mkey 0 is reserved.
BlockLocation.EMPTY = BlockLocation(0, 0, 0)


def _write_utf8(buf: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ValueError(f"string too long for wire format: {len(raw)}")
    buf += _U16.pack(len(raw))
    buf += raw


def _read_utf8(view: memoryview, offset: int) -> Tuple[str, int]:
    if offset + _U16.size > len(view):
        raise ValueError(f"truncated string header at offset {offset}")
    (n,) = _U16.unpack_from(view, offset)
    start = offset + _U16.size
    end = start + n
    if end > len(view):
        raise ValueError(
            f"truncated string: need {n}B at offset {start}, "
            f"have {len(view) - start}B"
        )
    s = bytes(view[start:end]).decode("utf-8")
    return s, end


@dataclass(frozen=True, slots=True)
class BlockManagerId:
    """Identifies a block-serving endpoint (executor_id, host, port).

    Compact wire format mirroring the reference's
    SerializableBlockManagerId (RdmaUtils.scala:28-67): length-prefixed
    UTF-8 strings plus an i32 port.
    """

    executor_id: str
    host: str
    port: int

    def write(self, buf: bytearray) -> None:
        _write_utf8(buf, self.executor_id)
        _write_utf8(buf, self.host)
        buf += _I32.pack(self.port)

    @staticmethod
    def read(view: memoryview, offset: int = 0) -> Tuple["BlockManagerId", int]:
        executor_id, offset = _read_utf8(view, offset)
        host, offset = _read_utf8(view, offset)
        (port,) = _I32.unpack_from(view, offset)
        return BlockManagerId(executor_id, host, port), offset + _I32.size

    def serialized_length(self) -> int:
        return (
            _U16.size + len(self.executor_id.encode("utf-8"))
            + _U16.size + len(self.host.encode("utf-8"))
            + _I32.size
        )


@dataclass(frozen=True, slots=True)
class ShuffleManagerId:
    """One shuffle-manager instance: (host, port) of its transport endpoint
    plus the Spark-style BlockManagerId it serves.

    Interned via :func:`get_cached_shuffle_manager_id` so driver-side maps
    compare by identity (reference: RdmaUtils.scala:121-138).
    """

    host: str
    port: int
    block_manager_id: BlockManagerId

    def write(self, buf: bytearray) -> None:
        _write_utf8(buf, self.host)
        buf += _I32.pack(self.port)
        self.block_manager_id.write(buf)

    @staticmethod
    def read(view: memoryview, offset: int = 0) -> Tuple["ShuffleManagerId", int]:
        host, offset = _read_utf8(view, offset)
        (port,) = _I32.unpack_from(view, offset)
        bmid, offset = BlockManagerId.read(view, offset + _I32.size)
        return get_cached_shuffle_manager_id(ShuffleManagerId(host, port, bmid)), offset

    def serialized_length(self) -> int:
        return (
            _U16.size + len(self.host.encode("utf-8"))
            + _I32.size
            + self.block_manager_id.serialized_length()
        )


_smid_cache: Dict[ShuffleManagerId, ShuffleManagerId] = {}
_smid_lock = threading.Lock()  # lock-order: 94


def get_cached_shuffle_manager_id(smid: ShuffleManagerId) -> ShuffleManagerId:
    cached = _smid_cache.get(smid)
    if cached is not None:
        return cached
    with _smid_lock:
        return _smid_cache.setdefault(smid, smid)
