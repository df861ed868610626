"""Host-side partitioners for the record path.

The reference reuses Spark's ``dependency.partitioner``
(RdmaWrapperShuffleWriter.scala:126-128); these are the standalone
equivalents.  The device path uses sparkrdma_tpu_torch.ops.partition instead.
"""

from __future__ import annotations

import bisect
import pickle
import struct
import zlib
from typing import Any, List, Sequence

import numpy as np

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """SplitMix64 finalizer — the scalar twin of
    :func:`_splitmix64_array`; the two MUST agree bit for bit so the
    tuple record plane and the columnar plane route any given key to
    the same partition."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _splitmix64_array(x: np.ndarray) -> np.ndarray:
    # in-place with one scratch buffer: the naive expression allocates
    # six N-element temporaries and the allocator cost shows at 1M+ keys
    z = x.astype(np.uint64)  # the one copy (also detaches caller's data)
    t = np.empty_like(z)
    z += np.uint64(0x9E3779B97F4A7C15)
    np.right_shift(z, np.uint64(30), out=t)
    z ^= t
    z *= np.uint64(0xBF58476D1CE4E5B9)
    np.right_shift(z, np.uint64(27), out=t)
    z ^= t
    z *= np.uint64(0x94D049BB133111EB)
    np.right_shift(z, np.uint64(31), out=t)
    z ^= t
    return z


def stable_hash(key: Any) -> int:
    """Process-stable hash: Python's builtin ``hash`` is salted per
    interpreter (PYTHONHASHSEED), so map tasks in different executor
    processes would disagree on key → partition.  64-bit-range ints and
    floats use SplitMix64 over their bit patterns (vectorizable — the
    columnar plane computes the identical value with numpy); other
    primitives hash a canonical byte encoding; everything else a
    fixed-protocol pickle."""
    if isinstance(key, bool):  # bool before int: True/1 must collide as in dicts
        key = int(key)
    if isinstance(key, (int, np.integer)):
        key = int(key)
        if -(1 << 63) <= key < (1 << 64):
            return _splitmix64(key & _MASK64)
        data = key.to_bytes(
            max(1, (key.bit_length() + 8) // 8), "little", signed=True
        )
    elif isinstance(key, (float, np.floating)):
        (bits,) = struct.unpack("<Q", struct.pack("<d", float(key)))
        return _splitmix64(bits)
    elif isinstance(key, str):
        data = key.encode("utf-8")
    elif isinstance(key, (bytes, bytearray)):
        data = bytes(key)
    elif isinstance(key, tuple):
        data = b"".join(
            (stable_hash(k) & 0xFFFFFFFF).to_bytes(4, "little") for k in key
        )
    else:
        data = pickle.dumps(key, protocol=4)
    return zlib.crc32(data)


def stable_hash_array(keys: np.ndarray) -> np.ndarray:
    """Vectorized :func:`stable_hash` over a numeric column — exact
    elementwise match with the scalar function (the cross-plane
    consistency contract).  Non-numeric dtypes fall back to a scalar
    loop over the extracted Python values."""
    keys = np.asarray(keys)
    if keys.dtype == np.bool_:
        keys = keys.astype(np.int64)
    if np.issubdtype(keys.dtype, np.integer):
        # two's-complement bit pattern, matching `key & _MASK64`
        bits = keys.astype(np.int64, copy=False).view(np.uint64) \
            if np.issubdtype(keys.dtype, np.signedinteger) \
            else keys.astype(np.uint64, copy=False)
        return _splitmix64_array(bits)
    if np.issubdtype(keys.dtype, np.floating):
        bits = keys.astype(np.float64, copy=False).view(np.uint64)
        return _splitmix64_array(bits)
    return np.fromiter(
        (stable_hash(k) for k in keys.tolist()),
        dtype=np.uint64, count=len(keys),
    )


class Partitioner:
    num_partitions: int

    def partition(self, key: Any) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def partition_array(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized partition over a key column (columnar plane).
        MUST agree elementwise with :meth:`partition` — a shuffle whose
        map tasks mix the tuple and columnar planes still routes every
        key to one reducer.  Base fallback: scalar loop."""
        return np.fromiter(
            (self.partition(k) for k in np.asarray(keys).tolist()),
            dtype=np.int32, count=len(keys),
        )


class HashPartitioner(Partitioner):
    def __init__(self, num_partitions: int):
        if num_partitions <= 0:
            raise ValueError(f"num_partitions must be > 0: {num_partitions}")
        self.num_partitions = num_partitions

    def partition(self, key: Any) -> int:
        return stable_hash(key) % self.num_partitions

    def partition_array(self, keys: np.ndarray) -> np.ndarray:
        return (
            stable_hash_array(keys) % np.uint64(self.num_partitions)
        ).astype(np.int32)


class RangePartitioner(Partitioner):
    """Equal-frequency range partitioner from a key sample (sortByKey)."""

    def __init__(self, num_partitions: int, sample: Sequence[Any]):
        if num_partitions <= 0:
            raise ValueError(f"num_partitions must be > 0: {num_partitions}")
        self.num_partitions = num_partitions
        s = sorted(sample)
        if not s:
            self.splitters: List[Any] = []
        else:
            self.splitters = [
                s[min(len(s) - 1, (i * len(s)) // num_partitions)]
                for i in range(1, num_partitions)
            ]

    def partition(self, key: Any) -> int:
        return bisect.bisect_right(self.splitters, key)

    def partition_array(self, keys: np.ndarray) -> np.ndarray:
        if not self.splitters:
            return np.zeros(len(keys), np.int32)
        try:
            splitters = np.asarray(self.splitters)
        except Exception:
            return super().partition_array(keys)
        if splitters.dtype.hasobject:
            return super().partition_array(keys)
        # bisect_right == searchsorted side='right', elementwise
        return np.searchsorted(splitters, keys, side="right").astype(np.int32)
