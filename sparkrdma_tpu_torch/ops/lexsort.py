"""Multi-column sorts: the counterpart of ``lax.sort`` with
``num_keys > 1``, which PyTorch lacks.

The port sorts rows by five column shapes only: (key, invalid),
(key, value) and (key, invalid, value), with ``invalid`` a 0/1 column,
and the joins' (key, role) and (group key, key, role), with ``role`` a
0..2 column.  An int32 key packs with ``invalid`` into one int64 sort
key ``(key << 1) | invalid``, and an int32 key with an int32 value into
``(key << 32) | (value + 2**31)``.  Anything wider runs as stable sorts
in sequence, least significant column first.  Every sort is stable, so
rows equal in every column keep their input order.  (The JAX package
sorts with ``is_stable=False``; tests compare within equal keys
canonically.)

The joins' keys are transport words (``models/join.py``): int32 or
int64 bit patterns of the JAX package's uint32 / uint64 columns.  They
sort in unsigned order, as in JAX, so the port's sorted stream is the
JAX stream up to the order of rows equal in every sort column.  A key
made from a column of at most 4 bytes, in a word of either width, packs
with its role into one int64 word (:func:`sort_key_role`), whose sorted
values give back the sorted key and role (:func:`unpack_key_role`), so
the joins' probes gather neither.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

_BIAS32 = 1 << 31
_MASK33 = (1 << 33) - 1


def _chain(sort_keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting ascending by ``sort_keys`` (most significant
    first), by one stable sort per key, least significant first."""
    perm = None
    for key in reversed(sort_keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _key_invalid(keys: torch.Tensor, invalid: torch.Tensor):
    if keys.dtype == torch.int32:
        return [(keys.to(torch.int64) << 1) | invalid.to(torch.int64)]
    return [keys, invalid]


def perm_by_key_invalid(keys: torch.Tensor,
                        invalid: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by the 0/1 ``invalid`` column."""
    return _chain(_key_invalid(keys, invalid))


def perm_by_key_value(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by value."""
    if keys.dtype == torch.int32 and vals.dtype == torch.int32:
        return _chain([(keys.to(torch.int64) << 32)
                       | (vals.to(torch.int64) + _BIAS32)])
    return _chain([keys, vals])


def perm_by_key_invalid_value(keys: torch.Tensor, invalid: torch.Tensor,
                              vals: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by the 0/1 ``invalid`` column, then by value."""
    return _chain(_key_invalid(keys, invalid) + [vals])


def unsigned_order(word: torch.Tensor) -> torch.Tensor:
    """A signed column whose order is the unsigned order of the int32 or
    int64 bit pattern ``word`` (its sign bit flipped)."""
    return word ^ torch.iinfo(word.dtype).min


def sort_key_role(key: torch.Tensor, role: torch.Tensor,
                  key_bytes: Optional[int] = None
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Rows by the transport word ``key`` (unsigned order), then by the
    0..2 ``role`` column.  Returns ``(word, perm)``: ``perm`` the stable
    permutation, and ``word`` the packed (key, role) int64 word in
    sorted order, or ``None`` where the key does not pack.

    ``key_bytes`` is the byte size of the widest column the key words
    were made from (by default the word's own).  Up to 4 bytes, a word
    of either width is the column's value sign- or zero-extended, so its
    upper 32 bits are all zeros or all ones: one extension bit, the low
    32 bits and the role order the rows as the unsigned word does, and
    one int64 sort on ``(ext << 34) | (low 32 bits << 2) | role`` sorts
    them (``ext`` is bit 32 of the word: the int32 word's sign, which
    keeps its unsigned order too).  An 8-byte key runs as two stable
    sorts, the role's then the key's."""
    if (key_bytes or key.dtype.itemsize) > 4:
        return None, _chain([unsigned_order(key), role])
    # role + 4 * (key & mask): one kernel, as the role is below 4
    word = torch.add(role, key.to(torch.int64) & _MASK33, alpha=4)
    word, perm = torch.sort(word, stable=True)
    return word, perm


def unpack_key_role(word: torch.Tensor, dtype: torch.dtype):
    """The transport words of ``dtype`` and the int32 roles that
    :func:`sort_key_role` packed into the contiguous ``word``: an int32
    word is the low 32 bits above the role, and an int64 word has bit 34
    extended back over its upper 32 bits.  The role is read from each
    word's low int32 half (little-endian, as on every host and card the
    port runs on)."""
    if dtype == torch.int32:
        key = (word >> 2).to(dtype)
    else:
        key = (word << 29) >> 31
    return key, word.view(torch.int32)[0::2] & 3


def sort_group_key_role(group_key: torch.Tensor, key: torch.Tensor,
                        role: torch.Tensor, key_bytes: Optional[int] = None):
    """Rows by the transport words ``group_key`` then ``key`` (unsigned
    order), then by ``role``: :func:`sort_key_role`, then one stable
    sort on the group key.  Returns ``(group_key, word, perm)``: the
    sorted group keys (that sort's values), the packed word in the same
    order (``None`` where the key does not pack) and the permutation."""
    word, perm = sort_key_role(key, role, key_bytes)
    sgk, order = torch.sort(unsigned_order(group_key)[perm], stable=True)
    return (unsigned_order(sgk), None if word is None else word[order],
            perm[order])


def perm_by_key_role(key: torch.Tensor, role: torch.Tensor) -> torch.Tensor:
    """Rows by the transport word ``key`` (unsigned order), then by the
    0..2 ``role`` column (:func:`sort_key_role`)."""
    return sort_key_role(key, role)[1]


def perm_by_group_key_role(group_key: torch.Tensor, key: torch.Tensor,
                           role: torch.Tensor) -> torch.Tensor:
    """Rows by the transport words ``group_key`` then ``key`` (unsigned
    order), then by ``role`` (:func:`sort_group_key_role`)."""
    return sort_group_key_role(group_key, key, role)[2]
