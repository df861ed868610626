"""Shared host-driver machinery: the port of
``sparkrdma_tpu/models/_base.py``.

Capacity sizing and the overflow-retry loop: buckets are padded to a
capacity; true counts travel with the step; if any bucket's true count
exceeded capacity the host re-runs the step with a doubled factor.

Rank-local drivers: over a group of D > 1 (``group=``) every driver
runs in each rank on that rank's own shard, and returns what the rank
owns after the exchange.  Before any collective the ranks agree, with
:meth:`ExchangeGroup.agree_max`, on the padded local length (the ladder
length of the longest shard) and so on every capacity, and each retry
decides on the largest bucket fill of every rank, so all ranks retry
together: one rank retrying alone would leave the others waiting in the
next collective.  At D = 1 nothing is agreed and nothing changes.

Dtypes: the models take what the JAX package takes.  Keys ride as int32
or int64 (:func:`carry_keys`): uint32 as int32 bits in unsigned order
(``ops/lexsort.py::unsigned_order``), which the hash exchange unflips
before hashing, so a key lands on the rank JAX sends it to; 8- and
16-bit integers widen to int32.  Values ride by what the model does
with them (:func:`carry_values`).  Results come back in the caller's
dtype: integer sums wrap in it as the JAX package's arithmetic does.
PyTorch does not truncate int64 the way JAX does without
``jax_enable_x64``, so the JAX package's ``check_no_silent_truncation``
guard has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.lexsort import unsigned_order
from sparkrdma_tpu_torch.parallel.device import DeviceLike, select_devices
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup

MAX_OVERFLOW_RETRIES = 6
_U32_MASK = (1 << 32) - 1
# integers that widen losslessly to int32
_NARROW = (torch.int8, torch.int16, torch.uint8, torch.uint16)


def quantize_padded_length(n: int, d: int) -> int:
    """Smallest padded length >= n that is a multiple of ``d`` and sits
    on a 16-steps-per-octave ladder (<= 12.5% padding).  Collapses
    arbitrary job sizes onto few shapes; padding rides the validity
    column, and inputs already on the ladder pad nothing."""
    if n <= 0:
        return n
    if n <= 16:
        m = n
    else:
        k = (n - 1).bit_length()
        step = 1 << max(0, k - 4)
        m = (n + step - 1) // step * step
    return (m + d - 1) // d * d


def as_tensor(col) -> torch.Tensor:
    """A numpy column (or tensor) as a tensor of the same dtype."""
    if isinstance(col, torch.Tensor):
        return col
    return torch.from_numpy(np.ascontiguousarray(np.asarray(col)))


def carry_keys(keys: torch.Tensor) -> torch.Tensor:
    """Keys as the models carry them: int32 and int64 as they are,
    uint32 as int32 bits in unsigned order, 8- and 16-bit integers
    widened to int32.  Other dtypes raise."""
    dt = keys.dtype
    if dt in (torch.int32, torch.int64):
        return keys
    if dt == torch.uint32:
        return unsigned_order(keys.view(torch.int32))
    if dt in _NARROW:
        return keys.to(torch.int32)
    raise ValueError(f"keys must be integers, got {dt}")


def restore_keys(carried: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`carry_keys`.  The carried dtype's max (the
    padding sentinel) comes back as ``dtype``'s max."""
    if carried.dtype == dtype:
        return carried
    if dtype == torch.uint32:
        return unsigned_order(carried).view(torch.uint32)
    info = torch.iinfo(dtype)
    return carried.clamp(info.min, info.max).to(dtype)


def carry_values(vals: torch.Tensor, use: str) -> torch.Tensor:
    """Values as the models carry them for ``use``: what the model does
    with them, carry them through sorts and the exchange ("payload"),
    sum them and take their min and max ("sum"), or order rows by them
    ("order").  int32, int64 and float32 as they are (floats do not
    order: JAX's complement refuses them too), float64 as payload, 8-
    and 16-bit integers widened to int32, and uint32 as int32 bits for
    payload, in unsigned order for ordering, and widened to int64 for
    sums (kernel 1 and the min/max need its order and its
    wrap-around)."""
    dt = vals.dtype
    if dt in (torch.int32, torch.int64) or (
            dt == torch.float32 and use != "order") or (
            dt == torch.float64 and use == "payload"):
        return vals
    if dt in _NARROW:
        return vals.to(torch.int32)
    if dt == torch.uint32:
        bits = vals.view(torch.int32)
        if use == "payload":
            return bits
        if use == "order":
            return unsigned_order(bits)
        return bits.to(torch.int64) & _U32_MASK
    raise ValueError(f"values of dtype {dt} cannot be used as {use}")


def restore_values(carried: torch.Tensor, dtype: torch.dtype,
                   use: str) -> torch.Tensor:
    """Inverse of :func:`carry_values`; sums wrap in ``dtype``."""
    if carried.dtype == dtype:
        return carried
    if dtype == torch.uint32:
        if use == "order":
            carried = unsigned_order(carried)
        return carried.to(torch.int32).view(torch.uint32)
    return carried.to(dtype)


class ExchangeModel:
    """Base for host-facing drivers of capacity-bucketed steps.

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch versions.  ``group`` (an
    :class:`ExchangeGroup` or a ``torch.distributed`` process group)
    runs the model over that group's D ranks, rank-locally (module
    docstring); without it the model runs on one device, and
    ``n_devices > 1`` raises ``ValueError``.
    """

    def __init__(self, device: DeviceLike = None,
                 capacity_factor: float = 1.3,
                 quantize_shapes: bool = True,
                 n_devices: Optional[int] = None,
                 device_list: Optional[Sequence[int]] = None,
                 group=None):
        if group is None:
            self.group = ExchangeGroup(
                device=select_devices(n_devices, device_list, device)[0])
        else:
            self.group = group if isinstance(group, ExchangeGroup) else \
                ExchangeGroup(group, device=device)
            if n_devices not in (None, self.group.size):
                raise ValueError(f"n_devices={n_devices} but the group has "
                                 f"{self.group.size} ranks")
        self.device = self.group.device
        self.n_devices = self.group.size
        self.capacity_factor = capacity_factor
        self.quantize_shapes = quantize_shapes
        #: steps run by the last host call, overflow retries included
        #: (the same on every rank)
        self.attempts = 0

    def _ladder(self, n: int) -> int:
        """``n`` rows padded onto the shape ladder (or not, without
        ``quantize_shapes``)."""
        return quantize_padded_length(n, 1) if self.quantize_shapes else n

    def _local_length(self, *ns: int) -> Tuple[Tuple[int, ...], bool]:
        """The padded local length of each of ``ns`` (one per column
        set): the ladder length of the longest shard over the ranks (at
        D = 1, of the whole input), and whether no rank pads any."""
        if self.n_devices == 1:
            longest = shortest = ns
        else:
            agreed = self.group.agree_max(*ns, *(-n for n in ns))
            longest = agreed[:len(ns)]
            shortest = tuple(-m for m in agreed[len(ns):])
        padded = tuple(self._ladder(n) for n in longest)
        return padded, padded == tuple(shortest)

    def _capacity(self, n_local: int, factor: Optional[float] = None) -> int:
        """Per-bucket capacity: n_local/D scaled by the skew factor,
        rounded up to a multiple of 8."""
        factor = self.capacity_factor if factor is None else factor
        cap = int(math.ceil(n_local / self.n_devices * factor))
        return max(8, (cap + 7) // 8 * 8)

    def _overflowed(self, fill: torch.Tensor, cap: int) -> bool:
        """Whether any bucket of any rank held more than ``cap``."""
        return self.group.agree_max(int(fill.max()))[0] > cap

    def _retry_with_factor(self, run: Callable[[float], Tuple]):
        """Call ``run(factor)`` -> (outputs, overflowed); re-run with a
        doubled factor while any bucket overflowed."""
        factor = self.capacity_factor
        self.attempts = 0
        for _attempt in range(MAX_OVERFLOW_RETRIES):
            self.attempts += 1
            outputs, overflowed = run(factor)
            if not overflowed:
                return outputs
            factor *= 2
        raise RuntimeError(
            f"bucket overflow persisted after {MAX_OVERFLOW_RETRIES} retries"
        )

    def _run_with_overflow_retry(self, n_local: int,
                                 run: Callable[[int], Tuple]):
        """Call ``run(capacity)`` -> (outputs, max_fill); re-run with a
        doubled factor while any bucket of any rank overflowed."""

        def attempt(factor: float):
            cap = self._capacity(n_local, factor)
            outputs, max_fill = run(cap)
            return outputs, self._overflowed(max_fill, cap)

        return self._retry_with_factor(attempt)

    def _to_device(self, *tensors):
        return tuple(None if t is None else t.to(self.device)
                     for t in tensors)

    def _run_device_keyed(self, make_step, keys, vals, valid,
                          capacity: Optional[int], value_rows):
        """One keyed step (wordcount, aggregate) on this rank's device
        tensors, in the caller's dtypes: carry the columns, run
        ``make_step``'s step (the validity path unless D == 1 and
        ``valid`` is None), and restore the key row and the
        ``value_rows``.  Returns (outputs, capacity)."""
        n_local = keys.shape[0]
        key_dtype, val_dtype = keys.dtype, vals.dtype
        cap = capacity or self._capacity(n_local)
        ck, cv, valid = self._to_device(carry_keys(keys),
                                        carry_values(vals, "sum"), valid)
        kw = dict(group=self.group, unsigned_keys=key_dtype == torch.uint32)
        if valid is None and self.n_devices == 1:
            outs = make_step(1, n_local, cap, with_validity=False,
                             **kw)(ck, cv)
        else:
            if valid is None:
                valid = torch.ones(n_local, dtype=torch.int32,
                                   device=self.device)
            outs = make_step(self.n_devices, n_local, cap, **kw)(ck, cv,
                                                                  valid)
        outs = list(outs)
        outs[0] = restore_keys(outs[0], key_dtype)
        for i in value_rows:
            outs[i] = restore_values(outs[i], val_dtype, "sum")
        return tuple(outs), cap

    def _run_padded_keyed(self, keys, vals, make_step, use: str,
                          value_rows: Sequence[int] = (1,)):
        """Host driver for keyed models (wordcount, aggregate, top-k):
        carry the columns (:func:`carry_keys`, :func:`carry_values` for
        ``use``), pad them with a validity column to the agreed local
        length, place them on the device once, run ``make_step(
        n_devices, n_local, capacity, with_validity=, group=,
        unsigned_keys=)`` under the overflow-retry policy, and return
        ``(rows, nu)``: the step's row tensors on the host, keys (row
        0) and the ``value_rows`` restored to the caller's dtypes, and
        this rank's valid-row count.  ``rows`` is None when every
        rank's input is empty."""
        tk, tv = as_tensor(keys), as_tensor(vals)
        if tk.shape != tv.shape or tk.dim() != 1:
            raise ValueError("keys/vals must be equal-length 1-D arrays")
        key_dtype, val_dtype = tk.dtype, tv.dtype
        ck, cv = carry_keys(tk), carry_values(tv, use)
        n = ck.shape[0]
        (n_local,), full = self._local_length(n)
        if n_local == 0:
            return None, None
        D = self.n_devices
        valid = torch.ones(n_local, dtype=torch.int32)
        if n_local > n:
            pad = n_local - n
            ck = torch.cat([ck, ck.new_zeros(pad)])
            cv = torch.cat([cv, cv.new_zeros(pad)])
            valid[n:] = 0
        # D == 1 with no padding: every slot is real, so the step drops
        # the validity operand from its sort
        fast = D == 1 and full
        cols = (ck, cv) if fast else (ck, cv, valid)
        placed = self._to_device(*cols)

        def run(cap):
            step = make_step(D, n_local, cap, with_validity=not fast,
                             group=self.group,
                             unsigned_keys=key_dtype == torch.uint32)
            *rows, n_unique, max_fill = step(*placed)
            return (rows, n_unique), max_fill

        rows, n_unique = self._run_with_overflow_retry(n_local, run)
        rows[0] = restore_keys(rows[0], key_dtype)
        for i in value_rows:
            rows[i] = restore_values(rows[i], val_dtype, use)
        host_rows = [r.cpu().numpy() for r in rows]
        return host_rows, int(n_unique.reshape(-1)[0])
