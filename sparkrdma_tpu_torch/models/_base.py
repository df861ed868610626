"""Shared host-driver machinery: the port of
``sparkrdma_tpu/models/_base.py``.

Capacity sizing and the overflow-retry loop: buckets are padded to a
capacity; true counts travel with the step; if any bucket's true count
exceeded capacity the host re-runs the step with a doubled factor.

Dtype policy: keys and values are int32 or int64, both accepted and
kept as they are.  PyTorch does not truncate int64 the way JAX does
without ``jax_enable_x64``, so the JAX package's
``check_no_silent_truncation`` guard has no counterpart here; other
dtypes raise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.device import DeviceLike, select_devices

MAX_OVERFLOW_RETRIES = 6
KEY_DTYPES = {np.dtype(np.int32), np.dtype(np.int64), torch.int32,
              torch.int64}


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


def check_dtypes(**columns) -> None:
    """Keys and values must be int32 or int64 (module docstring)."""
    for name, col in columns.items():
        if col.dtype not in KEY_DTYPES:
            raise ValueError(
                f"{name} must be int32 or int64, got {col.dtype}"
            )


class ExchangeModel:
    """Base for host-facing drivers of capacity-bucketed steps.

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch versions.  ``n_devices > 1``
    raises NotImplementedError in this slice.
    """

    def __init__(self, device: DeviceLike = None,
                 capacity_factor: float = 1.3,
                 quantize_shapes: bool = True,
                 n_devices: Optional[int] = None,
                 device_list: Optional[Sequence[int]] = None):
        self.devices = select_devices(n_devices, device_list, device)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        self.capacity_factor = capacity_factor
        self.quantize_shapes = quantize_shapes

    def _padded_length(self, n: int) -> int:
        if self.quantize_shapes:
            return quantize_padded_length(n, self.n_devices)
        return n + ((-n) % self.n_devices)

    def _capacity(self, n_local: int, factor: Optional[float] = None) -> int:
        """Per-bucket capacity: n_local/D scaled by the skew factor,
        rounded up to a multiple of 8."""
        factor = self.capacity_factor if factor is None else factor
        cap = int(math.ceil(n_local / self.n_devices * factor))
        return max(8, (cap + 7) // 8 * 8)

    def _retry_with_factor(self, run: Callable[[float], Tuple]):
        """Call ``run(factor)`` -> (outputs, overflowed); re-run with a
        doubled factor while any bucket overflowed."""
        factor = self.capacity_factor
        for _attempt in range(MAX_OVERFLOW_RETRIES):
            outputs, overflowed = run(factor)
            if not overflowed:
                return outputs
            factor *= 2
        raise RuntimeError(
            f"bucket overflow persisted after {MAX_OVERFLOW_RETRIES} retries"
        )

    def _run_with_overflow_retry(self, n_total: int,
                                 run: Callable[[int], Tuple]):
        """Call ``run(capacity)`` -> (outputs, max_fill); re-run with a
        doubled factor while any bucket overflowed."""

        def attempt(factor: float):
            cap = self._capacity(n_total // self.n_devices, factor)
            outputs, max_fill = run(cap)
            return outputs, int(max_fill.max()) > cap

        return self._retry_with_factor(attempt)

    def _to_device(self, *tensors):
        return tuple(None if t is None else t.to(self.device)
                     for t in tensors)

    def _run_padded_keyed(self, keys, vals, make_step):
        """Host driver for keyed models (wordcount, aggregate): pad the
        numpy columns with a validity column, place them on the device
        once, run ``make_step(n_devices, n_local, capacity,
        with_validity)`` under the overflow-retry policy, and return
        ``(rows, nu)``: each row tensor as a host [D, -1] array and the
        int32[D] valid-row counts."""
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError("keys/vals must be equal-length 1-D arrays")
        check_dtypes(keys=keys, vals=vals)
        n = keys.shape[0]
        if n == 0:
            return None, None
        D = self.n_devices
        n_pad = self._padded_length(n) - n
        valid = np.ones(n + n_pad, np.int32)
        if n_pad:
            keys = np.concatenate([keys, np.zeros(n_pad, keys.dtype)])
            vals = np.concatenate([vals, np.zeros(n_pad, vals.dtype)])
            valid[n:] = 0
        # D == 1 with no padding: every slot is real, so the step drops
        # the validity operand from its sort
        fast = D == 1 and n_pad == 0
        cols = (keys, vals) if fast else (keys, vals, valid)
        placed = tuple(torch.from_numpy(x).to(self.device) for x in cols)

        def run(cap):
            step = make_step(D, (n + n_pad) // D, cap, with_validity=not fast)
            *rows, n_unique, max_fill = step(*placed)
            return (rows, n_unique), max_fill

        rows, n_unique = self._run_with_overflow_retry(n + n_pad, run)
        host_rows = [r.cpu().numpy().reshape(D, -1) for r in rows]
        nu = n_unique.cpu().numpy().reshape(-1)
        return host_rows, nu
