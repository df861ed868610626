"""WordCount / reduceByKey on one GPU: the port of
``sparkrdma_tpu/models/wordcount.py``.

The exchange is the identity on one device (``ops/exchange.py``), then
the device-side segment reduction (``ops/segment.py``) puts every key's
total at its run end.  Validity is an explicit 0/1 column, so real keys
equal to the dtype max are counted correctly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel, check_dtypes
from sparkrdma_tpu_torch.ops.exchange import hash_exchange
from sparkrdma_tpu_torch.ops.segment import reduce_by_key_local


def _premask(k, v, valid, n_devices, capacity):
    """Exchange, then mask invalid slots to (dtype max key, 0 value)."""
    k, v, m, max_fill = hash_exchange(k, v, valid, n_devices, capacity)
    k = torch.where(m > 0, k, torch.iinfo(k.dtype).max)
    v = torch.where(m > 0, v, 0)
    return k, v, m, max_fill


def make_count_step(n_devices: int, n_local: int, capacity: int,
                    with_validity: bool = True):
    """The reduceByKey(+) step over [D * n_local] key/value(/valid)
    tensors.  Returns fn(...) -> (uniq, sums, counts, n_unique[1],
    max_fill[1]).  ``with_validity=False`` is the D == 1 unpadded fast
    path: every slot is real and the validity operand drops out of the
    sort."""
    if not with_validity:
        if n_devices != 1:
            raise ValueError("with_validity=False requires D == 1")

        def body_nv(k, v):
            uniq, sums, cnts, n_unique = reduce_by_key_local(k, v, None)
            return (uniq, sums, cnts, n_unique.reshape(1),
                    torch.zeros(1, dtype=torch.int32, device=k.device))

        return body_nv

    def body(k, v, valid):
        k, v, m, max_fill = _premask(k, v, valid, n_devices, capacity)
        uniq, sums, cnts, n_unique = reduce_by_key_local(k, v, m)
        return uniq, sums, cnts, n_unique.reshape(1), max_fill.reshape(1)

    return body


class WordCounter(ExchangeModel):
    """Host-facing reduceByKey(+): returns {key: total}."""

    def __init__(self, device=None, capacity_factor: float = 2.0, **kw):
        super().__init__(device, capacity_factor, **kw)

    def count_device(self, keys: torch.Tensor, vals: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     capacity: Optional[int] = None):
        """One step on device tensors.  Returns ((uniq, sums, counts,
        n_unique[1], max_fill[1]), capacity); results sit at run-end
        positions, extract by ``counts > 0``."""
        n = keys.shape[0]
        if n % self.n_devices:
            raise ValueError(f"length {n} not divisible by D={self.n_devices}")
        check_dtypes(keys=keys, vals=vals)
        n_local = n // self.n_devices
        cap = capacity or self._capacity(n_local)
        keys, vals, valid = self._to_device(keys, vals, valid)
        if valid is None and self.n_devices == 1:
            step = make_count_step(1, n_local, cap, with_validity=False)
            return step(keys, vals), cap
        if valid is None:
            valid = torch.ones(n, dtype=torch.int32, device=self.device)
        step = make_count_step(self.n_devices, n_local, cap)
        return step(keys, vals, valid), cap

    def count(self, keys, vals=None) -> Dict[int, int]:
        """Totals wrap in the value dtype on overflow (JVM Int/Long
        parity)."""
        keys = np.asarray(keys)
        vals = np.ones_like(keys) if vals is None else np.asarray(vals)
        rows, _nu = self._run_padded_keyed(keys, vals, make_count_step)
        if rows is None:
            return {}
        uniq_h, sums_h, counts_h = rows
        out: Dict[int, int] = {}
        for d in range(self.n_devices):
            mask = counts_h[d] > 0
            for k, s in zip(uniq_h[d][mask], sums_h[d][mask]):
                out[int(k)] = int(s)
        return out
