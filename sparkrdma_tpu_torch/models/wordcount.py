"""WordCount / reduceByKey: the port of
``sparkrdma_tpu/models/wordcount.py``.

The hash exchange (``ops/exchange.py``; the identity on one device)
moves every key to the rank that owns it, then the device-side segment
reduction (``ops/segment.py``) puts every key's total at its run end.
Validity is an explicit 0/1 column, so real keys equal to the dtype max
are counted correctly.  At D > 1 each rank returns the keys it owns;
the ranks' dicts are disjoint and their union is the whole count.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel
from sparkrdma_tpu_torch.ops.exchange import hash_exchange
from sparkrdma_tpu_torch.ops.segment import reduce_by_key_local


def _premask(k, v, valid, n_devices, capacity, group=None,
             unsigned_keys=False):
    """Exchange, then mask invalid slots to (dtype max key, 0 value)."""
    k, v, m, max_fill = hash_exchange(k, v, valid, n_devices, capacity,
                                      group, unsigned_keys)
    k = torch.where(m > 0, k, torch.iinfo(k.dtype).max)
    v = torch.where(m > 0, v, 0)
    return k, v, m, max_fill


def make_count_step(n_devices: int, n_local: int, capacity: int,
                    with_validity: bool = True, group=None,
                    unsigned_keys: bool = False):
    """The reduceByKey(+) step over this rank's [n_local] key/value
    (/valid) tensors.  Returns fn(...) -> (uniq, sums, counts,
    n_unique[1], max_fill[1]).  ``with_validity=False`` is the D == 1
    unpadded fast path: every slot is real and the validity operand
    drops out of the sort.  ``group`` and ``unsigned_keys`` as in
    ``hash_exchange``."""
    if not with_validity:
        if n_devices != 1:
            raise ValueError("with_validity=False requires D == 1")

        def body_nv(k, v):
            uniq, sums, cnts, n_unique = reduce_by_key_local(k, v, None)
            return (uniq, sums, cnts, n_unique.reshape(1),
                    torch.zeros(1, dtype=torch.int32, device=k.device))

        return body_nv

    def body(k, v, valid):
        k, v, m, max_fill = _premask(k, v, valid, n_devices, capacity,
                                     group, unsigned_keys)
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
        """One step on this rank's device tensors.  Returns ((uniq,
        sums, counts, n_unique[1], max_fill[1]), capacity); results sit
        at run-end positions, extract by ``counts > 0``."""
        return self._run_device_keyed(make_count_step, keys, vals, valid,
                                      capacity, (1,))

    def count(self, keys, vals=None) -> Dict[int, int]:
        """{key: total} of the keys this rank owns.  Totals wrap in the
        value dtype on overflow (JVM Int/Long parity); float values sum
        in float32 and come back as floats."""
        keys = np.asarray(keys)
        vals = np.ones_like(keys) if vals is None else vals
        rows, _nu = self._run_padded_keyed(keys, vals, make_count_step,
                                           "sum")
        if rows is None:
            return {}
        uniq_h, sums_h, counts_h = rows
        mask = counts_h > 0
        return dict(zip(uniq_h[mask].tolist(), sums_h[mask].tolist()))
