"""Keyed aggregation (aggregateByKey): the port of
``sparkrdma_tpu/models/aggregate.py``.

Sum, count, min, max (and mean, host-side) per key: the hash exchange
(the identity on one device) followed by ``ops/segment.py``'s
``aggregate_by_key_local``.  At D > 1 each rank returns the keys it
owns.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel
from sparkrdma_tpu_torch.models.wordcount import _premask
from sparkrdma_tpu_torch.ops.segment import aggregate_by_key_local

_VALUE_ROWS = (1, 3, 4)  # sums, mins, maxs


class KeyStats(NamedTuple):
    """Per-key aggregates (mean derived host-side: sum / count)."""

    sum: int
    count: int
    min: int
    max: int

    @property
    def mean(self) -> float:
        return self.sum / self.count


def make_aggregate_step(n_devices: int, n_local: int, capacity: int,
                        with_validity: bool = True, group=None,
                        unsigned_keys: bool = False):
    """The aggregateByKey step over this rank's [n_local] columns.
    Returns fn(...) -> (uniq, sums, counts, mins, maxs, n_unique[1],
    max_fill[1]).  ``with_validity=False`` is the D == 1 unpadded fast
    path."""
    if not with_validity:
        if n_devices != 1:
            raise ValueError("with_validity=False requires D == 1")

        def body_nv(k, v):
            *rows, n_unique = aggregate_by_key_local(k, v, None)
            return (*rows, n_unique.reshape(1),
                    torch.zeros(1, dtype=torch.int32, device=k.device))

        return body_nv

    def body(k, v, valid):
        k, v, m, max_fill = _premask(k, v, valid, n_devices, capacity,
                                     group, unsigned_keys)
        *rows, n_unique = aggregate_by_key_local(k, v, m)
        return (*rows, n_unique.reshape(1), max_fill.reshape(1))

    return body


class KeyedAggregator(ExchangeModel):
    """Host-facing aggregateByKey: returns {key: KeyStats}."""

    def __init__(self, device=None, capacity_factor: float = 2.0, **kw):
        super().__init__(device, capacity_factor, **kw)

    def aggregate_device(self, keys: torch.Tensor, vals: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         capacity: Optional[int] = None):
        """One step on this rank's device tensors (the counterpart of
        ``WordCounter.count_device``).  Returns ((uniq, sums, counts,
        mins, maxs, n_unique[1], max_fill[1]), capacity)."""
        return self._run_device_keyed(make_aggregate_step, keys, vals,
                                      valid, capacity, _VALUE_ROWS)

    def aggregate(self, keys, vals) -> Dict[int, KeyStats]:
        """{key: KeyStats} of the keys this rank owns.  Sums accumulate
        in the value dtype and wrap on overflow (JVM Int/Long parity);
        float values come back as floats."""
        rows, _nu = self._run_padded_keyed(keys, vals, make_aggregate_step,
                                           "sum", _VALUE_ROWS)
        if rows is None:
            return {}
        mask = rows[2] > 0
        uniq, sums, counts, mins, maxs = (r[mask].tolist() for r in rows)
        return {k: KeyStats(*st) for k, *st in
                zip(uniq, sums, counts, mins, maxs)}
