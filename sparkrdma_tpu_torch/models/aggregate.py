"""Keyed aggregation (aggregateByKey) on one GPU: the port of
``sparkrdma_tpu/models/aggregate.py``.

Sum, count, min, max (and mean, host-side) per key: the identity
exchange of one device followed by ``ops/segment.py``'s
``aggregate_by_key_local``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel, check_dtypes
from sparkrdma_tpu_torch.models.wordcount import _premask
from sparkrdma_tpu_torch.ops.segment import aggregate_by_key_local


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
                        with_validity: bool = True):
    """The aggregateByKey step over [D * n_local] columns.  Returns
    fn(...) -> (uniq, sums, counts, mins, maxs, n_unique[1],
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
        k, v, m, max_fill = _premask(k, v, valid, n_devices, capacity)
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
        """One step on device tensors (the counterpart of
        ``WordCounter.count_device``).  Returns ((uniq, sums, counts,
        mins, maxs, n_unique[1], max_fill[1]), capacity)."""
        n = keys.shape[0]
        if n % self.n_devices:
            raise ValueError(f"length {n} not divisible by D={self.n_devices}")
        check_dtypes(keys=keys, vals=vals)
        n_local = n // self.n_devices
        cap = capacity or self._capacity(n_local)
        keys, vals, valid = self._to_device(keys, vals, valid)
        if valid is None and self.n_devices == 1:
            step = make_aggregate_step(1, n_local, cap, with_validity=False)
            return step(keys, vals), cap
        if valid is None:
            valid = torch.ones(n, dtype=torch.int32, device=self.device)
        step = make_aggregate_step(self.n_devices, n_local, cap)
        return step(keys, vals, valid), cap

    def aggregate(self, keys, vals) -> Dict[int, KeyStats]:
        """Sums accumulate in the value dtype and wrap on overflow (JVM
        Int/Long parity)."""
        rows, _nu = self._run_padded_keyed(keys, vals, make_aggregate_step)
        if rows is None:
            return {}
        uniq_h, sums_h, counts_h, mins_h, maxs_h = rows
        out: Dict[int, KeyStats] = {}
        for d in range(self.n_devices):
            (idx,) = (counts_h[d] > 0).nonzero()
            for i in idx:
                out[int(uniq_h[d, i])] = KeyStats(
                    int(sums_h[d, i]), int(counts_h[d, i]),
                    int(mins_h[d, i]), int(maxs_h[d, i]),
                )
        return out
