"""Driver of ``hibench_terasort``: each step of the window is one
``TeraSorter.sort_device_wide`` over this rank's records, the port's
main path.  On one card it is the local sort (int64 radix sort, the
92 B payload row gather, the padding to capacity); over a world of D
ranks it is the exchange step (exact-quantile splitters, windows, three
``all_to_all``s over the group, the merge).

The records are made on the device from the seed by
``inputs/hibench_terasort.py`` and stay the same for every step.
"""

from __future__ import annotations

from typing import Dict, Sequence

from sparkrdma_tpu_torch.models.terasort import TeraSorter

from shufflebench.common import module


class Job:
    """One rank's share of the cell: its records and the sorter."""

    def __init__(self, config, seed: int, rank: int, world: int, group,
                 device):
        inputs = module("inputs", "hibench_terasort")
        self.keys = inputs.make_keys(config, seed, rank, device)
        self.payload = inputs.make_payload(config, seed, rank, device)
        self.group = group
        self.device = device
        self.factors: Sequence[float] = list(config["capacity_factors"])
        self.capacity = 0
        self.use_factor(self.factors[0])

    def use_factor(self, factor: float) -> None:
        self.factor = factor
        self.sorter = TeraSorter(device=self.device, capacity_factor=factor,
                                 group=self.group)

    def step(self):
        """One sort step; returns (keys', payload', n_valid, max_fill)
        without waiting for the device."""
        out, self.capacity = self.sorter.sort_device_wide(self.keys,
                                                          self.payload)
        return out

    def overflowed(self, out) -> bool:
        """Whether a bucket held more rows than its capacity (reads the
        step's one-number ``max_fill``, as the model's retry does)."""
        return int(out[3].reshape(-1)[0]) > self.capacity

    def info(self) -> Dict[str, object]:
        return {"capacity": self.capacity, "capacity_factor": self.factor,
                "records_per_card": int(self.keys.shape[0])}

    def release(self) -> None:
        del self.keys, self.payload, self.sorter
