"""The port's headline benchmark: TeraSort shuffle+sort throughput per card.

    python -m sparkrdma_tpu_torch.bench

The counterpart of the repository root's ``bench.py``, with its
contract: one ``#`` line for 8 B records (int32 key + int32 value) at
2^24 records, then ONE JSON line, the last, for HiBench 100 B records
(4 B key + 24 payload words) at 2^22 records:

    {"metric": "terasort shuffle+sort throughput per chip, HiBench 100B
     records (...)", "value": N, "unit": "GB/s/chip", "vs_baseline": N}

``vs_baseline`` divides by ``BASELINE_GBPS``, the 12.5 GB/s line rate of
the reference's 100 GbE RoCE data plane.  Each shape runs ``WARMUP``
steps, checks that every record came back, and times ``ITERS`` calls of
the same ``TeraSorter.sort_device`` / ``sort_device_wide`` step with CUDA
events (the host clock on the CPU, where the tests run it small).  The
wide step retries once with capacity factor 2.0 if a bucket overflowed
at 1.3; if it still overflows, or any check fails, the bench raises and
prints no result.

D is the size of the ``torch.distributed`` world when one is
initialised (NCCL, one process per card; the caller initialises it and
calls :func:`run`), else 1.  Every rank draws the whole seeded input and
sorts its contiguous shard; the record count is the whole input's, and
the value is per card: bytes sorted / step time / D.  Rank 0 prints.
The metric text names the card.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.parallel.device import DeviceLike
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, world_group

# 100 GbE RoCE line rate, the reference data plane's per-node ceiling (GB/s)
BASELINE_GBPS = 12.5
N_RECORDS = 1 << 24  # 8 B records: 134 MB
N_WIDE = 1 << 22     # 100 B records: 419 MB
WIDE_WORDS = 24      # 96 B payload + 4 B key
WARMUP = 2
ITERS = 20
WIDE_FACTORS = (1.3, 2.0)


def step_ms(fn: Callable[[], object], iters: int,
            device: torch.device) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` calls: CUDA events
    around the calls on a card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
    return (time.monotonic() - t0) / iters * 1e3


def _shard(x: np.ndarray, group: ExchangeGroup) -> np.ndarray:
    n = x.shape[0] // group.size
    return x[group.rank * n:(group.rank + 1) * n]


def _total(n_valid: torch.Tensor, group: ExchangeGroup) -> int:
    """Records every rank's step kept, summed over the ranks."""
    return int(group.all_gather(n_valid.reshape(-1)).sum())


def bench_8b(group: ExchangeGroup, n: int = N_RECORDS, iters: int = ITERS,
             warmup: int = WARMUP) -> float:
    """GB/s per card of the 8 B-record sort step over ``n`` records."""
    device = group.device
    rng = np.random.default_rng(42)
    keys = torch.from_numpy(_shard(
        rng.integers(0, 1 << 31, size=n, dtype=np.int32), group)).to(device)
    vals = torch.from_numpy(_shard(
        rng.integers(0, 1 << 31, size=n, dtype=np.int32), group)).to(device)
    sorter = TeraSorter(group=group)

    def run_once():
        (_sk, _sv, n_valid, _mf), _cap = sorter.sort_device(keys, vals)
        return n_valid

    for _ in range(warmup):
        n_valid = run_once()
    if _total(n_valid, group) != n:
        raise RuntimeError("records lost in the 8 B sort step")
    ms = step_ms(run_once, iters, device)
    return n * 8 / (ms * 1e-3) / 1e9 / group.size


def bench_wide(group: ExchangeGroup, n: int = N_WIDE,
               words: int = WIDE_WORDS, iters: int = ITERS,
               warmup: int = WARMUP) -> Tuple[float, float]:
    """(GB/s per card, capacity factor) of the wide-record sort step
    over ``n`` records of ``4 + 4 * words`` bytes.  Retries once with a
    larger capacity factor on a bucket overflow, and raises if that
    overflows too."""
    device = group.device
    rng = np.random.default_rng(7)
    keys = torch.from_numpy(_shard(
        rng.integers(0, 1 << 31, n, dtype=np.int32), group)).to(device)
    payload = torch.from_numpy(_shard(
        rng.integers(0, 1 << 31, (n, words), dtype=np.int32),
        group)).to(device)
    for factor in WIDE_FACTORS:
        sorter = TeraSorter(capacity_factor=factor, group=group)
        (_sk, _sp, n_valid, max_fill), cap = sorter.sort_device_wide(
            keys, payload)
        if sorter._overflowed(max_fill, cap):
            continue  # overflow: retry with more headroom
        for _ in range(warmup - 1):
            (_sk, _sp, n_valid, _mf), _cap = sorter.sort_device_wide(
                keys, payload)
        if _total(n_valid, group) != n:
            raise RuntimeError("records lost in the wide sort step")
        ms = step_ms(lambda: sorter.sort_device_wide(keys, payload), iters,
                     device)
        return n * (4 + 4 * words) / (ms * 1e-3) / 1e9 / group.size, factor
    raise RuntimeError(
        f"wide sort overflowed even at capacity factor {WIDE_FACTORS[-1]}")


def _card(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(device: DeviceLike = None, n_records: int = N_RECORDS,
        n_wide: int = N_WIDE, iters: int = ITERS,
        warmup: int = WARMUP) -> Tuple[str, Dict[str, object]]:
    """Both shapes: returns the ``#`` line of the 8 B records and the
    headline record (a dict; :func:`main` prints it as JSON).  Runs on
    the card unless ``device`` says otherwise; over the initialised
    ``torch.distributed`` world when there is one."""
    group = world_group(device)
    d = group.size
    card = _card(group.device)
    narrow = bench_8b(group, n_records, iters, warmup)
    comment = (f"# terasort 8B-record shape ({n_records} records, {d} "
               f"card(s) {card}, torch.sort): {narrow} GB/s/chip "
               f"(vs_baseline {narrow / BASELINE_GBPS})")
    wide, factor = bench_wide(group, n_wide, WIDE_WORDS, iters, warmup)
    record = {
        "metric": "terasort shuffle+sort throughput per chip, HiBench 100B "
                  f"records ({n_wide} records, {d} card(s) {card}, key sort "
                  f"+ payload gather, capacity factor {factor})",
        "value": wide,
        "unit": "GB/s/chip",
        "vs_baseline": wide / BASELINE_GBPS,
    }
    return comment, record


def main() -> None:
    comment, record = run()
    if world_group().rank == 0:
        print(comment, flush=True)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
