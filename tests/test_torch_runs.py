"""Kernel 1's passes a step makes, counted on the CPU.

Every pass of the flagged scan (``ops/scan_kernels.py``, kernel 1 on a
card) reads and writes the whole stream, so how many a step makes is
part of its cost.  On the CPU each pass is one call of
``scan_flagged_plain``: the test counts those calls, by scan kind,
through ``monkeypatch`` during one step of each caller of the run-end
layout (``ops/segment.py``) and of the joins' probe fill.
"""

import collections

import pytest
import torch

from sparkrdma_tpu_torch.models.join import make_hash_join_step
from sparkrdma_tpu_torch.models.join_aggregate import (
    make_broadcast_join_aggregate_step,
)
from sparkrdma_tpu_torch.models.rollup import make_rollup_step
from sparkrdma_tpu_torch.models.topk import make_topk_step
from sparkrdma_tpu_torch.ops import scan_kernels
from sparkrdma_tpu_torch.ops.segment import (
    aggregate_by_key_local,
    reduce_by_key_local,
)

N = 512
N_DIM = 96


def _keyed(with_valid: bool, seed: int = 5):
    """(keys, vals, valid): int32 keys over 64 values, about a fifth of
    the slots invalid and pre-masked to (dtype max, 0) when ``valid``
    is given."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, 64, (N,), generator=g, dtype=torch.int32)
    vals = torch.randint(-100, 100, (N,), generator=g, dtype=torch.int32)
    if not with_valid:
        return keys, vals, None
    valid = (torch.rand(N, generator=g) < 0.8).to(torch.int32)
    keys = torch.where(valid > 0, keys, torch.iinfo(torch.int32).max)
    return keys, torch.where(valid > 0, vals, 0), valid


def _join_cols(seed: int = 7):
    """A fact side of N rows and a dimension side of N_DIM distinct
    keys, each with validity."""
    g = torch.Generator().manual_seed(seed)
    dk = torch.randperm(4 * N_DIM, generator=g)[:N_DIM].to(torch.int32)
    return (torch.randint(0, 4 * N_DIM, (N,), generator=g, dtype=torch.int32),
            torch.randint(-1000, 1000, (N,), generator=g, dtype=torch.int32),
            (torch.rand(N, generator=g) < 0.9).to(torch.int32),
            dk,
            torch.randint(-1000, 1000, (N_DIM,), generator=g,
                          dtype=torch.int32),
            torch.ones(N_DIM, dtype=torch.int32))


def _by_key(key_u):
    return key_u


def _rollup():
    """Distinct ascending keys of four fields and their sums."""
    keys = torch.unique(torch.randint(0, 1 << 12, (N,),
                                      generator=torch.Generator().manual_seed(9)))
    step = make_rollup_step(keys.shape[0], 4 * N, [3, 2, 4, 3])
    return step(keys, keys * 3, torch.tensor([keys.shape[0]],
                                             dtype=torch.int32))


STEPS = {
    "reduce": lambda: reduce_by_key_local(*_keyed(False)),
    "reduce_valid": lambda: reduce_by_key_local(*_keyed(True)),
    "aggregate": lambda: aggregate_by_key_local(*_keyed(False)),
    "aggregate_valid": lambda: aggregate_by_key_local(*_keyed(True)),
    "join_aggregate": lambda: make_broadcast_join_aggregate_step(
        1, N, N_DIM, _by_key)(*_join_cols()),
    "hash_join": lambda: make_hash_join_step(1, N, N_DIM, 2 * N)(
        *_join_cols()),
    "topk": lambda: make_topk_step(1, N, N, 3)(*_keyed(True)),
    "topk_rank": lambda: make_topk_step(1, N, N, 3, ties="rank")(
        *_keyed(True)),
    "rollup": _rollup,
}

# the passes of one step by kind: "add" with no segment heads is a
# cumsum_1d, "fill" a forward fill, "min"/"max" segmented scans
PASSES = {
    "reduce": {"add": 2, "fill": 1},
    "reduce_valid": {"add": 2, "fill": 1},
    "aggregate": {"add": 2, "fill": 1},
    "aggregate_valid": {"add": 2, "fill": 1},
    "join_aggregate": {"add": 2, "fill": 2, "min": 1, "max": 1},
    "hash_join": {"fill": 1},
    "topk": {"fill": 1},
    "topk_rank": {"fill": 2},
    "rollup": {"add": 5},
}


@pytest.mark.parametrize("step", sorted(PASSES))
def test_kernel1_passes_per_step(monkeypatch, step):
    kinds = collections.Counter()
    plain = scan_kernels.scan_flagged_plain

    def counted(kind, flag, cols):
        kinds[kind] += 1
        return plain(kind, flag, cols)

    monkeypatch.setattr(scan_kernels, "scan_flagged_plain", counted)
    STEPS[step]()
    assert dict(kinds) == PASSES[step]
