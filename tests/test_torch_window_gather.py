"""TeraSort's map side gathers each payload row once (CPU).

``fill_windows`` reads the send block's payload straight from the
unsorted rows through the sort's permutation.  It is held against
windows built in numpy from ``np.lexsort``'s order alone (the route
before this one gathered the payload into sorted order first and the
windows from that copy; the reference reads ``vals[order[row]]`` the
same way): keys, valid counts and true counts bit for bit, the payload
of every slot that holds a key of the window bit for bit, padding keys
the dtype's max and 1-D padding payload 0.  The sort's permutation is
held against ``np.lexsort`` by (key, invalid, row), and the counter
``terasort_payload_rows_total{stage=}`` is pinned for a D = 4 step and
a D = 1 step.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models import terasort as tts
from sparkrdma_tpu_torch.ops import partition as tpart
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup

N = 2003
WORDS = 23


def _inputs(dtype, wide, with_valid, seed):
    """Keys with many duplicates and the dtype's extremes among them
    (the max too, as a real key), int32 payload rows, a 0/1 validity
    column or None."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    keys = rng.integers(-20, 20, N).astype(dtype)
    at = rng.choice(N, N // 8, replace=False)
    keys[at] = rng.choice(np.array([info.min, info.max, info.min + 1,
                                    info.max - 1], dtype), at.size)
    shape = (N, WORDS) if wide else (N,)
    vals = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
    valid = (rng.random(N) < 0.85).astype(np.int32) if with_valid else None
    return (torch.from_numpy(keys), torch.from_numpy(vals.astype(np.int32)),
            None if valid is None else torch.from_numpy(valid))


def _reference_windows(sorted_keys, order, vals, n_real, splitters,
                       capacity):
    """The send block in numpy from the sorted keys and the sort order
    alone: window p holds the sorted rows in ``[edges[p], edges[p+1])``,
    ``edges`` the splitters' right-sided positions in the sorted keys;
    its first ``min(count, capacity)`` slots hold those keys and the
    payload rows ``vals[order[row]]``, the rest the dtype's max (and 0
    for a 1-D payload).  Returns (keys, vals, valid counts, counts,
    which slots hold a key of their window)."""
    n, D = sorted_keys.shape[0], splitters.shape[0] + 1
    edges = np.concatenate([[0], np.searchsorted(sorted_keys, splitters,
                                                 side="right"), [n]])
    counts = np.diff(edges)
    valid_counts = np.clip(np.minimum(edges[1:], n_real) - edges[:-1],
                           0, capacity)
    bk = np.full((D, capacity), np.iinfo(sorted_keys.dtype).max,
                 sorted_keys.dtype)
    bv = np.zeros((D, capacity, *vals.shape[1:]), vals.dtype)
    held = np.zeros((D, capacity), bool)
    for p in range(D):
        rows = np.arange(edges[p], edges[p] + min(counts[p], capacity))
        bk[p, :rows.size] = sorted_keys[rows]
        bv[p, :rows.size] = vals[order[rows]]
        held[p, :rows.size] = True
    return (bk, bv, valid_counts.astype(np.int32), counts.astype(np.int32),
            held)


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_one_gather_matches_two_gathers(D, dtype, wide, with_valid, tight):
    keys, vals, valid = _inputs(dtype, wide, with_valid, D * 10 + wide)
    # a tight capacity truncates windows, as a step that overflows does
    capacity = (N // D // 2 if tight else -(-int(N / D * 1.3) // 8) * 8)
    k, perm, n_real, sample = tts.sort_and_sample(keys, valid, 256)

    sort_keys = keys.numpy().copy()
    invalid = np.zeros(N, np.int32)
    if valid is not None:
        invalid = 1 - valid.numpy()
        sort_keys[invalid == 1] = np.iinfo(dtype).max
    order = np.lexsort((np.arange(N), invalid, sort_keys))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(k.numpy(), sort_keys[order])
    assert int(n_real) == N - int(invalid.sum())

    splitters = tpart.make_range_splitters(sample, D)
    bk, bv, vc, counts = tts.fill_windows(k, perm, vals, n_real, splitters,
                                          capacity)
    want_k, want_v, want_vc, want_counts, held = _reference_windows(
        sort_keys[order], order, vals.numpy(), N - int(invalid.sum()),
        splitters.numpy(), capacity)
    for g, w in ((bk, want_k), (vc, want_vc), (counts, want_counts)):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert bv.dtype == vals.dtype
    assert bv.shape == (D, capacity, *vals.shape[1:])
    np.testing.assert_array_equal(bv.numpy()[held], want_v[held])
    if not wide:
        np.testing.assert_array_equal(bv.numpy(), want_v)
    if tight:
        assert int(counts.max()) > capacity
    # the valid prefix of every window is ascending, as the merge needs
    for p in range(D):
        run = bk[p, :int(vc[p])]
        assert (run[1:] >= run[:-1]).all()


class _MirrorGroup(ExchangeGroup):
    """Rank 0 of a world of ``size`` ranks that hold the same rows on
    the CPU: the all_gather repeats this rank's tensor, and every
    source sends rank 0 its row 0."""

    def __init__(self, size):
        super().__init__(device="cpu")
        self.size = size

    def all_gather(self, x):
        return torch.stack([x] * self.size)

    def all_to_all(self, x):
        return x[:1].expand_as(x).contiguous()


def _payload_rows(step, *args):
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        out = step(*args)
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    return out, {c["labels"]["stage"]: c["value"] for c in snap
                 if c["name"] == "terasort_payload_rows_total"}


@pytest.mark.parametrize("with_valid", [False, True])
def test_payload_rows_total_counts_the_window_fill_and_merge_at_d4(
        with_valid):
    """A four-rank step gathers payload rows once on each side of the
    exchange: ``local_sort`` never counts."""
    keys, vals, valid = _inputs(np.int64, True, with_valid, 7)
    cap = 664
    step = tts.make_sort_step(4, N, cap, 256, with_valid, _MirrorGroup(4))
    args = (keys, vals, valid) if with_valid else (keys, vals)
    (sk, sv, n_valid, max_fill), got = _payload_rows(step, *args)
    assert got == {"fill_windows": 4 * cap, "merge": 4 * cap}
    assert sk.shape == (4 * cap,) and sv.shape == (4 * cap, WORDS)
    assert int(max_fill[0]) <= cap


@pytest.mark.parametrize("capacity", [N + 5, N - 3])
def test_payload_rows_total_counts_the_local_sort_at_d1(capacity):
    """One card gathers the rows that fit its output once, in the local
    sort, and nothing else."""
    keys, vals, _valid = _inputs(np.int64, True, False, 8)
    step = tts.make_wide_sort_step(1, N, WORDS, capacity)
    (sk, sv, n_valid, _fill), got = _payload_rows(step, keys, vals)
    assert got == {"local_sort": min(N, capacity)}
    order = torch.sort(keys, stable=True).indices[:min(N, capacity)]
    assert torch.equal(sv[:min(N, capacity)], vals[order])
    assert (sv[min(N, capacity):] == 0).all()
