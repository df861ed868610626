"""The merge of sorted runs (``ops/merge_kernel.py``) on the CPU.

The plain version against an independent order (``np.lexsort`` by key,
then validity, then flat slot), the schedule of ``csrc/merge_runs.cu``
emulated in Python against the plain version, ``merge_received``'s
payload gather, the wrapper's refusals and its
``merge_rows_total{path=plain}`` counter.  tests/test_torch_gpu.py
holds the kernel against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models import terasort as tts
from sparkrdma_tpu_torch.ops import lexsort as tlex
from sparkrdma_tpu_torch.ops import merge_kernel as tmerge

DTYPES = [np.int32, np.int64]
CASES = ["empty", "full", "mixed"]


def _block(n_runs, cap, dtype, case, seed):
    """A received block: row s ascending over its first rvalid[s]
    slots (``dups_extremes`` keys, the dtype's max among them), the
    dtype's max after them."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if case == "empty":
        rvalid = np.zeros(n_runs, np.int32)
    elif case == "full":
        rvalid = np.full(n_runs, cap, np.int32)
    else:
        rvalid = rng.integers(0, cap + 1, n_runs).astype(np.int32)
        rvalid[0] = cap
        rvalid[-1] = 0 if n_runs > 1 else cap // 2
    rk = np.full((n_runs, cap), info.max, dtype)
    for s, n in enumerate(rvalid):
        k = rng.integers(0, 7, n).astype(dtype)
        k[: n // 4] = rng.choice(np.array([info.max, info.min, 0, -1],
                                          dtype), n // 4)
        rk[s, :n] = np.sort(k)
    return torch.from_numpy(rk), torch.from_numpy(rvalid)


def _lexsort_order(rk, rvalid):
    n_runs, cap = rk.shape
    invalid = np.arange(cap)[None, :] >= rvalid.numpy()[:, None]
    flat = rk.numpy().reshape(-1)
    return np.lexsort((np.arange(flat.size), invalid.reshape(-1), flat))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_runs", [1, 2, 3, 4, 8])
def test_merge_runs_plain_matches_lexsort(n_runs, dtype, case):
    rk, rvalid = _block(n_runs, 301, dtype, case, n_runs)
    keys, src = tmerge.merge_runs(rk, rvalid)
    order = _lexsort_order(rk, rvalid)
    assert src.dtype == torch.int32 and keys.dtype == rk.dtype
    np.testing.assert_array_equal(src.numpy(), order)
    np.testing.assert_array_equal(keys.numpy(), rk.numpy().reshape(-1)[order])


# The schedule of csrc/merge_runs.cu, emulated: each round's grid of
# (tile, pair) blocks, the 32-way co-rank search of a tile's two ends,
# the per-thread co-rank and merge of kItems outputs, the pass-through
# of an unpaired run, the ping-pong between the output and the scratch
# pair, and the last round's padding tail.  The kernel's tile is 256
# threads x 8 items; the emulation scales the tile down so that a small
# block crosses many tiles.
def _corank_warp(keys, a_base, na, b_base, nb, diag):
    lo, hi = max(0, diag - nb), min(diag, na)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        preds = [p < hi and keys[a_base + p] <= keys[b_base + diag - 1 - p]
                 for p in (lo + lane * step for lane in range(32))]
        assert preds == sorted(preds, reverse=True)  # one ballot's prefix
        c = sum(preds)
        if c == 0:
            hi = lo
        else:
            first_false = lo + c * step
            lo += (c - 1) * step + 1
            hi = min(hi, first_false)
    return lo


def _corank_seq(a, b, diag):
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _emulate_block(key_in, src_in, key_out, src_out, rk, off, cap, n_runs,
                   width, last, pair, tile, threads, items):
    t_len = threads * items
    a_row = 2 * pair * width
    b_row = min(a_row + width, n_runs)
    end_row = min(a_row + 2 * width, n_runs)
    na, nb = off[b_row] - off[a_row], off[end_row] - off[b_row]
    merged = na + nb
    a_base, b_base = a_row * cap, b_row * cap
    t0 = tile * t_len
    region = (end_row - a_row) * cap
    if t0 >= region or (not last and t0 >= merged):
        return
    t1 = min(t0 + t_len, region)
    d0, d1 = t0, min(t1, merged)
    if d0 < d1:
        a0 = _corank_warp(key_in, a_base, na, b_base, nb, d0)
        a1 = _corank_warp(key_in, a_base, na, b_base, nb, d1)
        n, ta = d1 - d0, a1 - a0
        xs = [a_base + a0 + k if k < ta else b_base + (d0 - a0) + (k - ta)
              for k in range(n)]
        s_key = [key_in[x] for x in xs]
        s_src = [x if src_in is None else src_in[x] for x in xs]
        sa, sb = s_key[:ta], s_key[ta:]
        outs = []
        for t in range(threads):
            diag = t * items
            if diag >= n:
                continue
            i = _corank_seq(sa, sb, diag)
            j = diag - i
            for _ in range(min(items, n - diag)):
                take_a = j >= len(sb) or (i < ta and sa[i] <= sb[j])
                at = i if take_a else ta + j
                outs.append((s_key[at], s_src[at]))
                i, j = i + take_a, j + (not take_a)
        assert len(outs) == n
        for k, (kk, ss) in enumerate(outs):
            key_out[a_base + d0 + k] = kk
            src_out[a_base + d0 + k] = ss
    if last:
        for p in range(max(t0, merged), t1):
            j = p - merged
            lo, hi = 0, n_runs - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if mid * cap - off[mid] <= j:
                    lo = mid
                else:
                    hi = mid - 1
            slot = (off[lo + 1] - off[lo]) + (j - (lo * cap - off[lo]))
            x = lo * cap + slot
            key_out[p] = rk[x]
            src_out[p] = x


def _emulate_merge_runs(rk, rvalid, threads=2, items=4):
    n_runs, cap = rk.shape
    flat = rk.reshape(-1).tolist()
    off = [0] + np.cumsum(np.clip(rvalid.numpy().astype(np.int64), 0, cap)
                          ).tolist()
    n_rounds = max(1, (n_runs - 1).bit_length())  # sr_merge_runs_rounds
    garbage = -12345
    out_k, out_s = [garbage] * len(flat), [garbage] * len(flat)
    tmp_k, tmp_s = [garbage] * len(flat), [garbage] * len(flat)
    key_in, src_in = flat, None
    t_len = threads * items
    for r in range(n_rounds):
        width = 1 << r
        to_out = (n_rounds - 1 - r) % 2 == 0
        ko, so = (out_k, out_s) if to_out else (tmp_k, tmp_s)
        rows = min(2 * width, n_runs)
        tiles = -(-rows * cap // t_len)
        pairs = -(-n_runs // (2 * width))
        for pair in range(pairs):
            for tile in range(tiles):
                _emulate_block(key_in, src_in, ko, so, flat, off, cap,
                               n_runs, width, r == n_rounds - 1, pair, tile,
                               threads, items)
        key_in, src_in = ko, so
    return (torch.tensor(out_k, dtype=rk.dtype),
            torch.tensor(out_s, dtype=torch.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_runs", [1, 2, 3, 4, 5, 8])
def test_merge_kernel_schedule_emulated(n_runs, dtype, case):
    rk, rvalid = _block(n_runs, 37, dtype, case, 10 + n_runs)
    want_k, want_s = tmerge.merge_runs_plain(rk, rvalid)
    got_k, got_s = _emulate_merge_runs(rk, rvalid)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_k, want_k)


def test_merge_kernel_schedule_emulated_wide_search():
    """Runs long enough that the co-rank search of a tile's ends takes
    several 32-way steps."""
    rk, rvalid = _block(4, 3000, np.int64, "mixed", 77)
    want = tmerge.merge_runs_plain(rk, rvalid)
    got = _emulate_merge_runs(rk, rvalid, threads=16, items=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_received_gathers_payload_by_source(dtype, wide):
    """``merge_received`` against the stable (key, invalid) sort of
    the whole block and its payload gather."""
    rk, rvalid = _block(4, 257, dtype, "mixed", 5)
    g = torch.Generator().manual_seed(6)
    shape = (4, 257, 23) if wide else (4, 257)
    rv = torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                       dtype=torch.int32)
    keys, vals, n_valid = tts.merge_received(rk, rv, rvalid)
    inv = (torch.arange(257)[None, :] >= rvalid[:, None]).to(torch.int32)
    perm = tlex.perm_by_key_invalid(rk.reshape(-1), inv.reshape(-1))
    assert torch.equal(keys, rk.reshape(-1)[perm])
    assert torch.equal(vals, rv.reshape(4 * 257, *shape[2:])[perm])
    assert n_valid.dtype == torch.int32 and int(n_valid[0]) == rvalid.sum()


def test_merge_rows_total_counts_the_plain_path():
    rk, rvalid = _block(3, 50, np.int64, "mixed", 8)
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        tmerge.merge_runs(rk, rvalid)
        tts.merge_received(rk, torch.zeros(3, 50, 2), rvalid)
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    got = {c["labels"]["path"]: c["value"] for c in snap
           if c["name"] == "merge_rows_total"}
    assert got == {"plain": 300}


def _bad(what):
    rk, rvalid = _block(4, 16, np.int64, "mixed", 9)
    if what == "non_contiguous":
        return rk.t().contiguous().t(), rvalid
    if what == "float_key":
        return rk.to(torch.float32), rvalid
    if what == "rvalid_length":
        return rk, rvalid[:3]
    if what == "rvalid_dtype":
        return rk, rvalid.to(torch.int64)
    if what == "one_dim":
        return rk.reshape(-1), rvalid
    raise AssertionError(what)


@pytest.mark.parametrize("what", ["non_contiguous", "float_key",
                                  "rvalid_length", "rvalid_dtype",
                                  "one_dim"])
def test_merge_runs_refuses_without_fallback(what):
    rk, rvalid = _bad(what)
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        with pytest.raises(ValueError):
            tmerge.merge_runs(rk, rvalid)
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    assert not [c for c in snap if c["name"] == "merge_rows_total"]
