"""The port's kernel modules against the JAX package, on the CPU.

``sparkrdma_tpu_torch.ops.sort_kernel`` and ``.scan_kernels`` hold the
two hand-written CUDA kernels.  On a CPU tensor their wrappers run the
plain PyTorch versions, which must match the Pallas kernels run in
interpret mode: integer results bit for bit, the block sort's values
included (the network is deterministic).  ``fill`` results are compared
under the returned flag, as in tests/test_scan_kernels.py.  float32
``add`` is compared with rtol 1e-6: both sides sum in the same log-step
order here, the tolerance only allows for a different rounding path.

tests/test_torch_gpu.py holds each CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkrdma_tpu.ops import scan_kernels as jscan
from sparkrdma_tpu.ops import sort_kernel as jsort
from sparkrdma_tpu.ops.segment import _ff_run_carry, segmented_scan
from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.ops import attention as tattn
from sparkrdma_tpu_torch.ops import lexsort as tlex
from sparkrdma_tpu_torch.ops import scan_kernels as tscan
from sparkrdma_tpu_torch.ops import segment as tseg
from sparkrdma_tpu_torch.ops import sort_kernel as tsort

I32 = np.iinfo(np.int32)


def _keys(pattern, n, rng):
    if pattern == "random":
        return rng.integers(I32.min, I32.max, n, dtype=np.int32,
                            endpoint=True)
    if pattern == "dups_extremes":
        k = rng.integers(0, 7, n, dtype=np.int32)
        k[: n // 8] = rng.choice(
            np.array([I32.max, I32.min, 0, -1], np.int32), n // 8
        )
        return k
    if pattern == "reversed":
        return np.arange(n, 0, -1).astype(np.int32)
    return np.full(n, 7, np.int32)  # all equal


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize(
    "pattern", ["random", "dups_extremes", "reversed", "equal"]
)
@pytest.mark.parametrize("block_rows", [4, 8])
def test_block_sort_bit_exact_vs_pallas(block_rows, pattern):
    rng = np.random.default_rng(block_rows * 31 + len(pattern))
    n = 3 * block_rows * 128
    k = _keys(pattern, n, rng)
    v = rng.integers(I32.min, I32.max, n, dtype=np.int32)
    want_k, want_v = jsort.sort_pairs_blocks(
        jnp.asarray(k), jnp.asarray(v), block_rows=block_rows,
        interpret=True,
    )
    got_k, got_v = tsort.sort_pairs_blocks(*_t(k, v), block_rows=block_rows)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize(
    "bad",
    [
        dict(k=np.zeros(512, np.int64), br=4),    # dtype
        dict(k=np.zeros(500, np.int32), br=4),    # not a block multiple
        dict(k=np.zeros(768, np.int32), br=6),    # block not a power of 2
    ],
)
def test_block_sort_rejects_unsupported(bad):
    k = bad["k"]
    with pytest.raises(ValueError):
        tsort.sort_pairs_blocks(*_t(k, k), block_rows=bad["br"])


def _canonical(keys, vals, valid):
    """Valid (key, value) pairs ordered by key, then value."""
    m = valid > 0
    k, v = keys[m], vals[m]
    order = np.lexsort((v, k))
    return k[order], v[order]


@pytest.mark.parametrize(
    "seed,n_buckets,pattern",
    [(3, 4, "random"), (4, 16, "random"), (5, 4, "dups_extremes"),
     (6, 4, "reversed")],
)
def test_sort_pairs_full_vs_pallas(seed, n_buckets, pattern):
    block_rows = 8
    n = 16 * block_rows * 128
    rng = np.random.default_rng(seed)
    k = _keys(pattern, n, rng)
    v = np.arange(n, dtype=np.int32)
    want = [np.asarray(x) for x in jsort.sort_pairs_full(
        jnp.asarray(k), jnp.asarray(v), block_rows=block_rows,
        n_buckets=n_buckets, cap_factor=2.0, interpret=True,
    )]
    got = [x.numpy() for x in tsort.sort_pairs_full(
        *_t(k, v), block_rows=block_rows, n_buckets=n_buckets,
        cap_factor=2.0,
    )]
    # keys, validity, fills and overflow are exact; values only within
    # equal keys (the JAX bucket sort is unstable)
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    gk, gv = _canonical(got[0], got[1], got[2])
    wk, wv = _canonical(want[0], want[1], want[2])
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_pairs_full_checked_raises_on_overflow():
    block_rows = 4
    n = 8 * block_rows * 128
    k = np.full(n, 42, np.int32)
    k[::2] = np.arange(n // 2, dtype=np.int32)
    with pytest.raises(tsort.BucketOverflowError):
        tsort.sort_pairs_full_checked(
            *_t(k, k), block_rows=block_rows, n_buckets=4, cap_factor=1.0,
        )


_SIZES = [1, 1000, jscan._BLOCK + 1]


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("kind", ["fill", "add", "min", "max"])
def test_scan_flagged_vs_pallas(kind, n):
    rng = np.random.default_rng(n + len(kind))
    flag = rng.random(n) < 0.01
    a = rng.integers(-(1 << 30), 1 << 30, n, dtype=np.int32)
    b = rng.integers(-(1 << 30), 1 << 30, n, dtype=np.int32)
    wf, (wa, wb) = jscan.scan_flagged(
        kind, jnp.asarray(flag), (jnp.asarray(a), jnp.asarray(b)),
        interpret=True,
    )
    gf, (ga, gb) = tscan.scan_flagged(kind, *_t(flag), _t(a, b))
    wf = np.asarray(wf)
    np.testing.assert_array_equal(gf.numpy(), wf)
    m = wf if kind == "fill" else np.ones(n, bool)
    np.testing.assert_array_equal(ga.numpy()[m], np.asarray(wa)[m])
    np.testing.assert_array_equal(gb.numpy()[m], np.asarray(wb)[m])


@pytest.mark.parametrize("kind", ["fill", "add", "min", "max"])
def test_segment_scans_vs_log_step_references(kind):
    n = 3000
    rng = np.random.default_rng(11)
    flag = rng.random(n) < 0.02
    x = rng.integers(-1000, 1000, n, dtype=np.int32)
    if kind == "fill":
        wf, (want,) = _ff_run_carry(jnp.asarray(flag), (jnp.asarray(x),))
        m = np.asarray(wf)
    else:
        op = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[kind]
        ident = {"add": 0, "min": I32.max, "max": I32.min}[kind]
        want = segmented_scan(jnp.asarray(x), jnp.asarray(flag), op, ident)
        m = np.ones(n, bool)
    if kind == "fill":
        gf, (got,) = tseg._ff_run_carry(*_t(flag), _t(x))
        np.testing.assert_array_equal(gf.numpy(), m)
    else:
        got = tseg.segmented_scan(*_t(x, flag), kind)
    np.testing.assert_array_equal(got.numpy()[m], np.asarray(want)[m])


@pytest.mark.parametrize(
    "kind,dtype",
    [("add", np.uint32), ("max", np.uint32), ("add", np.float32),
     ("min", np.float32)],
)
def test_scan_flagged_other_dtypes_vs_pallas(kind, dtype):
    n = 2000
    rng = np.random.default_rng(5)
    flag = rng.random(n) < 0.01
    if dtype == np.uint32:
        x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    else:
        x = rng.standard_normal(n).astype(np.float32)
    _wf, (want,) = jscan.scan_flagged(
        kind, jnp.asarray(flag), (jnp.asarray(x),), interpret=True
    )
    _gf, (got,) = tscan.scan_flagged(kind, *_t(flag), _t(x))
    assert got.dtype == torch.from_numpy(x).dtype
    if dtype == np.float32 and kind == "add":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cumsum_wraps_like_jax():
    x = np.full(70000, 1 << 20, np.int32)
    got = tscan.cumsum_1d(*_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.cumsum(x)))


def test_scan_mixed_dtypes_match_per_column():
    n = 777
    rng = np.random.default_rng(8)
    flag = rng.random(n) < 0.05
    a = rng.integers(-5, 5, n).astype(np.int64)
    b = rng.integers(-5, 5, n).astype(np.int32)
    gf, (ga, gb) = tscan.scan_flagged("add", *_t(flag), _t(a, b))
    _f, (ga1,) = tscan.scan_flagged("add", *_t(flag), _t(a))
    _f, (gb1,) = tscan.scan_flagged("add", *_t(flag), _t(b))
    assert ga.dtype == torch.int64 and gb.dtype == torch.int32
    assert torch.equal(ga, ga1) and torch.equal(gb, gb1)


@pytest.mark.parametrize(
    "kind,cols,flag_dtype",
    [("sum", 1, torch.bool), ("add", 0, torch.bool), ("add", 4, torch.bool),
     ("add", 1, torch.int32)],
)
def test_scan_rejects_unsupported(kind, cols, flag_dtype):
    flag = torch.zeros(10, dtype=flag_dtype)
    with pytest.raises(ValueError):
        tscan.scan_flagged(kind, flag, [torch.zeros(10, dtype=torch.int32)]
                           * cols)


def test_launch_counters_untouched_on_cpu():
    _build.reset_launch_counts()
    k = np.arange(512, dtype=np.int32)
    tsort.sort_pairs_blocks(*_t(k, k), block_rows=4)
    tscan.cumsum_1d(*_t(k))
    x = torch.zeros(64, 64)
    tattn.block_attention(x, x, x)
    assert _build.launch_counts() == {
        "flagged_scan": 0, "bitonic_block_sort": 0, "block_attention": 0,
    }


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("val_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", ["key_invalid", "key_value",
                                   "key_invalid_value"])
def test_sort_perms_match_np_lexsort(shape, key_dtype, val_dtype):
    rng = np.random.default_rng(11)
    n = 3000
    k = rng.integers(-4, 4, n).astype(key_dtype)
    k[:40] = np.iinfo(key_dtype).max
    k[40:80] = np.iinfo(key_dtype).min
    v = rng.integers(-3, 3, n).astype(val_dtype)
    v[:30] = np.iinfo(val_dtype).min
    v[30:60] = np.iinfo(val_dtype).max
    inv = (rng.random(n) < 0.3).astype(np.int32)
    if shape == "key_invalid":
        got = tlex.perm_by_key_invalid(*_t(k, inv))
        want = np.lexsort((inv, k))
    elif shape == "key_value":
        got = tlex.perm_by_key_value(*_t(k, v))
        want = np.lexsort((v, k))
    else:
        got = tlex.perm_by_key_invalid_value(*_t(k, inv, v))
        want = np.lexsort((v, inv, k))
    # both orders are stable, so the permutations are identical
    np.testing.assert_array_equal(got.numpy(), want)
