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

import jax
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
from sparkrdma_tpu_torch.ops import merge_kernel as tmerge
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
@pytest.mark.parametrize("block_rows", [1, 2, 4, 8, 16])
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


# The schedule of csrc/bitonic_block_sort.cu, emulated in numpy.  Each
# launch holds CTAs of 2^log_tile pairs in swizzled shared memory and
# 2^log_regs registers per thread; runs of steps gather registers
# through the kernel's layouts (index permutations), compare-exchanges
# pair registers only, the cluster exchange gathers one local position
# of every tile of the cluster, and distances beyond the cluster run as
# global passes.  The kernel's constants are (5, 13, 4): 32 registers,
# 8192 pairs per CTA, clusters of up to 16.
KERNEL_CONSTANTS = (5, 13, 4)
SCALED_CONSTANTS = (2, 5, 2)  # 4 registers, 8 threads, clusters of 4


def _swz(x, log_regs):
    return x ^ ((x >> log_regs) & ((1 << (log_regs - 1)) - 1))


def _run_base(t, lo, log_regs):
    return ((t >> lo) << (lo + log_regs)) | (t & ((1 << lo) - 1))


def _reg_cmpex(rk, rv, a, b, up):
    """The kernel's cmpex on register columns a (lower index) and b."""
    ka, kb, va, vb = rk[..., a], rk[..., b], rv[..., a], rv[..., b]
    sw = (ka > kb) == up
    rk[..., a], rk[..., b] = np.where(sw, kb, ka), np.where(sw, ka, kb)
    rv[..., a], rv[..., b] = np.where(sw, vb, va), np.where(sw, va, vb)


def _is_permutation(idx, size):
    flat = np.asarray(idx).reshape(-1)
    return flat.size == size and np.unique(flat).size == size


def _emulate_launch(gk, gv, consts, log_tile, log_c, stage_first,
                    stage_last, log_b, kinds):
    lr = consts[0]
    R, T = 1 << lr, 1 << log_tile
    nthr = T >> lr
    n_cta = gk.size // T
    t = np.arange(nthr)
    cta = np.arange(n_cta)
    tile_base = (cta << log_tile)[:, None]
    # global -> shared: thread t copies x = i * threads + t
    x = (np.arange(R)[:, None] * nthr + t).reshape(-1)
    assert _is_permutation(_swz(x, lr), T)
    sk = np.empty((n_cta, T), gk.dtype)
    sv = np.empty((n_cta, T), gv.dtype)
    sk[:, _swz(x, lr)] = gk.reshape(n_cta, T)[:, x]
    sv[:, _swz(x, lr)] = gv.reshape(n_cta, T)[:, x]

    def run(lo, steps):
        base = _run_base(t, lo, lr)
        p = _swz(base[:, None] | (np.arange(R) << lo), lr)  # [thread, reg]
        assert _is_permutation(p, T)
        rk, rv = sk[:, p], sv[:, p]
        steps(rk, rv, base)
        sk[:, p], sv[:, p] = rk, rv
        kinds["transpose"] += 1

    stage = stage_first
    if stage_first == 1:  # stages 1..log_regs, x = t * R + r
        def first(rk, rv, _base):
            for s in range(1, lr + 1):
                for j in range(s - 1, -1, -1):
                    for r in range(R):
                        if not r & (1 << j):
                            up = ((r >> s) & 1) == 0 if s < lr \
                                else (t & 1) == 0
                            _reg_cmpex(rk, rv, r, r | (1 << j), up)
                            kinds["register"] += 1
        run(0, first)
        stage = lr + 1
    span = log_tile + log_c
    C = 1 << log_c
    P, per = R // C, T >> log_c
    q = cta % C
    for stage in range(stage, stage_last + 1):
        top = min(stage - 1, span - 1)
        if log_c and top >= log_tile:
            xc = q[:, None, None] * per + np.arange(P)[:, None] * nthr + t
            pos = np.broadcast_to(_swz(xc, lr).transpose(0, 2, 1)[..., None],
                                  (n_cta, nthr, P, C))
            src = np.broadcast_to((cta - q)[:, None, None, None]
                                  + np.arange(C), (n_cta, nthr, P, C))
            assert _is_permutation(src * T + pos, n_cta * T)
            rk = sk[src, pos].reshape(n_cta, nthr, R)
            rv = sv[src, pos].reshape(n_cta, nthr, R)
            up = (stage == log_b) | (
                ((((cta - q)[:, None] + np.arange(C)) << log_tile)
                 >> stage) & 1 == 0)                          # [cta, C]
            for jc in range(log_c - 1, -1, -1):
                if jc <= top - log_tile:
                    for p in range(P):
                        for c in range(C):
                            if not c & (1 << jc):
                                _reg_cmpex(rk, rv, p * C + c,
                                           p * C + c + (1 << jc),
                                           up[:, c][:, None])
                    kinds["cluster"] += 1
            sk[src, pos] = rk.reshape(n_cta, nthr, P, C)
            sv[src, pos] = rv.reshape(n_cta, nthr, P, C)
        hi = min(top, log_tile - 1)
        while hi >= 0:
            lo = max(0, hi - (lr - 1))
            assert stage > lo + lr - 1  # the direction is one per thread

            def steps(rk, rv, base, lo=lo, hi=hi, stage=stage):
                up = (stage == log_b) | ((((tile_base | base) >> stage)
                                          & 1) == 0)
                for jb in range(hi - lo, -1, -1):
                    for r in range(R):
                        if not r & (1 << jb):
                            _reg_cmpex(rk, rv, r, r | (1 << jb), up)
                    kinds["register"] += 1
            run(lo, steps)
            hi -= lr
    gk.reshape(n_cta, T)[:, x] = sk[:, _swz(x, lr)]
    gv.reshape(n_cta, T)[:, x] = sv[:, _swz(x, lr)]


def _emulate_global_pass(gk, gv, stage, j, log_b, kinds):
    p = np.arange(gk.size // 2)  # four neighbours per thread in the kernel
    lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1))
    hi = lo + (1 << j)
    up = (stage == log_b) | (((lo >> stage) & 1) == 0)
    ka, kb, va, vb = gk[lo], gk[hi], gv[lo], gv[hi]
    sw = (ka > kb) == up
    gk[lo], gk[hi] = np.where(sw, kb, ka), np.where(sw, ka, kb)
    gv[lo], gv[hi] = np.where(sw, vb, va), np.where(sw, va, vb)
    kinds["global"] += 1


def _emulate_block_sort(keys, vals, block_rows, consts):
    """sr_bitonic_block_sort's launches on the CPU; returns the sorted
    keys and values and how many steps of each kind ran."""
    lr, max_tile, max_c = consts
    log_b = (block_rows * 128).bit_length() - 1
    log_tile = min(log_b, max_tile)
    log_c = min(log_b - log_tile, max_c)
    span = log_tile + log_c
    kinds = dict.fromkeys(("register", "transpose", "cluster", "global"), 0)
    gk, gv = keys.copy(), vals.copy()
    _emulate_launch(gk, gv, consts, log_tile, log_c, 1, min(log_b, span),
                    log_b, kinds)
    for stage in range(span + 1, log_b + 1):
        for j in range(stage - 1, span - 1, -1):
            _emulate_global_pass(gk, gv, stage, j, log_b, kinds)
        _emulate_launch(gk, gv, consts, log_tile, log_c, stage, stage,
                        log_b, kinds)
    return gk, gv, kinds


@pytest.mark.parametrize(
    "pattern", ["random", "dups_extremes", "reversed", "equal"]
)
@pytest.mark.parametrize(
    "consts,block_rows",
    [(SCALED_CONSTANTS, 4), (SCALED_CONSTANTS, 16), (KERNEL_CONSTANTS, 1),
     (KERNEL_CONSTANTS, 16)],
)
def test_kernel_schedule_bit_exact_vs_plain_and_pallas(consts, block_rows,
                                                       pattern):
    """The kernel's schedule reaches every kind of step at the scaled
    constants (register steps, shared-memory transposes, the cluster
    exchange, global passes beyond the cluster) and gives the network's
    bits, values included."""
    rng = np.random.default_rng(block_rows * 7 + len(pattern))
    n = 2 * block_rows * 128
    k = _keys(pattern, n, rng)
    v = rng.integers(I32.min, I32.max, n, dtype=np.int32)
    got_k, got_v, kinds = _emulate_block_sort(k, v, block_rows, consts)
    want_k, want_v = jsort.sort_pairs_blocks(
        jnp.asarray(k), jnp.asarray(v), block_rows=block_rows,
        interpret=True,
    )
    plain_k, plain_v = tsort.block_sort_plain(*_t(k, v), block_rows)
    np.testing.assert_array_equal(got_k, np.asarray(want_k))
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_array_equal(got_k, plain_k.numpy())
    np.testing.assert_array_equal(got_v, plain_v.numpy())
    if consts == SCALED_CONSTANTS:
        assert all(kinds.values()), kinds
    else:  # one CTA: no cluster, no global pass
        assert kinds["cluster"] == kinds["global"] == 0


@pytest.mark.parametrize("block_rows", [512, 1024, 2048])
def test_kernel_schedule_at_kernel_constants_vs_plain(block_rows):
    """The main path's shapes at the kernel's own constants: a cluster
    of 8 (block_rows 512), of 16 (1024), and of 16 plus global passes
    (2048); bit for bit with the plain version."""
    rng = np.random.default_rng(block_rows)
    n = block_rows * 128
    k = _keys("dups_extremes", n, rng)
    v = rng.integers(I32.min, I32.max, n, dtype=np.int32)
    got_k, got_v, kinds = _emulate_block_sort(k, v, block_rows,
                                              KERNEL_CONSTANTS)
    want_k, want_v = tsort.block_sort_plain(*_t(k, v), block_rows)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())
    assert kinds["cluster"] > 0
    assert (kinds["global"] > 0) == (block_rows > 1024)


def _banks_distinct(x, log_regs=KERNEL_CONSTANTS[0]):
    """Every warp's 8-byte (key, value) shared-memory accesses (x:
    [threads], one access per thread), served per half warp, fall in
    distinct pairs of banks: 16 distinct words modulo 16."""
    b = _swz(np.asarray(x), log_regs).reshape(-1, 16) % 16
    return all(np.unique(row).size == 16 for row in b)


@pytest.mark.parametrize("lo", list(range(9)))
def test_kernel_runs_are_free_of_bank_conflicts(lo):
    lr, log_tile, _ = KERNEL_CONSTANTS
    t = np.arange(1 << (log_tile - lr))
    base = _run_base(t, lo, lr)
    for r in range(1 << lr):
        assert _banks_distinct(base | (r << lo))


@pytest.mark.parametrize("log_c", [1, 2, 3, 4])
def test_kernel_cluster_exchange_and_copies_are_free_of_bank_conflicts(
        log_c):
    lr, log_tile, _ = KERNEL_CONSTANTS
    nthr = 1 << (log_tile - lr)
    t = np.arange(nthr)
    per = (1 << log_tile) >> log_c
    for q in range(1 << log_c):
        for p in range((1 << lr) >> log_c):
            assert _banks_distinct(q * per + p * nthr + t)
    for i in range(1 << lr):
        assert _banks_distinct(i * nthr + t)


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
    tmerge.merge_runs(*_t(k.reshape(4, 128), np.full(4, 100, np.int32)))
    assert _build.launch_counts() == {
        "flagged_scan": 0, "bitonic_block_sort": 0, "block_attention": 0,
        "merge_runs": 0,
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


_U32 = (1 << 32) - 1


def _lb_tile(dtype):
    return tscan.tile_elems(1, dtype == "int32")


def _lb_flags(pattern, n, t, rng):
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "all":
        return np.ones(n, bool)
    f = np.zeros(n, bool)
    if pattern == "tile_starts":
        f[::t] = True
    elif pattern == "tile_ends":
        f[t - 1::t] = True
    else:  # random at 1e-3
        f = rng.random(n) < 1e-3
    return f


def _lb_values(dtype, n, rng):
    if dtype == "int32":
        return rng.integers(I32.min, I32.max, n, dtype=np.int32,
                            endpoint=True)
    if dtype == "int64":
        return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    if dtype == "uint32":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return rng.standard_normal(n).astype(np.float32)


def _look_back_composed(kind, flag, x, t):
    """The kernel's order of composition: each tile of ``t`` elements
    scanned alone, its exclusive prefix the fold of its predecessors'
    aggregates taken nearest first with the earlier operand always on
    the left (the look-back), then folded in as the earlier operand of
    every position of the tile.  uint32 computes in int64 and wraps."""
    u32 = x.dtype == torch.uint32
    n = flag.shape[0]
    scans = [tscan.scan_flagged_plain(kind, flag[i:i + t], [x[i:i + t]])
             for i in range(0, n, t)]
    if u32:
        scans = [(f, [c.to(torch.int64)]) for f, (c,) in scans]
    aggs = [(f[-1:], [c[-1:]]) for f, (c,) in scans]
    out_f, out_x = [scans[0][0]], [scans[0][1][0]]
    for i in range(1, len(scans)):
        pf, pxs = aggs[i - 1]
        for j in range(i - 2, -1, -1):  # further back = earlier operand
            pf, pxs = tscan._combine(kind, aggs[j][0], aggs[j][1], pf, pxs)
        if u32:
            pxs = [c & _U32 for c in pxs]
        f, xs = scans[i]
        f, (c,) = tscan._combine(kind, pf.expand(f.shape),
                                 [pxs[0].expand(xs[0].shape)], f, xs)
        out_f.append(f)
        out_x.append(c & _U32 if u32 else c)
    got = torch.cat(out_x)
    return torch.cat(out_f), got.to(torch.uint32) if u32 else got


@pytest.mark.parametrize(
    "flags", ["none", "all", "tile_starts", "tile_ends", "random"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "uint32", "float32"])
@pytest.mark.parametrize("kind", ["fill", "add", "min", "max"])
def test_look_back_order_matches_whole_scan_and_pallas(kind, dtype, flags):
    """Tile scans folded in the look-back's order equal the whole-array
    plain scan and JAX's scan_flagged (interpret mode): integers bit for
    bit, float32 ``add`` within the card tests' tolerance (sums taken in
    another order), ``fill`` under the returned flag."""
    rng = np.random.default_rng(len(kind) * 7 + len(dtype) + len(flags))
    t = _lb_tile(dtype)
    n = 3 * t + 123  # three whole tiles and a ragged one
    flag = _lb_flags(flags, n, t, rng)
    x = _lb_values(dtype, n, rng)
    tf, tx = _t(flag, x)
    got_f, got = _look_back_composed(kind, tf, tx, t)
    whole_f, (whole,) = tscan.scan_flagged_plain(kind, tf, [tx])
    with jax.enable_x64(dtype == "int64"):
        jf, (jx,) = jscan.scan_flagged(
            kind, jnp.asarray(flag), (jnp.asarray(x),), interpret=True)
        jf, jx = np.asarray(jf), np.asarray(jx)
    assert jx.dtype == x.dtype
    np.testing.assert_array_equal(got_f.numpy(), whole_f.numpy())
    np.testing.assert_array_equal(got_f.numpy(), jf)
    m = jf if kind == "fill" else np.ones(n, bool)
    for want in (whole.numpy(), jx):
        if dtype == "float32" and kind == "add":
            np.testing.assert_allclose(got.numpy()[m], want[m], rtol=1e-5,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(got.numpy()[m], want[m])
