"""The port's one-GPU slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX models on a
one-device mesh (``make_mesh(1)``; D must be 1 on both sides) and
through ``sparkrdma_tpu_torch`` with ``device="cpu"``.  Integer paths
are bit-exact: the reductions at run-end positions, sorted keys,
counts and dicts.  Values and payload rows are compared within equal
keys canonically, because the JAX sorts are ``is_stable=False``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkrdma_tpu.models import TeraSorter as JTeraSorter
from sparkrdma_tpu.models import WordCounter as JWordCounter
from sparkrdma_tpu.models import aggregate as jagg
from sparkrdma_tpu.models import external_sort as jext
from sparkrdma_tpu.models.aggregate import KeyedAggregator as JAggregator
from sparkrdma_tpu.models.topk import GroupedTopK as JGroupedTopK
from sparkrdma_tpu.models._base import quantize_padded_length as jquant
from sparkrdma_tpu.ops import segment as jseg
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu_torch import (
    ExternalTeraSorter,
    GroupedTopK,
    KeyedAggregator,
    TeraSorter,
    WordCounter,
)
from sparkrdma_tpu_torch import interop
from sparkrdma_tpu_torch.models._base import quantize_padded_length
from sparkrdma_tpu_torch.ops import segment as tseg
from sparkrdma_tpu_torch.parallel import select_devices

CPU = "cpu"
I32 = np.iinfo(np.int32)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def _data(n, seed, n_keys=50, extreme=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(-n_keys, n_keys, n, dtype=np.int32)
    if extreme and n >= 4:
        k[:2] = I32.max  # real keys equal to the padding sentinel
        k[2] = I32.min
    v = rng.integers(-1000, 1000, n, dtype=np.int32)
    return k, v


def _valid(n, seed):
    """Validity with the invalid slots pre-masked per the contract."""
    return (np.random.default_rng(seed).random(n) < 0.8).astype(np.int32)


def _mask(k, v, m):
    return np.where(m > 0, k, I32.max), np.where(m > 0, v, 0)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n", [1, 300, 4099])
def test_reduce_by_key_local_bit_exact(n, with_valid):
    k, v = _data(n, n)
    m = _valid(n, n + 1) if with_valid else None
    if with_valid:
        k, v = _mask(k, v, m)
    want = jseg.reduce_by_key_local(
        jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
    )
    got = tseg.reduce_by_key_local(
        *interop.to_torch(k, v, m, device=CPU)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n", [1, 300, 4099])
def test_aggregate_by_key_local_bit_exact(n, with_valid):
    k, v = _data(n, 2 * n)
    m = _valid(n, n + 2) if with_valid else None
    if with_valid:
        k, v = _mask(k, v, m)
    want = jseg.aggregate_by_key_local(
        jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
    )
    got = tseg.aggregate_by_key_local(
        *interop.to_torch(k, v, m, device=CPU)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sums_wrap_in_value_dtype():
    k = np.zeros(4, np.int32)
    v = np.full(4, I32.max, np.int32)
    _u, sums, _c, _n = tseg.reduce_by_key_local(
        *interop.to_torch(k, v, device=CPU), None
    )
    want = np.asarray(jseg.reduce_by_key_local(
        jnp.asarray(k), jnp.asarray(v), None)[1])
    np.testing.assert_array_equal(sums.numpy(), want)
    assert sums.dtype == torch.int32


def _canon_pairs(k, v):
    order = np.lexsort((v, k))
    return k[order], v[order]


@pytest.mark.parametrize("n", [1, 1000, 1027, 5000])
def test_terasort_sort_matches_jax(mesh1, n):
    k, v = _data(n, n, n_keys=1 << 20)
    wk, wv = JTeraSorter(mesh1).sort(k, v)
    gk, gv = TeraSorter(device=CPU).sort(k, v)
    np.testing.assert_array_equal(gk, np.asarray(wk))
    for g, w in zip(_canon_pairs(gk, gv), _canon_pairs(np.asarray(wk),
                                                         np.asarray(wv))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_valid", [False, True])
def test_terasort_sort_device_matches_jax(mesh1, with_valid):
    n = 2048
    k, v = _data(n, 7, n_keys=100)
    m = _valid(n, 8) if with_valid else None
    (wk, wv, wn, wf), wcap = JTeraSorter(mesh1).sort_device(
        jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
    )
    (gk, gv, gn, gf), gcap = TeraSorter(device=CPU).sort_device(
        *interop.to_torch(k, v, m, device=CPU)
    )
    assert gcap == wcap
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    nv = int(gn[0])
    for g, w in zip(_canon_pairs(gk.numpy()[:nv], gv.numpy()[:nv]),
                    _canon_pairs(np.asarray(wk)[:nv], np.asarray(wv)[:nv])):
        np.testing.assert_array_equal(g, w)


def _canon_rows(k, p):
    order = np.lexsort(tuple(p[:, j] for j in reversed(range(p.shape[1])))
                       + (k,))
    return k[order], p[order]


@pytest.mark.parametrize("capacity", [None, 1024])
def test_terasort_sort_device_wide_matches_jax(mesh1, capacity):
    n, W = 1024, 5
    rng = np.random.default_rng(3)
    k = rng.integers(0, 64, n, dtype=np.int32)
    p = rng.integers(I32.min, I32.max, (n, W), dtype=np.int32)
    (wk, wp, wn, wf), wcap = JTeraSorter(mesh1).sort_device_wide(
        jnp.asarray(k), jnp.asarray(p), capacity=capacity
    )
    (gk, gp, gn, gf), gcap = TeraSorter(device=CPU).sort_device_wide(
        *interop.to_torch(k, p, device=CPU), capacity=capacity
    )
    assert gcap == wcap and gp.shape == tuple(np.asarray(wp).shape)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    nv = int(gn[0])
    for g, w in zip(_canon_rows(gk.numpy()[:nv], gp.numpy()[:nv]),
                    _canon_rows(np.asarray(wk)[:nv], np.asarray(wp)[:nv])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 500, 1024, 3001])
def test_wordcount_matches_jax(mesh1, n):
    k, v = _data(n, 40 + n)
    assert WordCounter(device=CPU).count(k, v) == \
        JWordCounter(mesh1).count(k, v)
    assert WordCounter(device=CPU).count(k) == JWordCounter(mesh1).count(k)


@pytest.mark.parametrize("with_valid", [False, True])
def test_wordcount_count_device_matches_jax(mesh1, with_valid):
    n = 1500
    k, v = _data(n, 9)
    m = _valid(n, 10) if with_valid else None
    (want, wcap) = JWordCounter(mesh1).count_device(
        jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
    )
    (got, gcap) = WordCounter(device=CPU).count_device(
        *interop.to_torch(k, v, m, device=CPU)
    )
    assert gcap == wcap
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))


@pytest.mark.parametrize("n", [1, 500, 1024, 3001])
def test_aggregate_matches_jax(mesh1, n):
    k, v = _data(n, 70 + n)
    got = KeyedAggregator(device=CPU).aggregate(k, v)
    want = JAggregator(mesh1).aggregate(k, v)
    assert got == {key: tuple(s) for key, s in want.items()}
    if got:
        key = next(iter(got))
        assert got[key].mean == want[key].mean


def test_aggregate_device_matches_plain_step():
    k, v = _data(999, 5)
    (got, cap) = KeyedAggregator(device=CPU).aggregate_device(
        *interop.to_torch(k, v, device=CPU)
    )
    want = tseg.aggregate_by_key_local(
        *interop.to_torch(k, v, device=CPU), None
    )
    assert cap >= 999 and int(got[-1][0]) == 0
    for g, w in zip(got[:6], want):
        assert torch.equal(g.reshape(-1), w.reshape(-1))


def test_int64_keys_and_values_are_kept():
    k = np.array([1 << 40, 3, 1 << 40, -(1 << 50)], np.int64)
    v = np.array([1 << 35, 1, 2, 5], np.int64)
    assert WordCounter(device=CPU).count(k, v) == {
        1 << 40: (1 << 35) + 2, 3: 1, -(1 << 50): 5,
    }
    sk, sv = TeraSorter(device=CPU).sort(k, v)
    np.testing.assert_array_equal(sk, np.sort(k))
    stats = KeyedAggregator(device=CPU).aggregate(k, v)
    assert stats[1 << 40] == ((1 << 35) + 2, 2, 2, 1 << 35)


# -- the dtypes the JAX package takes (uint32 and int16 keys, float32
# values, uint32 and int16 top-k values): integers bit for bit, float
# sums within F32_SUM_ATOL, in the caller's dtype

U32 = np.iinfo(np.uint32)
F32_SUM_ATOL = 0.1  # float32 prefix-sum differences, as in test_torch_exchange


def _dtype_keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint32":
        pool = rng.integers(0, U32.max, 61, endpoint=True).astype(np.uint32)
        pool[:3] = [U32.max, 0, 1 << 31]
        return pool[rng.integers(0, 61, n)]
    k = rng.integers(-100, 100, n).astype(np.int16)
    k[:3] = [32767, -32768, -1]
    return k


@pytest.mark.parametrize("n", [5, 1000, 4099])
@pytest.mark.parametrize("dtype", ["uint32", "int16"])
def test_terasort_dtypes_match_jax(mesh1, dtype, n):
    k = _dtype_keys(dtype, n, n)
    v = np.random.default_rng(n).integers(-500, 500, n).astype(k.dtype)
    wk, wv = JTeraSorter(mesh1).sort(k, v)
    gk, gv = TeraSorter(device=CPU).sort(k, v)
    assert gk.dtype == k.dtype and gv.dtype == v.dtype
    np.testing.assert_array_equal(gk, np.asarray(wk))
    for g, w in zip(_canon_pairs(gk, gv), _canon_pairs(np.asarray(wk),
                                                         np.asarray(wv))):
        np.testing.assert_array_equal(g, w)


def test_terasort_float32_values_match_jax(mesh1):
    k, _v = _data(3001, 4)
    v = np.random.default_rng(5).standard_normal(3001).astype(np.float32)
    wk, wv = JTeraSorter(mesh1).sort(k, v)
    gk, gv = TeraSorter(device=CPU).sort(k, v)
    assert gv.dtype == np.float32
    np.testing.assert_array_equal(gk, np.asarray(wk))
    for g, w in zip(_canon_pairs(gk, gv), _canon_pairs(np.asarray(wk),
                                                         np.asarray(wv))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["uint32", "int16"])
def test_sort_device_dtypes_match_jax(mesh1, dtype):
    """The padded run keeps the caller's dtype and its max as the
    sentinel."""
    n = 2048
    k = _dtype_keys(dtype, n, 11)
    v = np.arange(n).astype(k.dtype)
    m = _valid(n, 12)
    (wk, wv, wn, wf), wcap = JTeraSorter(mesh1).sort_device(
        *map(jnp.asarray, (k, v, m)), capacity=n + 64)
    (gk, gv, gn, gf), gcap = TeraSorter(device=CPU).sort_device(
        *interop.to_torch(k, v, m, device=CPU), capacity=n + 64)
    assert gk.dtype == getattr(torch, dtype) and gv.dtype == gk.dtype
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    assert int(gn[0]) == int(wn[0]) and int(gf[0]) == int(wf[0])
    nv = int(gn[0])
    for g, w in zip(_canon_pairs(gk.numpy()[:nv], gv.numpy()[:nv]),
                    _canon_pairs(np.asarray(wk)[:nv], np.asarray(wv)[:nv])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["uint32", "int16"])
def test_keyed_dtypes_match_jax(mesh1, dtype):
    """WordCount (default and given values) and aggregate; uint32 and
    int16 values wrap in their dtype as JAX's do."""
    k = _dtype_keys(dtype, 3001, 21)
    v = np.random.default_rng(22).integers(-30000, 30000, 3001).astype(
        k.dtype)
    assert WordCounter(device=CPU).count(k) == JWordCounter(mesh1).count(k)
    assert WordCounter(device=CPU).count(k, v) == \
        JWordCounter(mesh1).count(k, v)
    got = KeyedAggregator(device=CPU).aggregate(k, v)
    want = JAggregator(mesh1).aggregate(k, v)
    assert got == {key: tuple(s) for key, s in want.items()}


def test_int16_sums_wrap_like_jax(mesh1):
    k = np.zeros(20, np.int16)
    v = np.full(20, 30000, np.int16)
    assert WordCounter(device=CPU).count(k, v) == \
        JWordCounter(mesh1).count(k, v) == {0: 20 * 30000 - 9 * 65536}


@pytest.mark.parametrize("dtype", ["uint32", "int16"])
@pytest.mark.parametrize("model", ["count", "aggregate"])
def test_keyed_device_dtypes_match_jax(mesh1, dtype, model):
    """count_device / aggregate_device in the caller's dtypes.  uint32
    keys ride in unsigned order, so every slot matches, the uint32-max
    sentinels included.  int16 keys widen: the padding's int32 sentinel
    ends the run of a real int16-max key before it, where JAX's one run
    holds both, so there the run-end rows match as a set."""
    n = 1500
    k = _dtype_keys(dtype, n, 31)
    v = np.random.default_rng(32).integers(-900, 900, n).astype(k.dtype)
    m = _valid(n, 33)
    if model == "count":
        got, cap = WordCounter(device=CPU).count_device(
            *interop.to_torch(k, v, m, device=CPU))
        want, wcap = JWordCounter(mesh1).count_device(
            *map(jnp.asarray, (k, v, m)))
        assert cap == wcap
    else:
        got, cap = KeyedAggregator(device=CPU).aggregate_device(
            *interop.to_torch(k, v, m, device=CPU))
        want = jagg.make_aggregate_step(mesh1, n, cap)(
            *map(jnp.asarray, (k, v, m)))
    got = [g.numpy() for g in got]
    want = [np.asarray(w).reshape(-1) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(got[-2:], want[-2:])  # n_unique, fill
    rows = got[:-2]
    if dtype == "uint32":
        np.testing.assert_array_equal(rows, want[:-2])
    real = [r[rows[2] > 0] for r in rows]
    wreal = [r[want[2] > 0] for r in want[:-2]]
    assert sorted(zip(*(r.tolist() for r in real))) == \
        sorted(zip(*(r.tolist() for r in wreal)))


def test_keyed_float32_values_match_jax(mesh1):
    """The JAX drivers hand float sums back truncated to int; the port
    keeps them float32, within F32_SUM_ATOL of a float64 sum and 1 +
    F32_SUM_ATOL of the JAX integer; min and max exact."""
    rng = np.random.default_rng(41)
    k = rng.integers(-60, 60, 3000).astype(np.int32)
    v = (rng.standard_normal(3000) * 100).astype(np.float32)
    u, inv = np.unique(k, return_inverse=True)
    exact = dict(zip(u.tolist(), np.bincount(
        inv, weights=v.astype(np.float64)).tolist()))
    got = WordCounter(device=CPU).count(k, v)
    want = JWordCounter(mesh1).count(k, v)
    stats = KeyedAggregator(device=CPU).aggregate(k, v)
    wstats = JAggregator(mesh1).aggregate(k, v)
    assert set(got) == set(want) == set(exact) == set(stats)
    for key, s in got.items():
        st = stats[key]
        assert isinstance(s, float) and isinstance(st.sum, float)
        for total in (s, st.sum):
            assert abs(total - exact[key]) <= F32_SUM_ATOL
            assert abs(total - want[key]) <= 1 + F32_SUM_ATOL
        sel = v[k == key]
        assert (st.count, st.min, st.max) == (sel.size, float(sel.min()),
                                              float(sel.max()))
        assert (st.count, int(st.min), int(st.max)) == tuple(wstats[key])[1:]


@pytest.mark.parametrize("dtype", ["uint32", "int16"])
@pytest.mark.parametrize("k", [1, 4, 300])
def test_topk_value_dtypes_match_jax(mesh1, dtype, k):
    rng = np.random.default_rng(51)
    keys = rng.integers(0, 30, 2000).astype(np.int32)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, 2000, endpoint=True).astype(dtype)
    vals[:2] = [info.max, info.min]
    assert GroupedTopK(device=CPU).top_k(keys, vals, k) == \
        JGroupedTopK(mesh1).top_k(keys, vals, k)


def test_external_sort_uint32_keys_match_jax(mesh1, tmp_path):
    rng = np.random.default_rng(61)
    keys = rng.integers(0, U32.max, 4096, endpoint=True).astype(np.uint32)
    keys[:2] = [U32.max, 0]
    vals = np.arange(4096, dtype=np.int32)
    wk, wv = jext.ExternalTeraSorter(mesh1, spill_dir=str(tmp_path)).sort(
        keys, vals)
    gk, gv = ExternalTeraSorter(CPU, spill_dir=str(tmp_path)).sort(keys, vals)
    assert gk.dtype == np.uint32
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gk, np.sort(keys))
    for g, w in zip(_canon_pairs(gk, gv), _canon_pairs(np.asarray(wk),
                                                         np.asarray(wv))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 1000, 4097, (1 << 20) + 3])
def test_quantize_padded_length_matches_jax(n):
    assert quantize_padded_length(n, 1) == jquant(n, 1)
    assert quantize_padded_length(n, 8) == jquant(n, 8)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TeraSorter, WordCounter, KeyedAggregator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
    with pytest.raises(RuntimeError):
        interop.to_torch(np.zeros(3, np.int32))


@pytest.mark.parametrize("kw", [dict(n_devices=2), dict(n_devices=8)])
def test_multi_device_not_ported(kw):
    """More than one device takes a group: one process per GPU, each
    rank building the model with ``group=`` (tests/test_torch_exchange.py
    runs them)."""
    with pytest.raises(ValueError, match="one process per GPU.*group="):
        TeraSorter(device=CPU, **kw)


@pytest.mark.parametrize(
    "kw,err",
    [(dict(device_list=[0, 5]), ValueError),
     (dict(n_devices=1, device_list=[0, 1]), ValueError),
     (dict(device_list=[5]), ValueError),
     (dict(device_list=[-1]), ValueError)],
)
def test_select_devices_refuses_what_it_cannot_give(monkeypatch, kw, err):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(err):
        select_devices(device="cuda:0", **kw)


def test_select_devices_takes_one_ordinal(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert select_devices(device="cuda:0", device_list=[1]) == [
        torch.device("cuda", 1)]


def test_interop_round_trip():
    rng = np.random.default_rng(1)
    cols = (rng.integers(0, 9, 5).astype(np.int32),
            rng.integers(0, 9, 5).astype(np.int64),
            rng.random(5) < 0.5, rng.random((5, 3)).astype(np.float32))
    back = interop.to_numpy(*interop.to_torch(*cols, device=CPU))
    for a, b in zip(cols, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_import_loads_neither_jax_nor_reference():
    """Every module of the port, found by walking the package, imports
    without loading ``jax`` or ``sparkrdma_tpu``."""
    code = (
        "import importlib, pkgutil, sys, sparkrdma_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sparkrdma_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 80 and 'sparkrdma_tpu_torch.api' in mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'sparkrdma_tpu' "
        "or m.startswith('sparkrdma_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
