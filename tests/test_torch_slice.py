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
from sparkrdma_tpu.models.aggregate import KeyedAggregator as JAggregator
from sparkrdma_tpu.models._base import quantize_padded_length as jquant
from sparkrdma_tpu.ops import segment as jseg
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu_torch import KeyedAggregator, TeraSorter, WordCounter
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TeraSorter(device=CPU, **kw)


@pytest.mark.parametrize(
    "kw,err",
    [(dict(device_list=[0, 5]), NotImplementedError),
     (dict(n_devices=1, device_list=[0, 1]), NotImplementedError),
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
    code = (
        "import sys, sparkrdma_tpu_torch, sparkrdma_tpu_torch.ops, "
        "sparkrdma_tpu_torch.models, sparkrdma_tpu_torch.interop, "
        "sparkrdma_tpu_torch.parallel.ring, "
        "sparkrdma_tpu_torch.ops.attention, "
        "sparkrdma_tpu_torch.ops.partition, "
        "sparkrdma_tpu_torch.memory.direct_io, "
        "sparkrdma_tpu_torch.models.join, "
        "sparkrdma_tpu_torch.models.join_aggregate, "
        "sparkrdma_tpu_torch.models.topk, "
        "sparkrdma_tpu_torch.models.external_sort, "
        "sparkrdma_tpu_torch.models.ring_attention\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'sparkrdma_tpu' "
        "or m.startswith('sparkrdma_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
