"""The port's SQL-exchange models against the JAX package, on the CPU.

Hash and broadcast joins (four variants), the fused broadcast join +
aggregate, grouped top-k, the external sort and ``ops/partition.py``.
The same numpy inputs, made from a seed, go through the JAX package on
a one-device mesh (``make_mesh(1)``) and through
``sparkrdma_tpu_torch`` with ``device="cpu"``.  Integer paths are
bit-exact; rows that the JAX package's unstable sorts leave in any
order are compared canonically (sorted rows, or within equal keys).
The JAX package carries transport words as uint32; the port carries the
same bits as int32, so step outputs compare through ``.view(np.uint32)``.
int64 paths, which the JAX package runs only under x64, are held
against numpy oracles.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkrdma_tpu.models import aggregate as jagg
from sparkrdma_tpu.models import external_sort as jext
from sparkrdma_tpu.models import join as jjoin
from sparkrdma_tpu.models import join_aggregate as jja
from sparkrdma_tpu.models import topk as jtopk
from sparkrdma_tpu.ops import partition as jpart
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu_torch import ExchangeGroup, interop
from sparkrdma_tpu_torch.models import aggregate as tagg
from sparkrdma_tpu_torch.models import external_sort as text
from sparkrdma_tpu_torch.models import join as tjoin
from sparkrdma_tpu_torch.models import join_aggregate as tja
from sparkrdma_tpu_torch.models import topk as ttopk
from sparkrdma_tpu_torch.ops import lexsort as tlex
from sparkrdma_tpu_torch.ops import partition as tpart

CPU = "cpu"
I32 = np.iinfo(np.int32)
JOINERS = {"hash": (jjoin.HashJoiner, tjoin.HashJoiner),
           "broadcast": (jjoin.BroadcastJoiner, tjoin.BroadcastJoiner)}


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def _join_case(seed, n_fact, n_dim, key_space):
    rng = np.random.default_rng(seed)
    dk = rng.choice(key_space, size=n_dim, replace=False).astype(np.int32)
    dv = rng.integers(0, 1 << 30, size=n_dim, dtype=np.int32)
    fk = rng.integers(0, key_space, size=n_fact, dtype=np.int32)
    fv = rng.integers(0, 1 << 30, size=n_fact, dtype=np.int32)
    return fk, fv, dk, dv


def _skew_case():
    rng = np.random.default_rng(9)
    fk = np.concatenate([np.full(7000, 42, np.int32),
                         rng.integers(0, 500, size=3000, dtype=np.int32)])
    dk = np.arange(500, dtype=np.int32)
    return fk, np.arange(10000, dtype=np.int32), dk, dk * 3


def _a(*xs):
    return tuple(np.asarray(x) for x in xs)


JOIN_CASES = {
    "random": lambda: _join_case(5, 4000, 300, 1000),
    "fuzz_tiny_dim": lambda: _join_case(401, 9, 1, 3),
    "fuzz_wide_dim": lambda: _join_case(402, 1000, 1999, 3 * 1999),
    "dtype_max_fact_key": lambda: _a(
        np.array([1, 2, I32.max, 5], np.int32), np.array([10, 20, 30, 50],
                                                          np.int32),
        np.array([1, 2, 3], np.int32), np.array([100, 200, 300], np.int32)),
    "dtype_max_dim_key": lambda: _a(
        np.array([I32.max, 7], np.int32), np.array([1, 2], np.int32),
        np.array([I32.max, 7], np.int32), np.array([111, 77], np.int32)),
    "negative_keys": lambda: _a(
        np.array([-5, -5, 3, I32.min, -1], np.int32),
        np.array([1, 2, 3, 4, 5], np.int32),
        np.array([-5, 3, I32.min], np.int32),
        np.array([100, 200, -300], np.int32)),
    "empty_dim": lambda: _a(np.array([1, 2, 3, 4], np.int32),
                            np.array([10, 20, 30, 40], np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.int32)),
    "skew": _skew_case,
    "mixed_f32_dim": lambda: _a(
        np.array([1, 2, 3], np.int32),
        np.array([2 ** 24 + 1, 7, 9], np.int32),
        np.array([1, 2], np.int32), np.array([0.5, 1.5], np.float32)),
    "bool_fact_u16_dim": lambda: _a(
        np.array([4, 1, 2, 4, 9], np.int32),
        np.array([True, False, True, True, False]),
        np.array([1, 4, 9], np.int32), np.array([0, 65535, 7], np.uint16)),
    "mixed_i16_fact": lambda: _a(
        np.array([4, 1, 2, 4], np.int32),
        np.array([-3, 32767, -32768, 9], np.int16),
        np.array([1, 4], np.int32), np.array([-1.25, 3e9], np.float32)),
}


def _rows(out):
    """Output arrays as a sorted list of rows (canonical order)."""
    return sorted(zip(*(a.tolist() for a in out)))


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
@pytest.mark.parametrize("how", tjoin.JOIN_HOWS)
@pytest.mark.parametrize("joiner", sorted(JOINERS))
def test_join_matches_jax(mesh1, joiner, how, case):
    fk, fv, dk, dv = JOIN_CASES[case]()
    jcls, tcls = JOINERS[joiner]
    kw = dict(capacity_factor=1.1) if case == "skew" else {}
    want = jcls(mesh1, **kw).join(fk, fv, dk, dv, how=how)
    got = tcls(device=CPU, **kw).join(fk, fv, dk, dv, how=how)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("joiner", sorted(JOINERS))
def test_join_variants_against_dict_oracle(joiner):
    fk, fv, dk, dv = _join_case(23, 5000, 250, 900)
    lut = dict(zip(dk.tolist(), dv.tolist()))
    j = JOINERS[joiner][1](device=CPU)
    k, lv, rv = j.join(fk, fv, dk, dv)
    assert _rows((k, lv, rv)) == sorted(
        (int(a), int(b), lut[int(a)]) for a, b in zip(fk, fv)
        if int(a) in lut)
    k, lv, rv, m = j.join(fk, fv, dk, dv, how="left_outer")
    assert len(k) == len(fk)
    assert _rows((k, lv, np.where(m, rv, -1))) == sorted(
        (int(a), int(b), lut.get(int(a), -1)) for a, b in zip(fk, fv))
    with pytest.raises(ValueError, match="how"):
        j.join(fk, fv, dk, dv, how="full_outer")


@pytest.mark.parametrize("joiner", sorted(JOINERS))
def test_join_eight_byte_transport(joiner):
    """64-bit keys and values: keys that differ only above bit 31 must
    not collide (the JAX package runs this only under x64)."""
    j = JOINERS[joiner][1](device=CPU)
    fk = np.array([1, 2 ** 32 + 1, 5, -(2 ** 40)], np.int64)
    fv = np.array([10, 20, 30, 40], np.int64)
    dk = np.array([1, 5, -(2 ** 40)], np.int64)
    dv = np.array([100, 2 ** 33 + 7, -9], np.int64)
    assert _rows(j.join(fk, fv, dk, dv)) == [
        (-(2 ** 40), 40, -9), (1, 10, 100), (5, 30, 2 ** 33 + 7)]
    # int32 keys widen to 8-byte words when a value column is 64-bit
    k, lv, rv = j.join(np.array([3, -3, 4], np.int32),
                       np.array([1.5, -2.5, 0.0], np.float64),
                       np.array([-3, 4], np.int32),
                       np.array([2 ** 50, -1], np.int64))
    assert k.dtype == np.int32 and lv.dtype == np.float64
    assert _rows((k, lv, rv)) == [(-3, -2.5, 2 ** 50), (4, 0.0, -1)]


def test_join_rejects_unsupported_dtypes():
    j = tjoin.HashJoiner(device=CPU)
    with pytest.raises(ValueError, match="keys"):
        j.join(np.array([1.0]), np.array([1], np.int32),
               np.array([1.0]), np.array([1], np.int32))
    with pytest.raises(ValueError, match="value dtype"):
        j.join(np.array([1], np.int32), np.array([1 + 1j]),
               np.array([1], np.int32), np.array([1], np.int32))


def _stream(seed, n_fact, n_dim, key_space, p_valid=0.9):
    fk, fv, dk, dv = _join_case(seed, n_fact, n_dim, key_space)
    rng = np.random.default_rng(seed + 1)
    lval = (rng.random(n_fact) < p_valid).astype(np.int32)
    rval = (rng.random(n_dim) < p_valid).astype(np.int32)
    return fk, fv, lval, dk, dv, rval


def _as_u32(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def _step_rows(outs):
    return sorted(zip(*(_as_u32(o).tolist() for o in outs)))


@pytest.mark.parametrize("kind", ["hash", "broadcast"])
@pytest.mark.parametrize("seed", [0, 1])
def test_join_steps_match_jax(mesh1, kind, seed):
    """The step outputs (keys_u, fact_pay, dim_pay, found, is_fact):
    both sort (key, role) in unsigned order, so every column but the
    fact payload matches slot for slot, and the rows as multisets."""
    cols = _stream(seed, 3000, 400, 900)
    nl, nr = len(cols[0]), len(cols[3])
    if kind == "hash":
        want = jjoin.make_hash_join_step(mesh1, nl, nr, 4096)(
            *map(jnp.asarray, cols))
        got = tjoin.make_hash_join_step(1, nl, nr, 4096)(
            *interop.to_torch(*cols, device=CPU))
        assert int(np.asarray(want[5])[0]) == int(got[5][0]) == 0
    else:
        want = jjoin.make_broadcast_join_step(mesh1, nl, nr)(
            *map(jnp.asarray, cols))
        got = tjoin.make_broadcast_join_step(1, nl, nr)(
            *interop.to_torch(*cols, device=CPU))
    got = [g.numpy() for g in got[:5]]
    want = [np.asarray(w) for w in want[:5]]
    assert got[0].dtype == np.int32
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(_as_u32(got[i]), want[i])
    assert _step_rows(got) == _step_rows(want)


def test_hash_join_step_takes_transport_words(mesh1):
    """Stage 2 of bench_tpcds.py: the previous stage's uint32 words as
    keys and values and its found mask as validity."""
    cols = _stream(3, 2000, 300, 600)
    s1 = tjoin.make_hash_join_step(1, 2000, 300, 4096)(
        *interop.to_torch(*cols, device=CPU))
    j1 = jjoin.make_hash_join_step(mesh1, 2000, 300, 4096)(
        *map(jnp.asarray, cols))
    dk = np.arange(64, dtype=np.int32)
    dv = np.arange(64, dtype=np.int32) * -7
    one = np.ones(64, np.int32)
    fk = np.asarray(j1[1]) % np.uint32(64)
    t_fk = s1[1] % 64
    want = jjoin.make_broadcast_join_step(mesh1, 2300, 64)(
        jnp.asarray(fk), j1[2], j1[3], jnp.asarray(dk), jnp.asarray(dv),
        jnp.asarray(one))
    got = tjoin.make_broadcast_join_step(1, 2300, 64)(
        t_fk, s1[2], s1[3], *interop.to_torch(dk, dv, one, device=CPU))
    assert _step_rows([g.numpy() for g in got]) == _step_rows(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_fill_matches_jax_log_step(seed):
    """The port's fill (kernel 1's plain version on the CPU) against
    the JAX log-step on one sorted stream."""
    cols = _stream(seed, 2500, 300, 700, p_valid=0.8)
    ku, role, pay = tjoin._pack_sides(*interop.to_torch(*cols, device=CPU))
    perm = tlex.perm_by_key_role(ku, role)
    sk, srole, spay = ku[perm], role[perm], pay[perm]
    fval, found = tjoin._probe_fill(sk, srole, spay)
    wval, wfound = jjoin._probe_fill(
        jnp.asarray(sk.numpy().view(np.uint32)),
        jnp.asarray(srole.numpy().astype(np.uint32)),
        jnp.asarray(spay.numpy().view(np.uint32)))
    np.testing.assert_array_equal(found.numpy(), np.asarray(wfound))
    f = found.numpy()
    np.testing.assert_array_equal(fval.numpy()[f].view(np.uint32),
                                  np.asarray(wval)[f])
    assert f.sum() > 0


@pytest.mark.parametrize("width", [4, 8])
def test_join_sort_orders_match_np_lexsort(width):
    rng = np.random.default_rng(width)
    n = 3000
    dt = np.int32 if width == 4 else np.int64
    info = np.iinfo(dt)
    key = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    key[::7] = key[0]
    key[:3] = (info.min, info.max, -1)
    gk = rng.integers(-3, 3, n).astype(dt)
    role = rng.integers(0, 3, n).astype(np.int32)
    u = np.uint32 if width == 4 else np.uint64
    got = tlex.perm_by_key_role(torch.from_numpy(key), torch.from_numpy(role))
    np.testing.assert_array_equal(got.numpy(),
                                  np.lexsort((role, key.view(u))))
    got = tlex.perm_by_group_key_role(*map(torch.from_numpy, (gk, key, role)))
    np.testing.assert_array_equal(
        got.numpy(), np.lexsort((role, key.view(u), gk.view(u))))


# -- fused join + aggregate -------------------------------------------------


def _j_gk17(ku):
    return ku % jnp.asarray(17, ku.dtype)


def _t_gk17(ku):
    return ku % 17


def _j_xor(ku, fp, dvu):
    return (jax.lax.bitcast_convert_type(fp, jnp.int32)
            ^ jax.lax.bitcast_convert_type(dvu, jnp.int32))


def _t_xor(ku, fp, dvu):
    return (fp ^ dvu).to(torch.int32)


def _j_gk1024(ku):
    return ku % jnp.asarray(1024, ku.dtype)


def _t_gk1024(ku):
    return ku % 1024


@functools.lru_cache(maxsize=None)
def _j_gk_mod(p):
    return lambda ku: ku % jnp.asarray(p, ku.dtype)


@functools.lru_cache(maxsize=None)
def _t_gk_mod(p):
    return lambda ku: ku % p


def _j_float(ku, fp, dvu):
    return jax.lax.bitcast_convert_type(dvu, jnp.int32).astype(
        jnp.float32) * 0.5


def _t_float(ku, fp, dvu):
    return dvu.to(torch.int32).to(torch.float32) * 0.5


JA_CASES = {
    "defaults": (None, None, None, None,
                 lambda: _join_case(11, 4096, 300, 1000)),
    "gk17_xor": (_j_gk17, _j_xor, _t_gk17, _t_xor,
                 lambda: _join_case(11, 4096, 300, 1000)),
    "bench_tpcds_hooks": (_j_gk1024, _j_xor, _t_gk1024, _t_xor,
                          lambda: _join_case(12, 5000, 2000, 2200)),
    "fuzz_p1": (_j_gk_mod(1), _j_xor, _t_gk_mod(1), _t_xor,
                lambda: _join_case(1200, 8, 3, 6)),
    "fuzz_p7": (_j_gk_mod(7), _j_xor, _t_gk_mod(7), _t_xor,
                lambda: _join_case(1201, 512, 50, 100)),
    "fuzz_p64": (_j_gk_mod(64), _j_xor, _t_gk_mod(64), _t_xor,
                 lambda: _join_case(1202, 3000, 700, 1400)),
    "edge_keys": (None, None, None, None, lambda: _a(
        np.array([1, 1, 2, I32.max, 9], np.int32),
        np.array([10, 11, 20, 30, 90], np.int32),
        np.array([1, 2], np.int32), np.array([-5, 7], np.int32))),
    "negative_keys": (None, None, None, None, lambda: _a(
        np.array([-5, -5, 3, -1, I32.min], np.int32),
        np.array([1, 2, 3, 4, 5], np.int32),
        np.array([-5, 3, -1, I32.min], np.int32),
        np.array([100, 200, 7, 8], np.int32))),
    "negative_keys_gk17": (_j_gk17, _j_xor, _t_gk17, _t_xor, lambda: _a(
        np.array([-5, -5, 3, -1, I32.min, 40], np.int32),
        np.array([1, 2, 3, 4, 5, 6], np.int32),
        np.array([-5, 3, -1, I32.min, 40], np.int32),
        np.array([100, 200, 7, -8, 9], np.int32))),
}


@pytest.mark.parametrize("case", sorted(JA_CASES))
def test_join_aggregate_matches_jax(mesh1, case):
    jg, jv, tg, tv, data = JA_CASES[case]
    fk, fv, dk, dv = data()
    dv = dv - (1 << 29) if dv.size and dv.max() > (1 << 29) else dv
    want = jja.BroadcastJoinAggregator(mesh1).join_aggregate(
        fk, fv, dk, dv, jg, jv)
    got = tja.BroadcastJoinAggregator(device=CPU).join_aggregate(
        fk, fv, dk, dv, tg, tv)
    assert got == {k: tuple(s) for k, s in want.items()}
    assert got


def test_join_aggregate_float_values_match_jax(mesh1):
    """float32 hook values: the sums add in another order than JAX's
    cumsum, so they compare within float32 rounding of the partial
    sums (values are multiples of 0.5 below 2^30)."""
    fk, fv, dk, dv = _join_case(14, 3000, 200, 500)
    want = jja.BroadcastJoinAggregator(mesh1).join_aggregate(
        fk, fv, dk, dv, _j_gk17, _j_float)
    got = tja.BroadcastJoinAggregator(device=CPU).join_aggregate(
        fk, fv, dk, dv, _t_gk17, _t_float)
    assert set(got) == set(want)
    for g, st in got.items():
        w = want[g]
        assert (st.count, st.min, st.max) == (w.count, w.min, w.max)
        assert st.sum == pytest.approx(w.sum, rel=1e-5)


def test_join_aggregate_eight_byte_transport():
    """int64 keys against a dict oracle (JAX needs x64 for these)."""
    fk = np.array([2 ** 40, 2 ** 40, 3, -7, 2 ** 40 + 17], np.int64)
    fv = np.arange(5, dtype=np.int64)
    dk = np.array([2 ** 40, 3, -7], np.int64)
    dv = np.array([2 ** 35, -1, 5], np.int64)
    got = tja.BroadcastJoinAggregator(device=CPU).join_aggregate(
        fk, fv, dk, dv)
    assert got == {2 ** 40: (2 ** 36, 2, 2 ** 35, 2 ** 35),
                   3: (-1, 1, -1, -1), -7: (5, 1, 5, 5)}


def _tpcds_data(log2):
    """bench_tpcds.py:49-66 at 2^log2 fact rows."""
    n_fact = 1 << log2
    n_dim1 = 1 << max(10, log2 - 6)
    n_dim2 = 1 << max(8, log2 - 8)
    rng = np.random.default_rng(21)
    d1k = np.sort(rng.choice(int(n_dim1 * 1.07), n_dim1,
                             replace=False)).astype(np.int32)
    d1v = rng.integers(0, 1 << 31, n_dim1, dtype=np.int32)
    d2k = np.arange(n_dim2, dtype=np.int32)
    d2v = rng.integers(0, 1 << 31, n_dim2, dtype=np.int32)
    fk1 = rng.integers(0, int(n_dim1 * 1.07), n_fact).astype(np.int32)
    fk2 = rng.integers(0, n_dim2, n_fact).astype(np.int32)
    return n_fact, n_dim1, n_dim2, (fk1, fk2, np.ones(n_fact, np.int32),
                                    d1k, d1v, np.ones(n_dim1, np.int32),
                                    d2k, d2v, np.ones(n_dim2, np.int32))


def _run_tpcds(mods, n_fact, n_dim1, n_dim2, cols, hooks, mesh=None):
    """bench_tpcds.py's three-stage and fused pipelines through either
    package: returns the stage-3 rows and the fused rows."""
    join, ja, agg = mods
    first = (lambda *a: a[0](mesh, *a[1:])) if mesh is not None else (
        lambda *a: a[0](1, *a[1:]))
    lk, lv, l_valid, rk1, rv1, r1_valid, rk2, rv2, r2_valid = cols
    m1 = n_fact + n_dim1
    m2 = m1 + n_dim2
    step1 = first(join.make_hash_join_step, n_fact, n_dim1, 2 * m1)
    step2 = first(join.make_broadcast_join_step, m1, n_dim2)
    step3 = first(agg.make_aggregate_step, m2, 2 * m2)
    step23 = first(ja.make_broadcast_join_aggregate_step, m1, n_dim2, *hooks)
    _sk1, spay1, fval1, found1, _isf1, _fill1 = step1(
        lk, lv, l_valid, rk1, rv1, r1_valid)
    sk2, spay2, fval2, found2, _isf2 = step2(
        spay1, fval1, found1, rk2, rv2, r2_valid)
    if mesh is not None:
        k3, v3 = sk2 % jnp.uint32(1024), spay2 ^ fval2
    else:  # int32 words: x & 1023 is the unsigned x % 1024
        k3, v3 = sk2 & 1023, spay2 ^ fval2
    staged = step3(k3, v3, found2)[:5]
    fused = step23(spay1, fval1, found1, rk2, rv2, r2_valid)[:5]
    return [np.asarray(x) for x in staged], [np.asarray(x) for x in fused]


def test_tpcds_pipelines_match_jax(mesh1):
    """The chained three-stage and fused pipelines of bench_tpcds.py
    at 2^12 fact rows: the same groups, counts and (wrapped) sums in
    both packages; min/max of the fused pipelines bit for bit, and the
    port's three-stage min/max (signed) equal to its fused ones."""
    n_fact, n_dim1, n_dim2, cols = _tpcds_data(12)
    (ws, wf) = _run_tpcds((jjoin, jja, jagg), n_fact, n_dim1, n_dim2,
                          [jnp.asarray(c) for c in cols],
                          (_j_gk1024, _j_xor), mesh=mesh1)
    (gs, gf) = _run_tpcds((tjoin, tja, tagg), n_fact, n_dim1, n_dim2,
                          interop.to_torch(*cols, device=CPU),
                          (_t_gk1024, _t_xor))

    def groups(rows, signed_minmax):
        keys, sums, counts, mins, maxs = rows
        m = counts > 0
        out = {}
        for k, s, c, lo, hi in zip(keys[m].astype(np.int64),
                                   sums[m].astype(np.int64) & 0xFFFFFFFF,
                                   counts[m], mins[m], maxs[m]):
            mm = (int(lo), int(hi)) if signed_minmax else None
            out[int(k) & 0xFFFFFFFF] = (int(s), int(c), mm)
        return out

    def strip(d):
        return {k: v[:2] for k, v in d.items()}

    total = int(gs[2].sum())
    assert total == int(gf[2].sum()) == int(ws[2].sum()) > 0.9 * n_fact
    assert strip(groups(gs, False)) == strip(groups(ws, False))
    assert groups(gf, True) == groups(wf, True)
    assert groups(gs, True) == groups(gf, True)


# -- grouped top-k -----------------------------------------------------------


TOPK_CASES = {
    "ties": lambda: (np.random.default_rng(42).integers(0, 67, 20011,
                                                        dtype=np.int32),
                     np.random.default_rng(43).integers(-20, 20, 20011,
                                                        dtype=np.int32)),
    "dtype_max_key": lambda: (np.array([I32.max, I32.max, 7, I32.max, 7],
                                       np.int32),
                              np.array([3, 3, I32.min, 9, I32.max],
                                       np.int32)),
    "fuzz_one_key": lambda: (np.zeros(16, np.int32),
                             np.random.default_rng(2100).integers(
                                 -(1 << 20), 1 << 20, 16, dtype=np.int32)),
    "fuzz_300_keys": lambda: (
        np.random.default_rng(2101).integers(0, 300, 4096, dtype=np.int32),
        np.random.default_rng(2102).integers(-(1 << 20), 1 << 20, 4096,
                                             dtype=np.int32)),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
@pytest.mark.parametrize("k", [1, 3])
def test_grouped_topk_matches_jax(mesh1, case, k):
    keys, vals = TOPK_CASES[case]()
    got = ttopk.GroupedTopK(device=CPU).top_k(keys, vals, k)
    want = jtopk.GroupedTopK(mesh1).top_k(keys, vals, k)
    assert got == want
    for kk in np.unique(keys):
        assert got[int(kk)] == np.sort(vals[keys == kk])[::-1][:k].tolist()


@pytest.mark.parametrize("with_valid", [False, True])
def test_topk_step_matches_jax(mesh1, with_valid):
    """Keys ascend and values descend within a run in both packages, so
    even tied values match slot for slot."""
    rng = np.random.default_rng(7)
    n = 3000
    keys = rng.integers(-40, 40, n, dtype=np.int32)
    vals = rng.integers(-9, 9, n, dtype=np.int32)
    valid = (rng.random(n) < (0.7 if with_valid else 1.0)).astype(np.int32)
    want = jtopk.make_topk_step(mesh1, n, n, 5)(
        *map(jnp.asarray, (keys, vals, valid)))
    got = ttopk.make_topk_step(1, n, n, 5)(
        *interop.to_torch(keys, vals, valid, device=CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1),
                                      np.asarray(w).reshape(-1))


def test_topk_refuses_nonpositive_k():
    with pytest.raises(ValueError, match="k must be positive"):
        ttopk.GroupedTopK(device=CPU).top_k(np.zeros(4, np.int32),
                                            np.zeros(4, np.int32), 0)


# -- external sort -----------------------------------------------------------


def _ext_pair(mesh1, tmp_path, **kw):
    return (jext.ExternalTeraSorter(mesh1, spill_dir=str(tmp_path), **kw),
            text.ExternalTeraSorter(CPU, spill_dir=str(tmp_path), **kw))


def _ext_run(sorter, chunks):
    outs = list(sorter.sort_chunks(chunks))
    if not outs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), []
    return (np.concatenate([np.asarray(k) for k, _ in outs]),
            np.concatenate([np.asarray(v) for _, v in outs]),
            [len(k) for k, _ in outs])


def _stats(s):
    return (s.chunks_in, s.bytes_spilled, s.max_bucket_records,
            s.buckets_resplit)


def _streaming_chunks():
    rng = np.random.default_rng(50)
    out = []
    for _ in range(10):
        n = int(rng.integers(1000, 5000))
        out.append((rng.integers(0, 1 << 30, n).astype(np.int32),
                    rng.integers(0, 1 << 30, n).astype(np.int32)))
    return out


def _sorted_chunks():
    keys = np.arange(16000, dtype=np.int32)
    vals = keys[::-1].copy()
    return [(keys[i:i + 2000], vals[i:i + 2000]) for i in range(0, 16000,
                                                                2000)]


def _balanced_chunks():
    ks = np.random.default_rng(51).integers(0, 1 << 30, (16, 1000))
    return [(k.astype(np.int32), k.astype(np.int32)) for k in ks]


def _duplicate_chunks():
    keys = np.concatenate([np.arange(2000, dtype=np.int32),
                           np.full(14000, 7_000_000, np.int32)])
    vals = np.arange(len(keys), dtype=np.int32)
    return [(keys[i:i + 2000], vals[i:i + 2000]) for i in range(0, 16000,
                                                                2000)]


EXT_CASES = {
    "streaming": (dict(num_buckets=8, sample_per_chunk=512),
                  _streaming_chunks),
    "sorted_input_resplits": (dict(num_buckets=8, sample_per_chunk=256),
                              _sorted_chunks),
    "balanced_no_resplit": (dict(num_buckets=4, sample_per_chunk=512),
                            _balanced_chunks),
    "duplicate_heavy_bucket": (dict(num_buckets=8, sample_per_chunk=128),
                               _duplicate_chunks),
    "empty": (dict(num_buckets=4), lambda: [(np.zeros(0, np.int32),
                                              np.zeros(0, np.int32))]),
    "single": (dict(num_buckets=4), lambda: [(np.array([5], np.int32),
                                              np.array([7], np.int32))]),
}


@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_external_sort_matches_jax(mesh1, tmp_path, case):
    kw, chunks = EXT_CASES[case]
    js, ts = _ext_pair(mesh1, tmp_path, **kw)
    wk, wv, wlens = _ext_run(js, iter(chunks()))
    gk, gv, glens = _ext_run(ts, iter(chunks()))
    np.testing.assert_array_equal(gk, wk)
    assert glens == wlens and _stats(ts) == _stats(js)
    assert sorted(zip(gk.tolist(), gv.tolist())) == sorted(
        zip(wk.tolist(), wv.tolist()))
    allk = np.concatenate([k for k, _ in chunks()])
    np.testing.assert_array_equal(gk, np.sort(allk))
    assert list(tmp_path.iterdir()) == []  # spill files removed


def test_external_sort_resplit_bounds_buckets(tmp_path):
    ts = text.ExternalTeraSorter(CPU, num_buckets=8, sample_per_chunk=256,
                                 spill_dir=str(tmp_path), direct_io="off")
    gk, gv, _ = _ext_run(ts, iter(_sorted_chunks()))
    np.testing.assert_array_equal(gk, np.arange(16000))
    np.testing.assert_array_equal(gv, np.arange(16000)[::-1])
    assert ts.buckets_resplit >= 1 and ts.max_bucket_records <= 2000


# -- ops/partition.py ------------------------------------------------------


def _pkeys(n, seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    k[:4] = (info.min, info.max, 0, -1 if info.min < 0 else 1)
    return k


@pytest.mark.parametrize("n_parts", [1, 7, 8, 1000])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int16])
def test_hash_partition_ids_bit_exact(n_parts, dtype):
    k = _pkeys(5000, n_parts, dtype)
    got = tpart.hash_partition_ids(torch.from_numpy(k), n_parts)
    want = jpart.hash_partition_ids(jnp.asarray(k), n_parts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_partition_ids_int64_low_bits():
    """int64 keys hash their low 32 bits (JAX's astype(uint32))."""
    k = _pkeys(3000, 5, np.int64)
    got = tpart.hash_partition_ids(torch.from_numpy(k), 8)
    low = (k & 0xFFFFFFFF).astype(np.uint32)
    want = jpart.hash_partition_ids(jnp.asarray(low), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_parts", [2, 8, 33])
def test_range_splitters_and_ids_bit_exact(n_parts):
    rng = np.random.default_rng(n_parts)
    sample = rng.integers(-(1 << 30), 1 << 30, 4096).astype(np.int32)
    keys = rng.integers(-(1 << 30), 1 << 30, 10000).astype(np.int32)
    spl = tpart.make_range_splitters(torch.from_numpy(sample), n_parts)
    wspl = jpart.make_range_splitters(jnp.asarray(sample), n_parts)
    np.testing.assert_array_equal(spl.numpy(), np.asarray(wspl))
    ids = tpart.range_partition_ids(torch.from_numpy(keys), spl)
    wids = jpart.range_partition_ids(jnp.asarray(keys), wspl)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))


def _check_buckets(got, want, cap):
    """Counts and pad slots bit for bit; each bucket's real rows as a
    multiset (the JAX grouping sort is unstable)."""
    (gb, gc), (wb, wc) = got, want
    gc, wc = gc.numpy(), np.asarray(wc)
    np.testing.assert_array_equal(gc, wc)
    for g, w in zip(gb, wb):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        for p in range(g.shape[0]):
            c = min(int(gc[p]), cap)
            np.testing.assert_array_equal(g[p, c:], w[p, c:])
            if int(gc[p]) <= cap:
                assert sorted(map(repr, g[p, :c].tolist())) == \
                    sorted(map(repr, w[p, :c].tolist()))


@pytest.mark.parametrize("cap", [64, 256, 1024])
@pytest.mark.parametrize("n_parts", [1, 8])
def test_partition_to_buckets_matches_jax(n_parts, cap):
    rng = np.random.default_rng(cap)
    n = 1000
    keys = rng.integers(0, 1 << 20, n, dtype=np.int32)
    vals = rng.integers(0, 100, n, dtype=np.int32)
    emb = rng.standard_normal((n, 3)).astype(np.float32)
    ids = jpart.hash_partition_ids(jnp.asarray(keys), n_parts)
    want = jpart.partition_to_buckets(
        ids, tuple(map(jnp.asarray, (keys, vals, emb))), n_parts, cap)
    got = tpart.partition_to_buckets(
        torch.from_numpy(np.array(ids)),
        interop.to_torch(keys, vals, emb, device=CPU), n_parts, cap)
    _check_buckets(got, want, cap)


def test_partition_to_buckets_overflow_and_empty():
    ids = np.zeros(100, np.int32)
    keys = np.arange(100, dtype=np.int32)
    (bk,), counts = tpart.partition_to_buckets(
        *interop.to_torch(ids, device=CPU), (torch.from_numpy(keys),), 4, 32)
    assert counts.tolist() == [100, 0, 0, 0]
    kept = bk[0].numpy()
    assert len(np.unique(kept)) == 32 and kept.min() >= 0
    assert (bk[1:].numpy() == I32.max).all()
    empty = np.zeros(0, np.int32)
    got = tpart.partition_to_buckets(torch.from_numpy(empty),
                                     (torch.from_numpy(empty),), 4, 8)
    want = jpart.partition_to_buckets(jnp.asarray(empty),
                                      (jnp.asarray(empty),), 4, 8)
    _check_buckets(got, want, 8)


@pytest.mark.parametrize("cap", [128, 400])
def test_partition_to_buckets_dropping_matches_jax(cap):
    rng = np.random.default_rng(cap + 1)
    n = 2000
    ku = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    role = rng.integers(0, 3, n).astype(np.uint32)
    pay = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ids = jpart.hash_partition_ids(jnp.asarray(ku), 8)
    fills = (jnp.zeros((), jnp.uint32), jnp.uint32(2), jnp.zeros((),
                                                                jnp.uint32))
    want = jpart.partition_to_buckets_dropping(
        ids, jnp.asarray(role != 2), tuple(map(jnp.asarray, (ku, role, pay))),
        8, cap, fill_values=fills)
    words = tuple(torch.from_numpy(x.view(np.int32)) for x in (ku, role, pay))
    got = tpart.partition_to_buckets_dropping(
        torch.from_numpy(np.array(ids)), torch.from_numpy(role != 2),
        words, 8, cap, fill_values=(0, 2, 0))
    got = (tuple(b.view(torch.uint32) for b in got[0]), got[1])
    _check_buckets(got, want, cap)


@pytest.mark.parametrize("sort_within", [False, True])
def test_bucketize_segments_matches_jax(sort_within):
    rng = np.random.default_rng(5)
    n, cap = 3000, 1024  # no bucket overflows: the kept rows are all
    keys = rng.integers(-50, 50, n, dtype=np.int32)
    vals = rng.integers(0, 1 << 20, n, dtype=np.int32)
    ids = jpart.hash_partition_ids(jnp.asarray(keys), 8)
    wb, wc, wo = jpart.bucketize_segments(
        ids, (jnp.asarray(keys), jnp.asarray(vals)), 8, cap,
        sort_within=sort_within)
    gb, gc, go = tpart.bucketize_segments(
        torch.from_numpy(np.array(ids)),
        interop.to_torch(keys, vals, device=CPU), 8, cap,
        sort_within=sort_within)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    assert go.dtype == torch.int32
    if sort_within:  # keys sorted per bucket: bit for bit
        np.testing.assert_array_equal(gb[0].numpy(), np.asarray(wb[0]))
    _check_buckets((gb, gc), (wb, wc), cap)
    with pytest.raises(ValueError, match="sort_within"):
        tpart.bucketize_segments(
            torch.from_numpy(np.array(ids)),
            (torch.from_numpy(keys), torch.zeros(n, 2)), 8, cap,
            sort_within=True)


def test_window_copy_matches_jax():
    arr = np.arange(100, dtype=np.int32) * 3
    starts = np.array([0, 10, 95, 100], np.int32)
    want = jpart._window_copy(jnp.asarray(arr), jnp.asarray(starts), 4, 16)
    got = tpart._window_copy(*interop.to_torch(arr, starts, device=CPU), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- entry points ------------------------------------------------------------


STEP_MAKERS = {
    "hash_join": lambda d, g=None: tjoin.make_hash_join_step(
        d, 8, 8, 16, group=g),
    "broadcast_join": lambda d, g=None: tjoin.make_broadcast_join_step(
        d, 8, 8, group=g),
    "join_aggregate": lambda d, g=None: tja.make_broadcast_join_aggregate_step(
        d, 8, 8, _t_gk17, None, group=g),
    "topk": lambda d, g=None: ttopk.make_topk_step(d, 8, 16, 3, group=g),
}


class _TwoRanks(ExchangeGroup):
    """Rank 0 of a two-rank group, for building steps (the collectives
    run in tests/test_torch_exchange.py's gloo worlds)."""

    def __init__(self):
        self.device, self.group, self.rank, self.size = (
            torch.device(CPU), None, 0, 2)


@pytest.mark.parametrize("maker", sorted(STEP_MAKERS))
def test_step_makers_refuse_more_than_one_device(maker):
    """Over more than one device a step needs the group it runs in (one
    process per GPU); with one of the right size it builds."""
    with pytest.raises(ValueError, match="one process per GPU.*group="):
        STEP_MAKERS[maker](2)
    with pytest.raises(ValueError, match="made for 4 devices"):
        STEP_MAKERS[maker](4, _TwoRanks())
    assert callable(STEP_MAKERS[maker](2, _TwoRanks()))


def test_external_sort_builds_over_two_ranks():
    """Over a group of two ranks it sorts each chunk on its own device and
    each bucket over the group (the worlds of tests/test_torch_exchange.py
    run it)."""
    ext = text.ExternalTeraSorter(CPU, group=_TwoRanks())
    assert ext.sorter.n_devices == 2 and ext.chunk_sorter.n_devices == 1
    assert ext.chunk_sorter.device == ext.device == torch.device(CPU)


def test_sql_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tjoin.HashJoiner, tjoin.BroadcastJoiner,
                 tja.BroadcastJoinAggregator, ttopk.GroupedTopK,
                 text.ExternalTeraSorter):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_step_rejects_rows_it_was_not_made_for():
    step = tjoin.make_broadcast_join_step(1, 8, 4)
    z = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        step(z, z, z, z[:4], z[:4], z[:4])
