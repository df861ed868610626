"""The joins' probe sorts on the CPU: ``ops/lexsort.py::sort_key_role``
packs a key of at most 4 bytes with its role into one int64 word, in a
transport word of either width, and the probes read the sorted key and
role back from it.  Each probe here is held bit for bit against the
chained composition written out below: a packed sort for
4-byte words, and for 8-byte words a stable sort of the role, a gather
of the key through it, a stable sort of the key and the composition of
the two permutations, then gathers of key, role and payload (and of the
group key in the join+aggregate).  Also pinned: the registry's
``join_probe_rows_total{sort=packed|chain}``.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models import join as tjoin
from sparkrdma_tpu_torch.models import join_aggregate as tja
from sparkrdma_tpu_torch.ops import lexsort as tlex

MASK32 = (1 << 32) - 1

# (fact key, dimension key) dtypes: every key dtype of at most 4 bytes,
# mixed across the sides, then int64 keys, which take the chain
NARROW_PAIRS = [
    (torch.int32, torch.int32), (torch.int32, torch.uint32),
    (torch.uint32, torch.int32), (torch.int8, torch.int16),
    (torch.uint8, torch.int32), (torch.bool, torch.int8),
    (torch.int16, torch.uint32), (torch.uint8, torch.bool),
]
WIDE_PAIRS = [(torch.int64, torch.int32), (torch.int32, torch.int64),
              (torch.int64, torch.int64)]
PAIRS = NARROW_PAIRS + WIDE_PAIRS
PAYLOADS = [torch.int32, torch.int64]


def _name(dt):
    return str(dt).replace("torch.", "")


def _pair_id(pair):
    return "-".join(map(_name, pair))


# -- the chained composition ---------------------------------------------------


def _unsigned_order(word):
    return word ^ torch.iinfo(word.dtype).min


def _chained_perm(ku, role):
    """Rows by (key unsigned, role): one packed sort of a 4-byte word,
    two stable sorts of an 8-byte one."""
    if ku.dtype == torch.int32:
        packed = ((ku.to(torch.int64) & MASK32) << 2) | role.to(torch.int64)
        return torch.sort(packed, stable=True).indices
    perm = torch.sort(role, stable=True).indices
    order = torch.sort(_unsigned_order(ku)[perm], stable=True).indices
    return perm[order]


def _chained_probe(ku, role, pay):
    perm = _chained_perm(ku, role)
    sk, srole, spay = ku[perm], role[perm], pay[perm]
    fval, found = tjoin._probe_fill(sk, srole, spay)
    fval = torch.where(found, fval, 0)
    is_fact = (srole == tjoin._ROLE_FACT).to(torch.int32)
    return sk, spay, fval, found.to(torch.int32), is_fact


def _chained_join_aggregate(gk_fn, agg_fn, lk, lv, l_valid, rk, rv,
                            r_valid):
    ku, role, pay = tjoin._pack_sides(lk, lv, l_valid, rk, rv, r_valid)
    gk = gk_fn(tja._hook_view(ku)).to(ku.dtype)
    gk = torch.where(role != tjoin._ROLE_INVALID, gk, -1)
    perm = _chained_perm(ku, role)
    order = torch.sort(_unsigned_order(gk)[perm], stable=True).indices
    perm = perm[order]
    sgk, sk, srole, spay = gk[perm], ku[perm], role[perm], pay[perm]
    dim_val, found = tjoin._probe_fill(sk, srole, spay)
    v = dim_val if agg_fn is None else agg_fn(
        tja._hook_view(sk), tja._hook_view(spay), tja._hook_view(dim_val))
    return tja._aggregate_runs(sgk, v, found)


# -- inputs ---------------------------------------------------------------------


def _keys(rng, dtype, n, pool):
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, n).astype(bool))
    return torch.from_numpy(rng.choice(pool, n)).to(dtype)


def _pool(dtype):
    """Key values of a dtype: its extremes, -1, and a small range
    (negative for signed dtypes), so that keys repeat and match."""
    if dtype == torch.bool:
        return np.array([0, 1])
    info = torch.iinfo(dtype)
    vals = list(range(max(info.min, -12), min(info.max, 12) + 1))
    vals += [info.min, info.max, info.max - 1]
    if info.min < 0:
        vals += [-1, info.min + 1]
    return np.array(sorted(set(vals)), dtype=np.int64)


def _sides(seed, pair, pay_dtype, n_fact=700, n_dim=90, p_valid=0.8):
    """Fact and dimension columns: repeated fact keys (ties in key and
    role), dimension keys unique among the valid rows where the dtype
    allows, invalid rows on both sides."""
    rng = np.random.default_rng(seed)
    lk = _keys(rng, pair[0], n_fact, _pool(pair[0]))
    pool = _pool(pair[1])
    rk = torch.from_numpy(rng.permutation(pool)[:n_dim]).to(pair[1]) \
        if pair[1] != torch.bool else _keys(rng, pair[1], min(n_dim, 2),
                                            pool)
    if n_dim > rk.shape[0]:
        # the rest of the dimension rows repeat keys, but are invalid
        extra = _keys(rng, pair[1], n_dim - rk.shape[0], pool)
        rk = torch.cat([rk, extra])
    info = torch.iinfo(pay_dtype)
    lv = torch.from_numpy(rng.integers(info.min, info.max, n_fact,
                                       dtype=np.int64)).to(pay_dtype)
    rv = torch.from_numpy(rng.integers(info.min, info.max, rk.shape[0],
                                       dtype=np.int64)).to(pay_dtype)
    l_valid = torch.from_numpy(
        (rng.random(n_fact) < p_valid).astype(np.int32))
    r_valid = torch.from_numpy(
        (rng.random(rk.shape[0]) < p_valid).astype(np.int32))
    n_unique = len(pool) if pair[1] != torch.bool else 2
    r_valid[min(n_unique, n_dim):] = 0
    return lk, lv, l_valid, rk, rv, r_valid


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert torch.equal(g, w), i


# -- the sort and its word --------------------------------------------------------


@pytest.mark.parametrize("pay", PAYLOADS, ids=_name)
@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_sort_key_role_word_decodes_the_chained_gathers(pair, pay):
    lk, lv, l_valid, rk, rv, r_valid = _sides(11, pair, pay)
    ku, role, _pay = tjoin._pack_sides(lk, lv, l_valid, rk, rv, r_valid)
    kb = tjoin._key_bytes(lk, rk)
    word, perm = tlex.sort_key_role(ku, role, kb)
    want = _chained_perm(ku, role)
    assert torch.equal(perm, want)
    assert (word is None) == (kb == 8)
    if word is not None:
        sk, srole = tlex.unpack_key_role(word, ku.dtype)
        assert sk.dtype == ku.dtype
        assert torch.equal(sk, ku[want])
        assert srole.dtype == role.dtype
        assert torch.equal(srole, role[want])


# -- the probe ----------------------------------------------------------------------


@pytest.mark.parametrize("pay", PAYLOADS, ids=_name)
@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
@pytest.mark.parametrize("variant", ["hash", "broadcast"])
def test_join_steps_equal_the_chained_probe(variant, pair, pay):
    cols = _sides(5, pair, pay)
    n_fact, n_dim = cols[0].shape[0], cols[3].shape[0]
    if variant == "hash":
        got = tjoin.make_hash_join_step(1, n_fact, n_dim, 0)(*cols)[:5]
    else:
        got = tjoin.make_broadcast_join_step(1, n_fact, n_dim)(*cols)
    want = _chained_probe(*tjoin._pack_sides(*cols))
    _assert_same(got, want)
    assert int(want[3].sum()) > 0


@pytest.mark.parametrize("empty", ["fact", "dimension", "both"])
@pytest.mark.parametrize("pay", PAYLOADS, ids=_name)
def test_probe_of_an_empty_side_equals_the_chained_probe(pay, empty):
    lk, lv, l_valid, rk, rv, r_valid = _sides(6, (torch.int32, torch.uint32),
                                              pay)
    if empty in ("fact", "both"):
        lk, lv, l_valid = lk[:0], lv[:0], l_valid[:0]
    if empty in ("dimension", "both"):
        rk, rv, r_valid = rk[:0], rv[:0], r_valid[:0]
    cols = (lk, lv, l_valid, rk, rv, r_valid)
    got = tjoin.make_hash_join_step(1, lk.shape[0], rk.shape[0], 0)(*cols)
    _assert_same(got[:5], _chained_probe(*tjoin._pack_sides(*cols)))


@pytest.mark.parametrize("pay", PAYLOADS, ids=_name)
def test_int32_minus_one_and_uint32_max(pay):
    """int32 -1 and uint32 0xFFFFFFFF are one 4-byte word (JAX's uint32
    of each) but two 8-byte words, so they match only in 4-byte
    words; either way the probe equals the chained one."""
    lk = torch.tensor([-1, -1, 5, -1], dtype=torch.int32)
    rk = torch.from_numpy(np.array([MASK32, 5], np.uint32))
    lv = torch.arange(4, dtype=pay)
    rv = torch.tensor([70, 71], dtype=pay)
    cols = (lk, lv, torch.ones(4, dtype=torch.int32), rk, rv,
            torch.ones(2, dtype=torch.int32))
    got = tjoin.make_hash_join_step(1, 4, 2, 0)(*cols)[:5]
    _assert_same(got, _chained_probe(*tjoin._pack_sides(*cols)))
    found = got[3].tolist()
    assert sum(found) == (4 if pay == torch.int32 else 1)


# -- the join + aggregate -----------------------------------------------------------


def _gk7(key_u):
    return key_u % 7


def _fact_pay(key_u, fact_pay_u, dim_val_u):
    return fact_pay_u


@pytest.mark.parametrize("hooks", [(_gk7, None), (tja._identity_group_key,
                                                  _fact_pay)],
                         ids=["gk7-dim", "key-fact"])
@pytest.mark.parametrize("pay", PAYLOADS, ids=_name)
@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_join_aggregate_step_equals_the_chained_one(pair, pay, hooks):
    cols = _sides(9, pair, pay)
    step = tja.make_broadcast_join_aggregate_step(
        1, cols[0].shape[0], cols[3].shape[0], *hooks)
    got = step(*cols)
    want = _chained_join_aggregate(*hooks, *cols)
    _assert_same(got, want)
    assert int(want[2].sum()) > 0


# -- the counter ------------------------------------------------------------------


def _probe_rows(fn):
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        fn()
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    return {c["labels"]["sort"]: c["value"] for c in snap
            if c["name"] == "join_probe_rows_total"}


def test_query_55_steps_count_packed_probe_rows():
    """Both of query 55's probes pack: the date join's int32 keys in
    8-byte words (the int64 payload), the item join's in 4-byte
    words.  4096 fact and 80 date rows, then those and 64 items."""
    from shufflebench import common
    from shufflebench.tests import sizes

    config = dict(common.data("configs", "tpcds_sf100"))
    config.update(sizes.TPCDS)
    job = common.module("drivers", "tpcds_sf100").Job(
        config, 3, 0, 1, None, torch.device("cpu"))
    assert _probe_rows(job.step) == {"packed": 4176 + 4240}
    job.release()


def test_int64_keyed_hash_join_counts_chain_probe_rows():
    from sparkrdma_tpu_torch.models import HashJoiner

    rng = np.random.default_rng(4)
    fk = rng.integers(-50, 50, 300).astype(np.int64)
    dk = np.arange(-20, 20, dtype=np.int64)
    joiner = HashJoiner(device="cpu")
    got = _probe_rows(lambda: joiner.join(fk, fk, dk, dk))
    # the fact side padded onto the shape ladder: 320 + 40 rows
    assert joiner._local_length(300, 40)[0] == (320, 40)
    assert got == {"chain": 360}
