"""The port's multi-GPU exchange (D > 1) against the JAX package, on the
CPU.

D = 2 and 4 run in a gloo world of D worker processes
(tests/torch_exchange_worker.py, which imports neither JAX nor this
conftest), spawned once per module and per D over a ``file://`` store
under a temporary directory.  Each rank runs the port rank-locally on
its own shard and pickles what it gets; each test holds the ranks'
results against the JAX package on ``make_mesh(D)`` over the
conftest's 8-device CPU mesh, with the same numpy-seeded inputs.

- Step level (``hash_exchange``, the TeraSort narrow and wide steps,
  the hash and broadcast join steps, top-k): rank d's shard is the JAX
  step's shard d, and rank d's outputs are held against row d of the
  JAX outputs.  The port's grouping sort is stable and JAX's is not
  (``ops/partition.py``), so exchanged buckets compare as multisets per
  (destination, source), and sorted runs compare keys slot for slot and
  values canonically within equal keys.
- Host level (the cases of tests/test_models.py, and the dtypes the
  JAX package takes): each rank passes a contiguous shard of the input
  and gets what it owns; sorted runs concatenated in rank order, dicts
  merged (disjoint) and join rows united must give the JAX result.
  Overflow retries must run the same number of times on every rank.

Integer results are bit for bit.  float32 sums: both packages add in
float32 as differences of prefix sums, in other orders, and the JAX
package hands them back truncated to int; they hold within
``F32_SUM_ATOL`` of a float64 sum (prefix sums of a few thousand values
of magnitude 100 round to about 1e-3 per add) and within 1 +
``F32_SUM_ATOL`` of the JAX integer.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_exchange_worker as worker
from sparkrdma_tpu.models import TeraSorter as JTeraSorter
from sparkrdma_tpu.models import WordCounter as JWordCounter
from sparkrdma_tpu.models import external_sort as jext
from sparkrdma_tpu.models import join as jjoin
from sparkrdma_tpu.models import join_aggregate as jja
from sparkrdma_tpu.models import topk as jtopk
from sparkrdma_tpu.models.aggregate import KeyedAggregator as JAggregator
from sparkrdma_tpu.ops.exchange import hash_exchange as jhash_exchange
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu.parallel.mesh import EXCHANGE_AXIS

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 180
WORLDS = [2, 4]
F32_SUM_ATOL = 0.1


def _run_world(world, tmp):
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, str(pathlib.Path(worker.__file__)), str(r),
             str(world), str(store), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO),
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))  # written by our own workers
    return ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(D)``: the results of each rank of a D-rank gloo world,
    spawned once per module and per D."""
    cache = {}

    def get(D):
        if D not in cache:
            cache[D] = _run_world(D, tmp_path_factory.mktemp(f"gloo{D}"))
        return cache[D]

    return get


def _steps(world, D, name):
    return [r["steps"][name] for r in world(D)]


def _host(world, D, name):
    return [r["host"][name] for r in world(D)]


def _rows_sorted(*cols):
    """Rows of equal-length columns in canonical (lexicographic) order."""
    cols = [np.asarray(c) for c in cols]
    keys = [c2[:, j] for c in cols
            for c2 in [c if c.ndim == 2 else c[:, None]]
            for j in range(c2.shape[1])]
    order = np.lexsort(tuple(reversed(keys)))
    return [c[order] for c in cols]


def _assert_same_rows(got, want):
    for g, w in zip(_rows_sorted(*got), _rows_sorted(*want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- step level ---------------------------------------------------------------


def _jax_hash_exchange(keys, vals, valid, D, cap):
    def body(k, v, m):
        ek, ev, em, mf = jhash_exchange(k, v, m, D, cap)
        return ek, ev, em, mf[None]

    spec = P(EXCHANGE_AXIS)
    fn = jax.jit(jax.shard_map(body, mesh=make_mesh(D), in_specs=(spec,) * 3,
                               out_specs=(spec,) * 4))
    return [np.asarray(x) for x in fn(*map(jnp.asarray, (keys, vals, valid)))]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", ["i32", "u32", "i16"])
def test_hash_exchange_matches_jax(world, D, name):
    """Every (destination, source) bucket holds the JAX bucket's rows,
    in the caller's dtypes; uint32 and int16 keys land on the ranks
    JAX sends them to."""
    keys, vals, valid, cap = worker.exchange_inputs(name, D)
    wk, wv, wm, wf = _jax_hash_exchange(keys, vals, valid, D, cap)
    for d, (gk, gv, gm, gf) in enumerate(_steps(world, D, f"hx_{name}")):
        assert gf[0] == wf[d]
        want = [x.reshape(D, D, cap)[d] for x in (wk, wv, wm)]
        got = [x.reshape(D, cap) for x in (gk, gv, gm)]
        for src in range(D):
            _assert_same_rows([g[src] for g in got], [w[src] for w in want])


def _check_sorted_run(got, want, d, D):
    """Rank d's (keys, vals, n_valid, max_fill) against row d of the
    JAX step: keys, counts and fills bit for bit, values within equal
    keys."""
    gk, gv, gn, gf = got
    wk, wv, wn, wf = want
    rows = wk.shape[0] // D
    wk_d = wk[d * rows:(d + 1) * rows]
    wv_d = wv[d * rows:(d + 1) * rows]
    assert gk.dtype == wk.dtype and gv.dtype == wv.dtype
    np.testing.assert_array_equal(gk, wk_d)
    assert gn[0] == wn[d] and gf[0] == wf[d]
    nv = int(gn[0])
    _assert_same_rows([gk[:nv], gv[:nv]], [wk_d[:nv], wv_d[:nv]])


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", ["valid", "full", "u32", "i16",
                                  "arbitrary_valid"])
def test_terasort_step_matches_jax(world, D, name):
    keys, vals, valid = worker.sort_inputs(name, D)
    want, wcap = JTeraSorter(make_mesh(D)).sort_device(
        *(None if x is None else jnp.asarray(x) for x in (keys, vals, valid)))
    want = [np.asarray(x) for x in want]
    for d, (got, gcap) in enumerate(_steps(world, D, f"sort_{name}")):
        assert gcap == wcap
        _check_sorted_run(got, want, d, D)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("n", worker.WIDE_SIZES)
def test_terasort_wide_step_matches_jax(world, D, n):
    keys, payload = worker.wide_inputs(n)
    want, wcap = JTeraSorter(make_mesh(D)).sort_device_wide(
        jnp.asarray(keys), jnp.asarray(payload))
    want = [np.asarray(x) for x in want]
    for d, (got, gcap) in enumerate(_steps(world, D, f"wide_{n}")):
        assert gcap == wcap
        _check_sorted_run(got, want, d, D)
    # every record arrives once, next to its key
    out_k = np.concatenate([g[0][:g[2][0]] for g, _ in
                            _steps(world, D, f"wide_{n}")])
    out_p = np.concatenate([g[1][:g[2][0]] for g, _ in
                            _steps(world, D, f"wide_{n}")])
    np.testing.assert_array_equal(out_k, np.sort(keys))
    np.testing.assert_array_equal(out_p[:, 0], out_k)


def _check_join_step(got, want, d, D):
    """The probe layout: keys (as uint32 words), found and is_fact slot
    for slot; (key, fact payload, dim value) rows as a multiset."""
    rows = want[0].shape[0] // D
    w = [x[d * rows:(d + 1) * rows] for x in want[:5]]
    sk = got[0].view(np.uint32)
    np.testing.assert_array_equal(sk, w[0])
    for g, x in zip(got[3:5], w[3:5]):
        np.testing.assert_array_equal(g, x)
    _assert_same_rows([sk, got[1].view(np.uint32), got[2].view(np.uint32)],
                      w[:3])


@pytest.mark.parametrize("D", WORLDS)
def test_hash_join_step_matches_jax(world, D):
    cols = worker.join_step_inputs(D)
    nl, nr = cols[0].shape[0] // D, cols[3].shape[0] // D
    want = [np.asarray(x) for x in jjoin.make_hash_join_step(
        make_mesh(D), nl, nr, nl + nr)(*map(jnp.asarray, cols))]
    for d, got in enumerate(_steps(world, D, "hash_join_step")):
        _check_join_step(got, want, d, D)
        assert got[5][0] == want[5][d]


@pytest.mark.parametrize("D", WORLDS)
def test_broadcast_join_step_matches_jax(world, D):
    cols = worker.join_step_inputs(D)
    nl = cols[0].shape[0] // D
    want = [np.asarray(x) for x in jjoin.make_broadcast_join_step(
        make_mesh(D), nl, cols[3].shape[0])(*map(jnp.asarray, cols))]
    for d, got in enumerate(_steps(world, D, "broadcast_join_step")):
        _check_join_step(got, want, d, D)


@pytest.mark.parametrize("D", WORLDS)
def test_topk_step_matches_jax(world, D):
    """Keys ascend and values descend within a run in both packages, so
    every output matches slot for slot."""
    cols = worker.topk_step_inputs(D)
    n_local = cols[0].shape[0] // D
    want = [np.asarray(x) for x in jtopk.make_topk_step(
        make_mesh(D), n_local, n_local, worker.TOPK_STEP_K)(
        *map(jnp.asarray, cols))]
    for d, got in enumerate(_steps(world, D, "topk_step")):
        for g, w in zip(got, want):
            rows = w.shape[0] // D
            np.testing.assert_array_equal(g, w[d * rows:(d + 1) * rows])


# -- host level ---------------------------------------------------------------


def _concat_runs(runs):
    return (np.concatenate([k for k, _ in runs]),
            np.concatenate([v for _, v in runs]))


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", ["ts_uniform", "ts_ragged", "ts_max_key",
                                  "c1_u32", "c1_i16", "c1_f32"])
def test_terasort_runs_concatenate_to_jax_sort(world, D, name):
    """Rank r's run is a slice of the global sort; in rank order they
    are the JAX package's sort (test_models.py:16, :46, :79)."""
    keys, vals = worker.host_inputs(name)
    wk, wv = JTeraSorter(make_mesh(D)).sort(keys, vals)
    gk, gv = _concat_runs(_host(world, D, name))
    assert gk.dtype == keys.dtype and gv.dtype == vals.dtype
    np.testing.assert_array_equal(gk, np.asarray(wk))
    _assert_same_rows([gk, gv], [np.asarray(wk), np.asarray(wv)])


@pytest.mark.parametrize("D", WORLDS)
def test_terasort_skew_retries_on_every_rank(world, D):
    """test_models.py:33: one destination overflows at factor 1.05, and
    every rank re-runs the step with it."""
    keys, _ = worker.host_inputs("ts_skew")
    res = _host(world, D, "ts_skew")
    attempts = {a for _k, a in res}
    assert len(attempts) == 1 and attempts.pop() > 1
    np.testing.assert_array_equal(np.concatenate([k for k, _a in res]),
                                  np.sort(keys))


@pytest.mark.parametrize("D", WORLDS)
def test_terasort_empty_on_every_rank(world, D):
    for k, v in _host(world, D, "ts_empty"):
        assert k.size == 0 and v.size == 0


def _merged(dicts):
    out = {}
    for d in dicts:
        assert not set(out) & set(d), "a key is owned by two ranks"
        out.update(d)
    return out


def _assert_float_sums(got, want, oracle):
    assert set(got) == set(want) == set(oracle)
    for k, g in got.items():
        assert abs(g - oracle[k]) <= F32_SUM_ATOL, (k, g, oracle[k])
        assert abs(g - want[k]) <= 1 + F32_SUM_ATOL, (k, g, want[k])


def _f64_sums(keys, vals):
    u, inv = np.unique(keys, return_inverse=True)
    return dict(zip(u.tolist(), np.bincount(
        inv, weights=vals.astype(np.float64)).tolist()))


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", ["wc_basic", "wc_weighted", "wc_max_key",
                                  "c1_u32", "c1_i16"])
def test_wordcount_matches_jax(world, D, name):
    """test_models.py:56, :65, :79 and the dtypes the JAX package takes:
    the ranks' dicts are disjoint and their union is the JAX count."""
    want = JWordCounter(make_mesh(D)).count(*worker.host_inputs(name))
    assert _merged(_host(world, D, f"wc:{name}")) == want


@pytest.mark.parametrize("D", WORLDS)
def test_wordcount_float_values_match_jax(world, D):
    keys, vals = worker.host_inputs("c1_f32")
    want = JWordCounter(make_mesh(D)).count(keys, vals)
    got = _merged(_host(world, D, "wc:c1_f32"))
    assert all(isinstance(s, float) for s in got.values())
    _assert_float_sums(got, want, _f64_sums(keys, vals))


@pytest.mark.parametrize("D", WORLDS)
def test_wordcount_hot_key_retries_on_every_rank(world, D):
    """test_models.py:72: every record on one key, one rank."""
    res = _host(world, D, "wc:wc_hot")
    assert _merged([c for c, _a in res]) == {77: 10_000}
    attempts = {a for _c, a in res}
    assert len(attempts) == 1 and attempts.pop() > 1


@pytest.mark.parametrize("D", WORLDS)
def test_uint32_keys_land_on_jax_ranks(world, D):
    """Each rank owns exactly the uint32 keys the JAX exchange puts on
    its device (the hash reads the unflipped bits)."""
    keys = worker.host_inputs("c1_u32")[0]
    (uniq, _s, counts, _n, _f), _cap = JWordCounter(make_mesh(D)).count_device(
        jnp.asarray(keys), jnp.ones(keys.shape[0], jnp.uint32))
    uniq = np.asarray(uniq).reshape(D, -1)
    counts = np.asarray(counts).reshape(D, -1)
    for d, got in enumerate(_host(world, D, "wc:c1_u32_ones")):
        want = uniq[d][counts[d] > 0]
        assert sorted(got) == sorted(want.tolist())
        assert sum(got.values()) == int(counts[d].sum())


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", ["agg_full", "agg_sentinel", "c1_u32",
                                  "c1_i16"])
def test_aggregate_matches_jax(world, D, name):
    """test_models.py:208, :228 and the dtypes the JAX package takes."""
    want = JAggregator(make_mesh(D)).aggregate(*worker.host_inputs(name))
    assert _merged(_host(world, D, f"agg:{name}")) == \
        {k: tuple(s) for k, s in want.items()}


@pytest.mark.parametrize("D", WORLDS)
def test_aggregate_float_values_match_jax(world, D):
    keys, vals = worker.host_inputs("c1_f32")
    want = JAggregator(make_mesh(D)).aggregate(keys, vals)
    got = _merged(_host(world, D, "agg:c1_f32"))
    _assert_float_sums({k: s[0] for k, s in got.items()},
                       {k: s.sum for k, s in want.items()},
                       _f64_sums(keys, vals))
    for k, (_s, c, mn, mx) in got.items():
        sel = vals[keys == k]
        assert (c, mn, mx) == (sel.size, float(sel.min()), float(sel.max()))
        assert (c, int(mn), int(mx)) == tuple(want[k])[1:]


@pytest.mark.parametrize("D", WORLDS)
def test_aggregate_skew_retries_on_every_rank(world, D):
    """test_models.py:240."""
    keys, vals = worker.host_inputs("agg_skew")
    want = JAggregator(make_mesh(D), capacity_factor=1.1).aggregate(keys,
                                                                    vals)
    res = _host(world, D, "agg:agg_skew")
    assert _merged([s for s, _a in res]) == \
        {k: tuple(s) for k, s in want.items()}
    attempts = {a for _s, a in res}
    assert len(attempts) == 1 and attempts.pop() > 1


TOPK_PARAMS = [("topk", k) for k in worker.TOPK_KS] + [
    (name, k) for name in ("topk_u32", "topk_i16")
    for k in worker.TOPK_DTYPE_KS]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name,k", TOPK_PARAMS)
def test_grouped_topk_matches_jax(world, D, name, k):
    """test_models.py:641, and uint32 and int16 values."""
    want = jtopk.GroupedTopK(make_mesh(D)).top_k(*worker.host_inputs(name),
                                                k)
    assert _merged(_host(world, D, f"{name}:{k}")) == want


def _join_rows(outs):
    """The union of the ranks' join outputs, as sorted rows."""
    cols = [np.concatenate(c) for c in zip(*outs)]
    return sorted(zip(*(c.tolist() for c in cols)))


def _jax_join(cls, name, how, D):
    fk, fv, dk, dv = worker.host_inputs(name)
    kw = dict(capacity_factor=1.1) if name == "join_skew" else {}
    return cls(make_mesh(D), **kw).join(fk, fv, dk, dv, how=how)


JOIN_PARAMS = [(n, "inner") for n in worker.JOIN_CASES[:-1]] + \
    [("join_variants", h) for h in worker.JOIN_HOWS]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name,how", JOIN_PARAMS)
def test_hash_join_matches_jax(world, D, name, how):
    """test_models.py:136, :146, :164, :181, :197 and :551: the union of
    the ranks' rows is the JAX join."""
    res = _host(world, D, f"hash:{name}:{how}")
    want = _jax_join(jjoin.HashJoiner, name, how, D)
    assert _join_rows([r for r, _a in res]) == _join_rows([want])
    attempts = {a for _r, a in res}
    assert len(attempts) == 1
    if name == "join_skew":
        assert attempts.pop() > 1


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name,how", JOIN_PARAMS)
def test_broadcast_join_matches_jax(world, D, name, how):
    res = _host(world, D, f"broadcast:{name}:{how}")
    want = _jax_join(jjoin.BroadcastJoiner, name, how, D)
    assert _join_rows(res) == _join_rows([want])


def _j_gk17(ku):
    return ku % jnp.asarray(17, ku.dtype)


def _j_xor(ku, fact_pay_u, dim_val_u):
    return (jax.lax.bitcast_convert_type(fact_pay_u, jnp.int32)
            ^ jax.lax.bitcast_convert_type(dim_val_u, jnp.int32))


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", worker.JA_CASES)
def test_join_aggregate_matches_jax_on_every_rank(world, D, name):
    """test_models.py:486 and :518: every rank ends with the whole
    merged table, the JAX package's."""
    fk, fv, dk, dv = worker.host_inputs(name)
    hooks = (_j_gk17, _j_xor) if name == "ja_fused" else ()
    want = jja.BroadcastJoinAggregator(make_mesh(D)).join_aggregate(
        fk, fv, dk, dv, *hooks)
    want = {k: tuple(s) for k, s in want.items()}
    for got in _host(world, D, name):
        assert got == want


@pytest.mark.parametrize("D", WORLDS)
def test_external_sort_refuses_mixed_dtypes_on_every_rank(world, D):
    """A group whose ranks feed different dtypes: every rank refuses at
    the splitter gather (none waits in a later collective)."""
    for r in world(D):
        assert "different (key, value) dtypes" in r["external_sort_error"]
        assert "int64" in r["external_sort_error"]


def _ext(world, D, name):
    return [r["ext"][name] for r in world(D)]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("name", sorted(worker.EXT_CASES))
def test_external_sort_matches_jax(world, D, name, tmp_path):
    """tests/test_models.py:316-400 over D ranks, each feeding its own
    chunk stream (``random``: 2 + r chunks on rank r; ``zero_chunks``:
    none on rank 0; ``single``: one record on rank 0 and no chunk
    elsewhere), against the JAX ``ExternalTeraSorter`` on
    ``make_mesh(D)`` fed chunk i = the concatenation over ranks of their
    chunk i.  Every rank yields one run per non-empty bucket; the runs
    concatenated over buckets, and within a bucket over ranks, are the
    JAX sort: keys bit for bit, values within equal keys.  The bucket
    statistics are the same on every rank, and the spill files are
    gone."""
    ranks = _ext(world, D, name)
    kw = worker.EXT_CASES[name]
    chunks = worker.ext_global_chunks(name, D)
    js = jext.ExternalTeraSorter(make_mesh(D), spill_dir=str(tmp_path), **kw)
    wouts = list(js.sort_chunks(iter(chunks)))
    assert len({len(r["outs"]) for r in ranks}) == 1
    runs = [r["outs"][b] for b in range(len(ranks[0]["outs"]))
            for r in ranks]
    if not wouts:
        assert not runs
        return
    gk, gv = _concat_runs(runs)
    wk, wv = (np.concatenate([np.asarray(x[j]) for x in wouts])
              for j in (0, 1))
    assert gk.dtype == wk.dtype and gv.dtype == wv.dtype
    np.testing.assert_array_equal(gk, wk)
    _assert_same_rows([gk, gv], [wk, wv])
    np.testing.assert_array_equal(
        gk, np.sort(np.concatenate([k for k, _ in chunks])))
    stats = {r["stats"][2:] for r in ranks}
    assert len(stats) == 1
    max_bucket, resplit = stats.pop()
    assert sum(r["stats"][0] for r in ranks) == sum(
        len(worker.ext_chunks(name, d, D)) for d in range(D))
    assert all(not r["left"] for r in ranks)
    if name == "sorted_resplit":
        assert resplit >= 1 and js.buckets_resplit >= 1
        assert max_bucket <= 2000
    if name == "balanced":
        assert resplit == 0 == js.buckets_resplit


@pytest.mark.parametrize("D", WORLDS)
def test_external_sort_sort_owns_a_range(world, D):
    """``sort`` of this rank's shard returns what this rank owns: its
    range of each bucket, concatenated, so sorted; the ranks' rows
    together are the JAX sort's."""
    keys, vals = worker.host_inputs("ts_uniform")
    keys, vals = keys[:20_000], vals[:20_000]
    wk, wv = jext.ExternalTeraSorter(make_mesh(D), num_buckets=8).sort(
        keys, vals)
    got = [r["ext"]["sort"] for r in world(D)]
    gk, gv = _concat_runs(got)
    np.testing.assert_array_equal(np.sort(gk), np.asarray(wk))
    _assert_same_rows([gk, gv], [np.asarray(wk), np.asarray(wv)])
    for k, _v in got:
        assert (np.diff(k) >= 0).all()
