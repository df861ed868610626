"""One rank of a gloo world for tests/test_torch_exchange.py.

    python tests/torch_exchange_worker.py RANK WORLD STORE_FILE OUT_DIR

Joins a ``world``-rank gloo group over a ``file://`` store (no TCP
port), runs every step, host and external-sort case (:data:`EXT_CASES`)
on this rank's shard or chunk stream through ``sparkrdma_tpu_torch``,
and pickles the results to ``OUT_DIR/rank<RANK>.pkl``.  Imports torch,
numpy and ``sparkrdma_tpu_torch`` only: neither JAX nor the tests'
conftest.  The test module imports it for the input builders, so both
sides build the same inputs from the same seeds.

Step cases take the JAX package's shards: rank d gets rows ``[d *
n_local, (d + 1) * n_local)`` of the global columns, which is what
``shard_map`` hands device d.  Host cases split the global input into
``world`` contiguous, possibly ragged, shards (``np.array_split``).
"""

import os
import pickle
import sys

import numpy as np
import torch

I32 = np.iinfo(np.int32)
U32_MAX = (1 << 32) - 1


# -- inputs ------------------------------------------------------------------


def shard(x, rank, world):
    """Rank ``rank``'s contiguous, possibly ragged, shard of ``x``."""
    return np.array_split(x, world)[rank]


def step_shard(x, rank, world):
    """Rank ``rank``'s equal shard of ``x`` (the ``shard_map`` split)."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _rng(seed):
    return np.random.default_rng(seed)


def _int_keys(rng, n, lo, hi, dtype=np.int32):
    k = rng.integers(lo, hi, n).astype(dtype)
    info = np.iinfo(dtype)
    k[:3] = [info.max, info.min, info.max]  # real keys at the sentinel
    return k


def exchange_inputs(name, world):
    """Global (keys, vals, valid, capacity) of a hash_exchange case:
    int32, uint32 (with float32 values) and int16 keys."""
    n_local = 256
    n = n_local * world
    rng = _rng({"i32": 1, "u32": 2, "i16": 3}[name])
    if name == "i32":
        keys = _int_keys(rng, n, -50, 50)
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
    elif name == "u32":
        keys = rng.integers(0, U32_MAX, n, endpoint=True).astype(np.uint32)
        keys[:3] = [U32_MAX, 0, 1 << 31]
        vals = rng.standard_normal(n).astype(np.float32)
    else:
        keys = _int_keys(rng, n, -300, 300, np.int16)
        vals = rng.integers(-30000, 30000, n).astype(np.int16)
    valid = (rng.random(n) < 0.8).astype(np.int32)
    return keys, vals, valid, n_local


def sort_inputs(name, world):
    """Global (keys, vals, valid or None) of a TeraSort step case."""
    rng = _rng({"valid": 4, "full": 5, "u32": 6, "i16": 7,
                "arbitrary_valid": 8}[name])
    n = 512 * world
    if name == "arbitrary_valid":
        # invalid slots carry arbitrary keys (test_models.py:95)
        n = 8 * 1024
        keys = rng.integers(0, 1 << 31, n).astype(np.int32)
        vals = rng.integers(0, 1 << 31, n).astype(np.int32)
        return keys, vals, (rng.random(n) < 0.7).astype(np.int32)
    if name == "u32":
        keys = rng.integers(0, U32_MAX, n, endpoint=True).astype(np.uint32)
        keys[:2] = U32_MAX
        return keys, rng.standard_normal(n).astype(np.float32), None
    if name == "i16":
        keys = _int_keys(rng, n, -200, 200, np.int16)
        vals = rng.integers(-30000, 30000, n).astype(np.int16)
    else:
        keys = _int_keys(rng, n, -(1 << 20), 1 << 20)
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = None if name == "full" else \
        (rng.random(n) < 0.8).astype(np.int32)
    return keys, vals, valid


WIDE_SIZES = (8 * 512, 8 * 2048)  # test_models.py:662
WIDE_W = 24


def wide_inputs(n):
    rng = _rng(17 + n)
    keys = rng.integers(0, 1 << 31, n).astype(np.int32)
    payload = rng.integers(0, 1 << 31, (n, WIDE_W)).astype(np.int32)
    payload[:, 0] = keys
    return keys, payload


def join_case(seed, n_fact, n_dim, key_space):
    """test_models.py's ``_join_case``: unique dimension keys."""
    rng = _rng(seed)
    dk = rng.choice(key_space, size=n_dim, replace=False).astype(np.int32)
    dv = rng.integers(0, 1 << 30, size=n_dim, dtype=np.int32)
    fk = rng.integers(0, key_space, size=n_fact, dtype=np.int32)
    fv = rng.integers(0, 1 << 30, size=n_fact, dtype=np.int32)
    return fk, fv, dk, dv


def join_step_inputs(world):
    """Global step columns (lk, lv, l_valid, rk, rv, r_valid) with about
    10% of each side invalid, n_left 256 and n_right 64 per rank."""
    nl, nr = 256 * world, 64 * world
    fk, fv, dk, dv = join_case(31, nl, nr, 4 * nr)
    rng = _rng(32)
    fk[:2] = [I32.max, I32.min]
    return (fk, fv, (rng.random(nl) < 0.9).astype(np.int32), dk, dv,
            (rng.random(nr) < 0.9).astype(np.int32))


def topk_step_inputs(world):
    rng = _rng(33)
    n = 512 * world
    keys = rng.integers(-40, 40, n).astype(np.int32)
    vals = rng.integers(-9, 9, n).astype(np.int32)
    valid = (rng.random(n) < 0.8).astype(np.int32)
    return keys, vals, valid


TOPK_STEP_K = 5


def _skew_sort_keys():
    """test_models.py:33 with the hot range cut from 100 keys to 3, so
    that one destination overflows at D = 2 and 4 too."""
    rng = _rng(1)
    keys = np.concatenate([rng.integers(0, 3, 60_000, dtype=np.int32),
                           rng.integers(0, 1 << 30, 40_000, dtype=np.int32)])
    rng.shuffle(keys)
    return keys


def _c1_keys(dtype, seed, n=3000):
    """The re-anchor's dtype cases: uint32 keys over the whole range
    (sign bit set on half), or int16 keys with both extremes."""
    rng = _rng(seed)
    if dtype == "u32":
        pool = rng.integers(0, U32_MAX, 97, endpoint=True).astype(np.uint32)
        pool[:2] = [U32_MAX, 0]
        return pool[rng.integers(0, 97, n)]
    k = rng.integers(-150, 150, n).astype(np.int16)
    k[:4] = [32767, -32768, 32767, -1]
    return k


def host_inputs(name):
    """Global inputs of a host case (a tuple of numpy columns)."""
    rng = _rng(100 + sum(map(ord, name)))
    if name == "ts_uniform":
        return (rng.integers(0, 1 << 31, 100_000, dtype=np.int32),
                rng.integers(0, 1 << 31, 100_000, dtype=np.int32))
    if name == "ts_skew":
        k = _skew_sort_keys()
        return k, k
    if name == "ts_ragged":
        k = np.array([5, 3, 9], np.int32)
        return k, k * 10
    if name == "ts_max_key":
        return (np.array([I32.max, 1, I32.max, 3, 2], np.int32),
                np.array([10, 11, 12, 13, 14], np.int32))
    if name in ("c1_u32", "c1_i16"):
        k = _c1_keys(name[3:], 41)
        return k, rng.integers(-1000, 1000, k.shape[0]).astype(k.dtype)
    if name == "c1_f32":
        k = rng.integers(-60, 60, 3000).astype(np.int32)
        return k, (rng.standard_normal(3000) * 100).astype(np.float32)
    if name == "wc_basic":
        return (_rng(2).integers(0, 1000, size=50_000, dtype=np.int32),)
    if name == "wc_weighted":
        return (np.array([1, 2, 1, 3, 2, 1], np.int32),
                np.array([10, 20, 30, 40, 50, 60], np.int32))
    if name == "wc_hot":
        return (np.full(10_000, 77, np.int32),)
    if name == "wc_max_key":
        return (np.array([I32.max, I32.max, 5], np.int32),)
    if name == "agg_full":
        r = _rng(12)
        return (r.integers(0, 300, 20000).astype(np.int32),
                r.integers(-1000, 1000, 20000).astype(np.int32))
    if name == "agg_sentinel":
        return (np.array([I32.max, 5, I32.max, 5, I32.max], np.int32),
                np.array([7, -2, 3, 4, -9], np.int32))
    if name == "agg_skew":
        r = _rng(13)
        keys = np.concatenate([np.full(9000, 17, np.int32),
                               r.integers(0, 50, 1000).astype(np.int32)])
        return keys, np.arange(10000, dtype=np.int32)
    if name == "topk":
        r = _rng(42)
        return (r.integers(0, 67, 20011, dtype=np.int32),
                r.integers(-1000, 1000, 20011, dtype=np.int32))
    if name in ("topk_u32", "topk_i16"):
        k = rng.integers(0, 40, 2000).astype(np.int32)
        if name == "topk_u32":
            v = rng.integers(0, U32_MAX, 2000, endpoint=True).astype(
                np.uint32)
            v[:2] = [U32_MAX, 0]
        else:
            v = rng.integers(-32768, 32767, 2000, endpoint=True).astype(
                np.int16)
        return k, v
    if name == "join_random":
        return join_case(5, 4000, 300, 1000)
    if name == "join_skew":
        r = _rng(9)
        fk = np.concatenate([np.full(7000, 42, np.int32),
                             r.integers(0, 500, size=3000, dtype=np.int32)])
        dk = np.arange(500, dtype=np.int32)
        return fk, np.arange(10000, dtype=np.int32), dk, dk * 3
    if name == "join_max_fact":
        return (np.array([1, 2, I32.max, 5], np.int32),
                np.array([10, 20, 30, 50], np.int32),
                np.array([1, 2, 3], np.int32),
                np.array([100, 200, 300], np.int32))
    if name == "join_max_dim":
        return (np.array([I32.max, 7], np.int32), np.array([1, 2], np.int32),
                np.array([I32.max, 7], np.int32),
                np.array([111, 77], np.int32))
    if name == "join_empty_dim":
        return (np.array([1, 2, 3, 4], np.int32),
                np.array([10, 20, 30, 40], np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    if name == "join_variants":
        return join_case(23, 5000, 250, 900)
    if name == "ja_fused":
        fk, fv, dk, dv = join_case(11, 4096, 300, 1000)
        return fk, fv, dk, dv - (1 << 29)
    if name == "ja_defaults":
        return (np.array([1, 1, 2, I32.max, 9], np.int32),
                np.array([10, 11, 20, 30, 90], np.int32),
                np.array([1, 2], np.int32), np.array([-5, 7], np.int32))
    if name == "ja_negative":
        return (np.array([-5, -5, 3], np.int32), np.array([1, 2, 3], np.int32),
                np.array([-5, 3], np.int32), np.array([100, 200], np.int32))
    raise KeyError(name)


TOPK_KS = (1, 3, 500)   # test_models.py:641
TOPK_DTYPE_KS = (3,)    # test_torch_slice.py covers more k at D = 1
JOIN_CASES = ("join_random", "join_skew", "join_max_fact", "join_max_dim",
              "join_empty_dim", "join_variants")
JA_CASES = ("ja_fused", "ja_defaults", "ja_negative")
JOIN_HOWS = ("inner", "left_outer", "semi", "anti")


def ja_gk17(ku):
    return ku % 17


def ja_xor(ku, fact_pay_u, dim_val_u):
    return (fact_pay_u ^ dim_val_u).to(torch.int32)


# -- external sort: each rank feeds its own chunk stream ---------------------


def _rank_parts(chunks, rank, world):
    """Rank ``rank``'s part of each global chunk (``np.array_split``)."""
    return [tuple(np.array_split(x, world)[rank] for x in c) for c in chunks]


def ext_chunks(name, rank, world):
    """Rank ``rank``'s chunk stream of an external-sort case, a list of
    (keys, vals); the JAX package's chunk i is the concatenation over
    ranks of their chunk i (:func:`ext_global_chunks`)."""
    rng = _rng(200 + sum(map(ord, name)) + 7 * rank)
    if name == "random":  # rank r holds 2 + r chunks of ragged sizes
        return [(rng.integers(0, 1 << 30, n).astype(np.int32),
                 rng.integers(0, 1 << 30, n).astype(np.int32))
                for n in rng.integers(200, 1500, 2 + rank)]
    if name == "zero_chunks":  # rank 0 none, rank r > 0 r chunks
        out = [(rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32),
                rng.integers(0, 1 << 30, n).astype(np.int32))
               for n in rng.integers(100, 900, rank)]
        if rank == world - 1:  # an empty chunk first
            out.insert(0, (np.zeros(0, np.int32), np.zeros(0, np.int32)))
        return out
    if name == "sorted_resplit":  # test_models.py:344, split by rank
        keys = np.arange(16000, dtype=np.int32)
        vals = keys[::-1].copy()
        return _rank_parts([(keys[i:i + 2000], vals[i:i + 2000])
                            for i in range(0, 16000, 2000)], rank, world)
    if name == "balanced":  # test_models.py:372
        ks = _rng(51).integers(0, 1 << 30, (16, 1000)).astype(np.int32)
        return _rank_parts([(k, k.copy()) for k in ks], rank, world)
    if name == "duplicate_heavy":  # test_models.py:386
        keys = np.concatenate([np.arange(2000, dtype=np.int32),
                               np.full(14000, 7_000_000, np.int32)])
        vals = np.arange(len(keys), dtype=np.int32)
        return _rank_parts([(keys[i:i + 2000], vals[i:i + 2000])
                            for i in range(0, 16000, 2000)], rank, world)
    if name == "empty":
        return [(np.zeros(0, np.int32), np.zeros(0, np.int32))]
    if name == "single":  # one record on rank 0, no chunk elsewhere
        return [(np.array([5], np.int32), np.array([7], np.int32))] \
            if rank == 0 else []
    raise KeyError(name)


def ext_global_chunks(name, world):
    """The JAX package's chunk stream: chunk i is the concatenation over
    ranks of each rank's chunk i, where it has one."""
    streams = [ext_chunks(name, r, world) for r in range(world)]
    return [tuple(np.concatenate([s[i][j] for s in streams if i < len(s)])
                  for j in (0, 1))
            for i in range(max(map(len, streams)))]


# name: ExternalTeraSorter arguments (tests/test_models.py:316-400)
EXT_CASES = {
    "random": dict(num_buckets=8, sample_per_chunk=256),
    "zero_chunks": dict(num_buckets=8, sample_per_chunk=256),
    "sorted_resplit": dict(num_buckets=8, sample_per_chunk=256),
    "balanced": dict(num_buckets=4, sample_per_chunk=512),
    "duplicate_heavy": dict(num_buckets=8, sample_per_chunk=128),
    "empty": dict(num_buckets=4),
    "single": dict(num_buckets=4),
}


def run_external_sort_cases(rank, world, group, out_dir):
    from sparkrdma_tpu_torch import ExternalTeraSorter

    out = {}
    for name, kw in EXT_CASES.items():
        spill = os.path.join(out_dir, f"spill_{name}_{rank}")
        os.makedirs(spill)
        ext = ExternalTeraSorter(device="cpu", group=group, spill_dir=spill,
                                 **kw)
        outs = list(ext.sort_chunks(iter(ext_chunks(name, rank, world))))
        out[name] = dict(outs=outs, left=os.listdir(spill), stats=(
            ext.chunks_in, ext.bytes_spilled, ext.max_bucket_records,
            ext.buckets_resplit))
    keys, vals = host_inputs("ts_uniform")
    out["sort"] = ExternalTeraSorter(device="cpu", group=group,
                                     num_buckets=8).sort(
        shard(keys[:20_000], rank, world), shard(vals[:20_000], rank, world))
    return out


# -- the cases on this rank --------------------------------------------------


def _np(*tensors):
    return tuple(t.detach().cpu().numpy() for t in tensors)


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)) for a in arrays)


def run_step_cases(rank, world, group):
    from sparkrdma_tpu_torch import TeraSorter
    from sparkrdma_tpu_torch.models import join as tjoin
    from sparkrdma_tpu_torch.models import topk as ttopk
    from sparkrdma_tpu_torch.models._base import (
        carry_keys,
        carry_values,
        restore_keys,
        restore_values,
    )
    from sparkrdma_tpu_torch.ops.exchange import hash_exchange

    out = {}
    for name in ("i32", "u32", "i16"):
        keys, vals, valid, cap = exchange_inputs(name, world)
        k, v, m = _t(*(step_shard(x, rank, world) for x in (keys, vals,
                                                           valid)))
        ek, ev, em, fill = hash_exchange(
            carry_keys(k), carry_values(v, "sum"), m, world, cap, group,
            unsigned_keys=k.dtype == torch.uint32)
        out[f"hx_{name}"] = _np(restore_keys(ek, k.dtype),
                                restore_values(ev, v.dtype, "sum"), em,
                                fill.reshape(1))
    sorter = TeraSorter(group=group)
    for name in ("valid", "full", "u32", "i16", "arbitrary_valid"):
        keys, vals, valid = sort_inputs(name, world)
        k, v, m = _t(*(None if x is None else step_shard(x, rank, world)
                       for x in (keys, vals, valid)))
        res, cap = sorter.sort_device(k, v, m)
        out[f"sort_{name}"] = (_np(*res), cap)
    for n in WIDE_SIZES:
        k, p = _t(*(step_shard(x, rank, world) for x in wide_inputs(n)))
        res, cap = sorter.sort_device_wide(k, p)
        out[f"wide_{n}"] = (_np(*res), cap)
    cols = join_step_inputs(world)
    fact = _t(*(step_shard(x, rank, world) for x in cols[:3]))
    dim_mine = _t(*(step_shard(x, rank, world) for x in cols[3:]))
    dim_all = _t(*cols[3:])
    nl, nr = fact[0].shape[0], dim_mine[0].shape[0]
    out["hash_join_step"] = _np(*tjoin.make_hash_join_step(
        world, nl, nr, nl + nr, group)(*fact, *dim_mine))
    out["broadcast_join_step"] = _np(*tjoin.make_broadcast_join_step(
        world, nl, dim_all[0].shape[0], group)(*fact, *dim_all))
    k, v, m = _t(*(step_shard(x, rank, world)
                   for x in topk_step_inputs(world)))
    out["topk_step"] = _np(*ttopk.make_topk_step(
        world, k.shape[0], k.shape[0], TOPK_STEP_K, group)(k, v, m))
    return out


def run_host_cases(rank, world, group):
    from sparkrdma_tpu_torch import (
        BroadcastJoinAggregator,
        BroadcastJoiner,
        GroupedTopK,
        HashJoiner,
        KeyedAggregator,
        TeraSorter,
        WordCounter,
    )

    def mine(name):
        return tuple(shard(x, rank, world) for x in host_inputs(name))

    out = {}
    for name in ("ts_uniform", "ts_ragged", "ts_max_key", "c1_u32",
                 "c1_i16", "c1_f32"):
        out[name] = TeraSorter(group=group).sort(*mine(name))
    sorter = TeraSorter(group=group, capacity_factor=1.05)
    out["ts_skew"] = (sorter.sort(*mine("ts_skew"))[0], sorter.attempts)
    out["ts_empty"] = TeraSorter(group=group).sort(np.zeros(0, np.int32))
    for name in ("wc_basic", "wc_weighted", "wc_max_key", "c1_u32",
                 "c1_i16", "c1_f32"):
        out[f"wc:{name}"] = WordCounter(group=group).count(*mine(name))
    wc = WordCounter(group=group, capacity_factor=1.1)
    out["wc:wc_hot"] = (wc.count(*mine("wc_hot")), wc.attempts)
    out["wc:c1_u32_ones"] = WordCounter(group=group).count(
        mine("c1_u32")[0])
    for name in ("agg_full", "agg_sentinel", "c1_u32", "c1_i16", "c1_f32"):
        out[f"agg:{name}"] = {
            k: tuple(s) for k, s in
            KeyedAggregator(group=group).aggregate(*mine(name)).items()}
    agg = KeyedAggregator(group=group, capacity_factor=1.1)
    out["agg:agg_skew"] = (
        {k: tuple(s) for k, s in agg.aggregate(*mine("agg_skew")).items()},
        agg.attempts)
    for name, ks in (("topk", TOPK_KS), ("topk_u32", TOPK_DTYPE_KS),
                     ("topk_i16", TOPK_DTYPE_KS)):
        for kk in ks:
            out[f"{name}:{kk}"] = GroupedTopK(group=group).top_k(
                *mine(name), kk)
    for name in JOIN_CASES:
        fk, fv, dk, dv = host_inputs(name)
        my_f = (shard(fk, rank, world), shard(fv, rank, world))
        my_d = (shard(dk, rank, world), shard(dv, rank, world))
        hows = JOIN_HOWS if name == "join_variants" else ("inner",)
        for how in hows:
            hj = HashJoiner(group=group, **(
                dict(capacity_factor=1.1) if name == "join_skew" else {}))
            out[f"hash:{name}:{how}"] = (hj.join(*my_f, *my_d, how=how),
                                         hj.attempts)
            out[f"broadcast:{name}:{how}"] = BroadcastJoiner(
                group=group).join(*my_f, dk, dv, how=how)
    for name in JA_CASES:
        fk, fv, dk, dv = host_inputs(name)
        hooks = (ja_gk17, ja_xor) if name == "ja_fused" else ()
        got = BroadcastJoinAggregator(group=group).join_aggregate(
            shard(fk, rank, world), shard(fv, rank, world), dk, dv, *hooks)
        out[name] = {k: tuple(s) for k, s in got.items()}
    return out


def run_refusals(rank, group):
    """Ranks that feed the external sort different dtypes (int32 keys on
    even ranks, int64 on odd) all refuse at the splitter gather."""
    from sparkrdma_tpu_torch import ExternalTeraSorter

    dt = np.int64 if rank % 2 else np.int32
    keys = np.arange(10, dtype=dt)
    try:
        list(ExternalTeraSorter(device="cpu", group=group,
                                num_buckets=4).sort_chunks([(keys, keys)]))
        return ""
    except ValueError as e:
        return str(e)


def run_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from sparkrdma_tpu_torch import ExchangeGroup

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        group = ExchangeGroup(dist.group.WORLD, device="cpu")
        out = {"steps": run_step_cases(rank, world, group),
               "host": run_host_cases(rank, world, group),
               "ext": run_external_sort_cases(rank, world, group, out_dir),
               "external_sort_error": run_refusals(rank, group)}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
