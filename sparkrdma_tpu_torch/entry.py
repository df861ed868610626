"""The port's driver entry points: the counterpart of ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)``: the forward step of the
flagship model, one distributed-sort step (sample, range partition,
all_to_all, local sort; ``models/terasort.py::make_sort_step``) over
this rank's 8192 rows, and seeded int32 keys, values and the validity
mask for it, on the card unless the caller passes ``device="cpu"``.
``fn(*example_args)`` returns ``(keys' [D * capacity], vals', n_valid[1],
max_fill[1])``.

D is the size of the ``torch.distributed`` world when one is initialised
(one process per card, NCCL), else 1; at D > 1 each rank's args are its
contiguous shard of the seeded ``D * 8192`` rows, and the step exchanges
over the world.

``dryrun_multichip(n_ranks)`` runs every data-plane program once over a
world of ``n_ranks`` processes, one per rank (NCCL, card ``rank`` each;
gloo with ``device="cpu"``), on the JAX dry run's inputs
(:func:`dryrun_inputs`) and with its assertions: the TeraSort narrow
and wide steps, WordCount, ring against Ulysses attention, a multi-round
``TileExchange.exchange_bytes``, the hash and broadcast joins in four
variants, the fused join+aggregate, grouped top-k, the keyed
aggregator, ``RingExchange`` and the external sort; then, in rank 0, the
record plane (:func:`dryrun_record_plane`: the windowed plane under
``TpuShuffleContext`` and a windowed bulk session, over
``LoopbackNetwork``).  The JAX function runs one SPMD program over an
n-device mesh; here each rank passes its contiguous shard of the input
(what the mesh hands device ``rank``) and gets what it owns, so the
global properties are checked on the union of the ranks' results.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.models.terasort import TeraSorter, make_sort_step
from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, world_group

N_LOCAL = 8192
SAMPLE_SIZE = 256

# the dry run: rows per rank, as the JAX dry run's n = n_devices * 512
DRYRUN_ROWS = 512
# the fewest ranks the dry run takes (see dryrun_multichip)
DRYRUN_MIN_RANKS = 3
# bounds every collective of the dry run and the whole run
DRYRUN_TIMEOUT_S = 300.0
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5


Args = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def entry(device: DeviceLike = None) -> Tuple[Callable, Args]:
    """(fn, example_args) of one sort step on this rank's shard."""
    group = world_group(device)
    n_devices, rank = group.size, group.rank
    capacity = ((N_LOCAL // n_devices * 2) + 7) // 8 * 8
    fn = make_sort_step(n_devices, N_LOCAL, capacity,
                        sample_size=SAMPLE_SIZE, group=group)
    rng = np.random.default_rng(0)
    n = n_devices * N_LOCAL
    mine = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
    keys = rng.integers(0, 1 << 31, size=n, dtype=np.int32)[mine]
    vals = rng.integers(0, 1 << 31, size=n, dtype=np.int32)[mine]
    valid = np.ones(N_LOCAL, np.int32)
    return fn, tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(group.device)
        for x in (keys, vals, valid))


# -- the dry run ---------------------------------------------------------------


class DryRunError(AssertionError):
    """A dry-run case broke one of the JAX dry run's assertions."""


def _require(cond, what: str) -> None:
    if not cond:
        raise DryRunError(what)


def dryrun_inputs(n_ranks: int) -> Dict[str, object]:
    """The JAX dry run's inputs at ``n_devices = n_ranks``: drawn from
    ``np.random.default_rng(1)`` in its order, ``n = n_ranks * 512``."""
    D = int(n_ranks)
    rng = np.random.default_rng(1)
    n = D * DRYRUN_ROWS

    def ints(hi, size, lo=0):
        return rng.integers(lo, hi, size=size, dtype=np.int32)

    x: Dict[str, object] = {}
    x["terasort"] = (ints(1 << 31, n), ints(1 << 31, n))
    x["terasort_wide"] = (ints(1 << 31, n), ints(1 << 31, (n, 6)))
    x["wordcount"] = ints(50, n)
    H, S, d = D, D * 16, 8
    x["attention"] = tuple(rng.standard_normal((H, S, d)).astype(np.float32)
                           for _ in range(3))
    x["byte_exchange"] = [[bytes([(s * D + t) % 251]) * (128 * (s + t + 1))
                           for t in range(D)] for s in range(D)]
    dk = np.arange(0, 48, dtype=np.int32)  # keys 48..63 unmatched
    x["join"] = (ints(64, n), ints(1 << 20, n), dk, dk * 10)
    x["topk"] = (ints(7, n), ints(500, n, lo=-500))
    x["aggregate"] = (ints(9, n), ints(1000, n))
    x["ring"] = ints(100, (D, 16))
    x["external_sort"] = (ints(1 << 31, 2 * n), ints(1 << 31, 2 * n))
    return x


def _jax_loaded() -> bool:
    return any(m.split(".")[0] in ("jax", "sparkrdma_tpu")
               for m in sys.modules)


class _Rank:
    """One rank's view of the dry run: its group, its shard of each
    input, and the per-case times."""

    def __init__(self, group: ExchangeGroup, work_dir: str):
        self.group = group
        self.rank, self.D, self.dev = group.rank, group.size, group.device
        self.n = self.D * DRYRUN_ROWS
        self.mine = slice(self.rank * DRYRUN_ROWS,
                          (self.rank + 1) * DRYRUN_ROWS)
        self.work_dir = work_dir
        self.x = dryrun_inputs(self.D)
        self.seconds: Dict[str, float] = {}

    def timed(self, name: str, fn):
        """``fn()``, started together on every rank, its seconds kept
        (to the end of its work on the card)."""
        dist.barrier(group=self.group.group)
        t0 = time.monotonic()
        res = fn()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.seconds[name] = time.monotonic() - t0
        return res

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        objs = [None] * self.D
        dist.all_gather_object(objs, obj, group=self.group.group)
        return objs

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def merged(self, name: str, owned: dict) -> dict:
        """The union of the ranks' owned keys; a key owned twice fails."""
        parts = self.gather(owned)
        out = {}
        for part in parts:
            out.update(part)
        _require(sum(map(len, parts)) == len(out),
                 f"{name} dryrun: a key is owned by two ranks")
        return out


def _columns(rows: list) -> tuple:
    """The ranks' column tuples, each column concatenated in rank
    order."""
    return tuple(np.concatenate([np.asarray(r[j]) for r in rows])
                 for j in range(len(rows[0])))


def _case_terasort(r: _Rank) -> tuple:
    keys, vals = r.x["terasort"]
    run = r.timed("terasort", lambda: TeraSorter(group=r.group).sort(
        keys[r.mine], vals[r.mine]))
    sk, sv = _columns(r.gather(run))
    _require(sk.shape == (r.n,) and bool((np.diff(sk) >= 0).all()),
             "sort dryrun failed")
    return sk, sv


def _case_terasort_wide(r: _Rank) -> dict:
    wkeys, wpay = r.x["terasort_wide"]
    sorter = TeraSorter(group=r.group, capacity_factor=2.0)
    (wk, wp, wvalid, wmax), wcap = r.timed(
        "terasort_wide", lambda: sorter.sort_device_wide(
            r.tensor(wkeys[r.mine]), r.tensor(wpay[r.mine])))
    nv = int(wvalid.reshape(-1)[0])
    # valid entries are a prefix of this rank's received rows
    rows = r.gather((nv, int(wmax.reshape(-1).max()),
                     wk[:nv].cpu().numpy(), wp[:nv].cpu().numpy()))
    n_valid = [row[0] for row in rows]
    max_fill = [row[1] for row in rows]
    _require(max(max_fill) <= wcap, "wide sort dryrun overflowed")
    _require(sum(n_valid) == r.n, "wide sort dryrun lost records")
    got_k = np.concatenate([row[2] for row in rows])
    got_p = np.concatenate([row[3][:, 0] for row in rows])
    _require(bool((np.diff(got_k) >= 0).all()), "wide sort dryrun not sorted")
    _require(np.array_equal(np.sort(wkeys), got_k),
             "wide sort dryrun keys not a permutation of input")
    kp: Dict[int, list] = {}
    for kk, row in zip(wkeys.tolist(), wpay[:, 0].tolist()):
        kp.setdefault(kk, []).append(row)
    for kk, pp in zip(got_k.tolist(), got_p.tolist()):
        # consuming multiset match: a gather that duplicates one payload
        # of a repeated key while dropping another must fail
        _require(pp in kp[kk], "wide sort dryrun payload detached from key")
        kp[kk].remove(pp)
    return dict(capacity=wcap, n_valid=n_valid, max_fill=max_fill,
                keys=[row[2] for row in rows],
                payload=[row[3] for row in rows])


def _case_wordcount(r: _Rank) -> dict:
    from sparkrdma_tpu_torch.models.wordcount import WordCounter

    keys = r.x["wordcount"]
    counts = r.merged("wordcount", r.timed(
        "wordcount", lambda: WordCounter(group=r.group).count(keys[r.mine])))
    _require(sum(counts.values()) == r.n, "wordcount dryrun failed")
    return counts


def _case_attention(r: _Rank) -> tuple:
    from sparkrdma_tpu_torch.models import ring_attention, ulysses_attention

    s = r.x["attention"][0].shape[1] // r.D
    q, k, v = (r.tensor(a[:, r.rank * s:(r.rank + 1) * s])
               for a in r.x["attention"])
    ring = r.timed("ring_attention", lambda: ring_attention(
        q, k, v, group=r.group, causal=True)).cpu().numpy()
    uly = r.timed("ulysses_attention", lambda: ulysses_attention(
        q, k, v, group=r.group, causal=True)).cpu().numpy()
    _require(np.allclose(ring, uly, rtol=ATTN_RTOL, atol=ATTN_ATOL),
             "ring vs ulysses attention dryrun mismatch")
    rows = r.gather((ring, uly))
    return tuple(np.concatenate([row[j] for row in rows], axis=1)
                 for j in (0, 1))


def _case_byte_exchange(r: _Rank) -> list:
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange

    streams = r.x["byte_exchange"]
    ex = TileExchange(r.group, tile_bytes=1 << 10, verify_integrity=True)
    out = r.timed("byte_exchange", lambda: ex.exchange_bytes(streams))
    mine = [bytes(out[r.rank][s]) for s in range(r.D)]
    out_all = r.gather(mine)
    _require(all(out_all[d][s] == streams[s][d]
                 for s in range(r.D) for d in range(r.D)),
             "byte exchange dryrun failed")
    return out_all


def _case_joins(r: _Rank) -> dict:
    from sparkrdma_tpu_torch.models.join import BroadcastJoiner, HashJoiner

    fk, fv, dk, dv = r.x["join"]
    f_mine = (fk[r.mine], fv[r.mine])
    # the hash join shuffles both sides, the broadcast join takes the
    # whole dimension table on every rank
    d_mine = tuple(np.array_split(c, r.D)[r.rank] for c in (dk, dv))
    expect_rows = int((fk < 48).sum())
    out = {}
    for name, joiner, dims in (("hash", HashJoiner(group=r.group), d_mine),
                               ("broadcast", BroadcastJoiner(group=r.group),
                                (dk, dv))):
        res = {how: _columns(r.gather(r.timed(
            f"{name}_join_{how}", lambda how=how: joiner.join(
                *f_mine, *dims, how=how))))
            for how in ("inner", "semi", "anti", "left_outer")}
        what = f"{type(joiner).__name__} dryrun"
        jk, _jfv, jdv = res["inner"]
        _require(jk.shape == (expect_rows,),
                 f"{what} row count {jk.shape[0]} != {expect_rows}")
        _require(bool((jdv == jk * 10).all()), f"{what} values")
        _require(res["semi"][0].shape == (expect_rows,), "semi dryrun")
        _require(res["anti"][0].shape == (r.n - expect_rows,), "anti dryrun")
        ok_, om = res["left_outer"][0], res["left_outer"][3]
        _require(ok_.shape == (r.n,) and int(om.sum()) == expect_rows,
                 "left-outer dryrun")
        out.update({f"{name}:{how}": cols for how, cols in res.items()})
    return out


def _stats(d: dict) -> dict:
    return {int(k): tuple(s) for k, s in d.items()}


def _case_join_aggregate(r: _Rank) -> dict:
    from sparkrdma_tpu_torch.models.join_aggregate import (
        BroadcastJoinAggregator,
    )

    fk, fv, dk, dv = r.x["join"]
    # at D > 1 every rank gets the merged groups of the whole join
    ja = r.timed("join_aggregate", lambda: BroadcastJoinAggregator(
        group=r.group).join_aggregate(fk[r.mine], fv[r.mine], dk, dv))
    _require(sum(s.count for s in ja.values()) == int((fk < 48).sum()),
             "join+aggregate dryrun count")
    return _stats(ja)


def _case_topk(r: _Rank) -> dict:
    from sparkrdma_tpu_torch.models.topk import GroupedTopK

    tk, tv = r.x["topk"]
    top = r.merged("topk", r.timed("topk", lambda: GroupedTopK(
        group=r.group).top_k(tk[r.mine], tv[r.mine], 3)))
    for kk in np.unique(tk):
        want = np.sort(tv[tk == kk])[::-1][:3].tolist()
        _require(top.get(int(kk)) == want, f"topk dryrun key {kk}")
    return top


def _case_aggregate(r: _Rank) -> dict:
    from sparkrdma_tpu_torch.models.aggregate import KeyedAggregator

    ak, av = r.x["aggregate"]
    stats = r.merged("aggregate", r.timed(
        "aggregate", lambda: KeyedAggregator(group=r.group).aggregate(
            ak[r.mine], av[r.mine])))
    _require(sum(s.count for s in stats.values()) == r.n,
             "aggregate dryrun count")
    _require(sum(s.sum for s in stats.values())
             == int(av.sum(dtype=np.int64)), "aggregate dryrun sum")
    return _stats(stats)


def _case_ring(r: _Rank) -> tuple:
    from sparkrdma_tpu_torch.parallel.ring import RingExchange

    shards = r.x["ring"]
    ring = RingExchange(r.group)
    mine = r.tensor(shards[r.rank])
    allv = r.timed("ring_all_shards",
                   lambda: ring.all_shards(mine)).cpu().numpy()
    for j in range(r.D):
        _require(bool((allv[j] == shards[(r.rank - j) % r.D]).all()),
                 "ring all_shards dryrun")
    red = r.timed("ring_reduce", lambda: ring.ring_reduce(
        mine, torch.zeros_like, lambda acc, _src, cur: acc + cur))
    red = red.cpu().numpy()
    _require(bool((red == shards.sum(axis=0)).all()), "ring_reduce dryrun")
    return np.stack(r.gather(allv)), np.stack(r.gather(red))


def _case_external_sort(r: _Rank) -> tuple:
    from sparkrdma_tpu_torch.models.external_sort import ExternalTeraSorter

    ek, ev = r.x["external_sort"]
    # rank r's chunk i is its shard of the JAX run's chunk i
    lo = r.rank * DRYRUN_ROWS
    chunks = [(ek[i * r.n + lo:i * r.n + lo + DRYRUN_ROWS],
               ev[i * r.n + lo:i * r.n + lo + DRYRUN_ROWS]) for i in (0, 1)]
    spill = tempfile.mkdtemp(prefix=f"spill{r.rank}_", dir=r.work_dir)
    ext = ExternalTeraSorter(group=r.group, num_buckets=4, spill_dir=spill)
    # a generator: every rank drains it, its collectives run as it is
    # drawn
    outs = r.timed("external_sort", lambda: list(ext.sort_chunks(chunks)))
    rows = r.gather(outs)
    _require(len({len(o) for o in rows}) == 1,
             "external sort dryrun: ranks yielded different bucket counts")
    # bucket b is the ranks' owned ranges of it, in rank order
    runs = [rows[q][b] for b in range(len(rows[0])) for q in range(r.D)]
    got_k = np.concatenate([k for k, _ in runs])
    got_v = np.concatenate([v for _, v in runs])
    _require(bool((np.diff(got_k) >= 0).all())
             and got_k.shape == (2 * r.n,), "external sort dryrun")
    return got_k, got_v


CASES = (
    ("terasort", _case_terasort),
    ("terasort_wide", _case_terasort_wide),
    ("wordcount", _case_wordcount),
    ("attention", _case_attention),
    ("byte_exchange", _case_byte_exchange),
    ("joins", _case_joins),
    ("join_aggregate", _case_join_aggregate),
    ("topk", _case_topk),
    ("aggregate", _case_aggregate),
    ("ring", _case_ring),
    ("external_sort", _case_external_sort),
)


def dryrun_record_plane(n_ranks: int, device: DeviceLike = None) -> dict:
    """The record-plane half of the dry run, in one process over
    ``LoopbackNetwork`` (no socket): the windowed plane under
    ``TpuShuffleContext`` (``reduce_by_key("sum")`` of 2048 columnar
    records over 67 keys on ``min(4, n_ranks)`` co-located executors,
    windows of 2 maps), then a windowed ``BulkShuffleSession`` over a
    co-located exchange (3 maps, windows of 2, one reader thread per
    executor).  Runs on ``device`` (CUDA unless the caller asks for the
    CPU); returns each result, and raises :class:`DryRunError` where the
    JAX dry run's assertions fail."""
    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange
    from sparkrdma_tpu_torch.shuffle.bulk import (
        BulkExchangeReader,
        BulkShuffleSession,
    )
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.transport import LoopbackNetwork

    dev = resolve_device(device)
    seconds = {}
    t0 = time.monotonic()
    conf = TpuShuffleConf()
    conf.set("readPlane", "windowed")
    conf.set("bulkWindowMaps", "2")
    conf.set("serializer", "columnar")
    n_exec = min(4, n_ranks)
    with TpuShuffleContext(num_executors=n_exec, conf=conf, base_port=48000,
                           device=dev) as ctx:
        nk = 2048
        keys = np.arange(nk, dtype=np.int64) % 67
        vals = np.arange(nk, dtype=np.int64)
        got = dict(
            ctx.parallelize_columns(keys, vals, num_slices=2 * n_exec)
            .reduce_by_key("sum", num_partitions=2 * n_exec)
            .collect()
        )
        expect: Dict[int, int] = {}
        for kk, vv in zip(keys.tolist(), vals.tolist()):
            expect[kk] = expect.get(kk, 0) + vv
        _require(got == expect, "windowed record-plane shuffle dryrun")
        # 2 * n_exec maps in windows of 2: one collective round or more
        # per window, every byte over the executors' shared exchange
        wstats = dict(ctx.executors[0].windowed_plane.stats())
        _require(wstats["rounds_executed"] >= 2,
                 f"windowed shuffle dryrun ran {wstats['rounds_executed']} "
                 "collective round(s), expected >=2 (one per plan window)")
        _require(wstats["payload_bytes_moved"] > 0,
                 "windowed shuffle dryrun moved no payload")
    seconds["windowed_plane"] = time.monotonic() - t0

    t0 = time.monotonic()
    bnet = LoopbackNetwork()
    bconf = TpuShuffleConf()
    bconf.set("driverPort", 49500)
    # incremental plans: 3 maps / window of 2 -> 2 plan windows, each
    # one symmetric collective (the straggler-overlap mode)
    bconf.set("bulkWindowMaps", "2")
    bdriver = TpuShuffleManager(bconf, is_driver=True, network=bnet,
                                device=dev)
    bexec = [
        TpuShuffleManager(bconf, is_driver=False, network=bnet,
                          port=49600 + i * 10, executor_id=str(i),
                          stage_to_device=False, device=dev)
        for i in range(min(3, n_ranks))
    ]
    try:
        bhandle = bdriver.register_shuffle(80, len(bexec), HashPartitioner(6))
        brecords = [[(f"b{m}-{j}", j) for j in range(30)]
                    for m in range(len(bexec))]
        for m, recs in enumerate(brecords):
            w = bexec[m].get_writer(bhandle, m)
            w.write(recs)
            w.stop(True)
        session = BulkShuffleSession(
            TileExchange.colocated(len(bexec), tile_bytes=1 << 12,
                                   device=dev),
            len(bexec), timeout_s=bconf.bulk_barrier_timeout_ms / 1000.0)
        readers = {e.executor_id: BulkExchangeReader(e, session=session)
                   for e in bexec}
        bout, berr = {}, {}

        def read(eid):
            try:
                bout[eid] = list(readers[eid].read(80))
            except BaseException as err:  # noqa: BLE001 - raised below
                berr[eid] = err

        threads = [threading.Thread(target=read, args=(e.executor_id,),
                                    daemon=True) for e in bexec]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _require(not berr and all(not t.is_alive() for t in threads),
                 f"bulk shuffle dryrun failed: {berr}")
        bgot = sorted(kv for mine in bout.values() for kv in mine)
        _require(bgot == sorted(kv for recs in brecords for kv in recs),
                 "bulk shuffle dryrun record mismatch")
        events = {eid: [w for w, _t, _b in rd.window_events]
                  for eid, rd in readers.items()}
        _require(all(evs == [0, 1] for evs in events.values()),
                 f"windowed bulk dryrun: expected 2 plan windows, got "
                 f"{events}")
    finally:
        for m in bexec + [bdriver]:
            m.stop()
    seconds["bulk_session"] = time.monotonic() - t0
    return dict(windowed=got, windowed_stats=wstats, bulk_records=bgot,
                bulk_window_events=events, seconds=seconds)


def _dryrun_rank(group: ExchangeGroup, work_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: every case in the JAX dry
    run's order, then, in rank 0 while the others wait, the record
    plane; rank 0 writes the results to ``work_dir/result.pkl``."""
    from sparkrdma_tpu_torch import _build

    r = _Rank(group, work_dir)
    _build.reset_launch_counts()
    results = {name: case(r) for name, case in CASES}
    ranks = r.gather(dict(seconds=r.seconds, jax_loaded=_jax_loaded(),
                          launches=_build.launch_counts()))
    if group.rank == 0:
        # the world's tensors go before the record plane starts
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        results["record_plane"] = dryrun_record_plane(
            group.size, device=group.device)
        results["seconds"] = {k: max(x["seconds"][k] for x in ranks)
                              for k in ranks[0]["seconds"]}
        results["jax_loaded"] = [x["jax_loaded"] for x in ranks]
        results["launches"] = [x["launches"] for x in ranks]
        path = os.path.join(work_dir, "result.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
    dist.barrier(group=group.group)


def _world_rank(rank: int, target: Callable, n_ranks: int, store: str,
                device_type: str, timeout_s: float, args: tuple) -> None:
    from sparkrdma_tpu_torch.parallel import multihost

    # every rank shares the host's cores with the others
    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if device_type == "cuda" else \
        torch.device("cpu")
    multihost.initialize(f"file://{store}", n_ranks, rank, device=dev,
                         timeout_s=timeout_s)
    try:
        target(multihost.global_group(dev), *args)
    finally:
        dist.destroy_process_group()


def _world_device(n_ranks: int, device: DeviceLike) -> torch.device:
    """The device type of a world of ``n_ranks`` processes, one card
    each on CUDA (the default): refuses fewer cards than ranks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "world's ranks on the CPU over gloo")
        cards = torch.cuda.device_count()
        if cards < n_ranks:
            raise RuntimeError(
                f"a world of {n_ranks} ranks needs {n_ranks} cards, one "
                f"per rank (NCCL refuses two ranks on one GPU); this host "
                f"has {cards}")
        if dev.index is not None:
            raise ValueError("rank r runs on card r: pass device='cuda'")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def spawn_world(target: Callable, n_ranks: int, device: DeviceLike,
                timeout_s: float, args: tuple = ()) -> None:
    """Run ``target(group, *args)`` in each rank of a world of
    ``n_ranks`` new processes (``torch.multiprocessing`` spawn), joined
    through ``parallel/multihost.initialize`` over a ``file://`` store in
    a temporary directory: NCCL with card ``rank`` each on CUDA
    (``device`` None or ``"cuda"``), gloo with ``device="cpu"``.  ``group`` is the world as an
    :class:`ExchangeGroup` on the rank's device.  ``target`` must be
    importable by name.

    ``timeout_s`` bounds every collective and the whole run.  When a
    rank fails, the others are stopped and the call raises; so it does
    when the run outlasts ``timeout_s``."""
    import torch.multiprocessing as mp

    dev = _world_device(n_ranks, device)
    if dev.type == "cuda":
        # build the kernels once, here: the ranks load the cached library
        from sparkrdma_tpu_torch import _build

        _build.load()
    with tempfile.TemporaryDirectory(prefix="sparkrdma_world_") as tmp:
        ctx = mp.start_processes(
            _world_rank,
            args=(target, n_ranks, os.path.join(tmp, "store"), dev.type,
                  float(timeout_s), tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {n_ranks} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def dryrun_multichip(n_ranks: int, device: DeviceLike = None) -> dict:
    """Run every data-plane program once over a world of ``n_ranks``
    processes (module docstring), each case held to the JAX dry run's
    assertions, then the record plane in rank 0.  NCCL on cards 0 to
    ``n_ranks - 1`` by default, gloo with ``device="cpu"``; no fallback:
    fewer cards than ranks, or no CUDA, raises ``RuntimeError``.

    ``n_ranks`` must be at least 3: the bulk session writes ``min(3,
    n)`` maps in windows of 2 and expects window events ``[0, 1]`` on
    every reader, which two maps cannot give (the JAX dry run fails
    there at n = 2 too).

    Returns rank 0's results as host values: per case the union of the
    ranks' results (sorted runs concatenated in rank order, owned keys
    merged, attention shards joined on the sequence axis), the record
    plane's, ``seconds`` per case (the maximum over the ranks, each to
    the end of its work on the card), and per rank ``jax_loaded`` and
    ``launches`` (each kernel's launches over the eleven cases; all 0
    on the CPU, where the wrappers run their plain versions).  A
    failing rank, or a run past ``DRYRUN_TIMEOUT_S``, makes the call
    raise."""
    n_ranks = int(n_ranks)
    if n_ranks < DRYRUN_MIN_RANKS:
        raise ValueError(
            f"the dry run needs at least {DRYRUN_MIN_RANKS} ranks, got "
            f"{n_ranks}: its bulk session writes min(3, n) maps in windows "
            f"of 2 and expects window events [0, 1] on every reader, which "
            f"fails at n = 2 (as the JAX dry run does)")
    with tempfile.TemporaryDirectory(prefix="sparkrdma_dryrun_") as work:
        spawn_world(_dryrun_rank, n_ranks, device, DRYRUN_TIMEOUT_S,
                    args=(work,))
        with open(os.path.join(work, "result.pkl"), "rb") as f:
            return pickle.load(f)  # written by rank 0 of this run

