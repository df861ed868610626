"""The port's dry run (``sparkrdma_tpu_torch.entry.dryrun_multichip``)
against the JAX package, on the CPU.

The dry run spawns a gloo world of D processes (``file://`` store, no
TCP port; the record-plane half runs over ``LoopbackNetwork``), runs
every case of ``__graft_entry__.dryrun_multichip`` with its assertions
and returns rank 0's results.  D = 4 runs in a fresh interpreter, which
must load neither JAX nor the JAX package in itself or in any rank; D
= 8 runs from this process.  Each case's result is held against the JAX
models on ``make_mesh(D)`` over the same arrays
(``entry.dryrun_inputs``): integers and bytes exactly, values within
equal keys canonicalised where a sort is unstable (rows compared as
sorted multisets), attention to rtol 2e-4 and atol 2e-5.  The
record-plane half is held against the JAX dry run's own half, run here
with the same start as the port's (every executor known to the driver
before the first plan window), and against a late executor.  The
refusals: two ranks, no CUDA, fewer cards than ranks; and one rank's
failure or stall makes the call raise.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dryrun_worker as worker
from sparkrdma_tpu.api import TpuShuffleContext as JContext
from sparkrdma_tpu.conf import TpuShuffleConf as JConf
from sparkrdma_tpu.models.aggregate import KeyedAggregator
from sparkrdma_tpu.models.external_sort import ExternalTeraSorter
from sparkrdma_tpu.models.join import BroadcastJoiner, HashJoiner
from sparkrdma_tpu.models.join_aggregate import BroadcastJoinAggregator
from sparkrdma_tpu.models.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from sparkrdma_tpu.models.terasort import TeraSorter
from sparkrdma_tpu.models.topk import GroupedTopK
from sparkrdma_tpu.models.wordcount import WordCounter
from sparkrdma_tpu.parallel.exchange import TileExchange
from sparkrdma_tpu.parallel.mesh import make_mesh
from sparkrdma_tpu.parallel.ring import RingExchange
from sparkrdma_tpu.shuffle.bulk import BulkExchangeReader, BulkShuffleSession
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JManager
from sparkrdma_tpu.shuffle.partitioner import HashPartitioner
from sparkrdma_tpu.transport import LoopbackNetwork
from sparkrdma_tpu_torch import entry
from sparkrdma_tpu_torch.api import TpuShuffleContext as PContext
from sparkrdma_tpu_torch.conf import TpuShuffleConf as PConf
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager as PManager

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLDS = [4, 8]
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
FRESH_TIMEOUT_S = 240
# how long a worker waits for another's dry run
SHARED_WAIT_S = 2 * FRESH_TIMEOUT_S
JOIN_HOWS = ("inner", "semi", "anti", "left_outer")


def _fresh_run(D, tmp):
    """``dryrun_multichip(D, "cpu")`` in a new interpreter; its results,
    with whether that interpreter loaded JAX."""
    out = tmp / "result.pkl"
    code = (
        "import pickle, sys\n"
        "from sparkrdma_tpu_torch.entry import _jax_loaded, dryrun_multichip\n"
        f"r = dryrun_multichip({D}, device='cpu')\n"
        "r['parent_jax_loaded'] = _jax_loaded()\n"
        f"pickle.dump(r, open({str(out)!r}, 'wb'))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=FRESH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)  # written by the run above


def _once(tmp_path_factory, name, make):
    """``make()`` once per test session: under pytest-xdist the first
    worker to ask runs it and pickles the result (or its failure) under
    the session's shared temporary root, and the others load that."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's root, shared by the workers
    done = root / f"{name}.pkl"
    try:
        os.close(os.open(root / f"{name}.lock",
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + SHARED_WAIT_S
        while not done.exists():
            assert time.monotonic() < deadline, f"no {done} in time"
            time.sleep(0.2)
        with open(done, "rb") as f:
            ok, res = pickle.load(f)  # written by a worker of this run
        if not ok:
            pytest.fail(f"{name} failed on another worker:\n{res}")
        return res
    try:
        ok, res = True, make()
    except BaseException as e:
        ok, res = False, repr(e)
        raise
    finally:
        with open(f"{done}.tmp", "wb") as f:
            pickle.dump((ok, res), f)
        os.replace(f"{done}.tmp", done)
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(D)``: the port's dry-run results at D ranks, once per
    test session."""
    cache = {}

    def get(D):
        if D not in cache:
            cache[D] = _once(
                tmp_path_factory, f"torch_dryrun_{D}",
                lambda: _fresh_run(D, tmp_path_factory.mktemp(f"dry{D}"))
                if D == 4 else entry.dryrun_multichip(D, device="cpu"))
        return cache[D]

    return get


def _rows(cols):
    """Rows of equal-length columns in canonical (lexicographic) order."""
    cols = [np.asarray(c) for c in cols]
    flat = [c2[:, j] for c in cols for c2 in [c.reshape(len(c), -1)]
            for j in range(c2.shape[1])]
    order = np.lexsort(tuple(reversed(flat)))
    return [c[order] for c in cols]


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(_rows(got), _rows(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _sorted_pairs(got, want):
    """A sorted run: keys slot for slot, (key, value) rows as sorted
    multisets (values within equal keys come in any order)."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    _same_rows(got, want)


def _stats(d):
    return {int(k): tuple(s) for k, s in d.items()}


# -- each case against the JAX models ------------------------------------------


def _terasort(mesh, x, got):
    _sorted_pairs(got, TeraSorter(mesh).sort(*x["terasort"]))


def _terasort_wide(mesh, x, got):
    D = len(got["n_valid"])
    wk, wp = x["terasort_wide"]
    (k, p, valid, mx), cap = TeraSorter(
        mesh, capacity_factor=2.0).sort_device_wide(jnp.asarray(wk),
                                                    jnp.asarray(wp))
    assert got["capacity"] == cap
    valid = np.asarray(valid).tolist()
    assert got["n_valid"] == valid
    assert got["max_fill"] == np.asarray(mx).tolist()
    k = np.asarray(k).reshape(D, -1)
    p = np.asarray(p).reshape(D, -1, wp.shape[1])
    for d in range(D):
        _sorted_pairs((got["keys"][d], got["payload"][d]),
                      (k[d, :valid[d]], p[d, :valid[d]]))


def _wordcount(mesh, x, got):
    assert got == WordCounter(mesh).count(x["wordcount"])


def _attention(mesh, x, got):
    for fn, out in ((ring_attention, got[0]),
                    (ulysses_attention, got[1])):
        want = np.asarray(fn(*x["attention"], mesh=mesh, causal=True))
        assert out.shape == want.shape and out.dtype == want.dtype
        np.testing.assert_allclose(out, want, **ATTN_TOL)


def _byte_exchange(mesh, x, got):
    D = len(got)
    out = TileExchange(mesh, tile_bytes=1 << 10,
                            verify_integrity=True).exchange_bytes(
        x["byte_exchange"])
    assert got == [[bytes(out[d][s]) for s in range(D)] for d in range(D)]


def _joins(mesh, x, got):
    for name, cls in (("hash", HashJoiner), ("broadcast", BroadcastJoiner)):
        for how in JOIN_HOWS:
            want = cls(mesh).join(*x["join"], how=how)
            _same_rows(got[f"{name}:{how}"],
                       [np.asarray(c) for c in want])


def _join_aggregate(mesh, x, got):
    assert got == _stats(BroadcastJoinAggregator(mesh).join_aggregate(
        *x["join"]))


def _topk(mesh, x, got):
    assert got == GroupedTopK(mesh).top_k(*x["topk"], 3)


def _aggregate(mesh, x, got):
    assert got == _stats(KeyedAggregator(mesh).aggregate(
        *x["aggregate"]))


def _ring(mesh, x, got):
    ring = RingExchange(mesh)
    shards = jnp.asarray(x["ring"])
    np.testing.assert_array_equal(got[0], np.asarray(ring.all_shards(shards)))
    np.testing.assert_array_equal(got[1], np.asarray(ring.ring_reduce(
        shards, jnp.zeros_like, lambda acc, _src, cur: acc + cur)))


def _external_sort(mesh, x, got):
    ek, ev = x["external_sort"]
    n = ek.shape[0] // 2
    outs = list(ExternalTeraSorter(mesh, num_buckets=4).sort_chunks(
        [(ek[:n], ev[:n]), (ek[n:], ev[n:])]))
    _sorted_pairs(got, tuple(np.concatenate([o[j] for o in outs])
                             for j in (0, 1)))


CASES = {
    "terasort": _terasort,
    "terasort_wide": _terasort_wide,
    "wordcount": _wordcount,
    "attention": _attention,
    "byte_exchange": _byte_exchange,
    "joins": _joins,
    "join_aggregate": _join_aggregate,
    "topk": _topk,
    "aggregate": _aggregate,
    "ring": _ring,
    "external_sort": _external_sort,
}


def test_cases_in_the_jax_order():
    assert [name for name, _ in entry.CASES] == list(CASES)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_jax(devices, port, D, case):
    CASES[case](make_mesh(D), entry.dryrun_inputs(D), port(D)[case])


# -- the record-plane half ------------------------------------------------------


def _await_hellos(driver, executors):
    """Wait until ``driver`` knows every executor: the first plan window
    pins the host set, and an executor whose hello, publishes and plan
    request all land after that is refused its plans while the others
    wait for it at the exchange.  The port's plan requests wait so
    (``TpuShuffleManager.await_peers``); the JAX reference here is held
    to the same start."""
    want = {e.local_smid for e in executors}
    deadline = time.monotonic() + 60
    while not want.issubset(driver.executors):
        assert time.monotonic() < deadline, "an executor never said hello"
        time.sleep(0.001)


def _jax_windowed(n_exec, keys, vals, delay_executor=None):
    """The JAX dry run's windowed half: ``reduce_by_key("sum")`` on
    ``n_exec`` executors of a ``make_mesh(n_exec)`` context, windows of
    2 maps; its dict and ``executors[0]``'s plane stats."""
    conf = JConf()
    conf.set("readPlane", "windowed")
    conf.set("bulkWindowMaps", "2")
    conf.set("serializer", "columnar")
    with JContext(num_executors=n_exec, conf=conf, base_port=48000,
                  mesh=make_mesh(n_exec)) as ctx:
        _await_hellos(ctx.driver, ctx.executors)
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=2 * n_exec)
                   .reduce_by_key("sum", num_partitions=2 * n_exec)
                   .collect())
        return got, dict(ctx.executors[0].windowed_plane.stats())


def _jax_bulk(n_exec):
    """The JAX dry run's bulk session: 3 maps of 30 records, windows of
    2, one ``BulkExchangeReader`` thread per executor; the sorted
    records and each reader's window events."""
    net = LoopbackNetwork()
    conf = JConf()
    conf.set("driverPort", 49500)
    conf.set("bulkWindowMaps", "2")
    driver = JManager(conf, is_driver=True, network=net)
    execs = [JManager(conf, is_driver=False, network=net,
                      port=49600 + i * 10, executor_id=str(i),
                      stage_to_device=False) for i in range(n_exec)]
    try:
        _await_hellos(driver, execs)
        handle = driver.register_shuffle(80, n_exec, HashPartitioner(6))
        for m in range(n_exec):
            w = execs[m].get_writer(handle, m)
            w.write([(f"b{m}-{j}", j) for j in range(30)])
            w.stop(True)
        session = BulkShuffleSession(
            TileExchange(make_mesh(n_exec), tile_bytes=1 << 12), n_exec,
            timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
        readers = {e.executor_id: BulkExchangeReader(e, session=session)
                   for e in execs}
        with ThreadPoolExecutor(n_exec) as pool:
            outs = list(pool.map(lambda r: list(r.read(80)),
                                 readers.values()))
        return (sorted(kv for o in outs for kv in o),
                {eid: [w for w, _t, _b in r.window_events]
                 for eid, r in readers.items()})
    finally:
        for m in execs + [driver]:
            m.stop()


@pytest.fixture(scope="module")
def jax_record_plane(devices):
    """The JAX dry run's record-plane half at its n = 4 and at 8 (both
    run min(4, n) windowed executors and min(3, n) bulk maps)."""
    keys = np.arange(2048, dtype=np.int64) % 67
    vals = np.arange(2048, dtype=np.int64)
    windowed, wstats = _jax_windowed(4, keys, vals)
    records, events = _jax_bulk(3)
    return dict(windowed=windowed, windowed_stats=wstats,
                bulk_records=records, bulk_window_events=events)


# the plane's counters that the run's data fixes; padded_bytes_moved
# also depends on which maps have filled when each window is cut, in
# both packages
WSTATS_EXACT = ("rounds_executed", "payload_bytes_moved",
                "integrity_failures", "active_shuffles")


@pytest.mark.parametrize("D", WORLDS)
def test_record_plane_matches_the_jax_dryrun(port, jax_record_plane, D):
    got, want = port(D)["record_plane"], jax_record_plane
    assert got["windowed"] == want["windowed"]
    for key in WSTATS_EXACT:
        assert got["windowed_stats"][key] == want["windowed_stats"][key], key
    assert got["windowed_stats"]["rounds_executed"] >= 2
    assert got["windowed_stats"]["payload_bytes_moved"] > 0
    assert got["bulk_records"] == want["bulk_records"]
    assert got["bulk_window_events"] == want["bulk_window_events"] \
        == {str(i): [0, 1] for i in range(3)}


def test_windowed_plane_waits_for_a_late_executor(monkeypatch,
                                                  jax_record_plane):
    """Every message executor 3 sends the driver (its hello, publishes
    and plan requests) lands 0.5 s late.  Unless the first plan request
    waits for its hello, the first plan window pins executors 0-2 only,
    executor 3 is refused its plan, and the others wait for its row at
    the exchange until the barrier times out (the JAX context does
    so).  The port's plan requests wait until the driver has announced
    every executor, and its result equals the JAX dry run's on time."""
    send = PManager._send_driver_msg

    def late(self, msg, on_failure=None):
        if self.local_smid.block_manager_id.executor_id != "3":
            return send(self, msg, on_failure)

        def deliver():
            try:
                send(self, msg, on_failure)
            except Exception:  # noqa: BLE001 - the context has stopped
                pass

        threading.Timer(0.5, deliver).start()

    monkeypatch.setattr(PManager, "_send_driver_msg", late)
    conf = PConf()
    conf.set("readPlane", "windowed")
    conf.set("bulkWindowMaps", "2")
    conf.set("serializer", "columnar")
    conf.set("bulkBarrierTimeout", "20s")
    keys = np.arange(2048, dtype=np.int64) % 67
    vals = np.arange(2048, dtype=np.int64)
    with PContext(num_executors=4, conf=conf, base_port=48000,
                  device="cpu") as ctx:
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=8)
                   .reduce_by_key("sum", num_partitions=8).collect())
        assert {e.local_smid for e in ctx.executors} <= set(
            ctx.driver.executors)
        stats = ctx.executors[0].windowed_plane.stats()
    assert got == jax_record_plane["windowed"]
    for key in WSTATS_EXACT:
        assert stats[key] == jax_record_plane["windowed_stats"][key], key


@pytest.mark.parametrize("D", WORLDS)
def test_dryrun_reports_every_case(port, D):
    res = port(D)
    assert res["jax_loaded"] == [False] * D
    assert set(res["seconds"]) >= {"terasort", "terasort_wide", "wordcount",
                                   "ring_attention", "ulysses_attention",
                                   "byte_exchange", "join_aggregate",
                                   "topk", "aggregate", "ring_all_shards",
                                   "ring_reduce", "external_sort"}
    assert all(np.isfinite(s) and s >= 0 for s in res["seconds"].values())
    assert set(res["record_plane"]["seconds"]) == {"windowed_plane",
                                                   "bulk_session"}


def test_fresh_interpreter_loads_no_jax(port):
    res = port(4)
    assert res["parent_jax_loaded"] is False
    assert res["jax_loaded"] == [False] * 4


def test_dryrun_inputs_follow_the_jax_draws():
    """The JAX dry run draws n = D * 512 rows from default_rng(1) in its
    order; spot-check the first and the last draw."""
    x = entry.dryrun_inputs(3)
    rng = np.random.default_rng(1)
    assert np.array_equal(
        x["terasort"][0], rng.integers(0, 1 << 31, size=1536, dtype=np.int32))
    assert x["attention"][0].shape == (3, 48, 8)
    assert x["ring"].shape == (3, 16)
    assert x["external_sort"][0].shape == (3072,)


# -- refusals and failures -------------------------------------------------------


def test_dryrun_refuses_two_ranks():
    with pytest.raises(ValueError, match="at least 3 ranks"):
        entry.dryrun_multichip(2, device="cpu")


def test_dryrun_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(4)


def test_world_refuses_fewer_cards_than_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        entry.dryrun_multichip(3)
    with pytest.raises(ValueError, match="rank r runs on card r"):
        entry.spawn_world(worker.fail_on_one_rank, 2, "cuda:1", 60)


def test_failing_rank_raises_in_the_caller():
    """The failing rank's error, or a peer's lost connection to it,
    reaches the caller at once."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="terminated with the following "
                       "error"):
        entry.spawn_world(worker.fail_on_one_rank, 3, device="cpu",
                          timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_stalled_rank_raises_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        entry.spawn_world(worker.stall_on_one_rank, 3, device="cpu",
                          timeout_s=15, args=(600,))
    assert time.monotonic() - t0 < 60
