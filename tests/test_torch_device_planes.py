"""The port's bulk and windowed device read planes against the JAX
package, on the CPU.

- The co-located ``TileExchange`` (``TileExchange.colocated(E)``, E
  ranks in one process) against the JAX ``TileExchange(make_mesh(E))``
  at E = 2, 3, 4 and 8, bit for bit: received bytes, ``stats()``,
  ``on_round`` events and metric counter increments, over the cases of
  tests/test_exchange.py, tests/test_device_exchange.py (padded full and
  windowed, the round sequence, the empty plan, the integrity check) and
  tests/test_zero_copy_exchange.py (``exchange_into``).
- Every case of tests/test_bulk_shuffle.py through both packages (the
  port on ``device="cpu"``, its sessions over a co-located exchange; the
  JAX package on ``make_mesh(E)``), each holding its own oracle and the
  two packages' results equal.  Cases whose outcome depends on timing
  (a loss at a random point, a kill and retry) compare the oracle's
  verdict, not the timing.
- The device / host-staged / socket sweep and the off-mode pin of
  tests/test_device_exchange.py, the windowed cases of
  tests/test_zero_copy_exchange.py (pipelined equal to serial, abort,
  the zero-copy counters), ``readPlane`` bulk, windowed and collective
  through ``TpuShuffleContext`` against the JAX context, and the
  pool-backed ``DeviceStagingBridge`` rows.

Both packages' confs set ``deviceCensus`` to 8 (the JAX conftest's CPU
device count), so ``deviceExchangeEnabled`` defaults alike.
"""

import importlib
import os
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch_byte_plane_worker as gen

CPU = "cpu"
ES = [2, 3, 4, 8]


class Pkg:
    """One package's modules and the arguments its entry points need on
    the CPU."""

    def __init__(self, root: str):
        imp = importlib.import_module
        self.name = root
        self.port = root.endswith("_torch")
        self.conf = imp(f"{root}.conf")
        self.manager = imp(f"{root}.shuffle.manager")
        self.bulk = imp(f"{root}.shuffle.bulk")
        self.part = imp(f"{root}.shuffle.partitioner")
        self.reader = imp(f"{root}.shuffle.reader")
        self.transport = imp(f"{root}.transport")
        self.api = imp(f"{root}.api")
        self.xmod = imp(f"{root}.parallel.exchange")
        self.metrics = imp(f"{root}.metrics")
        self.kw = {"device": CPU} if self.port else {}

    def Conf(self, d=None):
        d = dict(d or {})
        d.setdefault("spark.shuffle.tpu.deviceCensus", "8")
        return self.conf.TpuShuffleConf(d)

    def Manager(self, conf, is_driver, net, **kw):
        return self.manager.TpuShuffleManager(
            conf, is_driver=is_driver, network=net, **self.kw, **kw)

    def Context(self, **kw):
        return self.api.TpuShuffleContext(**self.kw, **kw)

    def exchange(self, E, **kw):
        if self.port:
            return self.xmod.TileExchange.colocated(E, device=CPU, **kw)
        from sparkrdma_tpu.parallel.mesh import make_mesh

        return self.xmod.TileExchange(make_mesh(E), **kw)

    def exchange_from_conf(self, conf, E):
        if self.port:
            return self.xmod.TileExchange.from_conf(conf, colocated=E,
                                                    device=CPU)
        from sparkrdma_tpu.parallel.mesh import make_mesh

        return self.xmod.TileExchange.from_conf(conf, make_mesh(E))

    def Session(self, E, **kw):
        return self.bulk.BulkShuffleSession(
            self.exchange(E, tile_bytes=1 << 12), E, **kw)

    def counted(self, fn):
        reg = self.metrics.GLOBAL_REGISTRY
        prev = reg.enabled
        reg.reset()
        reg.enabled = True
        try:
            res = fn()
            snap = reg.snapshot()
        finally:
            reg.enabled = prev
            reg.reset()
        vals = {}
        for c in snap["counters"]:
            vals[c["name"]] = vals.get(c["name"], 0) + c["value"]
        return res, vals


@pytest.fixture(scope="module")
def pkgs(devices):
    return Pkg("sparkrdma_tpu"), Pkg("sparkrdma_tpu_torch")


def both(pkgs, fn):
    """``fn`` through the JAX package, then the port; the two results
    must be equal.  Returns the port's."""
    want = fn(pkgs[0])
    got = fn(pkgs[1])
    assert got == want
    return got


# -- the co-located exchange against TileExchange(make_mesh(E)) ---------------


def _rows(out, D):
    return [[bytes(memoryview(out[d][s])) for s in range(D)]
            for d in range(D)]


def exchange_cases(P, D):
    """Every exchange case at E = D through ``P``: name -> comparable
    result (received rows, stats, counters, events)."""
    res = {}
    ex = P.exchange

    def bytes_case(name, streams, **kw):
        e = ex(D, **kw)
        out = e.exchange_bytes(streams)
        res[name] = dict(rows=_rows(out, D), stats=e.stats(),
                         plain=isinstance(out, list))

    bytes_case("single_round", gen.make_streams(0, D), tile_bytes=1 << 20)
    bytes_case("multi_round", gen.make_streams(1, D, max_len=20000),
               tile_bytes=512, max_rounds_in_flight=3)
    bytes_case("skewed", gen.skewed_streams(D), tile_bytes=1024)
    bytes_case("all_empty", [[b""] * D for _ in range(D)])
    bytes_case("integrity_ok", gen.make_streams(8, D, max_len=2000),
               tile_bytes=512, verify_integrity=True)

    # with lengths: rows outside local_sources may be empty (zeros ship)
    lengths, streams = gen.random_plan(31, D, max_len=3000)
    vouched = frozenset(range(0, D, 2))
    part = [[streams[s][d] if s in vouched else b"" for d in range(D)]
            for s in range(D)]
    e = ex(D, tile_bytes=1024, verify_integrity=True)
    out = e.exchange_bytes(part, lengths=lengths, local_sources=vouched)
    res["lengths_partial"] = dict(rows=_rows(out, D), stats=e.stats())

    lengths, streams = gen.random_plan(32, D, max_len=20000)
    e = ex(D, tile_bytes=4096, verify_integrity=True)
    out, counters = P.counted(lambda: e.exchange_into(
        lengths, {s: gen.contig_row(lengths, streams, s)
                  for s in range(D)}))
    res["into"] = dict(rows=_rows(out, D), stats=e.stats(),
                       counters=counters,
                       exact=_rows(out, D) == [
                           [streams[s][d] for s in range(D)]
                           for d in range(D)])

    lengths, streams = gen.random_plan(33, D, max_len=9000)
    sizes = []

    def alloc(n):
        sizes.append(n)
        return np.empty(n + 7, np.uint8)

    e = ex(D, tile_bytes=512, max_rounds_in_flight=3)
    out = e.exchange_into(
        lengths, {s: gen.contig_row(lengths, streams, s) for s in range(D)},
        out_alloc=alloc)
    res["into_out_alloc"] = dict(rows=_rows(out, D), stats=e.stats(),
                                 sizes=sorted(sizes))

    e = ex(D)
    out = e.exchange_into(np.zeros((D, D), np.int64),
                          {s: np.empty(0, np.uint8) for s in range(D)})
    res["into_empty"] = dict(rows=_rows(out, D), stats=e.stats())

    lengths, streams = gen.random_plan(34, D, max_len=3000)
    e = ex(D, tile_bytes=1024)
    out = e.exchange_into(
        lengths, {s: gen.contig_row(lengths, streams, s)
                  for s in vouched}, local_sources=vouched)
    res["into_partial"] = dict(rows=_rows(out, D), stats=e.stats())

    for name, (tile, window, seed, max_len) in gen.PADDED.items():
        lengths, streams = gen.random_plan(seed + D, D, max_len=max_len)
        e = ex(D, tile_bytes=tile, verify_integrity=True)
        cols = e.plan(lengths).total_cols
        events = []
        out, counters = P.counted(lambda: e.exchange_padded(
            lengths,
            {s: P.xmod.PaddedSourceRow(
                gen.padded_row(lengths, streams, s, cols), cols)
             for s in range(D)},
            window_rounds=window,
            on_round=lambda r, lo, hi, rows: events.append(
                (r, lo, hi, all(rows[d] is not None for d in range(D))))))
        res[name] = dict(rows=_rows(out, D), stats=e.stats(),
                         counters=counters, events=events,
                         exact=_rows(out, D) == [
                             [streams[s][d] for s in range(D)]
                             for d in range(D)])

    # several rounds in flight: the on_round sequence of the windowed
    # shape (tests/test_device_exchange.py's round-sequence case)
    lengths, streams = gen.random_plan(5, D, max_len=150_000)
    e = ex(D, tile_bytes=1 << 16)
    cols = e.plan(lengths).total_cols
    events = []
    e.exchange_padded(
        lengths, {s: P.xmod.PaddedSourceRow(
            gen.padded_row(lengths, streams, s, cols), cols)
            for s in range(D)},
        window_rounds=3,
        on_round=lambda r, lo, hi, rows: events.append((r, lo, hi)))
    res["padded_round_sequence"] = dict(events=events, stats=e.stats())

    e = ex(D)
    out = e.exchange_padded(np.zeros((D, D), np.int64),
                            {0: P.xmod.PaddedSourceRow(
                                np.empty(0, np.uint8), 0)})
    res["padded_empty"] = dict(rows=_rows(out, D), stats=e.stats())

    # a row corrupted after framing rides through: the exchange is
    # self-consistent and the integrity check passes
    lengths, streams = gen.random_plan(9, D, max_len=500)
    e = ex(D, tile_bytes=1 << 12, verify_integrity=True)
    cols = e.plan(lengths).total_cols
    rows = {s: P.xmod.PaddedSourceRow(
        gen.padded_row(lengths, streams, s, cols), cols) for s in range(D)}
    e.exchange_padded(lengths, rows)
    d_bad = int(np.argmax(lengths[0]))
    bad = rows[0].buf.copy()
    bad[d_bad * cols] ^= 0xFF
    out = e.exchange_padded(lengths,
                            {**rows, 0: P.xmod.PaddedSourceRow(bad, cols)})
    res["padded_corrupt_row"] = dict(rows=_rows(out, D), stats=e.stats())

    # one row defeats the 4-byte view: the whole exchange ships uint8
    lengths, streams = gen.random_plan(41, D, max_len=3000)
    e = ex(D, tile_bytes=1 << 12, verify_integrity=True)
    cols = e.plan(lengths).total_cols
    rows = {}
    for s in range(D):
        buf = np.zeros(D * cols + 1, np.uint8)
        buf = buf[1:] if s == 0 else buf[:-1]
        buf[:] = gen.padded_row(lengths, streams, s, cols)
        rows[s] = P.xmod.PaddedSourceRow(buf, cols)
    out = e.exchange_padded(lengths, rows, window_rounds=2)
    res["padded_unaligned"] = dict(rows=_rows(out, D), stats=e.stats())

    # only some sources vouched: the others ship zeros
    lengths, streams = gen.random_plan(42, D, max_len=3000)
    e = ex(D, tile_bytes=1 << 10)
    cols = e.plan(lengths).total_cols
    out, counters = P.counted(lambda: e.exchange_padded(
        lengths, {s: P.xmod.PaddedSourceRow(
            gen.padded_row(lengths, streams, s, cols), cols)
            for s in vouched},
        local_sources=vouched, window_rounds=2))
    res["padded_partial"] = dict(rows=_rows(out, D), stats=e.stats(),
                                 counters=counters)

    x = gen.a2a_input(D)
    if P.port:
        got = np.asarray(ex(D).a2a(x).numpy())
    else:
        import jax.numpy as jnp

        got = np.asarray(ex(D).a2a(jnp.asarray(x)))
    res["a2a"] = dict(out=got.tobytes(), shape=got.shape,
                      exact=bool((got == x.transpose(1, 0, 2)).all()))
    return res


EXCHANGE_CASES = (
    "single_round", "multi_round", "skewed", "all_empty", "integrity_ok",
    "lengths_partial", "into", "into_out_alloc", "into_empty",
    "into_partial", *gen.PADDED, "padded_round_sequence", "padded_empty",
    "padded_corrupt_row", "padded_unaligned", "padded_partial", "a2a",
)


@pytest.fixture(scope="module")
def exchange_results(pkgs):
    cache = {}

    def get(P, D):
        if (P.name, D) not in cache:
            cache[(P.name, D)] = exchange_cases(P, D)
        return cache[(P.name, D)]

    return get


@pytest.mark.parametrize("case", EXCHANGE_CASES)
@pytest.mark.parametrize("E", ES)
def test_colocated_exchange(pkgs, exchange_results, E, case):
    want = exchange_results(pkgs[0], E)[case]
    got = exchange_results(pkgs[1], E)[case]
    assert got == want
    if "exact" in got:
        assert got["exact"]


def test_colocated_exchange_shape(pkgs):
    """The co-located mode is one process over E ranks: every row is
    addressable, no group, and the rank-local constructor is
    unchanged."""
    tex = pkgs[1].xmod
    e = tex.TileExchange.colocated(4, device=CPU, tile_bytes=1024)
    assert e.is_colocated and e.group is None and e.n_devices == 4
    assert not tex.TileExchange(device=CPU).is_colocated
    with pytest.raises(ValueError):
        tex.TileExchange.colocated(0, device=CPU)
    conf = pkgs[1].Conf({"spark.shuffle.tpu.exchangeTileBytes": "8192",
                         "spark.shuffle.tpu.verifyExchangeIntegrity":
                             "true"})
    f = tex.TileExchange.from_conf(conf, colocated=3, device=CPU)
    assert f.is_colocated and f.n_devices == 3
    assert f.tile_bytes == conf.exchange_tile_bytes
    assert f.verify_integrity
    out = f.exchange_into(np.zeros((3, 3), np.int64),
                          {s: np.empty(0, np.uint8) for s in range(3)})
    assert out.addressable == frozenset(range(3))


def test_colocated_integrity_detects_corruption(pkgs, monkeypatch):
    """A byte flipped on the way back from the device fails the
    integrity check with the stream's source and destination, as a
    corrupted collective does in the JAX package."""
    tex = pkgs[1].xmod
    D = 3
    streams = [[bytes([s * D + d]) * 100 for d in range(D)]
               for s in range(D)]
    e = tex.TileExchange.colocated(D, device=CPU, tile_bytes=256,
                                   verify_integrity=True)
    orig = tex._Link.to_host

    def flip(self, dst, src):
        done = orig(self, dst, src)
        b = dst.numpy().view(np.uint8).reshape(D, D, -1)
        b[2, 1, 50] ^= 0xFF  # destination 2, source 1
        return done

    monkeypatch.setattr(tex._Link, "to_host", flip)
    with pytest.raises(tex.ExchangeIntegrityError) as ei:
        e.exchange_bytes(streams)
    assert ei.value.src == 1 and ei.value.dst == 2
    assert e.stats()["integrity_failures"] == 1


# -- tests/test_bulk_shuffle.py through both packages --------------------------


def _cluster(P, base, extra=None, n=3):
    net = P.transport.LoopbackNetwork()
    d = {"spark.shuffle.tpu.driverPort": base,
         "spark.shuffle.tpu.partitionLocationFetchTimeout": "15s"}
    d.update(extra or {})
    conf = P.Conf(d)
    driver = P.Manager(conf, True, net)
    executors = [
        P.Manager(conf, False, net, port=base + 100 + i * 10,
                  executor_id=str(i), stage_to_device=False)
        for i in range(n)
    ]
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all(len(e._peers) == n for e in executors):
            break
        time.sleep(0.01)
    return net, conf, driver, executors


def _stop(*managers):
    for m in managers:
        m.stop()


def _threads(fn, args_list, timeout=60):
    ts = [threading.Thread(target=fn, args=a, daemon=True)
          for a in args_list]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    return ts


def _read_all(P, executors, sid, session, window_events=False):
    readers = {e.executor_id: P.bulk.BulkExchangeReader(e, session=session)
               for e in executors}
    results, errors = {}, {}

    def run(e):
        try:
            results[e.executor_id] = list(
                readers[e.executor_id].read(sid))
        except BaseException as err:
            errors[e.executor_id] = err

    _threads(run, [(e,) for e in executors])
    assert not errors, errors
    if window_events:
        return results, {k: [w for w, _t, _b in r.window_events]
                         for k, r in readers.items()}
    return results


def _canon(records):
    return sorted(map(repr, records))


def _owned_check(part, executors, results, E):
    hosts = sorted((e.local_smid for e in executors),
                   key=lambda s: (s.host, s.port))
    for e in executors:
        idx = hosts.index(e.local_smid)
        for k, _v in results[e.executor_id]:
            assert part.partition(k) % E == idx


def bulk_e2e(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        E, part = 3, P.part.HashPartitioner(9)
        handle = driver.register_shuffle(60, 6, part)
        recs = [[(f"k{j}", (m, j)) for j in range(40)] for m in range(6)]
        for m, r in enumerate(recs):
            w = executors[m % E].get_writer(handle, m)
            w.write(r)
            w.stop(True)
        res = _read_all(P, executors, 60, P.Session(E))
        _owned_check(part, executors, res, E)
        got = [kv for v in res.values() for kv in v]
        assert _canon(got) == _canon(kv for r in recs for kv in r)
        return {k: _canon(v) for k, v in res.items()}
    finally:
        _stop(*executors, driver)


def bulk_plan_unregistered_fails_fast(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        reader = P.bulk.BulkExchangeReader(
            executors[0], P.exchange(3, tile_bytes=1 << 12))
        t0 = time.monotonic()
        with pytest.raises(P.reader.MetadataFetchFailedError,
                           match="not registered"):
            list(reader.read(999))
        assert time.monotonic() - t0 < 5
        return "refused"
    finally:
        _stop(*executors, driver)


def bulk_plan_waits_for_all_maps(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        handle = driver.register_shuffle(61, 2, P.part.HashPartitioner(6))
        w = executors[0].get_writer(handle, 0)
        w.write([("a", 1)])
        w.stop(True)
        box = {}

        def run():
            try:
                box["out"] = _read_all(P, executors, 61, P.Session(3))
            except BaseException as e:
                box["err"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(0.5)
        assert not box, "plan answered before all maps published"
        w = executors[1].get_writer(handle, 1)
        w.write([("b", 2)])
        w.stop(True)
        t.join(timeout=60)
        assert "out" in box, box.get("err")
        got = sorted(kv for v in box["out"].values() for kv in v)
        assert got == [("a", 1), ("b", 2)]
        return got
    finally:
        _stop(*executors, driver)


def bulk_empty_partitions(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        handle = driver.register_shuffle(62, 2, P.part.HashPartitioner(7))
        for m, recs in enumerate([[], [("x", 1)]]):
            w = executors[m].get_writer(handle, m)
            w.write(recs)
            w.stop(True)
        res = _read_all(P, executors, 62, P.Session(3))
        got = [kv for v in res.values() for kv in v]
        assert got == [("x", 1)]
        return got
    finally:
        _stop(*executors, driver)


def bulk_read_plane_via_context(P):
    data = [(i % 17, i) for i in range(3000)]

    def run(conf, port):
        with P.Context(num_executors=3, conf=conf, base_port=port,
                       stage_to_device=False) as ctx:
            ds = ctx.parallelize(data, num_slices=6)
            return (sorted(ds.reduce_by_key(lambda a, b: a + b,
                                            num_partitions=6).collect()),
                    sorted(ds.sort_by_key(num_partitions=6).collect()))

    host = run(P.Conf(), 44500)
    bulk = run(P.Conf({"spark.shuffle.tpu.readPlane": "bulk"}), 44700)
    assert host == bulk
    return bulk


def bulk_columnar_fast_path(P):
    conf = P.Conf({"spark.shuffle.tpu.readPlane": "bulk",
                   "spark.shuffle.tpu.serializer": "columnar"})
    with P.Context(num_executors=3, conf=conf, base_port=45200,
                   stage_to_device=False) as ctx:
        n = 5000
        keys = np.arange(n, dtype=np.int64) % 97
        vals = np.arange(n, dtype=np.int64)
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=6)
                   .reduce_by_key("sum", num_partitions=6).collect())
    expect = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        expect[k] = expect.get(k, 0) + v
    assert got == expect
    return sorted(got.items())


def bulk_session_abort_unblocks_waiters(P):
    session = P.Session(2)
    lengths = np.zeros((2, 2), np.int64)
    box = {}

    def waiter():
        try:
            session.run(0, [b"", b""], lengths)
        except BaseException as e:
            box["err"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.2)
    session.abort(RuntimeError("participant 1 exploded"))
    t.join(timeout=10)
    assert not t.is_alive(), "waiter still blocked after abort"
    assert "participant 1 exploded" in repr(box["err"].__cause__)
    with pytest.raises(RuntimeError, match="aborted"):
        session.run(1, [b"", b""], lengths)
    return str(box["err"])


def bulk_concurrent_shuffles(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        E = 3
        handles = {}
        for sid, nparts in ((63, 5), (64, 8)):
            handles[sid] = driver.register_shuffle(
                sid, E, P.part.HashPartitioner(nparts))
            for m in range(E):
                w = executors[m].get_writer(handles[sid], m)
                w.write([((sid, f"k{m}-{j}"), j) for j in range(25)])
                w.stop(True)
        out, errs = {}, {}

        def run(sid):
            try:
                out[sid] = _read_all(P, executors, sid, P.Session(E))
            except BaseException as e:
                errs[sid] = e

        _threads(run, [(sid,) for sid in handles])
        assert not errs, errs
        res = {}
        for sid in handles:
            got = sorted(kv for v in out[sid].values() for kv in v)
            assert got == sorted(((sid, f"k{m}-{j}"), j)
                                 for m in range(E) for j in range(25))
            res[sid] = got
        return res
    finally:
        _stop(*executors, driver)


def bulk_matches_pull_fuzz(P):
    net, conf, driver, executors = _cluster(P, 43500)
    try:
        E = 3
        rng = random.Random(11)
        out = []
        for trial in range(4):
            sid = 70 + trial
            num_maps = rng.randint(1, 5)
            nparts = rng.randint(1, 10)
            handle = driver.register_shuffle(
                sid, num_maps, P.part.HashPartitioner(nparts))
            recs = [[(rng.randint(0, 20), rng.random())
                     for _ in range(rng.randint(0, 60))]
                    for _ in range(num_maps)]
            mbh = {}
            for m, r in enumerate(recs):
                ex = executors[m % E]
                w = ex.get_writer(handle, m)
                w.write(r)
                w.stop(True)
                mbh.setdefault(ex.local_smid, []).append(m)
            bulk = sorted(kv for v in _read_all(
                P, executors, sid, P.Session(E)).values() for kv in v)
            pull = []
            for p in range(nparts):
                pull.extend(executors[p % E].get_reader(
                    handle, p, p + 1, mbh).read())
            assert bulk == sorted(pull), (trial, sid)
            out.append(bulk)
        return out
    finally:
        _stop(*executors, driver)


def bulk_publish_before_hello_waits(P):
    PublishMsg = importlib.import_module(
        f"{P.name}.rpc.messages").PublishMapTaskOutputMsg
    MapTaskOutput = importlib.import_module(
        f"{P.name}.shuffle.map_output").MapTaskOutput
    types = importlib.import_module(f"{P.name}.utils.types")
    net = P.transport.LoopbackNetwork()
    driver = P.Manager(P.Conf({"spark.shuffle.tpu.driverPort": 39750}),
                       True, net)
    try:
        ghost = types.ShuffleManagerId(
            "127.0.0.1", 49777,
            types.BlockManagerId("g", "127.0.0.1", 49777))
        driver._shuffle_num_maps[90] = 1
        driver._shuffle_partitions[90] = 2
        with driver._plan_lock:
            driver._shuffle_epoch[90] = driver._membership_epoch
        mto = MapTaskOutput(2)
        mto.put(0, types.BlockLocation(0, 8, 1))
        mto.put(1, types.BlockLocation(8, 8, 1))
        driver._handle_publish(PublishMsg(
            ghost, shuffle_id=90, map_id=0, total_num_partitions=2,
            first_reduce_id=0, last_reduce_id=1,
            entries=mto.get_range_bytes(0, 1)))
        plan = driver._get_or_build_plan(90, 1)
        assert plan is P.manager._PLAN_WAIT, plan
        with driver._executors_lock:
            driver._executors.append(ghost)
        plan2 = driver._get_or_build_plan(90, 1)
        assert not isinstance(plan2, str) and plan2 is not \
            P.manager._PLAN_WAIT
        hosts, flat, manifest, idx = plan2
        assert ghost in idx and np.asarray(flat).sum() == 16
        return [list(np.asarray(flat)), manifest]
    finally:
        driver.stop()


def _wcluster(P, window_maps, base):
    return _cluster(P, base, {"spark.shuffle.tpu.bulkWindowMaps":
                              str(window_maps)})


def bulk_windowed_e2e(P):
    net, conf, driver, executors = _wcluster(P, 2, 44500)
    try:
        E, part = 3, P.part.HashPartitioner(9)
        handle = driver.register_shuffle(61, 6, part)
        recs = [[(f"k{j}", (m, j)) for j in range(40)] for m in range(6)]
        for m, r in enumerate(recs):
            w = executors[m % E].get_writer(handle, m)
            w.write(r)
            w.stop(True)
        res, evs = _read_all(P, executors, 61, P.Session(
            E, timeout_s=conf.bulk_barrier_timeout_ms / 1000.0),
            window_events=True)
        _owned_check(part, executors, res, E)
        got = [kv for v in res.values() for kv in v]
        assert _canon(got) == _canon(kv for r in recs for kv in r)
        assert all(v == [0, 1, 2] for v in evs.values()), evs
        return {k: _canon(v) for k, v in res.items()}, evs
    finally:
        _stop(*executors, driver)


def bulk_windowed_overlaps_straggler_map(P):
    net, conf, driver, executors = _wcluster(P, 2, 44900)
    try:
        E, part = 3, P.part.HashPartitioner(6)
        handle = driver.register_shuffle(62, 4, part)
        recs = [[(f"k{j}", (m, j)) for j in range(30)] for m in range(4)]
        for m in range(3):
            w = executors[m % E].get_writer(handle, m)
            w.write(recs[m])
            w.stop(True)
        session = P.Session(
            E, timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
        readers = {e.executor_id: P.bulk.BulkExchangeReader(
            e, session=session) for e in executors}
        results, errors = {}, {}

        def run(e):
            try:
                results[e.executor_id] = list(
                    readers[e.executor_id].read(62))
            except BaseException as err:
                errors[e.executor_id] = err

        ts = [threading.Thread(target=run, args=(e,), daemon=True)
              for e in executors]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(r.window_events for r in readers.values()):
                break
            time.sleep(0.01)
        assert all(r.window_events for r in readers.values()), \
            "no window exchanged before the straggler map published"
        assert not results, "read() returned before the last map"
        w = executors[0].get_writer(handle, 3)
        w.write(recs[3])
        w.stop(True)
        for t in ts:
            t.join(timeout=60)
        assert not errors, errors
        got = [kv for r in results.values() for kv in r]
        assert _canon(got) == _canon(kv for r in recs for kv in r)
        return _canon(got)
    finally:
        _stop(*executors, driver)


def bulk_session_timeout_conf(P):
    session = P.Session(2, timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="bulkBarrierTimeout"):
        session.run(0, [b"", b""], np.zeros((2, 2), np.int64))
    assert time.monotonic() - t0 < 5
    return "timeout"


def bulk_windowed_zero_map_shuffle(P):
    net, conf, driver, executors = _wcluster(P, 2, 45300)
    try:
        driver.register_shuffle(63, 0, P.part.HashPartitioner(4))
        res, evs = _read_all(P, executors, 63, P.Session(
            3, timeout_s=conf.bulk_barrier_timeout_ms / 1000.0),
            window_events=True)
        assert all(v == [] for v in res.values()), res
        assert all(v == [0] for v in evs.values()), evs
        return res, evs
    finally:
        _stop(*executors, driver)


def bulk_mixed_plan_modes_rejected(P):
    net, conf, driver, executors = _wcluster(P, 2, 45700)
    try:
        handle = driver.register_shuffle(64, 3, P.part.HashPartitioner(4))
        for m, e in enumerate(executors):
            w = e.get_writer(handle, m)
            w.write([(f"k{j}", j) for j in range(10)])
            w.stop(True)
        session = P.Session(3)
        r0 = P.bulk.BulkExchangeReader(executors[0], session=session)
        results = {}

        def r0_read():
            try:
                results["ok"] = list(r0.read(64))
            except (P.reader.MetadataFetchFailedError, RuntimeError,
                    TimeoutError) as e:
                results["r0_err"] = e

        t0 = threading.Thread(target=r0_read, daemon=True)
        t0.start()
        time.sleep(0.3)
        ex1 = executors[1]
        old = ex1.conf
        ex1.conf = P.Conf({"spark.shuffle.tpu.driverPort":
                           conf.driver_port})
        try:
            r1 = P.bulk.BulkExchangeReader(ex1, session=session)
            t_start = time.monotonic()
            with pytest.raises(P.reader.MetadataFetchFailedError,
                               match="plan mode mismatch"):
                list(r1.read(64))
            assert time.monotonic() - t_start < 10
        finally:
            ex1.conf = old
            session.abort(RuntimeError("mode-mismatch test teardown"))
            t0.join(timeout=10)
            assert not t0.is_alive(), "r0 reader thread leaked"
        assert "ok" not in results, results
        err = results.get("r0_err")
        assert err is not None and (
            isinstance(err, P.reader.MetadataFetchFailedError)
            or "mode-mismatch test teardown" in str(
                getattr(err, "__cause__", None) or err)), repr(err)
        return "rejected"
    finally:
        _stop(*executors, driver)


def _plane_cluster(P, window_maps, base, n_exec=2, extra=None):
    d = {"spark.shuffle.tpu.bulkWindowMaps": str(window_maps),
         "spark.shuffle.tpu.readPlane": "windowed"}
    d.update(extra or {})
    net, conf, driver, executors = _cluster(P, base, d, n=n_exec)
    session = P.bulk.BulkShuffleSession(
        P.exchange(n_exec, tile_bytes=1 << 12), n_exec,
        timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
    for e in executors:
        e.windowed_plane = P.bulk.WindowedReadPlane(e, session=session)
    return net, conf, driver, executors, session


def windowed_reactive_reader_overlap(P):
    net, conf, driver, executors, _s = _plane_cluster(P, 2, 46200)
    try:
        E, part = 2, P.part.HashPartitioner(6)
        handle = driver.register_shuffle(66, 4, part)
        recs = [[(f"m{m}k{j}", (m, j)) for j in range(60)]
                for m in range(4)]
        for m in range(3):
            w = executors[m % E].get_writer(handle, m)
            w.write(recs[m])
            w.stop(True)
        executors[1].windowed_plane.join(66)
        r0 = executors[0].get_reader(handle, 0, 1, {})
        blocks = []
        finished = threading.Event()

        def consume():
            for data in r0._iter_block_bytes():
                blocks.append((time.monotonic(), bytes(data)))
            finished.set()

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not blocks:
            time.sleep(0.01)
        assert blocks, "no window-0 block reached the reader"
        assert not finished.is_set()
        w = executors[1].get_writer(handle, 3)
        w.write(recs[3])
        w.stop(True)
        th.join(timeout=60)
        assert finished.is_set(), "reader never completed"
        deser = executors[0].serializer.deserialize
        got = [kv for _t, b in blocks for kv in deser(b)]
        want = [kv for r in recs for kv in r if part.partition(kv[0]) == 0]
        assert _canon(got) == _canon(want)
        evs = [w for w, _t, _b in executors[0].windowed_plane
               .window_events(66)]
        assert evs == [0, 1], evs
        return _canon(got), evs
    finally:
        _stop(*executors, driver)


def windowed_all_partitions_via_get_reader(P):
    net, conf, driver, executors, _s = _plane_cluster(P, 2, 46400)
    try:
        E, part = 2, P.part.HashPartitioner(8)
        handle = driver.register_shuffle(67, 6, part)
        recs = [[(f"m{m}k{j}", j) for j in range(40)] for m in range(6)]
        for m, r in enumerate(recs):
            w = executors[m % E].get_writer(handle, m)
            w.write(r)
            w.stop(True)
        results, errors = {}, {}

        def task(pid):
            try:
                results[pid] = list(executors[pid % E].get_reader(
                    handle, pid, pid + 1, {}).read())
            except BaseException as e:
                errors[pid] = e

        _threads(task, [(p,) for p in range(8)])
        assert not errors, errors
        for pid, rs in results.items():
            assert all(part.partition(k) == pid for k, _v in rs)
        got = [kv for rs in results.values() for kv in rs]
        assert _canon(got) == _canon(kv for r in recs for kv in r)
        evs = [[w for w, _t, _b in e.windowed_plane.window_events(67)]
               for e in executors]
        assert all(v == [0, 1, 2] for v in evs), evs
        return {p: _canon(v) for p, v in results.items()}, evs
    finally:
        _stop(*executors, driver)


def windowed_ownership_violation_fails_fast(P):
    net, conf, driver, executors, _s = _plane_cluster(P, 0, 46600)
    try:
        handle = driver.register_shuffle(68, 2, P.part.HashPartitioner(4))
        for m in range(2):
            w = executors[m].get_writer(handle, m)
            w.write([(f"k{j}", j) for j in range(10)])
            w.stop(True)
        for e in executors:
            e.windowed_plane.join(68)
        r = executors[0].get_reader(handle, 1, 2, {})
        with pytest.raises(P.reader.FetchFailedError,
                           match="belongs to host"):
            list(r.read())
        return "refused"
    finally:
        _stop(*executors, driver)


def windowed_context_e2e(P):
    conf = P.Conf({"spark.shuffle.tpu.serializer": "columnar",
                   "spark.shuffle.tpu.readPlane": "windowed",
                   "spark.shuffle.tpu.bulkWindowMaps": "2"})
    with P.Context(num_executors=2, conf=conf, base_port=46800) as ctx:
        keys = np.arange(3000, dtype=np.int64) % 17
        vals = np.arange(3000, dtype=np.int64)
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=4)
                   .reduce_by_key("sum").collect())
        srt = (ctx.parallelize_columns(keys[:500], vals[:500], num_slices=4)
               .sort_by_key().collect())
    expect = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        expect[k] = expect.get(k, 0) + v
    assert got == expect
    assert [k for k, _v in srt] == sorted(keys[:500].tolist())
    return sorted(got.items()), [k for k, _v in srt]


def windowed_failure_then_stage_retry(P):
    """Kill an executor mid-windowed-shuffle: every reader fails fast;
    then the shuffle re-registered on the survivors completes."""
    net, conf, driver, executors = _cluster(P, 46950, {
        "spark.shuffle.tpu.heartbeatInterval": "100ms",
        "spark.shuffle.tpu.heartbeatTimeout": "3s",
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "8s",
        "spark.shuffle.tpu.bulkWindowMaps": "2",
        "spark.shuffle.tpu.readPlane": "windowed",
    })
    try:
        E = 3
        session = P.bulk.BulkShuffleSession(
            P.exchange(E, tile_bytes=1 << 12), E,
            timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
        for e in executors:
            e.windowed_plane = P.bulk.WindowedReadPlane(e, session=session)
        part = P.part.HashPartitioner(6)
        recs = [[(f"m{m}k{j}", (m, j)) for j in range(30)]
                for m in range(6)]
        handle = driver.register_shuffle(75, 6, part)
        for m in range(3):
            w = executors[m % E].get_writer(handle, m)
            w.write(recs[m])
            w.stop(True)
        results, errors, error_times = {}, {}, {}

        def task(pid, execs, hdl, nE):
            try:
                results[pid] = list(execs[pid % nE].get_reader(
                    hdl, pid, pid + 1, {}).read())
            except BaseException as e:
                errors[pid] = e
                error_times[pid] = time.monotonic()

        ts = [threading.Thread(target=task, args=(p, executors, handle, E),
                               daemon=True) for p in range(6)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(e.windowed_plane.window_events(75) for e in executors):
                break
            time.sleep(0.01)
        assert all(e.windowed_plane.window_events(75) for e in executors)
        t_kill = time.monotonic()
        net.partition(executors[2].node.address)
        for t in ts:
            t.join(timeout=45)
        assert not results, results
        assert set(errors) == set(range(6)), errors
        assert all(isinstance(e, P.reader.FetchFailedError)
                   for e in errors.values()), errors
        for pid, t_err in error_times.items():
            if pid % E != 2:
                assert t_err - t_kill < 5, (pid, t_err - t_kill)
        survivors = executors[:2]
        handle2 = driver.register_shuffle(76, 6, part)
        for m in range(6):
            w = survivors[m % 2].get_writer(handle2, m)
            w.write(recs[m])
            w.stop(True)
        session2 = P.bulk.BulkShuffleSession(
            P.exchange(2, tile_bytes=1 << 12), 2,
            timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
        for e in survivors:
            e.windowed_plane = P.bulk.WindowedReadPlane(e, session=session2)
        results.clear()
        errors.clear()
        _threads(task, [(p, survivors, handle2, 2) for p in range(6)])
        assert not errors, errors
        got = [kv for rs in results.values() for kv in rs]
        assert _canon(got) == _canon(kv for r in recs for kv in r)
        evs = [[w for w, _t, _b in e.windowed_plane.window_events(76)]
               for e in survivors]
        assert all(v == [0, 1, 2] for v in evs), evs
        return _canon(got), evs
    finally:
        net.heal(executors[2].node.address)
        _stop(*executors, driver)


def _concurrent(jobs, timeout=120):
    out, errs = {}, {}

    def wrap(tag, fn):
        try:
            out[tag] = fn()
        except BaseException as e:
            errs[tag] = e

    ts = _threads(wrap, jobs, timeout=timeout)
    assert not any(t.is_alive() for t in ts), "hung job"
    assert not errs, errs
    return out


def windowed_concurrent_shuffles_one_session(P):
    conf = P.Conf({"spark.shuffle.tpu.serializer": "columnar",
                   "spark.shuffle.tpu.readPlane": "windowed",
                   "spark.shuffle.tpu.bulkWindowMaps": "2"})
    with P.Context(num_executors=2, conf=conf, base_port=48300) as ctx:
        keys = np.arange(4000, dtype=np.int64) % 7
        va = np.arange(4000, dtype=np.int64)
        vb = va * 10

        def job(vals):
            return lambda: dict(
                ctx.parallelize_columns(keys, vals, num_slices=4)
                .reduce_by_key("sum", num_partitions=4).collect())

        out = _concurrent([("a", job(va)), ("b", job(vb))])
    for tag, vals in (("a", va), ("b", vb)):
        expect = {}
        for k, v in zip(keys.tolist(), vals.tolist()):
            expect[k] = expect.get(k, 0) + v
        assert out[tag] == expect, tag
    return {t: sorted(v.items()) for t, v in out.items()}


def windowed_over_spilled_file_backed_commits(P, tmp):
    conf = P.Conf({"spark.shuffle.tpu.serializer": "columnar",
                   "spark.shuffle.tpu.readPlane": "windowed",
                   "spark.shuffle.tpu.bulkWindowMaps": "2",
                   "spark.shuffle.tpu.shuffleSpillRecordThreshold": "1000",
                   "spark.shuffle.tpu.spillDir": str(tmp)})
    with P.Context(num_executors=2, conf=conf, base_port=48500) as ctx:
        keys = np.arange(40000, dtype=np.int64) % 29
        vals = np.arange(40000, dtype=np.int64)
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=6)
                   .reduce_by_key("sum", num_partitions=6).collect())
        assert ctx.executors[0].windowed_plane.stats()[
            "payload_bytes_moved"] > 0
    expect = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        expect[k] = expect.get(k, 0) + v
    assert got == expect
    import glob

    assert not glob.glob(str(tmp / "sparkrdma*")), "files leaked"
    return sorted(got.items())


def windowed_many_concurrent_no_leak(P):
    conf = P.Conf({"spark.shuffle.tpu.serializer": "columnar",
                   "spark.shuffle.tpu.readPlane": "windowed",
                   "spark.shuffle.tpu.bulkWindowMaps": "2"})
    with P.Context(num_executors=2, conf=conf, base_port=48900) as ctx:
        def job(tag):
            def run():
                keys = np.arange(3000, dtype=np.int64) % (5 + tag)
                vals = np.full(3000, tag + 1, np.int64)
                return dict(ctx.parallelize_columns(keys, vals, num_slices=4)
                            .reduce_by_key("sum", num_partitions=4)
                            .collect())
            return run

        out = _concurrent([(t, job(t)) for t in range(4)])
        for tag in range(4):
            nk = 5 + tag
            assert out[tag] == {
                k: (tag + 1) * len([x for x in range(3000) if x % nk == k])
                for k in range(nk)}, tag
        session = ctx.executors[0].windowed_plane._bulk.session
        with session._cv:
            assert not session._keyed, list(session._keyed)
    return {t: sorted(v.items()) for t, v in out.items()}


def windowed_chaos_random_loss(P):
    """An executor loss at a seeded random point of the map/window
    schedule: every reducer ends with its exact partition or a prompt
    FetchFailedError, never wrong data or a hang.  Returns the seeded
    schedule and the oracle's verdict (timing decides which reducers
    finish, so their count is not compared).  The barrier timeout is
    10 s instead of the default 120 s: a survivor parked in a window's
    barrier when the loss lands fails through it, as a FetchFailedError,
    within the file's time budget."""
    rng = random.Random(int(os.environ.get("SPARKRDMA_TEST_CHAOS_SEED",
                                           "4321")))
    E, num_maps, num_parts = 3, 6, 6
    verdicts = []
    for trial in range(int(os.environ.get("SPARKRDMA_TEST_CHAOS_TRIALS",
                                          "2"))):
        net, conf, driver, executors = _cluster(P, 46200, {
            "spark.shuffle.tpu.heartbeatInterval": "100ms",
            "spark.shuffle.tpu.heartbeatTimeout": "3s",
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "8s",
            "spark.shuffle.tpu.bulkBarrierTimeout": "10s",
            "spark.shuffle.tpu.bulkWindowMaps": "2",
            "spark.shuffle.tpu.readPlane": "windowed",
        }, n=E)
        victim = executors[rng.randrange(1, E)]
        try:
            session = P.bulk.BulkShuffleSession(
                P.exchange(E, tile_bytes=1 << 12), E,
                timeout_s=conf.bulk_barrier_timeout_ms / 1000.0)
            for e in executors:
                e.windowed_plane = P.bulk.WindowedReadPlane(
                    e, session=session)
            part = P.part.HashPartitioner(num_parts)
            recs = [[(f"m{m}k{j}", (m, j)) for j in range(25)]
                    for m in range(num_maps)]
            handle = driver.register_shuffle(800 + trial, num_maps, part)
            fault = rng.choice(["none", "loss", "loss"])
            kill_after = rng.randrange(2, num_maps + 1)
            results, errors = {}, {}

            def task(pid):
                try:
                    results[pid] = list(executors[pid % E].get_reader(
                        handle, pid, pid + 1, {}).read())
                except BaseException as e:
                    errors[pid] = e

            ts = [threading.Thread(target=task, args=(p,), daemon=True)
                  for p in range(num_parts)]
            for t in ts:
                t.start()
            for m in range(num_maps):
                if fault == "loss" and m == kill_after:
                    net.partition(victim.node.address)
                w = executors[m % E].get_writer(handle, m)
                w.write(recs[m])
                try:
                    w.stop(True)
                except BaseException:
                    pass
                time.sleep(rng.uniform(0, 0.01))
            if fault == "loss" and kill_after == num_maps:
                net.partition(victim.node.address)
            for t in ts:
                t.join(timeout=120)
            hung = [p for p in range(num_parts)
                    if p not in results and p not in errors]
            assert not hung, (trial, hung)
            flat = [kv for r in recs for kv in r]
            for pid, got in results.items():
                want = [kv for kv in flat if part.partition(kv[0]) == pid]
                assert _canon(got) == _canon(want), (trial, pid)
            for pid, err in errors.items():
                assert isinstance(err, P.reader.FetchFailedError), err
            if fault == "none":
                assert not errors, errors
            verdicts.append((fault, kill_after, "exact-or-failed"))
        finally:
            net.heal(victim.node.address)
            _stop(*executors, driver)
    return verdicts


def windowed_generator_close_cancels_prefetched_waiter(P):
    cancelled = []

    class Waiter:
        def __init__(self, window):
            self.window = window

        def wait(self):
            return SimpleNamespace(final=False, window=self.window)

        def cancel(self):
            cancelled.append(self.window)

    reader = P.bulk.BulkExchangeReader.__new__(P.bulk.BulkExchangeReader)
    reader._fetch_plan_async = lambda sid, window: Waiter(window)
    reader._exchange_rows = lambda sid, window, plan: (plan, 2, [b"", b""])

    def run():
        gen_ = reader._iter_windowed_exchanges(0)
        plan, _e, _row = next(gen_)
        assert plan.window == 0
        gen_.close()

    _, counters = P.counted(run)
    assert cancelled == [1]
    assert counters.get("shuffle_plan_waiters_cancelled_total") == 1
    return cancelled


def windowed_generator_wait_failure_cancels(P):
    cancelled = []

    class FailingWaiter:
        def __init__(self, window):
            self.window = window

        def wait(self):
            raise RuntimeError("driver gone")

        def cancel(self):
            cancelled.append(self.window)

    reader = P.bulk.BulkExchangeReader.__new__(P.bulk.BulkExchangeReader)
    reader._fetch_plan_async = lambda sid, window: FailingWaiter(window)
    gen_ = reader._iter_windowed_exchanges(0)
    with pytest.raises(RuntimeError, match="driver gone"):
        next(gen_)
    assert cancelled == [0]
    return cancelled


BULK_CASES = {f.__name__: f for f in (
    bulk_e2e, bulk_plan_unregistered_fails_fast,
    bulk_plan_waits_for_all_maps, bulk_empty_partitions,
    bulk_read_plane_via_context, bulk_columnar_fast_path,
    bulk_session_abort_unblocks_waiters, bulk_concurrent_shuffles,
    bulk_matches_pull_fuzz, bulk_publish_before_hello_waits,
    bulk_windowed_e2e, bulk_windowed_overlaps_straggler_map,
    bulk_session_timeout_conf, bulk_windowed_zero_map_shuffle,
    bulk_mixed_plan_modes_rejected, windowed_reactive_reader_overlap,
    windowed_all_partitions_via_get_reader,
    windowed_ownership_violation_fails_fast, windowed_context_e2e,
    windowed_failure_then_stage_retry,
    windowed_concurrent_shuffles_one_session,
    windowed_many_concurrent_no_leak, windowed_chaos_random_loss,
    windowed_generator_close_cancels_prefetched_waiter,
    windowed_generator_wait_failure_cancels,
)}


@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_bulk_shuffle_case(pkgs, case):
    both(pkgs, BULK_CASES[case])


def test_windowed_over_spilled_file_backed_commits(pkgs, tmp_path):
    both(pkgs, lambda P: windowed_over_spilled_file_backed_commits(
        P, tmp_path / P.name))


# -- tests/test_device_exchange.py: the sweep and the off-mode pin ------------


def _write_maps(driver, executors, sid, num_maps, num_parts, P, seed=0,
                int_records=False, rec_bytes=200, recs_per_map=30):
    rng = np.random.default_rng(seed)
    handle = driver.register_shuffle(sid, num_maps,
                                     P.part.HashPartitioner(num_parts))
    if int_records:
        recs = [[((m * 1000 + j) * 2654435761 % 100003, m * 1000 + j)
                 for j in range(recs_per_map)] for m in range(num_maps)]
    else:
        recs = [[(f"m{m}k{j}", rng.bytes(int(rng.integers(1, rec_bytes))))
                 for j in range(recs_per_map)] for m in range(num_maps)]
    mbh = {}
    for m, r in enumerate(recs):
        ex = executors[m % len(executors)]
        w = ex.get_writer(handle, m)
        w.write(r)
        w.stop(True)
        mbh.setdefault(ex.local_smid, []).append(m)
    return handle, recs, mbh


def _read_partitions(executors, handle, num_parts, locs=None, raw=False):
    E = len(executors)
    out, errs = {}, {}

    def task(pid):
        try:
            r = executors[pid % E].get_reader(handle, pid, pid + 1,
                                              dict(locs or {}))
            out[pid] = ([bytes(memoryview(b)) for b in r._iter_block_bytes()]
                        if raw else sorted(r.read(), key=repr))
        except BaseException as e:
            errs[pid] = e

    _threads(task, [(p,) for p in range(num_parts)])
    assert not errs, errs
    return out if raw else [out[p] for p in range(num_parts)]


def _plane_run(P, n_exec, extra, sid, seed, int_records=False, raw=False,
               num_maps=4, num_parts=4):
    d = {"spark.shuffle.tpu.bulkWindowMaps": "2",
         "spark.shuffle.tpu.readPlane": "windowed"}
    d.update(extra)
    net, conf, driver, executors = _cluster(P, 53000, d, n=n_exec)
    session = None
    if conf.read_plane == "windowed":
        session = P.bulk.BulkShuffleSession(
            P.exchange_from_conf(conf, n_exec), n_exec,
            timeout_s=conf.bulk_barrier_timeout_ms / 1000.0,
            window_rounds=conf.device_exchange_window_rounds)
        for e in executors:
            e.windowed_plane = P.bulk.WindowedReadPlane(e, session=session)
    try:
        handle, _recs, mbh = _write_maps(
            driver, executors, sid, num_maps, num_parts, P, seed=seed,
            int_records=int_records)
        out = _read_partitions(executors, handle, num_parts, locs=mbh,
                               raw=raw)
        dev = session.exchange.stats()["device_exchanges"] if session \
            else 0
        return out, dev
    finally:
        _stop(*executors, driver)


def test_off_mode_byte_identical_pin(pkgs):
    """deviceExchangeEnabled=false routes the shuffle through the
    host-staged exchange with byte-identical block streams; the toggle
    routes (``device_exchanges``), in both packages alike."""
    def run(P):
        blocks, devs = {}, {}
        for on in ("true", "false"):
            blocks[on], devs[on] = _plane_run(
                P, 2, {"spark.shuffle.tpu.deviceExchangeEnabled": on},
                700, seed=77, raw=True, num_maps=6, num_parts=6)
        assert blocks["true"] == blocks["false"]
        assert any(v for v in blocks["true"].values())
        assert devs["true"] > 0 and devs["false"] == 0
        return blocks["true"], devs["true"] > 0
    both(pkgs, run)


@pytest.mark.parametrize("threads", [0, 4])
@pytest.mark.parametrize("mode", ["pickle", "columnar"])
@pytest.mark.parametrize("n_exec", [2, 4])
def test_bit_exact_sweep(pkgs, n_exec, mode, threads):
    """The same seeded shuffle through the device-native exchange, the
    host-staged exchange and the socket pull reader gives the same
    records, in both packages."""
    ser = {} if mode == "pickle" else {
        "spark.shuffle.tpu.serializer": "columnar"}
    planes = {
        "device": {"spark.shuffle.tpu.deviceExchangeEnabled": "true"},
        "host": {"spark.shuffle.tpu.deviceExchangeEnabled": "false"},
        "socket": {"spark.shuffle.tpu.readPlane": "host"},
    }
    sid = 710 + n_exec * 2 + (0 if mode == "pickle" else 1)

    def run(P):
        outs, devs = {}, {}
        for plane, extra in planes.items():
            d = dict(ser, **extra)
            d["spark.shuffle.tpu.decodeThreads"] = str(threads)
            outs[plane], devs[plane] = _plane_run(
                P, n_exec, d, sid, seed=13,
                int_records=(mode == "columnar"))
        assert any(outs["socket"])
        assert outs["device"] == outs["socket"] == outs["host"]
        assert devs["device"] > 0 and devs["host"] == 0
        return outs["socket"]
    both(pkgs, run)


def test_multi_round_overlap_early_delivery(pkgs, monkeypatch):
    """A multi-round device exchange hands landed rounds to the decode
    side early and stays bit-exact with the host-staged path."""
    def run(P):
        seen = []
        orig = P.bulk._make_round_emitter

        def spy(plan, E, me, lengths, sink):
            inner = orig(plan, E, me, lengths, sink)

            def wrapped(rnd, lo, hi, rows):
                seen.append(rnd)
                return inner(rnd, lo, hi, rows)
            return wrapped

        monkeypatch.setattr(P.bulk, "_make_round_emitter", spy)
        outs = {}
        for key, extra in (
                ("device", {
                    "spark.shuffle.tpu.deviceExchangeEnabled": "true",
                    "spark.shuffle.tpu.exchangeTileBytes": str(64 << 10),
                    "spark.shuffle.tpu.deviceExchangeWindowRounds": "2"}),
                ("host", {"spark.shuffle.tpu.deviceExchangeEnabled":
                          "false"})):
            d = {"spark.shuffle.tpu.bulkWindowMaps": "2",
                 "spark.shuffle.tpu.readPlane": "windowed", **extra}
            net, conf, driver, executors = _cluster(P, 53000, d, n=2)
            session = P.bulk.BulkShuffleSession(
                P.exchange_from_conf(conf, 2), 2,
                timeout_s=conf.bulk_barrier_timeout_ms / 1000.0,
                window_rounds=conf.device_exchange_window_rounds)
            for e in executors:
                e.windowed_plane = P.bulk.WindowedReadPlane(
                    e, session=session)
            try:
                rng = np.random.default_rng(31)
                handle = driver.register_shuffle(
                    720, 4, P.part.HashPartitioner(2))
                for m in range(4):
                    w = executors[m % 2].get_writer(handle, m)
                    w.write([(f"m{m}k{j}",
                              rng.bytes(int(rng.integers(1, 2000))))
                             for j in range(120)])
                    w.stop(True)
                outs[key] = _read_partitions(executors, handle, 2)
            finally:
                _stop(*executors, driver)
        assert outs["device"] == outs["host"] and any(outs["device"])
        assert len(set(seen)) > 1, seen
        return outs["device"]
    both(pkgs, run)


# -- tests/test_zero_copy_exchange.py: the windowed cases ---------------------


def test_windowed_pipelined_bit_exact_vs_serial(pkgs):
    def run(P):
        blocks = {}
        for pipelined in (True, False):
            blocks[pipelined], _ = _plane_run(
                P, 2, {"spark.shuffle.tpu.bulkPipelineWindows":
                       str(pipelined)}, 210, seed=42, raw=True,
                num_maps=6, num_parts=6)
        assert blocks[True] == blocks[False]
        assert any(v for v in blocks[True].values())
        return blocks[True]
    both(pkgs, run)


@pytest.mark.parametrize("device_path", [False, True])
def test_windowed_pipeline_abort_fails_all_windows_promptly(pkgs,
                                                            device_path):
    """Poisoning the session mid-pipeline fails the in-flight window and
    the one being assembled: every reader gets FetchFailedError fast.
    With the device path on, the windows run as device rounds (the
    mid-round abort of tests/test_device_exchange.py)."""
    def run(P):
        extra = {"spark.shuffle.tpu.bulkPipelineWindows": "true",
                 "spark.shuffle.tpu.partitionLocationFetchTimeout": "3s"}
        if device_path:
            extra.update({
                "spark.shuffle.tpu.deviceExchangeEnabled": "true",
                "spark.shuffle.tpu.exchangeTileBytes": str(64 << 10),
                "spark.shuffle.tpu.deviceExchangeWindowRounds": "2"})
        net, conf, driver, executors, session = _plane_cluster(
            P, 2, 52600, extra=extra)
        try:
            E = 2
            handle = driver.register_shuffle(211, 6,
                                             P.part.HashPartitioner(4))
            for m in range(3):
                w = executors[m % E].get_writer(handle, m)
                w.write([(f"m{m}k{j}", j) for j in range(20)])
                w.stop(True)
            results, errors = {}, {}

            def task(pid):
                try:
                    results[pid] = list(executors[pid % E].get_reader(
                        handle, pid, pid + 1, {}).read())
                except BaseException as e:
                    errors[pid] = e

            ts = [threading.Thread(target=task, args=(p,), daemon=True)
                  for p in range(4)]
            for t in ts:
                t.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if all(e.windowed_plane.window_events(211)
                       for e in executors):
                    break
                time.sleep(0.01)
            assert all(e.windowed_plane.window_events(211)
                       for e in executors)
            t0 = time.monotonic()
            session.abort(RuntimeError("mid-pipeline participant loss"))
            for t in ts:
                t.join(timeout=20)
            took = time.monotonic() - t0
            assert not any(t.is_alive() for t in ts), "reader hung"
            assert not results, results
            assert set(errors) == set(range(4))
            assert all(isinstance(e, P.reader.FetchFailedError)
                       for e in errors.values()), errors
            assert took < 15, took
            return sorted(errors)
        finally:
            _stop(*executors, driver)
    both(pkgs, run)


def test_windowed_zero_copy_smoke_counters(pkgs):
    def run(P):
        def body():
            return _plane_run(P, 2, {
                "spark.shuffle.tpu.metrics": "true",
                "spark.shuffle.tpu.bulkPipelineWindows": "true"},
                212, seed=3, raw=True)
        (got, _dev), vals = P.counted(body)
        assert any(got.values())
        assert vals.get("exchange_assembly_bytes_total", 0) > 0
        assert vals.get("exchange_assembly_materialized_blocks_total",
                        0) == 0
        assert vals.get("exchange_copy_bytes_avoided_total", 0) > 0
        assert vals.get("exchange_windows_pipelined_total", 0) >= 1
        return got, vals["exchange_assembly_bytes_total"]
    both(pkgs, run)


def test_session_array_and_mixed_rows(pkgs):
    """Array rows ride exchange_into; a round with one legacy list
    contributor downgrades to the bytes path with identical output."""
    def run(P):
        E = 2
        rng = np.random.default_rng(11)
        lengths = np.array([[100, 200], [300, 50]], np.int64)
        streams = [[rng.bytes(int(lengths[s, d])) for d in range(E)]
                   for s in range(E)]
        rows = {s: gen.contig_row(lengths, streams, s) for s in range(E)}
        got = []
        for mixed in (False, True):
            session = P.Session(E)
            out = {}

            def contribute(me, c):
                out[me] = session.run(me, c, lengths)

            t = threading.Thread(target=contribute, args=(
                1, list(streams[1]) if mixed else rows[1]), daemon=True)
            t.start()
            time.sleep(0.05)
            contribute(0, rows[0])
            t.join(timeout=30)
            for me in range(E):
                for s in range(E):
                    assert bytes(memoryview(out[me][me][s])) == \
                        streams[s][me]
            got.append(session.exchange.stats())
        return got
    both(pkgs, run)


# -- readPlane through TpuShuffleContext ---------------------------------------


@pytest.mark.parametrize("plane", ["bulk", "windowed", "collective"])
@pytest.mark.parametrize("E", [2, 4])
def test_context_read_planes(pkgs, plane, E, caplog):
    """``readPlane`` bulk, windowed and collective (rewritten to windowed
    with a warning) through the context: the port on the CPU equals the
    JAX context on ``make_mesh(E)``, results and, on the windowed plane,
    the window events of every executor (one window per plan with
    ``bulkWindowMaps=0``)."""
    def run(P):
        conf = P.Conf({"spark.shuffle.tpu.readPlane": plane,
                       "spark.shuffle.tpu.serializer": "columnar"})
        rng = np.random.default_rng(5)
        keys = rng.integers(0, 300, 6000).astype(np.int64)
        vals = rng.integers(-1000, 1000, 6000).astype(np.int64)
        with P.Context(num_executors=E, conf=conf, base_port=47000) as ctx:
            assert ctx.conf.read_plane == (
                "windowed" if plane == "collective" else plane)
            # the window events of every shuffle, kept as each executor
            # forgets the shuffle
            evs = {}
            for i, ex in enumerate(ctx.executors):
                wp = ex.windowed_plane
                if wp is None:
                    continue

                def forget(sid, wp=wp, i=i, orig=wp.forget):
                    # stop() forgets each shuffle a second time, empty
                    evs.setdefault((sid, i), [w for w, _t, _b in
                                              wp.window_events(sid)])
                    orig(sid)
                wp.forget = forget
            got = dict(ctx.parallelize_columns(keys, vals, num_slices=2 * E)
                       .reduce_by_key("sum", num_partitions=8).collect())
            srt = (ctx.parallelize_columns(keys[:800], vals[:800], 3)
                   .sort_by_key(num_partitions=5).collect())
        want = {}
        for k, v in zip(keys.tolist(), vals.tolist()):
            want[k] = want.get(k, 0) + v
        assert got == want
        assert [k for k, _v in srt] == sorted(keys[:800].tolist())
        if plane != "bulk":
            assert len(evs) == 2 * E and all(evs.values()), evs
        return sorted(got.items()), srt, sorted(evs.items())
    with caplog.at_level("WARNING"):
        both(pkgs, run)
    if plane == "collective":
        assert "superseded by the unified windowed plane" in caplog.text


def test_context_lazy_staging_arena(pkgs):
    """``lazyStaging`` on the windowed plane: one device arena per
    executor on the context's device, and the shuffle still exact."""
    P = pkgs[1]
    conf = P.Conf({"spark.shuffle.tpu.readPlane": "windowed",
                   "spark.shuffle.tpu.lazyStaging": "true",
                   "spark.shuffle.tpu.deviceArenaBytes": str(1 << 20)})
    with P.Context(num_executors=2, conf=conf, base_port=47200) as ctx:
        arenas = [ex.device_arena for ex in ctx.executors]
        assert all(a is not None for a in arenas)
        assert len({id(a) for a in arenas}) == 2
        assert all(str(a.device) == CPU for a in arenas)
        got = dict(ctx.parallelize([(i % 13, 1) for i in range(2000)], 4)
                   .reduce_by_key(lambda a, b: a + b).collect())
    assert got == {k: len(range(k, 2000, 13)) for k in range(13)}


def test_bulk_task_failure_aborts_session(pkgs, monkeypatch):
    """A failing bulk task poisons the session: its peers fail at once
    instead of riding out the barrier timeout, and the error reaches the
    caller."""
    P = pkgs[1]
    conf = P.Conf({"spark.shuffle.tpu.readPlane": "bulk",
                   "spark.shuffle.tpu.bulkBarrierTimeout": "60s"})
    calls = []
    orig = P.bulk.BulkExchangeReader._assemble

    def boom(self, *a, **kw):
        calls.append(self.manager.executor_id)
        if self.manager.executor_id == "1":
            raise RuntimeError("assembly exploded")
        return orig(self, *a, **kw)

    monkeypatch.setattr(P.bulk.BulkExchangeReader, "_assemble", boom)
    with P.Context(num_executors=3, conf=conf, base_port=47400) as ctx:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="assembly exploded|aborted"):
            ctx.parallelize([(i, i) for i in range(300)], 3) \
                .reduce_by_key(lambda a, b: a + b).collect()
        assert time.monotonic() - t0 < 30
    assert "1" in calls


def test_rank_local_reader_refuses_wrong_rank(pkgs):
    """Across processes a reader's exchange is rank-local: a plan whose
    canonical index for this host is not the group rank fails with
    MetadataFetchFailedError instead of exchanging zeros."""
    P = pkgs[1]
    net, conf, driver, executors = _cluster(P, 47600, n=2)
    try:
        handle = driver.register_shuffle(5, 2, P.part.HashPartitioner(2))
        for m in range(2):
            w = executors[m].get_writer(handle, m)
            w.write([(m, m)])
            w.stop(True)

        class RankOne:
            is_colocated = False
            rank = 1
            n_devices = 2

            def plan(self, lengths):
                return P.xmod.ExchangePlan(lengths, 4096)

        reader = P.bulk.BulkExchangeReader(executors[0], exchange=RankOne())
        with pytest.raises(P.reader.MetadataFetchFailedError,
                           match="group rank 1"):
            list(reader.read(5))
    finally:
        _stop(*executors, driver)


# -- the pool-backed bridge ----------------------------------------------------


def test_bridge_pool_rows(pkgs):
    """``DeviceStagingBridge(device, pool)`` hands out pooled rows (the
    JAX ``DeviceStagingBridge(pool)``), recycled when the last view dies
    and plain numpy, counted, when the budget is spent; without a pool
    the rows are the device's host rows."""
    from sparkrdma_tpu.memory.device_arena import (
        DeviceStagingBridge as JBridge,
    )
    from sparkrdma_tpu.memory.staging import StagingPool as JPool
    from sparkrdma_tpu_torch.memory.device_arena import DeviceStagingBridge
    from sparkrdma_tpu_torch.memory.staging import StagingPool

    def run(P, Bridge, Pool):
        pool = Pool(max_bytes=1 << 20)
        br = Bridge(pool=pool) if not P.port else Bridge(CPU, pool=pool)

        def body():
            a = br.alloc_row(4000)
            b = br.alloc_row(300_000)
            assert a.dtype == np.uint8 and a.shape == (4000,)
            a[:] = 7
            assert Bridge.as_words(a) is not None
            c = br.alloc_row(2 << 20)  # over budget: plain numpy
            assert c.shape == (2 << 20,)
            e = br.alloc_row(0)
            return [a.shape, b.shape, c.shape, e.shape]

        shapes, counters = P.counted(body)
        pool.close()
        return shapes, counters.get("exchange_row_pool_fallbacks_total")

    want = run(pkgs[0], JBridge, JPool)
    got = run(pkgs[1], DeviceStagingBridge, StagingPool)
    assert got == want and got[1] == 1
    plain = DeviceStagingBridge(CPU).alloc_row(64)
    assert plain.shape == (64,) and plain.dtype == np.uint8


def test_source_row_alloc_choice(pkgs):
    """The assembled source rows: the staging pool on the CPU (as in
    the JAX package); pinned rows on a card (tests/test_torch_gpu.py)."""
    P = pkgs[1]
    net, conf, driver, executors = _cluster(P, 47800, n=1)
    try:
        ex = executors[0]
        sizes = []
        orig = ex.staging_pool.alloc_gc

        def alloc_gc(n):
            sizes.append(n)
            return orig(n)

        ex.staging_pool.alloc_gc = alloc_gc
        row = P.bulk.source_row_alloc(ex)(10_000)
        assert row.shape == (10_000,) and sizes == [10_000]
    finally:
        _stop(*executors, driver)
