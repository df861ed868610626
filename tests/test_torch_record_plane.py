"""The port's record-level shuffle on the host read plane
(``sparkrdma_tpu_torch.api`` / ``shuffle/``) held against the JAX
package on the same seeded inputs, on the CPU.

Every job case of tests/test_api.py and every loopback case of
tests/test_shuffle_e2e.py runs through both packages with map outputs
staged to the device (CPU tensors in the port, JAX CPU arrays in the
reference) and kept on the host.  Results must be equal: record for
record, and in order where the JAX result is ordered.  Also here: the
committed segment bytes of a map task, the failure classes, the
resource ledger and arena after ``stop()``, a columnar subset of
tests/test_columnar.py, the cases of tests/test_map_output.py, one TCP
shuffle, and the refusal without CUDA.  The bulk and windowed read
planes are in tests/test_torch_device_planes.py.
"""

import contextlib
import importlib
import pathlib
import random
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


class Pkg:
    """One package's record-plane modules, and the keyword arguments
    its entry points need on the CPU."""

    def __init__(self, root: str, kw: dict):
        self.name = root
        imp = importlib.import_module
        self.api = imp(f"{root}.api")
        self.conf = imp(f"{root}.conf")
        self.manager = imp(f"{root}.shuffle.manager")
        self.part = imp(f"{root}.shuffle.partitioner")
        self.reader = imp(f"{root}.shuffle.reader")
        self.map_output = imp(f"{root}.shuffle.map_output")
        self.transport = imp(f"{root}.transport")
        self.columns = imp(f"{root}.utils.columns")
        self.types = imp(f"{root}.utils.types")
        self.ledger = imp(f"{root}.utils.ledger")
        self.kw = kw

    def Conf(self, d=None):
        return self.conf.TpuShuffleConf(dict(d or {}))

    def Manager(self, conf, is_driver, net, **kw):
        return self.manager.TpuShuffleManager(
            conf, is_driver=is_driver, network=net, **self.kw, **kw
        )

    def Context(self, **kw):
        return self.api.TpuShuffleContext(**self.kw, **kw)


@pytest.fixture(scope="module")
def pkgs(devices):
    return (Pkg("sparkrdma_tpu", {}), Pkg("sparkrdma_tpu_torch",
                                          {"device": "cpu"}))


@pytest.fixture(scope="module")
def dev_kw(pkgs):
    """The device workloads' placement: the JAX models on a one-device
    mesh, the port's on the context's device."""
    from sparkrdma_tpu.parallel.mesh import make_mesh

    return {"sparkrdma_tpu": {"mesh": make_mesh(1)},
            "sparkrdma_tpu_torch": {}}


STAGES = [pytest.param(False, id="host"), pytest.param(True, id="staged")]


@pytest.fixture(scope="module")
def contexts(pkgs):
    """(package, stage_to_device) -> a 3-executor context, built once."""
    made = {}

    def get(P, stage):
        key = (P.name, stage)
        if key not in made:
            made[key] = P.Context(num_executors=3, base_port=43000,
                                  stage_to_device=stage)
        return made[key]

    yield get
    for c in made.values():
        c.stop()


# -- the job cases of tests/test_api.py --------------------------------------
# Each returns a canonical result: sorted where the job's output order is
# not defined, exact where it is.


def job_narrow_ops_fused(ctx, P, dk):
    ds = ctx.parallelize(range(100), num_slices=5)
    out = ds.map(lambda x: x * 2).filter(lambda x: x % 4 == 0).collect()
    assert sorted(out) == [x * 2 for x in range(100) if (x * 2) % 4 == 0]
    return sorted(out), ds.flat_map(lambda x: [x, x]).count()


def job_reduce_by_key(ctx, P, dk):
    ds = ctx.parallelize(range(10_000), num_slices=8)
    got = dict(ds.map(lambda x: (x % 97, 1))
               .reduce_by_key(lambda a, b: a + b, num_partitions=5)
               .collect())
    expected = defaultdict(int)
    for x in range(10_000):
        expected[x % 97] += 1
    assert got == dict(expected)
    return sorted(got.items())


def job_group_by_key(ctx, P, dk):
    ds = ctx.parallelize([(i % 7, i) for i in range(500)], num_slices=6)
    got = dict(ds.group_by_key(num_partitions=4).collect())
    assert sorted(got) == list(range(7))
    return sorted((k, sorted(v)) for k, v in got.items())


def job_sort_by_key_global_order(ctx, P, dk):
    rng = random.Random(3)
    keys = [rng.randrange(10**6) for _ in range(3000)]
    ds = ctx.parallelize([(k, k + 1) for k in keys], num_slices=6)
    out = ds.sort_by_key(num_partitions=5).collect()
    assert [k for k, _ in out] == sorted(keys)
    return out


def job_join(ctx, P, dk):
    left = ctx.parallelize([(i % 10, f"L{i}") for i in range(50)], 4)
    right = ctx.parallelize([(i % 10, f"R{i}") for i in range(20)], 3)
    got = sorted(left.join(right, num_partitions=4).collect())
    assert len(got) == 100
    return got


def job_device_workloads_via_context(ctx, P, dk):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 20, size=4096, dtype=np.int32)
    sk, sv = ctx.device_sort(keys, keys, **dk)
    sk, sv = np.asarray(sk), np.asarray(sv)
    assert (np.diff(sk) >= 0).all()
    counts = ctx.device_count((keys % 13).astype(np.int32), **dk)
    assert sum(counts.values()) == len(keys)
    return sk.tolist(), sv.tolist(), sorted(counts.items())


def job_device_aggregate_and_join_via_context(ctx, P, dk):
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 40, 3000).astype(np.int32)
    vals = rng.integers(-50, 50, 3000).astype(np.int32)
    agg = ctx.device_aggregate(keys, vals, **dk)
    out = [sorted((k, tuple(v)) for k, v in agg.items())]
    dkeys = np.arange(100, dtype=np.int32)
    dvals = dkeys * 2
    fk = rng.integers(0, 200, 500).astype(np.int32)
    fv = rng.integers(0, 9, 500).astype(np.int32)
    for broadcast in (False, True):
        jk, jfv, jdv = ctx.device_join(fk, fv, dkeys, dvals,
                                       broadcast=broadcast, **dk)
        rows = sorted(zip(np.asarray(jk).tolist(), np.asarray(jfv).tolist(),
                          np.asarray(jdv).tolist()))
        assert len(rows) == int((fk < 100).sum())
        out.append(rows)
    return out


def job_dataset_cogroup_distinct_count_by_key(ctx, P, dk):
    left = ctx.parallelize([(k % 5, k) for k in range(40)], num_slices=4)
    right = ctx.parallelize([(k % 7, -k) for k in range(21)], num_slices=3)
    cg = sorted(
        (k, (sorted(vs), sorted(ws)))
        for k, (vs, ws) in left.cogroup(right, num_partitions=4).collect()
    )
    d = ctx.parallelize([1, 2, 2, 3, 3, 3, 4] * 3, num_slices=4)
    kv = ctx.parallelize([("a", 1), ("b", 2), ("a", 3)] * 5, num_slices=2)
    return (cg, sorted(d.distinct(num_partitions=3).collect()),
            kv.count_by_key())


def job_dataset_join_variants(ctx, P, dk):
    left = ctx.parallelize([(1, "x"), (1, "y"), (2, "z"), (9, "q")],
                           num_slices=2)
    right = ctx.parallelize([(1, 10), (2, 20), (3, 30)], num_slices=2)
    out = {}
    for how in ("inner", "left_outer", "semi", "anti", "right_outer",
                "full_outer"):
        out[how] = sorted(left.join(right, num_partitions=3,
                                    how=how).collect(), key=repr)
    with pytest.raises(ValueError, match="how"):
        left.join(right, how="cross")
    return out


def job_dataset_aggregate_fold_subtract_by_key(ctx, P, dk):
    kv = ctx.parallelize([(k % 3, v) for k, v in enumerate(range(30))],
                         num_slices=4)

    def seq(acc, v):
        acc.append(v)
        return acc

    agg = sorted((k, sorted(v)) for k, v in kv.aggregate_by_key(
        [], seq, lambda a, b: a + b, num_partitions=3).collect())
    assert sum(len(v) for _k, v in agg) == 30
    fold = sorted(kv.fold_by_key(0, lambda a, b: a + b).collect())
    other = ctx.parallelize([(0, "zz"), (7, "yy")], num_slices=2)
    return agg, fold, sorted(kv.subtract_by_key(other).collect())


def job_dataset_combine_by_key(ctx, P, dk):
    kv = ctx.parallelize([(k % 3, v) for k, v in enumerate(range(30))],
                         num_slices=4)
    return sorted(kv.combine_by_key(
        create_combiner=lambda v: (v, 1),
        merge_value=lambda c, v: (c[0] + v, c[1] + 1),
        merge_combiners=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        num_partitions=3,
    ).collect())


def job_dataset_staples(ctx, P, dk):
    ds = ctx.parallelize([(k % 4, k) for k in range(40)], num_slices=4)
    u = ds.union(ctx.parallelize([(9, 99)], num_slices=1))
    return (
        sorted(ds.keys().collect()), sorted(ds.values().collect()),
        sorted(ds.map_values(lambda v: v * 2).collect()),
        sorted(u.collect()), ds.first(), ds.take(7),
        sorted(ds.sample(0.5, seed=3).collect()),
    )


def job_repartition_and_sort_within_partitions(ctx, P, dk):
    rng = random.Random(5)
    data = [(rng.randrange(1000), i) for i in range(500)]
    parts = ctx.parallelize(data, num_slices=4) \
        .repartition_and_sort_within_partitions(num_partitions=5) \
        ._materialize()
    assert len(parts) == 5
    # keys in order within each partition; equal keys keep no order
    return [([k for k, _v in p], sorted(p)) for p in parts]


def job_dataset_cache_materializes_once(ctx, P, dk):
    calls = []

    def probe(x):
        calls.append(x)
        return x * 2

    ds = ctx.parallelize(list(range(20)), num_slices=2).map(probe)
    first = (sorted(ds.collect()), sorted(ds.collect()), len(calls))
    calls.clear()
    cached = ctx.parallelize(list(range(20)), num_slices=2).map(probe).cache()
    return first, (sorted(cached.collect()), sorted(cached.collect()),
                   cached.count(), len(calls))


def job_dataset_top_k_per_key(ctx, P, dk):
    rng = random.Random(7)
    data = [(i % 5, rng.randrange(-100, 100)) for i in range(300)]
    got = sorted((k, list(v)) for k, v in ctx.parallelize(
        data, num_slices=4).top_k_per_key(3, num_partitions=4).collect())
    with pytest.raises(ValueError, match="k must be positive"):
        ctx.parallelize(data, num_slices=2).top_k_per_key(0)
    return got


def job_device_top_k_and_join_how_via_context(ctx, P, dk):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 9, 2000).astype(np.int32)
    vals = rng.integers(-100, 100, 2000).astype(np.int32)
    top = ctx.device_top_k(keys, vals, 2, **dk)
    fk = np.array([1, 2, 9], np.int32)
    fv = np.array([10, 20, 90], np.int32)
    k_, v_ = ctx.device_join(fk, fv, np.array([1, 2], np.int32),
                             np.array([5, 6], np.int32), how="anti", **dk)
    return sorted(top.items()), np.asarray(k_).tolist(), np.asarray(v_).tolist()


JOBS = {f.__name__[4:]: f for f in (
    job_narrow_ops_fused, job_reduce_by_key, job_group_by_key,
    job_sort_by_key_global_order, job_join, job_device_workloads_via_context,
    job_device_aggregate_and_join_via_context,
    job_dataset_cogroup_distinct_count_by_key, job_dataset_join_variants,
    job_dataset_aggregate_fold_subtract_by_key, job_dataset_combine_by_key,
    job_dataset_staples, job_repartition_and_sort_within_partitions,
    job_dataset_cache_materializes_once, job_dataset_top_k_per_key,
    job_device_top_k_and_join_how_via_context,
)}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("job", list(JOBS))
def test_job_matches_jax(pkgs, contexts, dev_kw, job, stage):
    out = [JOBS[job](contexts(P, stage), P, dev_kw[P.name]) for P in pkgs]
    assert out[1] == out[0]


# -- the loopback cases of tests/test_shuffle_e2e.py -------------------------


@contextlib.contextmanager
def cluster(P, stage, n=3, extra=None):
    """Driver + n executors sharing one loopback network and conf."""
    net = P.transport.LoopbackNetwork()
    conf = P.Conf({
        "spark.shuffle.tpu.collectShuffleReaderStats": True,
        "spark.shuffle.tpu.driverPort": 37000,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "5s",
        **(extra or {}),
    })
    driver = P.Manager(conf, True, net, stage_to_device=stage)
    executors = [
        P.Manager(conf, False, net, port=38000 + i * 10,
                  executor_id=str(i), stage_to_device=stage)
        for i in range(n)
    ]
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all(len(e._peers) == n for e in executors):
            break
        time.sleep(0.01)
    try:
        yield net, conf, driver, executors
    finally:
        for m in executors + [driver]:
            m.stop()


def run_maps(handle, executors, records_per_map):
    maps_by_host = defaultdict(list)
    for map_id, records in enumerate(records_per_map):
        ex = executors[map_id % len(executors)]
        w = ex.get_writer(handle, map_id)
        w.write(records)
        w.stop(True)
        maps_by_host[ex.local_smid].append(map_id)
    return dict(maps_by_host)


def e2e_membership_and_announce(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        return len(driver.executors), [len(e._peers) for e in executors]


def e2e_group_by_key(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        handle = driver.register_shuffle(0, 4, P.part.HashPartitioner(6))
        recs = [[(f"k{j}", (m, j)) for j in range(50)] for m in range(4)]
        mbh = run_maps(handle, executors, recs)
        got = defaultdict(list)
        blocks = []
        for i, ex in enumerate(executors):
            reader = ex.get_reader(handle, i * 2, i * 2 + 2, mbh)
            for k, v in reader.read():
                got[k].append(v)
            m = reader.metrics
            blocks.append((m.records_read, m.remote_blocks, m.local_blocks))
            assert m.remote_blocks > 0 and m.local_blocks > 0
        return sorted((k, sorted(v)) for k, v in got.items()), blocks


def e2e_reduce_by_key_with_map_side_combine(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        agg = P.manager.Aggregator(lambda v: v, lambda c, v: c + v,
                                   lambda a, b: a + b)
        handle = driver.register_shuffle(1, 3, P.part.HashPartitioner(4),
                                         aggregator=agg,
                                         map_side_combine=True)
        mbh = run_maps(handle, executors,
                       [[(j % 10, 1) for j in range(100)]] * 3)
        got = {}
        got.update(dict(executors[0].get_reader(handle, 0, 2, mbh).read()))
        got.update(dict(executors[1].get_reader(handle, 2, 4, mbh).read()))
        assert got == {k: 30 for k in range(10)}
        return sorted(got.items())


def e2e_sort_by_key(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        rng = random.Random(0)
        keys = [rng.randrange(10**6) for _ in range(600)]
        part = P.part.RangePartitioner(6, rng.sample(keys, 100))
        handle = driver.register_shuffle(2, 3, part, key_ordering=True)
        mbh = run_maps(handle, executors, [
            [(k, k * 2) for k in keys[m * 200:(m + 1) * 200]]
            for m in range(3)
        ])
        out = []
        for pid in range(6):
            out.append(list(executors[pid % 3].get_reader(
                handle, pid, pid + 1, mbh).read()))
        assert [k for c in out for k, _ in c] == sorted(keys)
        return out


def e2e_empty_partitions(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        handle = driver.register_shuffle(3, 2, P.part.HashPartitioner(8))
        mbh = run_maps(handle, executors, [[], [("x", 1)]])
        total = []
        for pid in range(8):
            total.extend(executors[0].get_reader(handle, pid, pid + 1,
                                                 mbh).read())
        return total


def e2e_metadata_fetch_timeout(P, stage, tmp_path):
    with cluster(P, stage) as (_net, conf, driver, executors):
        conf.set("partitionLocationFetchTimeout", "300ms")
        handle = driver.register_shuffle(4, 2, P.part.HashPartitioner(2))
        reader = executors[0].get_reader(
            handle, 0, 1, {executors[1].local_smid: [0]})
        with pytest.raises(P.reader.MetadataFetchFailedError) as ei:
            list(reader.read())
        return type(ei.value).__name__, type(ei.value).__mro__[1].__name__


def e2e_executor_loss_fails_fetch(P, stage, tmp_path):
    with cluster(P, stage) as (net, _conf, driver, executors):
        handle = driver.register_shuffle(5, 2, P.part.HashPartitioner(2))
        mbh = run_maps(handle, executors[:2], [[("a", 1)], [("b", 2)]])
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if sum(len(v) for v in driver.maps_by_host(5).values()) == 2:
                break
            time.sleep(0.01)
        victim = executors[1]
        net.partition(victim.node.address)
        reader = executors[0].get_reader(handle, 0, 2, mbh)
        with pytest.raises(P.reader.FetchFailedError) as ei:
            list(reader.read())
        net.heal(victim.node.address)
        driver.remove_executor(victim.local_smid)
        return type(ei.value).__name__, victim.local_smid in driver.executors


def e2e_unregister_shuffle_releases_segments(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        handle = driver.register_shuffle(6, 2, P.part.HashPartitioner(2))
        run_maps(handle, executors[:1], [[("a", 1)], [("b", 2)]])
        ex = executors[0]
        before = ex.arena.stats()["segments"]
        ex.unregister_shuffle(6)
        return before, ex.arena.stats()


def e2e_stable_hash_cross_process(P, stage, tmp_path):
    keys = ["k1", 42, -7, 3.5, (1, "a"), b"raw", True, "日本語"]
    here = [P.part.stable_hash(k) for k in keys]
    code = (f"from {P.name}.shuffle.partitioner import stable_hash\n"
            f"print([stable_hash(k) for k in {keys!r}])")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(REPO), env={"PATH": "/usr/local/bin:/usr/bin:/bin",
                            "PYTHONHASHSEED": "random",
                            "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert eval(out.stdout) == here
    return here


def e2e_map_task_retry_releases_old_segment(P, stage, tmp_path):
    with cluster(P, stage) as (_net, _conf, driver, executors):
        handle = driver.register_shuffle(7, 1, P.part.HashPartitioner(2))
        ex = executors[0]
        for _ in range(2):  # the second is a speculative re-run of map 0
            w = ex.get_writer(handle, 0)
            w.write([("a", 1)])
            w.stop(True)
        return ex.arena.stats()


def e2e_abandoned_reader_cleans_up(P, stage, tmp_path):
    import gc

    with cluster(P, stage) as (_net, _conf, driver, executors):
        handle = driver.register_shuffle(8, 2, P.part.HashPartitioner(2))
        mbh = run_maps(handle, executors[:2], [
            [(f"k{i}", i) for i in range(500)],
            [(f"j{i}", i) for i in range(500)],
        ])
        ex = executors[0]
        before = len(ex._callbacks)
        it = ex.get_reader(handle, 0, 2, mbh).read()
        next(it)
        del it
        gc.collect()
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline and len(ex._callbacks) > before:
            time.sleep(0.05)
        return len(ex._callbacks) - before


def _one_executor(P, stage, conf_extra):
    net = P.transport.LoopbackNetwork()
    conf = P.Conf({"spark.shuffle.tpu.driverPort": 37300, **conf_extra})
    driver = P.Manager(conf, True, net, stage_to_device=stage)
    ex = P.Manager(conf, False, net, port=38300, executor_id="0",
                   stage_to_device=stage)
    return driver, ex


def _read_all(ex, handle, nparts):
    got = []
    for pid in range(nparts):
        got.extend(ex.get_reader(handle, pid, pid + 1,
                                 {ex.local_smid: [0]}).read())
    return got


def e2e_writer_spill_roundtrip(P, stage, tmp_path):
    driver, ex = _one_executor(P, stage, {
        "spark.shuffle.tpu.shuffleSpillRecordThreshold": "100",
        "spark.shuffle.tpu.spillDir": str(tmp_path),
    })
    try:
        handle = driver.register_shuffle(0, 1, P.part.HashPartitioner(4))
        w = ex.get_writer(handle, 0)
        records = [(i % 37, i) for i in range(1000)]
        w.write(records)
        w.stop(True)
        assert not list(tmp_path.glob("sparkrdma_tpu_spill_*"))
        got = _read_all(ex, handle, 4)
        assert sorted(got) == sorted(records)
        return (w.metrics.spills, w.metrics.bytes_spilled,
                ex.arena.stats()["file_bytes"] > 0, sorted(got))
    finally:
        ex.stop()
        driver.stop()


def e2e_writer_spill_with_map_side_combine(P, stage, tmp_path):
    driver, ex = _one_executor(P, stage, {
        "spark.shuffle.tpu.shuffleSpillRecordThreshold": "10",
        "spark.shuffle.tpu.spillDir": str(tmp_path),
    })
    try:
        agg = P.manager.Aggregator(lambda v: v, lambda c, v: c + v,
                                   lambda a, b: a + b)
        handle = driver.register_shuffle(0, 1, P.part.HashPartitioner(2),
                                         aggregator=agg,
                                         map_side_combine=True)
        w = ex.get_writer(handle, 0)
        w.write([(i % 20, 1) for i in range(400)])
        w.stop(True)
        got = dict(_read_all(ex, handle, 2))
        assert got == {k: 20 for k in range(20)}
        return w.metrics.spills, sorted(got.items())
    finally:
        ex.stop()
        driver.stop()


def e2e_file_backed_commit(P, stage, tmp_path):
    driver, ex = _one_executor(P, stage, {
        "spark.shuffle.tpu.fileBackedCommitBytes": "1k",
        "spark.shuffle.tpu.spillDir": str(tmp_path),
    })
    try:
        handle = driver.register_shuffle(0, 1, P.part.HashPartitioner(3))
        w = ex.get_writer(handle, 0)
        records = [(i, "x" * 50) for i in range(500)]
        w.write(records)
        w.stop(True)
        files = len(list(tmp_path.glob("sparkrdma_tpu_shuffle_*")))
        got = sorted(_read_all(ex, handle, 3))
        assert got == sorted(records)
        ex.unregister_shuffle(0)
        left = list(tmp_path.glob("sparkrdma_tpu_shuffle_*"))
        return files, got, left
    finally:
        ex.stop()
        driver.stop()


def e2e_writer_spill_with_compression(P, stage, tmp_path):
    driver, ex = _one_executor(P, stage, {
        "spark.shuffle.tpu.shuffleSpillRecordThreshold": "64",
        "spark.shuffle.tpu.spillDir": str(tmp_path / "newdir"),
        "spark.shuffle.tpu.compress": "true",
    })
    try:
        handle = driver.register_shuffle(0, 1, P.part.HashPartitioner(3))
        w = ex.get_writer(handle, 0)
        records = [(i % 91, "v" * (i % 17)) for i in range(700)]
        w.write(records)
        w.stop(True)
        got = sorted(_read_all(ex, handle, 3))
        assert got == sorted(records)
        return w.metrics.spills, got
    finally:
        ex.stop()
        driver.stop()


def e2e_concurrent_shuffles_stress(P, stage, tmp_path):
    import concurrent.futures

    with cluster(P, stage) as (_net, _conf, driver, executors):
        def run_one(sid):
            handle = driver.register_shuffle(100 + sid, 4,
                                             P.part.HashPartitioner(3))
            recs = [[((m * 31 + i) % 50, (sid, m, i)) for i in range(200)]
                    for m in range(4)]
            mbh = run_maps(handle, executors, recs)
            got = []
            for pid in range(3):
                got.extend(executors[pid % 3].get_reader(
                    handle, pid, pid + 1, mbh).read())
            driver.unregister_shuffle(100 + sid)
            for ex in executors:
                ex.unregister_shuffle(100 + sid)
            return sorted(got)

        with concurrent.futures.ThreadPoolExecutor(max_workers=6) as p:
            out = list(p.map(run_one, range(6)))
        return out, [ex.arena.stats()["segments"] for ex in executors]


E2E = {f.__name__[4:]: f for f in (
    e2e_membership_and_announce, e2e_group_by_key,
    e2e_reduce_by_key_with_map_side_combine, e2e_sort_by_key,
    e2e_empty_partitions, e2e_metadata_fetch_timeout,
    e2e_executor_loss_fails_fetch, e2e_unregister_shuffle_releases_segments,
    e2e_stable_hash_cross_process, e2e_map_task_retry_releases_old_segment,
    e2e_abandoned_reader_cleans_up, e2e_writer_spill_roundtrip,
    e2e_writer_spill_with_map_side_combine, e2e_file_backed_commit,
    e2e_writer_spill_with_compression, e2e_concurrent_shuffles_stress,
)}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", list(E2E))
def test_loopback_case_matches_jax(pkgs, case, stage, tmp_path):
    out = []
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        out.append(E2E[case](P, stage, d))
    assert out[1] == out[0]


# -- committed bytes, device segments, lifetimes ----------------------------


def _segment_bytes(seg) -> bytes:
    arr = seg.array
    if isinstance(arr, torch.Tensor):
        return arr.numpy().tobytes()
    return np.asarray(arr).tobytes()


@pytest.mark.parametrize("serializer", ["pickle", "columnar"])
@pytest.mark.parametrize("stage", STAGES)
def test_committed_segment_bytes_equal(pkgs, stage, serializer):
    """One map task's committed segment and location table are the same
    bytes in both packages; staged, the port's segment is a tensor on
    the manager's device."""
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 50, 2000).astype(np.int64)
    vals = rng.integers(-9, 9, 2000).astype(np.int64)
    out = []
    for P in pkgs:
        with cluster(P, stage, n=1, extra={
                "spark.shuffle.tpu.serializer": serializer}) as (
                _n, _c, driver, (ex,)):
            handle = driver.register_shuffle(0, 1,
                                             P.part.HashPartitioner(5))
            w = ex.get_writer(handle, 0)
            if serializer == "columnar":
                w.write(P.columns.ColumnBatch(keys, vals))
            else:
                w.write(list(zip(keys.tolist(), vals.tolist())))
            w.stop(True)
            mto, segs = ex.resolver._shuffles[0].outputs[0]
            if P.name == "sparkrdma_tpu_torch":
                for seg in segs.values():
                    assert isinstance(seg.array, torch.Tensor) == stage
                    if stage:
                        assert seg.array.device == ex.device
            out.append((mto.get_range_bytes(0, 4),
                        {k: _segment_bytes(s) for k, s in segs.items()}))
    assert out[1] == out[0]


def _counter(name, **labels):
    """The port's counter ``name`` summed over the label sets that
    match ``labels``."""
    from sparkrdma_tpu_torch.metrics import get_registry

    return sum(c["value"] for c in get_registry().snapshot()["counters"]
               if c["name"] == name and all(
                   c["labels"].get(k) == v for k, v in labels.items()))


def test_staging_counters_and_stop_release(pkgs):
    """Staged commits count their host-to-device bytes and segments,
    fetches their device-to-host bytes, no commit falls back to the
    host, and after stop() the resource ledger and every arena are
    empty in both packages."""
    conf = {"spark.shuffle.tpu.resourceDebug": "true"}
    data = [(i % 31, i) for i in range(3000)]
    results = []
    for P in pkgs:
        h2d0 = _counter("staging_h2d_bytes_total", device="cpu")
        d2h0 = _counter("arena_device_read_bytes_total")
        segs0 = _counter("staging_device_segments_total", device="cpu")
        falls0 = _counter("staging_commit_fallbacks_total")
        ctx = P.Context(num_executors=2, conf=P.Conf(conf),
                        stage_to_device=True)
        try:
            got = sorted(ctx.parallelize(data, num_slices=4)
                         .reduce_by_key(lambda a, b: a + b,
                                        num_partitions=3).collect())
        finally:
            ctx.stop()
        arenas = [m.arena.stats() for m in ctx.executors + [ctx.driver]]
        assert all(a["segments"] == 0 and a["total_bytes"] == 0
                   for a in arenas), arenas
        assert P.ledger.get_resource_ledger().outstanding() == {}
        results.append(got)
        if P.name == "sparkrdma_tpu_torch":
            assert _counter("staging_device_segments_total",
                            device="cpu") - segs0 == 4
            assert _counter("staging_h2d_bytes_total", device="cpu") > h2d0
            assert _counter("arena_device_read_bytes_total") > d2h0
            assert _counter("staging_commit_fallbacks_total") == falls0
            assert all(ex.staging_pool.is_native for ex in ctx.executors)
    assert results[1] == results[0]


def test_pool_exhausted_commit_falls_back_and_counts(pkgs):
    """A staging pool over its budget keeps the commit (on a plain host
    buffer, then staged) and counts the fallback, as the JAX resolver
    keeps it."""
    P = pkgs[1]
    before = _counter("staging_commit_fallbacks_total",
                      reason="pool_exhausted")

    def exhausted(size):
        raise MemoryError(f"staging pool budget exhausted allocating {size}B")

    with cluster(P, True, n=1) as (_n, _c, driver, (ex,)):
        ex.staging_pool.alloc = exhausted
        handle = driver.register_shuffle(0, 1, P.part.HashPartitioner(2))
        w = ex.get_writer(handle, 0)
        w.write([(i, "y" * 64) for i in range(400)])
        w.stop(True)
        _mto, segs = ex.resolver._shuffles[0].outputs[0]
        assert all(isinstance(s.array, torch.Tensor) for s in segs.values())
        got = sorted(_read_all(ex, handle, 2))
    assert got == sorted((i, "y" * 64) for i in range(400))
    assert _counter("staging_commit_fallbacks_total",
                    reason="pool_exhausted") > before


# -- columnar subset of tests/test_columnar.py -------------------------------


def _col(P, extra=None):
    return P.Conf({"spark.shuffle.tpu.serializer": "columnar",
                   **(extra or {})})


def col_group_by_key(P, stage, tmp_path):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 97, 8000).astype(np.int64)
    vals = np.frombuffer(rng.bytes(8000 * 16), dtype="S16")
    with P.Context(num_executors=3, conf=_col(P),
                   stage_to_device=stage) as ctx:
        out = ctx.parallelize_columns(keys, vals, num_slices=6) \
            .group_by_key(num_partitions=5).collect()
    assert len(out) == 97
    return sorted((k, sorted(g.tolist())) for k, g in out)


def col_reduce_by_key(P, stage, tmp_path):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 100, 30000).astype(np.int64)
    vals = rng.integers(0, 1000, 30000).astype(np.int64)
    with P.Context(num_executors=2, conf=_col(P),
                   stage_to_device=stage) as ctx:
        out = ctx.parallelize_columns(keys, vals, num_slices=4) \
            .reduce_by_key("sum").collect()
    expect = np.bincount(keys, weights=vals, minlength=100)
    assert sorted(out) == [(k, int(expect[k])) for k in range(100)]
    return sorted(out)


def col_sort_by_key(P, stage, tmp_path):
    rng = np.random.default_rng(7)
    keys = rng.integers(-(2**40), 2**40, 20000).astype(np.int64)
    vals = np.arange(20000, dtype=np.int64)
    with P.Context(num_executors=2, conf=_col(P),
                   stage_to_device=stage) as ctx:
        flat = ctx.parallelize_columns(keys, vals, num_slices=4) \
            .sort_by_key(num_partitions=4).collect()
    assert [k for k, _ in flat] == sorted(keys.tolist())
    return [(int(k), int(v)) for k, v in flat]


def col_spill_roundtrip(P, stage, tmp_path):
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 23, 5000).astype(np.int64)
    vals = rng.integers(0, 9, 5000).astype(np.int64)
    conf = _col(P, {"spark.shuffle.tpu.shuffleSpillRecordThreshold": "400",
                    "spark.shuffle.tpu.spillDir": str(tmp_path)})
    with P.Context(num_executors=2, conf=conf, stage_to_device=stage) as ctx:
        out = sorted(ctx.parallelize_columns(keys, vals, num_slices=4)
                     .reduce_by_key("sum").collect())
    assert not list(tmp_path.glob("sparkrdma_tpu_spill_*"))
    return out


def col_with_compression(P, stage, tmp_path):
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 50, 20000).astype(np.int64)
    vals = rng.integers(0, 5, 20000).astype(np.int64)
    conf = _col(P, {"spark.shuffle.tpu.compress": "true"})
    with P.Context(num_executors=2, conf=conf, stage_to_device=stage) as ctx:
        return sorted(ctx.parallelize_columns(keys, vals, num_slices=4)
                      .reduce_by_key("sum").collect())


COLUMNAR = {f.__name__[4:]: f for f in (
    col_group_by_key, col_reduce_by_key, col_sort_by_key,
    col_spill_roundtrip, col_with_compression,
)}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", list(COLUMNAR))
def test_columnar_case_matches_jax(pkgs, case, stage, tmp_path):
    out = []
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        out.append(COLUMNAR[case](P, stage, d))
    assert out[1] == out[0]


# -- the cases of tests/test_map_output.py ------------------------------------


def mo_put_and_get(MTO, BL, ES):
    mto = MTO(4)
    mto.put(2, BL(1000, 64, 3))
    return mto.get_location(2), mto.get_location(0) == BL.EMPTY


def mo_fill_future_resolves_only_when_complete(MTO, BL, ES):
    mto = MTO(3)
    seen = [mto.is_complete]
    mto.put(0, BL(0, 1, 1))
    mto.put(1, BL(1, 1, 1))
    seen.append(mto.fill_future.done())
    mto.put(2, BL(2, 1, 1))
    seen += [mto.fill_future.done(), mto.fill_future.result(timeout=0) is mto]
    return seen


def mo_put_range_roundtrip(MTO, BL, ES):
    src = MTO(8)
    for p in range(8):
        src.put(p, BL(p * 100, p + 1, 9))
    dst = MTO(8)
    dst.put_range(4, 7, src.get_range_bytes(4, 7))
    seen = [dst.is_complete]
    dst.put_range(0, 3, src.get_range_bytes(0, 3))
    seen.append(dst.is_complete)
    return seen, [dst.get_location(p) for p in range(8)], \
        src.get_range_bytes(0, 7)


def mo_get_locations_and_total_bytes(MTO, BL, ES):
    mto = MTO(5)
    for p in range(5):
        mto.put(p, BL(p, 10 * (p + 1), 1))
    return [loc.length for loc in mto.get_locations(1, 3)], mto.total_bytes()


def mo_range_checks(MTO, BL, ES):
    mto = MTO(4)
    raised = []
    for fn, exc in (
        (lambda: mto.put(4, BL.EMPTY), IndexError),
        (lambda: mto.get_location(-1), IndexError),
        (lambda: mto.put_range(0, 1, b"\x00" * (3 * ES)), ValueError),
        (lambda: MTO(0), ValueError),
    ):
        with pytest.raises(exc):
            fn()
        raised.append(exc.__name__)
    return raised


def mo_duplicate_fills_do_not_fake_completion(MTO, BL, ES):
    mto = MTO(3)
    mto.put(0, BL(0, 1, 1))
    mto.put(0, BL(0, 2, 1))
    mto.put_range(0, 1, mto.get_range_bytes(0, 1))
    seen = [mto.is_complete]
    mto.put(1, BL(1, 1, 1))
    mto.put(2, BL(2, 1, 1))
    return seen + [mto.is_complete]


def mo_take_delta_first_publish_is_whole_table(MTO, BL, ES):
    mto = MTO(16)
    for p in range(16):
        mto.put(p, BL(p * 100, p + 1, 7))
    return mto.take_delta(), mto.take_delta(), mto.take_delta()


def mo_take_delta_returns_only_changed_runs(MTO, BL, ES):
    mto = MTO(64)
    for p in range(64):
        mto.put(p, BL(p * 100, p + 1, 7))
    mto.take_delta()
    mto.put(5, BL(9999, 6, 8))
    mto.put(6, BL(10005, 7, 8))
    mto.put(40, BL(20000, 41, 8))
    epoch, runs = mto.take_delta()
    assert [(f, last) for f, last, _raw in runs] == [(5, 6), (40, 40)]
    return epoch, runs


def mo_put_range_epoch_guard_rejects_stale_segments(MTO, BL, ES):
    src = MTO(8)
    for p in range(8):
        src.put(p, BL(p * 100, p + 1, 9))
    stale_full = src.get_range_bytes(0, 7)
    src.put(3, BL(7777, 4, 10))
    fresh = src.get_range_bytes(3, 3)
    dst = MTO(8)
    dst.put_range(3, 3, fresh, epoch=1)
    dst.put_range(0, 7, stale_full, epoch=0)
    dst2 = MTO(8)
    dst2.put_range(0, 7, stale_full, epoch=0)
    dst2.put_range(3, 3, fresh, epoch=1)
    locs = [dst.get_location(p) for p in range(8)]
    assert locs == [dst2.get_location(p) for p in range(8)]
    assert locs[3] == BL(7777, 4, 10)
    return dst.is_complete, locs


MAP_OUTPUT = {f.__name__[3:]: f for f in (
    mo_put_and_get, mo_fill_future_resolves_only_when_complete,
    mo_put_range_roundtrip, mo_get_locations_and_total_bytes,
    mo_range_checks, mo_duplicate_fills_do_not_fake_completion,
    mo_take_delta_first_publish_is_whole_table,
    mo_take_delta_returns_only_changed_runs,
    mo_put_range_epoch_guard_rejects_stale_segments,
)}


def _plain(x):
    """Locations as tuples, so the two packages' results compare."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "address") and hasattr(x, "mkey"):
        return ("loc", x.address, x.length, x.mkey)
    return x


@pytest.mark.parametrize("case", list(MAP_OUTPUT))
def test_map_output_case_matches_jax(pkgs, case):
    out = [
        _plain(MAP_OUTPUT[case](P.map_output.MapTaskOutput,
                                P.types.BlockLocation,
                                P.types.LOCATION_ENTRY_SIZE))
        for P in pkgs
    ]
    assert out[1] == out[0]


# -- TCP, refusals ------------------------------------------------------------


def test_tcp_shuffle(pkgs):
    """A shuffle over real sockets: two executors and the driver on
    ports outside the suite's fixed ranges; the result equals the
    loopback one's and the oracle."""
    P = pkgs[1]
    data = [(i % 41, i) for i in range(4000)]
    want = defaultdict(int)
    for k, v in data:
        want[k] += v
    conf = P.Conf({"spark.shuffle.tpu.driverPort": 29640})
    with P.Context(num_executors=2, conf=conf, base_port=29640,
                   network=P.transport.TcpNetwork(),
                   stage_to_device=True) as ctx:
        got = sorted(ctx.parallelize(data, num_slices=4)
                     .reduce_by_key(lambda a, b: a + b, num_partitions=4)
                     .collect())
    assert got == sorted(want.items())


def test_context_without_device_needs_cuda(pkgs):
    P = pkgs[1]
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.api.TpuShuffleContext(num_executors=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.manager.TpuShuffleManager(
            P.Conf(), is_driver=True, network=P.transport.LoopbackNetwork())
