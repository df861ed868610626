"""The port's host-plane features held against the JAX package: push
merge, skew split, the tiered store, striped fetch, QoS, fault injection
and failure detection, through the port's own ``api.py``, ``manager.py``,
``resolver.py`` and ``conf.py``, with map outputs staged to the device
(CPU tensors in the port, JAX CPU arrays in the reference) and kept on
the host.

Each case runs the same seeded records through both packages over a
``LoopbackNetwork`` (no socket is bound; one case runs over TCP on the
ports ``TCP_BASE`` gives) and returns its canonical result with the
counters that the data fixes (sub-blocks sent for merging, split
partitions, spills, tier promotions and demotions, stripes, response
cuts); the port's must equal the JAX package's, and each package's
result must equal the Python oracle.  Counters that depend on thread
timing (merged blocks, prefetch hits, retries, breaker trips) are
checked to have moved, not compared.  The twins of tests/test_{push,
skew,tiered_store,striped_transport,qos,faults,failure_detection}.py
are the cluster cases; ``test_api_feature_matches_jax`` runs
``reduce_by_key``, ``group_by_key`` and ``sort_by_key`` under each
feature, pickle and columnar.  Also here: the two repairs of the port,
each reproduced (the host-set race in the co-located windowed plane;
the tier store's segmentation fault in a subprocess).
"""

import contextlib
import gc
import os
import subprocess
import sys
import textwrap
import threading
import time
from collections import defaultdict

import numpy as np
import pytest

from tests.test_torch_conf_matrix import (  # noqa: F401 - fixtures
    STAGES,
    canon,
    counters,
    delta,
    jax_free_keeps_mapping,
    oracle,
    pkgs,
    registries_on,
    run_op,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def globals_reset(pkgs):
    """Every process-global the features keep (fault schedule, skew and
    tenant registries) starts and ends clean in both packages."""
    saved = []
    for P in pkgs:
        skew, qos = P.skew.get_skew(), P.qos.GLOBAL_QOS
        saved.append((skew.enabled, qos.enabled))
        P.faults.reset()
        skew.reset()
        qos.reset()
    yield
    for P, (skew_on, qos_on) in zip(pkgs, saved):
        P.faults.reset()
        P.skew.get_skew().reset()
        P.skew.get_skew().enabled = skew_on
        P.qos.GLOBAL_QOS.reset()
        P.qos.GLOBAL_QOS.enabled = qos_on


@contextlib.contextmanager
def cluster(P, stage, extra=None, n=2, conf=None, announced=True):
    """Driver + ``n`` executors on one loopback network and conf; with
    ``announced``, once every executor knows all ``n``."""
    net = P.transport.LoopbackNetwork()
    conf = conf or P.Conf({
        "spark.shuffle.tpu.driverPort": 37700,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "10s",
        "spark.shuffle.tpu.connectTimeout": "5s",
        **(extra or {}),
    })
    driver = P.Manager(conf, True, net, stage_to_device=stage)
    executors = [
        P.Manager(conf, False, net, port=37800 + i * 10,
                  executor_id=str(i), stage_to_device=stage)
        for i in range(n)
    ]
    deadline = time.monotonic() + 5
    while announced and time.monotonic() < deadline:
        if all(len(e._peers) == n for e in executors):
            break
        time.sleep(0.01)
    try:
        yield net, driver, executors
    finally:
        for m in executors + [driver]:
            m.stop()


def write_maps(handle, executors, records_per_map):
    mbh = defaultdict(list)
    for m, recs in enumerate(records_per_map):
        ex = executors[m % len(executors)]
        w = ex.get_writer(handle, m)
        w.write(recs)
        w.stop(True)
        mbh[ex.local_smid].append(m)
    return dict(mbh)


def read_grouped(executors, handle, num_parts, mbh):
    """Every partition, one reader each round-robin: {key: sorted
    values}."""
    got = defaultdict(list)
    for pid in range(num_parts):
        rd = executors[pid % len(executors)].get_reader(
            handle, pid, pid + 1, mbh)
        for k, v in rd.read():
            got[k].append(bytes(v) if isinstance(v, memoryview) else v)
    return {k: sorted(v) for k, v in got.items()}


def grouped(records_per_map):
    want = defaultdict(list)
    for recs in records_per_map:
        for k, v in recs:
            want[k].append(v)
    return {k: sorted(v) for k, v in want.items()}


def both(pkgs, case, *args):
    """Run ``case`` through both packages; the port's output must equal
    the JAX package's."""
    want, got = (case(P, *args) for P in pkgs)
    assert got == want
    return got


# -- push merge (tests/test_push.py) -------------------------------------------

PUSH_MAPS, PUSH_PARTS = 4, 6


def _push_job(P, stage, extra, n=3):
    part = P.part.HashPartitioner(PUSH_PARTS)
    recs = [[(f"k{j}", (m, j)) for j in range(40)] for m in range(PUSH_MAPS)]
    c0 = counters(P)
    with cluster(P, stage, extra, n=n) as (_net, driver, executors):
        handle = driver.register_shuffle(0, PUSH_MAPS, part)
        mbh = write_maps(handle, executors, recs)
        got = read_grouped(executors, handle, PUSH_PARTS, mbh)
    assert got == grouped(recs), P.name
    return got, delta(c0, counters(P), "push_sub_blocks_total",
                      "push_sub_blocks_sent_total", "push_merged_blocks_total",
                      ("shuffle_fetch_rpcs_total", "push"),
                      ("shuffle_fetch_rpcs_total", "pull"),
                      ("shuffle_fetch_rpcs_total", "merge_status"),
                      "shuffle_fetch_failures_total",
                      "push_merge_query_failures_total",
                      ("push_drops_total", "fault"))


PUSH_SWEEP = [(dt, skew) for dt in (0, 4) for skew in (False, True)]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("dt,skew", PUSH_SWEEP, ids=[
    f"dt{d}-{'skew' if s else 'noskew'}" for d, s in PUSH_SWEEP])
def test_push_matches_jax(pkgs, stage, dt, skew):
    """pushEnabled gives the pull answer in both packages; the merge
    plane engaged (sub-blocks pushed and merged, merged spans served, no
    fetch failure), with the same sub-blocks sent."""
    extra = {"spark.shuffle.tpu.pushEnabled": True,
             "spark.shuffle.tpu.decodeThreads": dt}
    if skew:
        extra["spark.shuffle.tpu.skewEnabled"] = True
        extra["spark.shuffle.tpu.skewSplitThreshold"] = 4096

    def case(P):
        got, d = _push_job(P, stage, extra)
        assert d["push_sub_blocks_total"] > 0
        assert d["push_merged_blocks_total"] > 0
        assert d[("shuffle_fetch_rpcs_total", "merge_status")] > 0
        assert d[("shuffle_fetch_rpcs_total", "push")] > 0
        assert d["shuffle_fetch_failures_total"] == 0
        pull, _ = _push_job(P, stage, {})
        assert pull == got
        # what merges depends on when each push lands against the seal
        return got, d["push_sub_blocks_sent_total"]

    both(pkgs, case)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("spec", ["merge_status:nth=1",
                                  "push_merge:nth=2;seed=7"],
                         ids=["dead-merger", "lossy-merger"])
def test_push_merger_faults_match_jax(pkgs, stage, spec):
    """A dead merger (every merge-status query fails) falls back to the
    pull plan; a lossy one (every second pushed sub-block dropped)
    serves what merged and pulls the rest.  Both exact, with no fetch
    failure, in both packages."""
    def case(P):
        got, d = _push_job(P, stage, {
            "spark.shuffle.tpu.pushEnabled": True,
            "spark.shuffle.tpu.faultInject": spec})
        assert d["shuffle_fetch_failures_total"] == 0
        if spec.startswith("merge_status"):
            assert d["push_merge_query_failures_total"] > 0
            assert d[("shuffle_fetch_rpcs_total", "push")] == 0
        else:
            assert d[("push_drops_total", "fault")] > 0
            assert d[("shuffle_fetch_rpcs_total", "push")] > 0
            assert d[("shuffle_fetch_rpcs_total", "pull")] > 0
        return got, P.faults.fired_counts()

    both(pkgs, case)


@pytest.mark.parametrize("stage", STAGES)
def test_push_merger_dedups_retried_map(pkgs, stage):
    def case(P):
        with cluster(P, stage, {"spark.shuffle.tpu.pushEnabled": True},
                     n=3) as (_net, _driver, executors):
            merger = executors[0].push_merger
            c0 = counters(P)
            merger.on_sub_block(99, 5, 0, 6, 0, b"abcdef")
            merger.on_sub_block(99, 5, 0, 6, 0, b"abcdef")  # the retry
            dups = delta(c0, counters(P), ("push_drops_total", "dup"))
            [(rid, mkey, length, prov)] = merger.merge_status(99, [0])
            assert mkey != 0
            return dups, rid, length, [row[0] for row in prov]

    assert both(pkgs, case) == ({("push_drops_total", "dup"): 1}, 0, 6, [5])


# -- skew split (tests/test_skew.py) -------------------------------------------

SKEW_PARTS, HOT_PID = 8, 3


def _hot_records(P, m, n_hot=9000, n_cold=300):
    part = P.part.HashPartitioner(SKEW_PARTS)
    pool, i = [], 0
    while len(pool) < 40:
        k = f"hot-m{m}-{i:04d}"
        if part.partition(k) == HOT_PID:
            pool.append(k)
        i += 1
    recs = [(pool[j % 40], bytes([m, j % 251]) * 30) for j in range(n_hot)]
    return recs + [(f"k{j % 61}-m{m}", bytes([m, j % 251]) * 30)
                   for j in range(n_cold)]


def _skew_job(P, stage, skew_on, sid, extra=None):
    """Four skewed maps over two executors, read in key order from both
    sides: (per-reader ordered output, the commit-time skew stats)."""
    with cluster(P, stage, {
        "spark.shuffle.tpu.skewEnabled": skew_on,
        "spark.shuffle.tpu.skewSplitThreshold": "16k",
        **(extra or {}),
    }) as (_net, driver, executors):
        handle = driver.register_shuffle(
            sid, 4, P.part.HashPartitioner(SKEW_PARTS), key_ordering=True)
        mbh = write_maps(handle, executors,
                         [_hot_records(P, m) for m in range(4)])
        stats = P.skew.get_skew().shuffle_stats(sid)
        out = [list(ex.get_reader(handle, i * 4, i * 4 + 4, mbh).read())
               for i, ex in enumerate(executors)]
    return out, {k: stats.get(k, 0)
                 for k in ("partitions_split", "sub_blocks")}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("dt", [0, 4])
def test_skew_split_matches_jax(pkgs, stage, dt):
    """skewEnabled splits the hot partition on every map and the reduce
    output is byte-identical to the unsplit run, in order; the same
    partitions split into the same sub-blocks in both packages."""
    extra = {"spark.shuffle.tpu.decodeThreads": dt}

    def case(P):
        golden, off = _skew_job(P, stage, False, 11, extra)
        assert off["partitions_split"] == 0
        P.skew.get_skew().reset()
        got, on = _skew_job(P, stage, True, 11, extra)
        assert on["partitions_split"] >= 4
        assert on["sub_blocks"] >= 2 * on["partitions_split"]
        assert got == golden
        return got, on

    both(pkgs, case)


@pytest.mark.parametrize("stage", STAGES)
def test_skew_columnar_split_matches_jax(pkgs, stage):
    def run(P, skew_on):
        with cluster(P, stage, {
            "spark.shuffle.tpu.skewEnabled": skew_on,
            "spark.shuffle.tpu.skewSplitThreshold": "16k",
            "spark.shuffle.tpu.serializer": "columnar",
        }) as (_net, driver, exs):
            handle = driver.register_shuffle(
                5, 2, P.part.HashPartitioner(SKEW_PARTS), key_ordering=True)
            mbh = defaultdict(list)
            rng = np.random.default_rng(3)
            for m in range(2):
                w = exs[m].get_writer(handle, m)
                for _ in range(6):
                    keys = np.where(rng.random(4000) < 0.9, np.int64(HOT_PID),
                                    rng.integers(0, 1000, 4000))
                    w.write_columns(P.columns.ColumnBatch(
                        keys, rng.integers(0, 1 << 40, 4000).astype(np.int64)))
                w.stop(True)
                mbh[exs[m].local_smid].append(m)
            stats = P.skew.get_skew().shuffle_stats(5)
            out = [[(int(k), int(v)) for k, v in ex.get_reader(
                handle, i * 4, i * 4 + 4, dict(mbh)).read()]
                for i, ex in enumerate(exs)]
        return out, stats.get("partitions_split", 0)

    def case(P):
        golden, _ = run(P, False)
        P.skew.get_skew().reset()
        got, split = run(P, True)
        assert split >= 1 and got == golden
        return got, split

    both(pkgs, case)


@pytest.mark.parametrize("stage", STAGES)
def test_feature_stack_releases_every_resource_once(pkgs, stage):
    """Push, skew and a small hot tier over file-backed map outputs
    under ``resourceDebug``: once the shuffle is unregistered every
    ledger resource has drained (pushed payloads, merged and tiered
    segments, pins, hot rows), nothing was released twice, and no
    manager reports a leak at stop, in both packages."""
    def case(P):
        led = P.ledger.get_resource_ledger()
        was = led.enabled
        led.reset()
        c0 = counters(P)
        try:
            with cluster(P, stage, {
                "spark.shuffle.tpu.resourceDebug": True,
                "spark.shuffle.tpu.pushEnabled": True,
                "spark.shuffle.tpu.skewEnabled": True,
                "spark.shuffle.tpu.skewSplitThreshold": 4096,
                "spark.shuffle.tpu.fileBackedCommitBytes": 1,
                "spark.shuffle.tpu.tierHotBytes": "16k",
            }, n=3) as (_net, driver, executors):
                handle = driver.register_shuffle(
                    0, 4, P.part.HashPartitioner(SKEW_PARTS))
                recs = [_hot_records(P, m, n_hot=5000, n_cold=200)
                        for m in range(4)]
                mbh = write_maps(handle, executors, recs)
                got = read_grouped(executors, handle, SKEW_PARTS, mbh)
                driver.unregister_shuffle(0)
                gc.collect()
                deadline = time.monotonic() + 10
                left = {}
                while time.monotonic() < deadline:
                    left = {r: n for r, n in led.outstanding().items()
                            if n and r != "tcp.fds"}
                    if not left:
                        break
                    time.sleep(0.05)
                    gc.collect()
                assert not left, (P.name, left, led.leak_report())
                assert led.double_releases() == 0, led.leak_report()
            leaked = delta(c0, counters(P), "resource_leaked_total",
                           "resource_double_release_total")
            assert set(leaked.values()) == {0}, leaked
        finally:
            led.enabled = was
            led.reset()
        assert got == grouped(recs)
        return got

    both(pkgs, case)


# -- the tiered store (tests/test_tiered_store.py) ------------------------------

TIER_COUNTERS = ("tier_promotes_total", "tier_demotes_total",
                 "tier_commit_bytes_total")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["no-prefetch", "prefetch"])
def test_tier_churn_matches_jax(pkgs, stage, prefetch):
    """Every commit file-backed through the tier with a hot budget far
    below the map outputs, a demand-promote sweep of every block to
    force demotion churn, then every partition read: exact in both
    packages, with the same promotions and demotions (prefetch off;
    with prefetch on the readahead's share depends on timing, so the
    hint plane is only checked to have run)."""
    hot = 24 << 10

    def case(P):
        c0 = counters(P)
        with cluster(P, stage, {
            "spark.shuffle.tpu.fileBackedCommitBytes": 1,
            "spark.shuffle.tpu.tierHotBytes": "24k",
            "spark.shuffle.tpu.tierPrefetch": prefetch,
        }) as (_net, driver, executors):
            handle = driver.register_shuffle(3, 4, P.part.HashPartitioner(8))
            recs = [[(f"k{j % 17}", bytes([m, j % 251]) * 60)
                     for j in range(250)] for m in range(4)]
            mbh = write_maps(handle, executors, recs)
            for ex in executors:
                with ex.tier_store._lock:
                    entries = list(ex.tier_store._by_mkey.values())
                for e in entries:
                    seg = ex.arena.get(e.mkey)
                    for blk in e.blocks:
                        if blk.length > 1:
                            seg.read(blk.offset, blk.length - 1)
                assert ex.tier_store.stats()["hot_bytes"] <= hot
            sweep = delta(c0, counters(P), *TIER_COUNTERS)
            got = read_grouped(executors, handle, 8, mbh)
            d = delta(c0, counters(P), *TIER_COUNTERS, "tier_hint_msgs_total")
            for ex in executors:
                assert ex.tier_store.stats()["hot_bytes"] <= hot
        assert got == grouped(recs)
        assert sweep["tier_demotes_total"] > 0
        if prefetch:
            # the sweep's own reads schedule readahead on the serve pool
            assert d["tier_hint_msgs_total"] > 0
            return got, d["tier_commit_bytes_total"]
        return got, sweep, {k: d[k] for k in TIER_COUNTERS}

    both(pkgs, case)


# -- striped fetch (tests/test_striped_transport.py) ---------------------------


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("stripes", [1, 3])
def test_striped_fetch_matches_jax(pkgs, stage, stripes):
    """Blocks above the stripe threshold read as stripes over 3 data
    lanes, and exactly as over one channel: the same records and the
    same stripe count in both packages."""
    def case(P):
        c0 = counters(P)
        with cluster(P, stage, {
            "spark.shuffle.tpu.transportNumStripes": stripes,
            "spark.shuffle.tpu.transportStripeThreshold": "64k",
            "spark.shuffle.tpu.shuffleReadBlockSize": "8m",
            "spark.shuffle.tpu.maxAggBlock": "8m",
        }) as (_net, driver, executors):
            handle = driver.register_shuffle(31, 2, P.part.HashPartitioner(2))
            recs = [[(f"m{m}k{j}", bytes([j % 251]) * 40_000)
                     for j in range(40)] for m in range(2)]
            mbh = write_maps(handle, executors, recs)
            got = {}
            for i, ex in enumerate(executors):
                rd = ex.get_reader(handle, i, i + 1, mbh)
                got.update((k, bytes(memoryview(v))) for k, v in rd.read())
                assert rd.metrics.remote_blocks > 0
        assert got == {k: v for r in recs for k, v in r}
        d = delta(c0, counters(P), "transport_stripes_total",
                  "transport_striped_reads_total")
        assert (d["transport_stripes_total"] > 0) == (stripes > 1), d
        return sorted(got), d

    both(pkgs, case)


# -- QoS (tests/test_qos.py) ---------------------------------------------------


def _qos_job(P, stage, extra):
    """Two shuffles at once, each its own tenant (the default tenant is
    per shuffle): their records, and each tenant's registered bytes
    after unregister."""
    with cluster(P, stage, extra) as (_net, driver, executors):
        outs = {}

        def one(sid):
            handle = driver.register_shuffle(sid, 4, P.part.HashPartitioner(4))
            mbh = write_maps(handle, executors, [
                [(f"k{j % 17}", (sid, m, j)) for j in range(200)]
                for m in range(4)])
            outs[sid] = read_grouped(executors, handle, 4, mbh)
            driver.unregister_shuffle(sid)

        ts = [threading.Thread(target=one, args=(sid,)) for sid in (7, 8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert sorted(outs) == [7, 8]
        qos = P.qos.GLOBAL_QOS
        left = {t["name"]: t["registered_bytes"]
                for t in qos.snapshot()["tenants"]}
    return outs, left


@pytest.mark.parametrize("stage", STAGES)
def test_qos_two_tenants_match_jax(pkgs, stage):
    """qosEnabled with two tenants gives the records of the QoS-off run
    in both packages, grants credits to both tenants, and hands every
    admitted byte back once the shuffles are unregistered."""
    def case(P):
        off, _ = _qos_job(P, stage, {})
        P.qos.GLOBAL_QOS.reset()
        c0 = counters(P)
        on, left = _qos_job(P, stage, {
            "spark.shuffle.tpu.qosEnabled": True,
            "spark.shuffle.tpu.decodeThreads": 2})
        granted = delta(c0, counters(P), ("qos_granted_bytes_total",
                                          "shuffle-7"),
                        ("qos_granted_bytes_total", "shuffle-8"))
        assert on == off
        assert sorted(left) == ["shuffle-7", "shuffle-8"]
        assert set(left.values()) == {0}, left
        assert all(v > 0 for v in granted.values()), granted
        return on, left

    both(pkgs, case)


# -- fault injection and failure detection -------------------------------------
# (tests/test_faults.py, tests/test_failure_detection.py)

RETRY = {"spark.shuffle.tpu.fetchRetryCount": 10,
         "spark.shuffle.tpu.fetchRetryWaitMs": "2ms",
         "spark.shuffle.tpu.fetchRetryMaxMs": "30s"}


def _fault_job(P, stage, extra, maps=4):
    """Maps on executors 1 and 2, every partition read by executor 0,
    so every block is fetched: a fault on a LOCAL tier read escapes as
    the injected error itself in both packages (ROADMAP §C.3)."""
    recs = [[(f"m{m}r{j}", bytes([(m + j) % 251]) * 600) for j in range(200)]
            for m in range(maps)]
    c0 = counters(P)
    outcome = "exact"
    with cluster(P, stage, {**RETRY, **extra}, n=3) as (_n, driver, exs):
        handle = driver.register_shuffle(0, maps, P.part.HashPartitioner(4))
        mbh = write_maps(handle, exs[1:], recs)
        try:
            got = read_grouped(exs[:1], handle, 4, mbh)
            assert got == grouped(recs), P.name
        except (P.reader.FetchFailedError,
                P.reader.MetadataFetchFailedError):
            outcome = "failed-clean"
        fired = P.faults.fired_counts()
    return outcome, fired, delta(
        c0, counters(P), "shuffle_fetch_retries_total", "fault_injected_total")


FAULT_SPECS = {
    # every second read response cut: the in-task retries absorb it
    "read_resp": ("read_resp:nth=2;seed=3", {}),
    # every third cold-tier disk read fails on the serving side
    "disk_read": ("disk_read:nth=3;seed=5",
                  {"spark.shuffle.tpu.fileBackedCommitBytes": 1,
                   "spark.shuffle.tpu.tierHotBytes": "16k"}),
    # a seeded mix over the fetch plane and the disk
    "mixed": ("connect:p=0.04;read_resp:p=0.06;serve_delay:ms=2,p=0.3;"
              "send:p=0.015;disk_read:p=0.04;seed=101",
              {"spark.shuffle.tpu.fileBackedCommitBytes": 1,
               "spark.shuffle.tpu.tierHotBytes": "64k",
               "spark.shuffle.tpu.fetchRetryCount": 4}),
}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("fault", list(FAULT_SPECS))
def test_fault_injection_matches_jax(pkgs, stage, fault):
    """A fault schedule on fetches and disk reads: every run is exact
    or fails cleanly with a stage-retriable error, never a wrong answer
    or a hang.  The deterministic schedules (``nth=``) are absorbed by
    the retries in both packages; the response cuts fire the same
    number of times."""
    spec, extra = FAULT_SPECS[fault]

    def case(P):
        outcome, fired, d = _fault_job(
            P, stage, {"spark.shuffle.tpu.faultInject": spec, **extra})
        assert outcome in ("exact", "failed-clean")
        assert fired and d["fault_injected_total"] > 0, fired
        if fault == "mixed":
            return outcome in ("exact", "failed-clean")
        assert outcome == "exact" and d["shuffle_fetch_retries_total"] > 0
        # a retried block's re-read draws from the disk schedule again,
        # and which blocks cluster into one read depends on the timing
        return outcome, fired if fault == "read_resp" else None

    both(pkgs, case)


@pytest.mark.parametrize("stage", STAGES)
def test_fetch_failure_ladder_matches_jax(pkgs, stage):
    """Every read response cut (``read_resp:nth=1``): with retries off
    the first failure converts to a FetchFailedError and nothing is
    retried; with retries on, the strikes trip the per-peer breaker and
    the fetch still fails cleanly; once the fault plane heals, a stage
    rerun's fresh reader probes the open breaker and reads exactly.
    Lane kills on striped reads demote the peer to one lane, and the
    retry completes exactly.  The same in both packages."""
    def ladder(P, extra, heal):
        recs = [[(f"m{m}r{j}", bytes([(m + j) % 251]) * 1500)
                 for j in range(240)] for m in range(2)]
        c0 = counters(P)
        out = []
        with cluster(P, stage, {**RETRY, **extra}, n=3) as (_n, drv, exs):
            handle = drv.register_shuffle(0, 2, P.part.HashPartitioner(4))
            mbh = write_maps(handle, exs[1:], recs)
            try:
                out.append(read_grouped(exs[:1], handle, 4, mbh)
                           == grouped(recs))
            except P.reader.FetchFailedError:
                out.append("failed-clean")
            if heal:
                P.faults.reset()
                again = drv.register_shuffle(2, 2, P.part.HashPartitioner(4))
                mbh = write_maps(again, exs[1:], recs)
                out.append(read_grouped(exs[:1], again, 4, mbh)
                           == grouped(recs))
            fired = P.faults.fired_counts()
        d = delta(c0, counters(P), "shuffle_fetch_retries_total",
                  "transport_breaker_trips_total",
                  "transport_stripe_demotions_total")
        return out, fired, {k: v > 0 for k, v in d.items()}

    def case(P):
        off = ladder(P, {"spark.shuffle.tpu.faultInject": "read_resp:nth=1",
                         "spark.shuffle.tpu.fetchRetryCount": 0}, False)
        assert off[0] == ["failed-clean"] and not any(off[2].values())
        P.faults.reset()
        brk = ladder(P, {"spark.shuffle.tpu.faultInject": "read_resp:nth=1",
                         "spark.shuffle.tpu.fetchRetryCount": 3,
                         "spark.shuffle.tpu.fetchRetryWaitMs": "1ms",
                         "spark.shuffle.tpu.fetchBreakerFailures": 2,
                         "spark.shuffle.tpu.fetchBreakerResetMs": "600s"},
                     True)
        assert brk[0] == ["failed-clean", True], brk
        assert brk[2]["transport_breaker_trips_total"], brk
        P.faults.reset()
        lane = ladder(P, {
            "spark.shuffle.tpu.faultInject": "lane_kill:nth=2;seed=5",
            "spark.shuffle.tpu.fetchRetryCount": 8,
            "spark.shuffle.tpu.transportNumStripes": 2,
            "spark.shuffle.tpu.transportStripeThreshold": "64k",
            "spark.shuffle.tpu.stripeDemoteFailures": 1,
            "spark.shuffle.tpu.stripeDemoteMs": "60s",
            "spark.shuffle.tpu.fetchBreakerFailures": 0}, False)
        assert lane[0] == [True] and lane[1].get("lane_kill", 0) >= 1, lane
        assert lane[2]["transport_stripe_demotions_total"], lane
        # the faults fire as responses land (two peers, retries), so
        # only the outcomes and what moved are compared
        return off[0], off[2], brk[0], brk[2], lane[0], lane[2]

    both(pkgs, case)


# the TCP case's listeners: driver, then executors at +10 and +20, one
# cluster at a time (both packages, both staging modes, in one test)
TCP_BASE = 29776


def test_striped_push_over_tcp_matches_jax(pkgs):
    """Push merge and striped fetch over real sockets (``TcpNetwork``,
    one per manager): the JAX package with map outputs on the host, the
    port staged and not, the same records, with sub-blocks pushed and
    stripes read, on the ports asserted."""
    def run(P, stage):
        confd = {
            "spark.shuffle.tpu.driverPort": TCP_BASE,
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "20s",
            "spark.shuffle.tpu.connectTimeout": "10s",
            "spark.shuffle.tpu.pushEnabled": True,
            "spark.shuffle.tpu.transportNumStripes": 3,
            "spark.shuffle.tpu.transportStripeThreshold": "64k",
            "spark.shuffle.tpu.shuffleReadBlockSize": "8m",
            "spark.shuffle.tpu.maxAggBlock": "8m",
        }
        c0 = counters(P)
        driver = P.Manager(P.Conf(confd), True, P.transport.TcpNetwork(),
                           port=TCP_BASE, stage_to_device=stage)
        executors = [P.Manager(P.Conf(confd), False, P.transport.TcpNetwork(),
                               port=TCP_BASE + 10 * (i + 1),
                               executor_id=str(i), stage_to_device=stage)
                     for i in range(2)]
        try:
            ports = [m.node.address[1] for m in [driver] + executors]
            assert ports == [TCP_BASE, TCP_BASE + 10, TCP_BASE + 20], ports
            handle = driver.register_shuffle(31, 2, P.part.HashPartitioner(2))
            recs = [[(f"m{m}k{j}", bytes([j % 251]) * 40_000)
                     for j in range(40)] for m in range(2)]
            mbh = write_maps(handle, executors, recs)
            got = read_grouped(executors, handle, 2, mbh)
        finally:
            for m in executors + [driver]:
                m.stop()
        assert got == grouped(recs)
        # which partitions a merged span serves (and so which blocks are
        # striped) depends on when each push lands against the seal
        d = delta(c0, counters(P), "push_sub_blocks_sent_total",
                  "transport_stripes_total")
        assert all(v > 0 for v in d.values()), d
        return got

    want = run(pkgs[0], False)
    for stage in (False, True):
        assert run(pkgs[1], stage) == want


@pytest.mark.parametrize("stage", STAGES)
def test_executor_loss_fails_clean_then_retry_is_exact(pkgs, stage):
    """An executor cut off before the reduce: the read fails with a
    stage-retriable error instead of hanging; after the heal, the stage
    rerun on the survivors is exact (the failure-detection contract of
    tests/test_failure_detection.py)."""
    def case(P):
        rng = np.random.default_rng(1234)
        recs = [[(int(k), int(v)) for k, v in zip(
            rng.integers(0, 30, 150), rng.integers(0, 100, 150))]
            for _m in range(3)]
        with cluster(P, stage, {
            "spark.shuffle.tpu.heartbeatInterval": "100ms",
            "spark.shuffle.tpu.heartbeatTimeout": "400ms",
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "30s",
        }, n=3) as (net, driver, executors):
            handle = driver.register_shuffle(900, 3, P.part.HashPartitioner(4))
            mbh = write_maps(handle, executors, recs)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and sum(
                    len(v) for v in driver.maps_by_host(900).values()) < 3:
                time.sleep(0.01)
            victim = executors[2]
            net.partition(victim.node.address)
            t0 = time.monotonic()
            # a data-plane or a metadata failure, by when the driver
            # prunes the victim: both are the stage-retriable contract
            with pytest.raises((P.reader.FetchFailedError,
                                P.reader.MetadataFetchFailedError)):
                read_grouped(executors[:1], handle, 4, mbh)
            assert time.monotonic() - t0 < 20
            net.heal(victim.node.address)
            retry = driver.register_shuffle(901, 3, P.part.HashPartitioner(4))
            mbh = write_maps(retry, executors[:2], recs)
            got = read_grouped(executors[:1], retry, 4, mbh)
        assert got == grouped(recs)
        return got

    both(pkgs, case)


# -- every feature through api.py ----------------------------------------------

FEATURES = {
    "push": {"spark.shuffle.tpu.pushEnabled": True},
    "skew": {"spark.shuffle.tpu.skewEnabled": True,
             "spark.shuffle.tpu.skewSplitThreshold": "2k"},
    "tier": {"spark.shuffle.tpu.fileBackedCommitBytes": 1,
             "spark.shuffle.tpu.tierHotBytes": "8k"},
    "stripe": {"spark.shuffle.tpu.transportNumStripes": 3,
               "spark.shuffle.tpu.transportStripeThreshold": "64k",
               "spark.shuffle.tpu.shuffleReadBlockSize": "8m",
               "spark.shuffle.tpu.maxAggBlock": "8m"},
    "qos": {"spark.shuffle.tpu.qosEnabled": True,
            "spark.shuffle.tpu.decodeThreads": 2},
    "faults": {"spark.shuffle.tpu.faultInject": "read_resp:nth=3;seed=3",
               **RETRY},
}
# the counter each feature must move in the api run
ENGAGED = {"push": "push_sub_blocks_total",
           "skew": "skew_partitions_split_total",
           "tier": "tier_commit_bytes_total",
           "stripe": "transport_stripes_total",
           "qos": "qos_granted_bytes_total",
           "faults": "fault_injected_total"}


def _api_records(feature):
    """Zipf-like keys (a third of the records on key 0, so ``skew``
    has a hot partition).  ``skew`` splits only at serializer frames
    (pickle batches of 4096 records), and ``stripe`` needs blocks above
    its 64 KiB threshold, so both get more records."""
    n = 100_000 if feature in ("skew", "stripe") else 3000
    rng = np.random.default_rng(7)
    keys = np.where(rng.random(n) < 0.35, 0, rng.integers(1, 61, n))
    return keys.astype(np.int64), rng.integers(0, 1000, n).astype(np.int64)


def _api_job(P, stage, feature, serializer, tmp):
    keys, vals = _api_records(feature)
    records = list(zip(keys.tolist(), vals.tolist()))
    conf = P.Conf({"spark.shuffle.tpu.serializer": serializer,
                   "spark.shuffle.tpu.spillDir": str(tmp),
                   **FEATURES[feature]})
    c0 = counters(P)
    out = {}
    with P.Context(num_executors=2, conf=conf, stage_to_device=stage,
                   base_port=37600) as ctx:
        for op in ("group", "reduce", "sort"):
            if serializer == "columnar":
                ds = ctx.parallelize_columns(keys, vals, num_slices=4)
            else:
                ds = ctx.parallelize(records, num_slices=4)
            out[op] = canon(run_op(ds, op, serializer == "columnar"), op)
            assert out[op] == oracle(records, op), (P.name, feature, op)
    moved = delta(c0, counters(P), ENGAGED[feature])[ENGAGED[feature]]
    # one ColumnBatch a slice is one frame a partition: nothing to split
    assert (moved > 0) == (feature != "skew" or serializer == "pickle"), (
        P.name, feature, ENGAGED[feature])
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("serializer", ["pickle", "columnar"])
@pytest.mark.parametrize("feature", list(FEATURES))
def test_api_feature_matches_jax(pkgs, tmp_path, feature, serializer, stage):
    both(pkgs, _api_job, stage, feature, serializer, tmp_path)


# -- the repairs ---------------------------------------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_colocated_windowed_plane_waits_for_a_late_executor(pkgs, stage):
    """Four executors share one co-located windowed plane built by hand
    (no context waits for their hellos), and every message executor 3
    sends the driver lands 0.3 s late.  The driver pins the plan's
    host set at the first window: unless the first plan request waits
    until the driver has announced all four, executor 3 is refused its
    plan and the others wait for its row until the barrier times out.
    The result equals the JAX package's context, run on time."""
    P = pkgs[1]
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange
    from sparkrdma_tpu_torch.shuffle.bulk import (
        BulkShuffleSession,
        WindowedReadPlane,
    )

    keys = np.arange(2048, dtype=np.int64) % 67
    vals = np.arange(2048, dtype=np.int64)
    confd = {"spark.shuffle.tpu.readPlane": "windowed",
             "spark.shuffle.tpu.bulkWindowMaps": "2",
             "spark.shuffle.tpu.serializer": "columnar",
             "spark.shuffle.tpu.bulkBarrierTimeout": "15s"}
    with pkgs[0].Context(num_executors=4, conf=pkgs[0].Conf(confd),
                         stage_to_device=stage) as jctx:
        want = dict(jctx.parallelize_columns(keys, vals, num_slices=8)
                    .reduce_by_key("sum", num_partitions=8).collect())

    cls = P.manager.TpuShuffleManager
    send = cls._send_driver_msg

    def late(self, msg, on_failure=None):
        if self.local_smid.block_manager_id.executor_id != "3":
            return send(self, msg, on_failure)

        def deliver():
            try:
                send(self, msg, on_failure)
            except Exception:  # noqa: BLE001 - the manager stopped
                pass

        threading.Timer(0.3, deliver).start()

    cls._send_driver_msg = late
    try:
        with cluster(P, stage, n=4, announced=False, conf=P.Conf({
            **confd, "spark.shuffle.tpu.driverPort": 37700,
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "20s",
        })) as (_net, driver, executors):
            session = BulkShuffleSession(
                TileExchange.colocated(4, tile_bytes=1 << 12, device="cpu"),
                4, timeout_s=15.0)
            for ex in executors:
                ex.windowed_plane = WindowedReadPlane(ex, session=session)
            agg = P.manager.ColumnarAggregator.reduce("sum")
            handle = driver.register_shuffle(
                0, 8, P.part.HashPartitioner(8), aggregator=agg,
                map_side_combine=True)
            for m in range(8):
                w = executors[m % 4].get_writer(handle, m)
                lo, hi = m * 256, (m + 1) * 256
                w.write_columns(P.columns.ColumnBatch(keys[lo:hi],
                                                      vals[lo:hi]))
                w.stop(True)
            got, errs = {}, {}

            def reduce(p):
                try:
                    for k, v in executors[p % 4].get_reader(
                            handle, p, p + 1, {}).read():
                        got[int(k)] = int(v)
                except BaseException as e:  # noqa: BLE001 - reported
                    errs[p] = e

            ts = [threading.Thread(target=reduce, args=(p,))
                  for p in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(40)
            assert not any(t.is_alive() for t in ts), "a reader stalled"
            assert not errs, errs
    finally:
        cls._send_driver_msg = send
    assert got == {int(k): int(v) for k, v in want.items()}


TIER_FAULT = textwrap.dedent("""
    import os, sys, numpy as np
    from sparkrdma_tpu_torch.memory.arena import ArenaManager
    from sparkrdma_tpu_torch.memory.mapped_file import MappedFile
    from sparkrdma_tpu_torch.memory.tier import TieredBlockStore

    store = TieredBlockStore(hot_bytes=1 << 20)
    arena = ArenaManager()
    pattern = np.random.default_rng(7).integers(0, 256, 8 * 8192,
                                                dtype=np.uint8)
    mf = MappedFile(pattern.tobytes(), directory=sys.argv[1],
                    direct_write=False, defer_map=True)
    seg = store.adopt(mf, [(i * 8192, 8192) for i in range(8)],
                      8 * 8192, 0, arena)
    read = store._disk_read

    def racing_read(entry, offset, length):
        # the segment is released (shuffle unregistered, task retry)
        # while a warm has its cold bytes in hand and not yet copied
        data = read(entry, offset, length)
        arena.release(seg.mkey)
        return data

    store._disk_read = racing_read
    entry = store._by_mkey[seg.mkey]
    row = store._load_row(entry, entry.blocks[2])
    assert np.array_equal(row, pattern[2 * 8192:3 * 8192])
    assert not os.listdir(sys.argv[1])
    print("intact")
""")


def test_tier_warm_survives_a_racing_release(tmp_path):
    """The tier store's segmentation fault: a warm on a drain thread
    copies a block's cold bytes (an ``np.memmap`` view) into a pooled
    row while the segment is released, and ``MappedFile.free`` used to
    close the mapping under the view.  Run in a subprocess, so that a
    crash fails this test alone."""
    out = subprocess.run(
        [sys.executable, "-c", TIER_FAULT, str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "intact", (
        out.returncode, out.stdout, out.stderr)


def test_tier_disk_read_raced_by_a_free_fails_cleanly(tmp_path):
    """A cold read whose mapping is made while the segment is freed (a
    task retry superseding it) fails with ``TransportError``, which the
    serve paths turn into a retryable fetch failure.
    ``MappedFile.ensure_mapped`` returned None when ``free()`` landed
    between its mapping and its read of the mapped array, and the read
    escaped as a ``TypeError``."""
    from sparkrdma_tpu_torch.memory.arena import ArenaManager
    from sparkrdma_tpu_torch.memory.mapped_file import MappedFile
    from sparkrdma_tpu_torch.memory.tier import TieredBlockStore
    from sparkrdma_tpu_torch.transport import TransportError

    store = TieredBlockStore(hot_bytes=1 << 20)
    arena = ArenaManager()
    mf = MappedFile(bytes(range(256)) * 256, directory=str(tmp_path),
                    direct_write=False, defer_map=True)
    seg = store.adopt(mf, [(i * 8192, 8192) for i in range(8)],
                      8 * 8192, 0, arena)
    entry = store._by_mkey[seg.mkey]
    real_map = mf._map

    def map_then_freed(length):
        real_map(length)
        mf.free()

    mf._map = map_then_freed
    with pytest.raises(TransportError, match="freed"):
        store._disk_read(entry, 8192, 8192)
    assert not os.listdir(tmp_path)
