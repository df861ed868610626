"""The port's failure detection and chaos across processes held against the
JAX package: the twins of tests/test_failure_detection.py and
tests/test_tcp_chaos.py.

The failure-detection cases run over a ``LoopbackNetwork`` cluster of
each package (driver and three executors, a fast heartbeat and a slow
location timeout, as the JAX file's own ``cluster`` fixture), with map
outputs staged and on the host; the loss, prune and rejoin cases run once
more over ``TcpNetwork``.  The chaos cases kill a data lane mid-read, and
SIGKILL executor processes (spawned from tests/torch_transport_worker.py)
on a seeded schedule.  Timing decides those outcomes, so each package is
held to the same contract, not the same counts: every read exact or
failed with a stage-retriable error within the bound, and every rerun on
the survivors exact.

TCP listeners bind in 63300-64299 (``BAND``): the JAX package's at
``PORTS``, the port's ``HALF`` above; every case asserts the ports it
bound, and the TCP clusters take turns under a lock file.
"""

import contextlib
import fcntl
import multiprocessing
import os
import random
import tempfile
import threading
import time
from collections import defaultdict

import pytest

from tests import torch_transport_worker as worker
from tests.test_torch_conf_matrix import STAGES, pkgs  # noqa: F401
from tests.test_torch_transport import Wire

BAND = (63300, 64300)
HALF = 500
PORTS = {  # the JAX half; the port's is HALF above
    "tcp_loss": 63300,      # 2 x 50: driver, executors +10, +20, +30
    "lane_kill": 63400,     # 4 x 20: driver, writer +10
    "sweep": 63480,         # drivers +0, +10; executors from 63500 and
    "sweep_execs": 63500,   # 63600, +10 per spawn (at most 9 each)
    "dead_peer": 63700,     # 2 x 50: driver, executors +10, +20
}
SWEEP_TRIALS = int(os.environ.get("SPARKRDMA_TCP_CHAOS_TRIALS", "6"))
SWEEP_SEED = int(os.environ.get("SPARKRDMA_TEST_CHAOS_SEED", "20260731"))


@pytest.fixture(scope="module")
def wires(pkgs):
    return tuple(Wire(P) for P in pkgs)


def port_of(W, name, k=0):
    return PORTS[name] + k + (HALF if W.is_port else 0)


def bound(*managers, want):
    got = [m.node.address[1] for m in managers]
    assert got == list(want), got
    assert all(BAND[0] <= p < BAND[1] for p in got), got


@contextlib.contextmanager
def cluster_lock(port):
    """A cluster holds the lock file of its first port while it runs:
    another run of the same case (another worker, another checkout) waits
    instead of taking its ports."""
    path = os.path.join(tempfile.gettempdir(),
                        f"sparkrdma_tpu_torch_ports_{port}.lock")
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def both(wires, case, *args):
    want, got = (case(W, *args) for W in wires)
    assert got == want
    return got


def jax_once_port_twice(wires, case):
    """The JAX package's run with map outputs on the host, then the
    port's with them on the host and staged: each equal to the JAX run.
    For the long chaos cases, where a JAX run in both modes would add
    nothing the port's two runs do not check."""
    jw, pw = wires
    want = case(jw, False)
    for stage in (False, True):
        assert case(pw, stage) == want
    return want


def await_(cond, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def run_maps(handle, executors, records_per_map):
    mbh = defaultdict(list)
    for map_id, records in enumerate(records_per_map):
        ex = executors[map_id % len(executors)]
        w = ex.get_writer(handle, map_id)
        w.write(records)
        w.stop(True)
        mbh[ex.local_smid].append(map_id)
    return dict(mbh)


def read_all(reader_ex, handle, parts, mbh):
    got = defaultdict(list)
    for pid in range(parts):
        for k, v in reader_ex.get_reader(handle, pid, pid + 1, mbh).read():
            got[k].append(v)
    return {k: sorted(v) for k, v in got.items()}


def grouped(records_per_map):
    want = defaultdict(list)
    for recs in records_per_map:
        for k, v in recs:
            want[k].append(v)
    return {k: sorted(v) for k, v in want.items()}


# -- failure detection over loopback (tests/test_failure_detection.py) ---------


@contextlib.contextmanager
def loop_cluster(W, stage, heartbeat_timeout="400ms"):
    net = W.LoopbackNetwork()
    conf = W.Conf({
        "spark.shuffle.tpu.driverPort": 39500,
        "spark.shuffle.tpu.heartbeatInterval": "100ms",
        "spark.shuffle.tpu.heartbeatTimeout": heartbeat_timeout,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "30s",
    })
    driver = W.Manager(conf, True, net, stage)
    executors = [W.Manager(conf, False, net, stage, port=39600 + i * 10,
                           executor_id=str(i)) for i in range(3)]
    try:
        await_(lambda: all(len(e._peers) == 3 for e in executors), 5,
               "announces")
        yield net, conf, driver, executors
    finally:
        for m in executors + [driver]:
            m.stop()


def rejoin(net, driver, victim, msg="re-join after heal"):
    net.heal(victim.node.address)
    victim._hello_sent = False
    victim._say_hello()
    await_(lambda: victim.local_smid in driver.executors, msg=msg)


def prune(net, driver, victim):
    net.partition(victim.node.address)
    await_(lambda: victim.local_smid not in driver.executors, msg="prune")


def _heartbeat_keeps_live_executors(W, net, conf, driver, executors):
    time.sleep(1.2)
    return len(driver.executors)


def _foreign_shutdown_shaped_error_still_prunes(W, net, conf, driver,
                                                executors):
    victim = executors[2]
    driver._on_executor_send_failure(victim.local_smid, RuntimeError(
        "cannot schedule new futures after interpreter shutdown"))
    pruned = victim.local_smid not in driver.executors
    quiesced = driver._hb_stop.is_set()
    time.sleep(0.5)
    return pruned, quiesced, len(driver.executors)


def _own_node_shutdown_quiesces_instead_of_pruning(W, net, conf, driver,
                                                   executors):
    driver.node._stopped.set()
    try:
        driver._on_executor_send_failure(executors[0].local_smid,
                                         OSError("socket closed"))
        return (executors[0].local_smid in driver.executors,
                driver._hb_stop.is_set())
    finally:
        driver.node._stopped.clear()
        driver._hb_stop.clear()


def _dead_executor_pruned_automatically(W, net, conf, driver, executors):
    prune(net, driver, executors[2])
    n = len(driver.executors)
    net.heal(executors[2].node.address)
    return n


def _timed_raise(W, fn, errors):
    """(the exception class's name, seconds) of ``fn``, which must raise
    one of ``errors``."""
    t0 = time.monotonic()
    with pytest.raises(errors) as e:
        fn()
    return type(e.value).__name__, time.monotonic() - t0


def _executor_loss_mid_shuffle_fails_reducer_promptly(W, net, conf, driver,
                                                      executors):
    handle = driver.register_shuffle(50, 2, W.Hash(2))
    w = executors[0].get_writer(handle, 0)
    w.write([("a", 1)])
    w.stop(True)
    victim = executors[1]
    mbh = {executors[0].local_smid: [0], victim.local_smid: [1]}
    net.partition(victim.node.address)
    kind, secs = _timed_raise(W, lambda: list(executors[0].get_reader(
        handle, 0, 2, mbh).read()), W.reader.MetadataFetchFailedError)
    net.heal(victim.node.address)
    return kind, secs < 10


def _fetch_status_for_tombstoned_executor_fails_immediately(
        W, net, conf, driver, executors):
    handle = driver.register_shuffle(51, 1, W.Hash(2))
    victim = executors[1]
    prune(net, driver, victim)
    kind, secs = _timed_raise(W, lambda: list(executors[0].get_reader(
        handle, 0, 2, {victim.local_smid: [0]}).read()),
        W.reader.MetadataFetchFailedError)
    net.heal(victim.node.address)
    return kind, secs < 5


def _unregistered_shuffle_fails_fast(W, net, conf, driver, executors):
    handle = W.imp("shuffle.manager").ShuffleHandle(99, 1, W.Hash(2))
    t0 = time.monotonic()
    with pytest.raises(W.reader.MetadataFetchFailedError,
                       match="not registered"):
        list(executors[0].get_reader(
            handle, 0, 1, {executors[1].local_smid: [0]}).read())
    return time.monotonic() - t0 < 5


def _pruned_executor_can_rejoin(W, net, conf, driver, executors):
    victim = executors[2]
    prune(net, driver, victim)
    rejoin(net, driver, victim)
    return sorted(s.block_manager_id.executor_id for s in driver.executors)


def _loss_after_publish_still_fails_data_plane(W, net, conf, driver,
                                               executors):
    handle = driver.register_shuffle(52, 2, W.Hash(2))
    mbh = run_maps(handle, executors[:2], [[("k0", 0)], [("k1", 1)]])
    await_(lambda: sum(len(v) for v in driver.maps_by_host(52).values())
           == 2, msg="publishes to land")
    net.partition(executors[1].node.address)
    kind, secs = _timed_raise(W, lambda: list(executors[0].get_reader(
        handle, 0, 2, mbh).read()), W.reader.FetchFailedError)
    net.heal(executors[1].node.address)
    # the metadata kind when the driver prunes before the fetch-status
    # request lands: timing picks which, in both packages
    return issubclass(getattr(W.reader, kind), W.reader.FetchFailedError), \
        secs < 10


def bulk_reader(W, executor):
    bulk = W.imp("shuffle.bulk")
    ex = W.imp("parallel.exchange")
    if W.is_port:
        exchange = ex.TileExchange.colocated(3, device="cpu",
                                             tile_bytes=1 << 12)
    else:
        from sparkrdma_tpu.parallel.mesh import make_mesh

        exchange = ex.TileExchange(make_mesh(3), tile_bytes=1 << 12)
    return bulk.BulkExchangeReader(executor, exchange)


def _executor_loss_fails_bulk_plan_waiters_promptly(W, net, conf, driver,
                                                    executors):
    handle = driver.register_shuffle(55, 2, W.Hash(4))
    w = executors[0].get_writer(handle, 0)
    w.write([("a", 1)])
    w.stop(True)
    reader = bulk_reader(W, executors[0])
    t0, box = time.monotonic(), {}

    def run():
        try:
            box["out"] = list(reader.read(55))
        except BaseException as e:
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)
    early = bool(box)
    net.partition(executors[2].node.address)
    t.join(timeout=15)
    net.heal(executors[2].node.address)
    return (early, type(box.get("err")).__name__,
            time.monotonic() - t0 < 15)


def _post_loss_bulk_plan_request_fails_fast(W, net, conf, driver, executors):
    handle = driver.register_shuffle(56, 2, W.Hash(4))
    run_maps(handle, executors[:2], [[("k0", 0)], [("k1", 1)]])
    prune(net, driver, executors[1])
    reader = bulk_reader(W, executors[0])
    t0 = time.monotonic()
    with pytest.raises(W.reader.MetadataFetchFailedError, match="membership"):
        list(reader.read(56))
    net.heal(executors[1].node.address)
    return time.monotonic() - t0 < 5


def _duplicate_prune_does_not_bump_epoch(W, net, conf, driver, executors):
    victim = executors[2]
    prune(net, driver, victim)
    epoch = driver._membership_epoch
    driver.remove_executor(victim.local_smid)
    net.heal(victim.node.address)
    return driver._membership_epoch == epoch


def _publish_from_tombstoned_executor_dropped(W, net, conf, driver,
                                              executors):
    driver.register_shuffle(77, 1, W.Hash(2))
    victim = executors[0]
    prune(net, driver, victim)
    L = W.BlockLocation
    mto = W.imp("shuffle.map_output").MapTaskOutput(2)
    mto.put(0, L(1, 8, 3))
    mto.put(1, L(9, 8, 3))
    driver._handle_publish(W.imp("rpc.messages").PublishMapTaskOutputMsg(
        victim.local_smid, shuffle_id=77, map_id=0, total_num_partitions=2,
        first_reduce_id=0, last_reduce_id=1,
        entries=mto.get_range_bytes(0, 1)))
    net.heal(victim.node.address)
    return victim.local_smid not in driver.maps_by_host(77)


def _chaos_random_faults_exact_or_clean_failure(W, net, conf, driver,
                                                executors):
    """The seeded sweep: eight trials, each exact, or a stage-retriable
    failure followed by an exact rerun on the survivors.  Returns the
    seeded schedule (the same in both packages) and that trial 0, a
    partition before the read, failed and was retried."""
    rng = random.Random(int(os.environ.get("SPARKRDMA_TEST_CHAOS_SEED",
                                           "1234")))
    t_start, retried, schedule = time.monotonic(), [], []
    for trial in range(8):
        sid = 900 + trial * 2
        parts = rng.choice([2, 4])
        n_maps = rng.choice([3, 6])
        handle = driver.register_shuffle(sid, n_maps, W.Hash(parts))
        recs = [[(rng.randrange(30), rng.randrange(100))
                 for _ in range(rng.randrange(50, 200))]
                for _ in range(n_maps)]
        mbh = run_maps(handle, executors, recs)
        fault = ("partition" if trial == 0 else rng.choice(
            ["none", "partition", "partition", "channel"]))
        victim = rng.choice(executors[1:])
        delay = 0.0 if trial == 0 else rng.uniform(0.0, 0.008)
        pick = rng.random()
        schedule.append((parts, n_maps, fault, victim.local_smid.port))
        injected = threading.Event()

        def inject(victim=victim, delay=delay, fault=fault, pick=pick):
            time.sleep(delay)
            if fault == "partition":
                net.partition(victim.node.address)
            elif fault == "channel":
                with victim.node._active_lock:
                    chans = list(victim.node._active.values())
                if chans:
                    chans[int(pick * len(chans))].inject_error()
            injected.set()

        th = threading.Thread(target=inject, daemon=True)
        th.start()
        try:
            got, failed = read_all(executors[0], handle, parts, mbh), None
        except W.fetch_errors as e:
            failed = e
        th.join(timeout=5)
        assert injected.is_set()
        if failed is None:
            assert got == grouped(recs), (trial, fault)
        else:
            assert fault in ("partition", "channel"), failed
            net.heal(victim.node.address)
            survivors = [e for e in executors if e is not victim]
            retry = driver.register_shuffle(sid + 1, n_maps, W.Hash(parts))
            assert read_all(executors[0], retry, parts, run_maps(
                retry, survivors, recs)) == grouped(recs), trial
            retried.append(trial)
        driver.unregister_shuffle(sid)
        driver.unregister_shuffle(sid + 1)
        net.heal(victim.node.address)
        if fault in ("partition", "channel"):
            time.sleep(0.05)
            rejoin(net, driver, victim, msg=f"trial {trial} rejoin")
    assert time.monotonic() - t_start < 120
    return schedule, retried[:1] == [0]


def _rejoin_hello_refreshes_ack_clock(W, net, conf, driver, executors):
    victim = executors[2]
    kept = []
    for rep in range(5):
        for _attempt in range(3):
            t0 = time.monotonic()
            driver._last_ack[victim.local_smid] = t0 - 10.0
            victim._hello_sent = False
            victim._say_hello()
            await_(lambda: driver._last_ack.get(victim.local_smid, 0.0)
                   >= t0 - 5.0, msg=f"rep {rep} ack-clock refresh")
            if victim.local_smid in driver.executors:
                break
        time.sleep(0.25)
        kept.append(victim.local_smid in driver.executors)
    return kept


DETECTION_CASES = {f.__name__[1:]: f for f in (
    _heartbeat_keeps_live_executors,
    _foreign_shutdown_shaped_error_still_prunes,
    _own_node_shutdown_quiesces_instead_of_pruning,
    _dead_executor_pruned_automatically,
    _executor_loss_mid_shuffle_fails_reducer_promptly,
    _fetch_status_for_tombstoned_executor_fails_immediately,
    _unregistered_shuffle_fails_fast,
    _pruned_executor_can_rejoin,
    _loss_after_publish_still_fails_data_plane,
    _executor_loss_fails_bulk_plan_waiters_promptly,
    _post_loss_bulk_plan_request_fails_fast,
    _duplicate_prune_does_not_bump_epoch,
    _publish_from_tombstoned_executor_dropped,
    _rejoin_hello_refreshes_ack_clock)}

WANT = {
    "heartbeat_keeps_live_executors": 3,
    "foreign_shutdown_shaped_error_still_prunes": (True, False, 2),
    "own_node_shutdown_quiesces_instead_of_pruning": (True, True),
    "dead_executor_pruned_automatically": 2,
    "executor_loss_mid_shuffle_fails_reducer_promptly":
        ("MetadataFetchFailedError", True),
    "fetch_status_for_tombstoned_executor_fails_immediately":
        ("MetadataFetchFailedError", True),
    "unregistered_shuffle_fails_fast": True,
    "pruned_executor_can_rejoin": ["0", "1", "2"],
    "loss_after_publish_still_fails_data_plane": (True, True),
    "executor_loss_fails_bulk_plan_waiters_promptly":
        (False, "MetadataFetchFailedError", True),
    "post_loss_bulk_plan_request_fails_fast": True,
    "duplicate_prune_does_not_bump_epoch": True,
    "publish_from_tombstoned_executor_dropped": True,
    "rejoin_hello_refreshes_ack_clock": [True] * 5,
}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", list(DETECTION_CASES))
def test_failure_detection_matches_jax(wires, case, stage):
    """Each case of tests/test_failure_detection.py on each package's
    loopback cluster: heartbeat, prune, tombstone, rejoin, the membership
    epoch and the bulk-plan waiters give the same outcome, each within
    the JAX test's bound."""
    def run(W):
        with loop_cluster(W, stage) as cl:
            return DETECTION_CASES[case](W, *cl)

    assert both(wires, run) == WANT[case]


def test_chaos_random_faults_exact_or_clean_failure_matches_jax(wires):
    """The seeded fault sweep of tests/test_failure_detection.py: each of
    eight trials exact, or a stage-retriable failure and an exact rerun
    on the survivors; the same schedule in both packages, and trial 0's
    failure retried.  Its contract is exact-or-clean under the injected
    faults: at the JAX file's 400 ms heartbeat timeout a live executor
    that missed acks on a loaded test machine was pruned between trials,
    in both packages, so the sweep's clusters wait 2 s."""
    def run(W, stage):
        with loop_cluster(W, stage, "2s") as cl:
            return _chaos_random_faults_exact_or_clean_failure(W, *cl)

    assert jax_once_port_twice(wires, run)[1] is True


# -- loss, prune and rejoin over TcpNetwork ------------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_loss_prune_rejoin_over_tcp_matches_jax(wires, stage):
    """Over real sockets, each manager on its own ``TcpNetwork``: an
    executor that stops is pruned by the heartbeat, a read of its maps
    fails with a stage-retriable error within 10 s, a fresh manager of
    the same identity rejoins, and a rerun over all three is exact."""
    def case(W):
        base = port_of(W, "tcp_loss", 50 * stage)
        confd = {**worker.tcp_conf(base),
                 "spark.shuffle.tpu.heartbeatInterval": "100ms",
                 "spark.shuffle.tpu.heartbeatTimeout": "400ms",
                 "spark.shuffle.tpu.partitionLocationFetchTimeout": "30s"}

        def executor(i):
            return W.Manager(W.Conf(confd), False, W.TcpNetwork(), stage,
                             port=base + 10 * (i + 1), executor_id=str(i))

        driver = W.Manager(W.Conf(confd), True, W.TcpNetwork(), stage,
                           port=base)
        exs = []
        try:
            exs.extend(executor(i) for i in range(3))
            bound(driver, *exs, want=[base + 10 * i for i in range(4)])
            await_(lambda: len(driver.executors) == 3, msg="hellos")
            recs = [[(f"m{m}k{j}", m * 100 + j) for j in range(60)]
                    for m in range(3)]
            handle = driver.register_shuffle(40, 3, W.Hash(4))
            mbh = run_maps(handle, exs, recs)
            await_(lambda: sum(len(v) for v in driver.maps_by_host(
                40).values()) == 3, msg="publishes")
            victim = exs[2]
            lost = victim.local_smid
            victim.stop()
            await_(lambda: lost not in driver.executors, msg="prune")
            kind, secs = _timed_raise(
                W, lambda: read_all(exs[0], handle, 4, mbh), W.fetch_errors)
            exs[2] = executor(2)
            bound(exs[2], want=[base + 30])
            await_(lambda: exs[2].local_smid in driver.executors,
                   msg="rejoin")
            retry = driver.register_shuffle(41, 3, W.Hash(4))
            got = read_all(exs[0], retry, 4, run_maps(retry, exs, recs))
            assert got == grouped(recs)
            return kind in ("FetchFailedError", "MetadataFetchFailedError"), \
                secs < 10, sorted(s.block_manager_id.executor_id
                                   for s in driver.executors)
        finally:
            for m in exs + [driver]:
                m.stop()

    with cluster_lock(PORTS["tcp_loss"] + 50 * stage):
        assert both(wires, case) == (True, True, ["0", "1", "2"])


# -- chaos across real processes (tests/test_tcp_chaos.py) ---------------------


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("async_mode", ["on", "off"])
def test_kill_data_channel_mid_striped_read_matches_jax(wires, async_mode,
                                                        stage):
    """One data lane of a striped group stopped while a 16 MB partition
    crosses it: the read is exact or fails with a stage-retriable error
    (never hangs), and a fresh read is exact, on both engines."""
    def case(W):
        base = port_of(W, "lane_kill", 20 * (2 * (async_mode == "off")
                                             + stage))
        confd = {
            "spark.shuffle.tpu.driverPort": base,
            "spark.shuffle.tpu.transportAsyncDispatcher": async_mode,
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "10s",
            "spark.shuffle.tpu.connectTimeout": "5s",
            "spark.shuffle.tpu.transportNumStripes": 2,
            "spark.shuffle.tpu.transportStripeThreshold": "64k",
            "spark.shuffle.tpu.shuffleReadBlockSize": "32m",
            "spark.shuffle.tpu.maxAggBlock": "32m",
            "spark.shuffle.tpu.maxBytesInFlight": "64m",
        }
        driver = W.Manager(W.Conf(confd), True, W.TcpNetwork(), stage,
                           port=base)
        writer = W.Manager(W.Conf(confd), False, W.TcpNetwork(), stage,
                           port=base + 10, executor_id="w")
        try:
            bound(driver, writer, want=[base, base + 10])
            await_(lambda: len(writer._peers) >= 1, 5, "announce")
            handle = driver.register_shuffle(77, 1, W.Hash(1))
            rows = [(f"k{j}", bytes([j % 251]) * 65_536) for j in range(256)]
            w = writer.get_writer(handle, 0)
            w.write(rows)
            w.stop(True)
            mbh = {writer.local_smid: [0]}
            res = {}

            def read():
                try:
                    rd = driver.get_reader(handle, 0, 1, dict(mbh))
                    res["data"] = {k: bytes(memoryview(v))
                                   for k, v in rd.read()}
                except W.fetch_errors as e:
                    res["error"] = e

            t = threading.Thread(target=read, daemon=True)
            t.start()
            key = (writer.local_smid.host, writer.local_smid.port)
            deadline, victim = time.monotonic() + 10, None
            while victim is None and time.monotonic() < deadline:
                if driver.node._read_groups.get(key) is not None:
                    with driver.node._active_lock:
                        active = list(driver.node._active.items())
                    lanes = [ch for (_p, _t, slot), ch in active
                             if slot > 0 and ch.is_connected()]
                    if lanes:
                        victim = lanes[0]
                        victim.stop()
                        break
                time.sleep(0.0005)
            t.join(timeout=30)
            assert not t.is_alive(), "striped fetch hung after lane kill"
            if "data" in res:
                assert res["data"] == dict(rows), "completed read not exact"
            again = {k: bytes(memoryview(v)) for k, v in driver.get_reader(
                handle, 0, 1, dict(mbh)).read()}
            return ("data" in res or isinstance(res["error"],
                                                W.fetch_errors),
                    again == dict(rows))
        finally:
            writer.stop()
            driver.stop()

    with cluster_lock(PORTS["lane_kill"] + 20 * (
            2 * (async_mode == "off") + stage)):
        assert both(wires, case) == (True, True)


class ChaosCluster:
    """Executor processes of one package (tests/test_tcp_chaos.py's
    ``_Cluster``): SIGKILL, and respawn under a fresh identity and
    port."""

    def __init__(self, W, stage, driver_port, first_port, n=3, extra=None):
        self.W, self.stage, self.extra = W, stage, extra
        self.ctx = multiprocessing.get_context("spawn")
        self.driver_port, self.next_port = driver_port, first_port
        self.next_id = 0
        self.procs = {}
        self.ack_q = self.ctx.Queue()
        for slot in range(n):
            self.spawn(slot)

    def spawn(self, slot):
        exec_id, port = f"c{self.next_id}", self.next_port
        self.next_id += 1
        self.next_port += 10
        assert BAND[0] <= port < BAND[1]
        cmd_q = self.ctx.Queue()
        p = self.ctx.Process(target=worker.chaos_executor, args=(
            self.W.name, self.stage, exec_id, self.driver_port, port, cmd_q,
            self.ack_q, self.extra), daemon=True)
        p.start()
        self.procs[slot] = (p, exec_id, port, cmd_q)
        msg = self.await_ack("up", exec_id)
        assert msg[2] == port, f"{exec_id} bound {msg[2]}, not {port}"

    def await_ack(self, kind, exec_id, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                msg = self.ack_q.get(timeout=1)
            except Exception:
                continue
            if msg[0] == "err":
                raise AssertionError(f"child {msg[1]} crashed: {msg[2]}")
            if msg[0] == kind and msg[1] == exec_id:
                return msg
        raise AssertionError(f"no {kind} ack from {exec_id}")

    def smid(self, slot):
        _p, exec_id, port, _q = self.procs[slot]
        t = self.W.types
        return t.ShuffleManagerId(
            "127.0.0.1", port, t.BlockManagerId(exec_id, "127.0.0.1", port))

    def order_write(self, slot, sid, n_maps, map_ids):
        self.procs[slot][3].put(("write", sid, n_maps, list(map_ids)))

    def kill(self, slot):
        p = self.procs[slot][0]
        p.kill()
        p.join(timeout=10)

    def stop(self):
        for p, _e, _po, q in self.procs.values():
            if p.is_alive():
                with contextlib.suppress(Exception):
                    q.put(("quit",))
        for p, _e, _po, _q in self.procs.values():
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


def chaos_oracle(sid, map_ids):
    return {k: v for m in map_ids for k, v in worker.chaos_records(sid, m)}


def read_shuffle(W, driver, handle, mbh, result):
    t0 = time.monotonic()
    try:
        got = {}
        for pid in range(worker.NUM_PARTS):
            for k, v in driver.get_reader(handle, pid, pid + 1,
                                          dict(mbh)).read():
                got[k] = bytes(memoryview(v)) if not isinstance(
                    v, (bytes, str)) else v
        result["data"] = got
    except W.fetch_errors as e:
        result["error"] = e
    result["elapsed"] = time.monotonic() - t0


@pytest.mark.cluster
def test_tcp_chaos_sigkill_sweep_matches_jax(wires):
    """Three executor processes; each trial writes and reads two shuffles
    at once while a seeded coin SIGKILLs one executor at a random moment:
    each read exact, or a stage-retriable failure within 60 s; every
    rerun on the survivors exact; the victim respawned under a fresh
    identity.  ``SPARKRDMA_TCP_CHAOS_TRIALS`` (6 here, 20 in the JAX
    file) and ``SPARKRDMA_TEST_CHAOS_SEED`` set the sweep."""
    def case(W, stage):
        rng = random.Random(SWEEP_SEED)
        driver_port = port_of(W, "sweep", 10 * stage)
        driver = W.Manager(W.Conf(worker.chaos_conf(driver_port)), True,
                           W.TcpNetwork(), stage, port=driver_port)
        bound(driver, want=[driver_port])
        cl = ChaosCluster(W, stage, driver_port,
                          port_of(W, "sweep_execs", 100 * stage))
        stats, schedule = defaultdict(int), []
        part = W.Hash(worker.NUM_PARTS)
        try:
            for trial in range(SWEEP_TRIALS):
                sid_a, n_maps = 3000 + trial * 10, 3
                sid_b = sid_a + 1
                ha = driver.register_shuffle(sid_a, n_maps, part)
                hb = driver.register_shuffle(sid_b, n_maps, part)
                mbh = {cl.smid(s): [s] for s in range(3)}
                for s in range(3):
                    cl.order_write(s, sid_a, n_maps, [s])
                    cl.order_write(s, sid_b, n_maps, [s])
                kill = trial == 0 or rng.random() < 0.7
                victim = rng.randrange(3) if kill else None
                delay = rng.uniform(0.0, 1.5) if kill else None
                schedule.append((kill, victim))
                killer = None
                if kill:
                    killer = threading.Thread(target=lambda: (
                        time.sleep(delay), cl.kill(victim)), daemon=True)
                    killer.start()
                res = ({}, {})
                readers = [threading.Thread(target=read_shuffle, args=(
                    W, driver, h, mbh, r), daemon=True)
                    for h, r in zip((ha, hb), res)]
                for t in readers:
                    t.start()
                for t in readers:
                    t.join(timeout=90)
                    assert not t.is_alive(), f"trial {trial}: reader hung"
                if killer is not None:
                    killer.join(timeout=30)
                for sid, r in zip((sid_a, sid_b), res):
                    if "data" in r:
                        assert r["data"] == chaos_oracle(sid, range(3)), \
                            f"trial {trial} sid {sid}: wrong data"
                        stats["exact"] += 1
                    else:
                        assert kill, f"trial {trial}: spurious failure"
                        assert r["elapsed"] < 60, r["elapsed"]
                        stats["failed"] += 1
                if kill:
                    survivors = [s for s in range(3) if s != victim]
                    retry_sid = sid_a + 5
                    hr = driver.register_shuffle(retry_sid, n_maps, part)
                    assign = {s: [m for m in range(n_maps)
                                  if m % len(survivors) == i]
                              for i, s in enumerate(survivors)}
                    for s, maps in assign.items():
                        cl.order_write(s, retry_sid, n_maps, maps)
                    rr = {}
                    read_shuffle(W, driver, hr, {
                        cl.smid(s): m for s, m in assign.items()}, rr)
                    assert rr.get("data") == chaos_oracle(
                        retry_sid, range(n_maps)), rr.get("error")
                    stats["retries"] += 1
                    cl.spawn(victim)
            assert stats["retries"] >= 3 and stats["exact"] >= 3, stats
            return schedule, stats["retries"]
        finally:
            cl.stop()
            driver.stop()

    with cluster_lock(PORTS["sweep"]):
        jax_once_port_twice(wires, case)


@pytest.mark.cluster
def test_tcp_chaos_dead_peer_mid_striped_read_async_matches_jax(wires):
    """The serving executor process SIGKILLed while a striped multi-MB
    read is in flight on the async engine: exact, or a stage-retriable
    failure within 40 s; the same driver node then reads a respawned
    executor's rewrite exactly."""
    extra = {
        "spark.shuffle.tpu.transportAsyncDispatcher": "on",
        "spark.shuffle.tpu.transportNumStripes": 2,
        "spark.shuffle.tpu.transportStripeThreshold": "64k",
        "spark.shuffle.tpu.shuffleReadBlockSize": "32m",
        "spark.shuffle.tpu.maxAggBlock": "32m",
        "spark.shuffle.tpu.maxBytesInFlight": "64m",
    }

    def case(W, stage):
        driver_port = port_of(W, "dead_peer", 50 * stage)
        driver = W.Manager(W.Conf(worker.chaos_conf(driver_port, extra)),
                           True, W.TcpNetwork(), stage, port=driver_port)
        bound(driver, want=[driver_port])
        cl = ChaosCluster(W, stage, driver_port, driver_port + 10, n=1,
                          extra=extra)
        part = W.Hash(worker.NUM_PARTS)
        try:
            sid = 9100
            handle = driver.register_shuffle(sid, 1, part)
            cl.order_write(0, sid, 1, [0])
            cl.await_ack("wrote", cl.procs[0][1])
            res = {}
            t = threading.Thread(target=read_shuffle, args=(
                W, driver, handle, {cl.smid(0): [0]}, res), daemon=True)
            t.start()
            time.sleep(0.02)
            cl.kill(0)
            t.join(timeout=60)
            assert not t.is_alive(), "read against SIGKILLed peer hung"
            if "data" in res:
                assert res["data"] == chaos_oracle(sid, [0])
            else:
                assert res["elapsed"] < 40, res["elapsed"]
            cl.spawn(0)
            handle2 = driver.register_shuffle(sid + 1, 1, part)
            cl.order_write(0, sid + 1, 1, [0])
            res2 = {}
            read_shuffle(W, driver, handle2, {cl.smid(0): [0]}, res2)
            return ("data" in res or isinstance(res["error"],
                                                W.fetch_errors),
                    res2.get("data") == chaos_oracle(sid + 1, [0]))
        finally:
            cl.stop()
            driver.stop()

    with cluster_lock(PORTS["dead_peer"]):
        assert jax_once_port_twice(wires, case) == (True, True)
