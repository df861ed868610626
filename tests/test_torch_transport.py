"""The port's network transport plane held against the JAX package: the
twins of tests/test_{transport,tcp,async_dispatcher,channel_cache,
striped_transport}.py, a live socket between the two packages' nodes,
a TCP-fetched block staged through the port's resolver, and ``api.py``
over ``TcpNetwork``.

Each case runs through both packages (``Wire``: one package's transport
modules, as the JAX tests import them) and returns what the run fixes:
the bytes read, the records, counters the data decides, or the class of
outcome (exact, or the clean exception's type) where timing decides.
The port's result must equal the JAX package's.  Where a case builds
shuffle managers it runs with map outputs staged (CPU tensors in the
port, JAX CPU arrays in the reference) and on the host.

Every listener here binds in 61000-63299 (``BAND``; ``PORTS`` gives each
case's first port), above the kernel's ephemeral range, where no JAX test
binds.  Each case has its own ports: the JAX package's at ``PORTS``, the
port's ``HALF`` above (a threaded listener of the JAX package keeps its
port after ``unregister``: see ``test_threaded_listener_frees_its_port``).
Every case asserts the ports its listeners bound, and a case that builds
a cluster (managers, or executor processes) holds a lock file named by
its first port while it runs.
"""

import contextlib
import fcntl
import gc
import importlib
import multiprocessing
import os
import socket
import struct
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np
import pytest

from tests import torch_transport_worker as worker
from tests.test_torch_conf_matrix import (  # noqa: F401 - fixture
    STAGES,
    Pkg,
    canon,
    oracle,
    pkgs,
    run_op,
)

BAND = (61000, 63300)
HALF = 1150  # the port's listeners: the JAX package's ports + HALF
PORTS = {  # each case's first port (JAX half), and the listeners from there
    "tcp_e2e": 61000,       # 4 x 30: driver, +10, +20
    "e2e_engines": 61120,   # 4 x 40: driver, +11, then +20, +31
    "multiprocess": 61280,  # 2 x 40: driver, executor processes +20, +30
    "sigkill": 61360,       # 2 x 40: the same
    "pooled": 61440,        # 2 x 30: driver, +10, +20
    "resolver": 61500,      # 2 x 30: the same
    "api": 61560,           # 4 x 20: driver, executors +100, +110
    "concurrent": 61740,    # 2 x 10: nodes at +0, +7 (and so on below)
    "engines": 61760,       # async, threaded
    "interop": 61780,       # 2 x 10
    "serve_credit": 61800, "backpressure": 61810,
    "dead_peer": 61820,     # and the fresh responder at +9
    "census": 61830, "prune": 61840, "backoff": 61850,  # dials +1
    "sweep": 61860,         # 8 x 10: threaded, then async
    "single": 61940,        # 2 x 10
    "scatter": 61960, "progress": 61970, "credits": 61980,
    "lane_kill": 61990, "evil": 62000, "malformed": 62010,
    "dead_group": 62020, "tokens": 62030,
    "cross": 62040,         # 4 x 10, one run of both packages
    "evictions": 62080,     # 2 x 10: a fleet of 3 peers each
    "tiny_cap": 62100,      # 6 peers
    "lane_pool": 62110, "lanes_evicted": 62120,  # 1 and 4 peers
}
_PATTERN = (np.arange(6 << 20, dtype=np.uint32) % 251).astype(np.uint8)


class Wire:
    """One package's transport, metrics and shuffle modules, by the names
    the JAX tests import them under."""

    def __init__(self, P: Pkg):
        def imp(path):
            return importlib.import_module(f"{P.name}.{path}")

        self.P, self.name = P, P.name
        self.is_port = P.name == worker.PORT
        self.off = HALF if self.is_port else 0
        tr = imp("transport")
        self.LoopbackNetwork, self.TcpNetwork = tr.LoopbackNetwork, tr.TcpNetwork
        self.TransportError = tr.TransportError
        self.channel = imp("transport.channel")
        self.ChannelType = self.channel.ChannelType
        self.Listener = self.channel.FnCompletionListener
        self.BytesBlockStore = self.channel.BytesBlockStore
        self.node = imp("transport.node")
        self.Node = self.node.Node
        self.census = self.node.transport_census
        self.tcp = imp("transport.tcp")
        self.simfleet = imp("transport.simfleet")
        self.ArenaManager = imp("memory.arena").ArenaManager
        self.BlockLocation = imp("utils.types").BlockLocation
        self.types = imp("utils.types")
        self.metrics = imp("metrics")
        self.registry = self.metrics.GLOBAL_REGISTRY
        self.ledger = imp("utils.ledger")
        self.reader = imp("shuffle.reader")
        self.fetch_errors = (self.reader.FetchFailedError,
                             self.reader.MetadataFetchFailedError)
        self.Hash = imp("shuffle.partitioner").HashPartitioner
        self.imp = imp

    def Conf(self, d=None):
        return self.P.Conf(d)

    def Manager(self, conf, is_driver, net, stage=False, **kw):
        return self.P.Manager(conf, is_driver, net, stage_to_device=stage,
                              **kw)


@pytest.fixture(scope="module")
def wires(pkgs):
    return tuple(Wire(P) for P in pkgs)


def both(wires, case, *args):
    """Run ``case`` through both packages; the port's output must equal
    the JAX package's."""
    want, got = (case(W, *args) for W in wires)
    assert got == want
    return got


def bound(*owners, want):
    """The ports the listeners of ``owners`` (nodes, managers, fleets)
    bound: each the one asked for, inside the band."""
    got = []
    for o in owners:
        o = getattr(o, "node", o)
        addrs = o.addresses if hasattr(o, "addresses") else [o.address]
        got.extend(p for _h, p in addrs)
    assert got == list(want), got
    assert all(BAND[0] <= p < BAND[1] for p in got), got
    return got


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


def pool_in_use(pool, timeout=5.0):
    """The staging pool's bytes in use once collection has run: a row
    a reader thread let go of a moment ago returns on a later
    collection."""
    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        n = pool.stats()["in_use"]
        if n == 0 or time.monotonic() > deadline:
            return n
        time.sleep(0.02)


def registry_on(W):
    """Switch one package's registry on; returns the restore callable."""
    prev = W.registry.enabled
    W.registry.enabled = True
    return lambda: setattr(W.registry, "enabled", prev)


def counter(W, name, **labels):
    return W.registry.counter(name, **labels).value


def wait_for(event, timeout=5.0):
    assert event.wait(timeout), "timed out"


def as_np(blk):
    if isinstance(blk, np.ndarray):
        return blk
    return np.frombuffer(memoryview(blk), np.uint8)


def group_read(W, group, locs, timeout=30, on_progress=None):
    done = threading.Event()
    res = {}
    group.read_blocks(locs, W.Listener(
        lambda blocks: (res.setdefault("blocks", blocks), done.set()),
        lambda e: (res.setdefault("error", e), done.set())),
        on_progress=on_progress)
    assert done.wait(timeout), "group read hung"
    if "error" in res:
        raise res["error"]
    return res["blocks"]


def pair(W, netcls, port, conf_a, conf_b=None):
    """Two nodes (per-node confs), at ``port`` and ``port + 7`` of the
    package's half of the band, with the pattern served by ``b``."""
    port += W.off
    net = netcls()
    a = W.Node(("127.0.0.1", port), conf_a)
    b = W.Node(("127.0.0.1", port + 7), conf_b or conf_a)
    net.register(a)
    net.register(b)
    if netcls is W.TcpNetwork:
        bound(a, b, want=[port, port + 7])
    arena = W.ArenaManager()
    seg = arena.register(_PATTERN, zero_copy_ok=True)
    b.register_block_store(seg.mkey, arena)
    return net, a, b, seg.mkey


def teardown(net, *nodes):
    """Stop the nodes last one first: a pair's serving node closes its
    sockets before the reader's, so a socket's TIME_WAIT lands on the
    band's port, not on an ephemeral one a fixed-port JAX test may
    want.  Then release every arena segment the nodes served: with the
    process-global resource ledger on (a ``resourceDebug`` manager
    leaves it so), a segment left registered reads as a leak in a later
    test's ledger check."""
    # taken first: a node's stop() forgets its stores
    stores = [kv for n in nodes for kv in list(n._block_stores.items())]
    for n in reversed(nodes):
        n.stop()
    for n in nodes:
        net.unregister(n)
    for mkey, store in stores:
        if hasattr(store, "release"):
            store.release(mkey)


def payloads(blocks):
    return [bytes(memoryview(as_np(b))) for b in blocks]


def pattern_of(locs):
    return [_PATTERN[a:a + n].tobytes() for a, n in locs]


# -- channels, credits, failure semantics (tests/test_transport.py) ------------


@contextlib.contextmanager
def loop_nodes(W):
    network = W.LoopbackNetwork()
    nodes = []

    def make_node(port, **kw):
        node = W.Node(("127.0.0.1", port), **kw)
        network.register(node)
        nodes.append(node)
        return node

    try:
        yield network, make_node
    finally:
        for n in nodes:
            n.stop()


def _rpc_roundtrip(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    got, done, sent = [], threading.Event(), threading.Event()
    b.set_receive_listener(lambda ch, frame: (got.append(frame), done.set()))
    ch = a.get_channel(b.address, W.ChannelType.RPC_REQUESTOR, network.connect)
    ch.send_rpc([b"hello-frame"], W.Listener(lambda r: sent.set()))
    wait_for(sent)
    wait_for(done)
    return got


def _rpc_reply_channel(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    done, replies = threading.Event(), []
    b.set_receive_listener(lambda ch, frame: ch.reply_channel().send_rpc(
        [b"re:" + frame], W.Listener()))
    a.set_receive_listener(
        lambda ch, frame: (replies.append(frame), done.set()))
    ch = a.get_channel(b.address, W.ChannelType.RPC_REQUESTOR, network.connect)
    ch.send_rpc([b"ping"], W.Listener())
    wait_for(done)
    return replies


def _one_sided_read(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    payload = bytes(range(256)) * 16
    b.register_block_store(7, W.BytesBlockStore(payload))
    ch = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                       network.connect)
    result, done = [], threading.Event()
    L = W.BlockLocation
    ch.read_blocks([L(0, 16, 7), L(256, 32, 7), L(4000, 8, 7)],
                   W.Listener(lambda r: (result.append(r), done.set())))
    wait_for(done)
    assert result[0] == [payload[0:16], payload[256:288], payload[4000:4008]]
    return [bytes(b) for b in result[0]]


def _read_unknown_mkey_fails(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    ch = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                       network.connect)
    errs, done = [], threading.Event()
    ch.read_blocks([W.BlockLocation(0, 4, 99)], W.Listener(
        on_failure=lambda e: (errs.append(e), done.set())))
    wait_for(done)
    assert isinstance(errs[0], W.TransportError)
    return type(errs[0]).__name__


def _connect_refused_and_retries(W, network, make_node):
    a = make_node(9000, conf=W.Conf(
        {"spark.shuffle.tpu.maxConnectionAttempts": 2}))
    with pytest.raises(W.TransportError, match="could not connect") as e:
        a.get_channel(("127.0.0.1", 9999), W.ChannelType.RPC_REQUESTOR,
                      network.connect)
    return type(e.value).__name__


def _channel_cache_reuse(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    T = W.ChannelType
    c1 = a.get_channel(b.address, T.RPC_REQUESTOR, network.connect)
    c2 = a.get_channel(b.address, T.RPC_REQUESTOR, network.connect)
    c3 = a.get_channel(b.address, T.READ_REQUESTOR, network.connect)
    return c1 is c2, c3 is not c1


def _partition_fails_inflight_and_reconnect_after_heal(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    b.register_block_store(1, W.BytesBlockStore(b"x" * 64))
    T = W.ChannelType
    ch = a.get_channel(b.address, T.READ_REQUESTOR, network.connect)
    network.partition(b.address)
    errs, done = [], threading.Event()
    ch.read_blocks([W.BlockLocation(0, 4, 1)], W.Listener(
        on_failure=lambda e: (errs.append(e), done.set())))
    wait_for(done)
    assert isinstance(errs[0], W.TransportError)
    network.heal(b.address)
    ch2 = a.get_channel(b.address, T.READ_REQUESTOR, network.connect)
    ok, done2 = [], threading.Event()
    ch2.read_blocks([W.BlockLocation(0, 4, 1)],
                    W.Listener(lambda r: (ok.append(r), done2.set())))
    wait_for(done2)
    return type(errs[0]).__name__, ch2 is not ch, [bytes(x) for x in ok[0]]


def _stop_fails_outstanding_listeners(W, network, make_node):
    a, b = make_node(9000), make_node(9001)
    ch = a.get_channel(b.address, W.ChannelType.RPC_REQUESTOR,
                       network.connect)
    ch.stop()
    with pytest.raises(W.TransportError) as e:
        ch.send_rpc([b"x"], W.Listener(on_failure=lambda e: None))
    return type(e.value).__name__


def _flood(W, network, make_node, conf_a, conf_b, prefix, n_msgs=1000):
    a = make_node(9000, conf=conf_a)
    b = make_node(9001, conf=conf_b) if conf_b else make_node(9001)
    seen, all_seen, completed, all_done = [], threading.Event(), [], \
        threading.Event()

    def listener(ch, frame):
        seen.append(frame)
        if len(seen) == n_msgs:
            all_seen.set()

    def ok(_):
        completed.append(1)
        if len(completed) == n_msgs:
            all_done.set()

    b.set_receive_listener(listener)
    ch = a.get_channel(b.address, W.ChannelType.RPC_REQUESTOR,
                       network.connect)
    for i in range(n_msgs):
        ch.send_rpc([prefix + b"%d" % i], W.Listener(ok))
    wait_for(all_done, 10)
    wait_for(all_seen, 15)
    return sorted(seen)


def _send_budget_queues_instead_of_dropping(W, network, make_node):
    """More posts than the queue depth all complete (the pending drain)."""
    return _flood(W, network, make_node, W.Conf(
        {"spark.shuffle.tpu.sendQueueDepth": 256}), None, b"m")


def _credit_flow_control_blocks_then_drains(W, network, make_node):
    """swFlowControl: 4x the credit budget stalls, then drains, each frame
    once (in no defined order)."""
    conf = W.Conf({"spark.shuffle.tpu.recvQueueDepth": 256,
                   "spark.shuffle.tpu.swFlowControl": True})
    return _flood(W, network, make_node, conf, conf, b"c")


def _node_stop_parallel_teardown(W, network, make_node):
    a = make_node(9000)
    peers = [make_node(9001 + i) for i in range(5)]
    chans = [a.get_channel(p.address, W.ChannelType.RPC_REQUESTOR,
                           network.connect) for p in peers]
    a.stop()
    return [c.is_connected() for c in chans]


def _trace_spans_collected(W, network, make_node):
    import json

    t = W.imp("utils.trace").Tracer(enabled=True)
    with t.span("outer", tag="x"):
        t.instant("marker")
    t.counter("bytes", value=42)
    names = [e["name"] for e in t.events]
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    t.dump(path)
    with open(path) as f:
        doc = json.load(f)
    t2 = W.imp("utils.trace").Tracer(enabled=False)
    with t2.span("nope"):
        pass
    return names, len(doc["traceEvents"]), t2.events


def _node_teardown_bounded_by_hung_channel(W, network, make_node):
    """A channel whose stop() hangs does not wedge node teardown."""
    node = W.Node(("127.0.0.1", 45990), W.Conf(
        {"spark.shuffle.tpu.teardownListenTimeout": "100ms"}))

    class HungChannel:
        def __init__(self):
            self.ev = threading.Event()

        def stop(self):
            self.ev.wait(30)

    hung = HungChannel()
    with node._passive_lock:
        node._passive.append(hung)
    t0 = time.monotonic()
    node.stop()
    took = time.monotonic() - t0
    hung.ev.set()
    assert took < 5, f"teardown blocked {took:.1f}s on a hung channel"
    return True


CHANNEL_CASES = {f.__name__[1:]: f for f in (
    _rpc_roundtrip, _rpc_reply_channel, _one_sided_read,
    _read_unknown_mkey_fails, _connect_refused_and_retries,
    _channel_cache_reuse, _partition_fails_inflight_and_reconnect_after_heal,
    _stop_fails_outstanding_listeners, _send_budget_queues_instead_of_dropping,
    _node_stop_parallel_teardown, _credit_flow_control_blocks_then_drains,
    _trace_spans_collected, _node_teardown_bounded_by_hung_channel)}


@pytest.mark.parametrize("case", list(CHANNEL_CASES))
def test_channel_semantics_match_jax(wires, case):
    """Each case of tests/test_transport.py over ``LoopbackNetwork`` (no
    socket is bound): frames, blocks, the error classes, cache identity,
    teardown."""
    def run(W):
        with loop_nodes(W) as (network, make_node):
            return CHANNEL_CASES[case](W, network, make_node)

    both(wires, run)


# -- TCP, threaded engine and processes (tests/test_tcp.py) --------------------


def tcp_conf(W, driver_port, extra=None):
    return W.Conf({**worker.tcp_conf(driver_port), **(extra or {})})


@contextlib.contextmanager
def tcp_managers(W, driver_port, stage, n=2, extra=None):
    """Driver + ``n`` executors, each with its own ``TcpNetwork``, at
    ``driver_port`` and ``driver_port + spacing * (i + 1)``."""
    driver_port += W.off
    ports = [driver_port + 10 * i for i in range(n + 1)]
    driver = W.Manager(tcp_conf(W, driver_port, extra), True, W.TcpNetwork(),
                       stage, port=driver_port)
    executors = []
    try:
        for i in range(n):
            executors.append(W.Manager(
                tcp_conf(W, driver_port, extra), False, W.TcpNetwork(),
                stage, port=ports[i + 1], executor_id=str(i)))
        bound(driver, *executors, want=ports)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(len(e._peers) == n for e in executors):
                break
            time.sleep(0.01)
        yield driver, executors
    finally:
        for m in executors + [driver]:
            m.stop()


THREADED = {"spark.shuffle.tpu.transportAsyncDispatcher": "off"}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ["threaded", "async"])
def test_tcp_shuffle_e2e_matches_jax(wires, stage, engine):
    """tests/test_tcp.py::test_tcp_shuffle_e2e on each engine: the same
    groups, with blocks read across real sockets."""
    base = PORTS["tcp_e2e"] + 30 * (2 * (engine == "async") + stage)

    def case(W):
        with tcp_managers(W, base, stage, extra=THREADED
                          if engine == "threaded" else None) as (drv, exs):
            handle = drv.register_shuffle(0, 4, W.Hash(4))
            mbh = defaultdict(list)
            recs = [[(f"k{j}", (m, j)) for j in range(40)] for m in range(4)]
            for m, r in enumerate(recs):
                ex = exs[m % 2]
                w = ex.get_writer(handle, m)
                w.write(r)
                w.stop(True)
                mbh[ex.local_smid].append(m)
            got, remote = defaultdict(list), 0
            for i, ex in enumerate(exs):
                rd = ex.get_reader(handle, i * 2, i * 2 + 2, dict(mbh))
                for k, v in rd.read():
                    got[k].append(tuple(v))
                remote += rd.metrics.remote_blocks
        assert remote > 0
        return {k: sorted(v) for k, v in got.items()}

    with cluster_lock(base):
        got = both(wires, case)
    assert len(got) == 40


def _wait_published(driver, shuffle_id, n, failed, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not failed.is_set():
        mbh = driver.maps_by_host(shuffle_id)
        if sum(len(v) for v in mbh.values()) == n:
            break
        time.sleep(0.05)
    return driver.maps_by_host(shuffle_id)


@contextlib.contextmanager
def executor_procs(W, stage, driver_port, ports, events):
    """tests/test_tcp.py's executor processes (spawn), one per port."""
    ctx = multiprocessing.get_context("spawn")
    dones = [ctx.Event() for _ in ports]
    failed = ctx.Event()
    procs = [ctx.Process(target=worker.executor_main,
                         args=(W.name, stage, i, driver_port, p, dones[i],
                               failed), daemon=True)
             for i, p in enumerate(ports)]
    for p in procs:
        p.start()
    events.update(dones=dones, failed=failed)
    try:
        yield procs
    finally:
        for i, d in enumerate(dones):
            if i not in events.get("killed", ()):
                d.set()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


@pytest.mark.cluster
@pytest.mark.parametrize("stage", STAGES)
def test_tcp_multiprocess_shuffle_matches_jax(wires, stage):
    """Two executor processes write and publish over sockets; the driver
    process resolves and pulls every block: the same records."""
    def case(W):
        base = PORTS["multiprocess"] + 40 * stage + W.off
        driver = W.Manager(tcp_conf(W, base), True, W.TcpNetwork(), stage,
                           port=base)
        ev = {}
        try:
            bound(driver, want=[base])
            handle = driver.register_shuffle(7, 2, W.Hash(4))
            with executor_procs(W, stage, base, [base + 20, base + 30], ev):
                mbh = _wait_published(driver, 7, 2, ev["failed"])
                assert not ev["failed"].is_set(), "executor process crashed"
                assert sorted(s.port for s in mbh) == [base + 20, base + 30]
                rd = driver.get_reader(handle, 0, 4, mbh)
                got = dict(rd.read())
                assert rd.metrics.remote_blocks > 0
        finally:
            driver.stop()
        assert got == {f"w{i}-{j}": j for i in range(2) for j in range(30)}
        return got

    with cluster_lock(PORTS["multiprocess"] + 40 * stage):
        both(wires, case)


@pytest.mark.parametrize("stage", STAGES)
def test_tcp_read_responses_ride_pooled_buffers_matches_jax(wires, stage):
    """Remote TCP fetches land in pooled staging rows and reach the reader
    as read-only zero-copy views; the pool reclaims them once consumed."""
    base = PORTS["pooled"] + 30 * stage

    def case(W):
        with tcp_managers(W, base, stage) as (driver, exs):
            handle = driver.register_shuffle(9, 1, W.Hash(2))
            w = exs[1].get_writer(handle, 0)
            w.write([(f"k{i}", b"x" * 200) for i in range(500)])
            w.stop(True)
            captured = []
            Channel = W.channel.Channel
            orig = Channel._complete

            def spy(self, listener, result):
                if isinstance(result, list):
                    captured.extend(result)
                return orig(self, listener, result)

            Channel._complete = spy
            try:
                out = list(exs[0].get_reader(
                    handle, 0, 2, {exs[1].local_smid: [0]}).read())
            finally:
                Channel._complete = orig
            blocks = [b for b in captured if isinstance(b, np.ndarray)]
            res = (len(out), bool(blocks),
                   all(not b.flags.writeable for b in blocks))
            del blocks, captured, out
            return res + (pool_in_use(exs[0].staging_pool),)

    with cluster_lock(base):
        assert both(wires, case) == (500, True, True, 0)


@pytest.mark.parametrize("engine", ["threaded", "async"])
def test_tcp_concurrent_reads_one_channel_matches_jax(wires, engine):
    """An 8 MiB read and seven 4 KiB reads outstanding on one channel all
    complete exactly (reads are served off the reader thread)."""
    conf = THREADED if engine == "threaded" else {}

    def case(W):
        base = PORTS["concurrent"] + 10 * (engine == "async") + W.off
        net = W.TcpNetwork()
        a = W.Node(("127.0.0.1", base), W.Conf(conf))
        b = W.Node(("127.0.0.1", base + 7), W.Conf(conf))
        net.register(a)
        net.register(b)
        try:
            bound(a, b, want=[base, base + 7])
            arena = W.ArenaManager()
            big = np.arange(8 << 20, dtype=np.uint8) % 251
            small = np.arange(4096, dtype=np.uint8)
            seg_big = arena.register(big, zero_copy_ok=True)
            seg_small = arena.register(small, zero_copy_ok=True)
            b.register_block_store(seg_big.mkey, arena)
            b.register_block_store(seg_small.mkey, arena)
            ch = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                               net.connect)
            results, events = {}, [threading.Event() for _ in range(8)]

            def issue(i, loc):
                def ok(blocks, i=i):
                    results[i] = bytes(blocks[0])
                    events[i].set()

                def err(e, i=i):
                    results[i] = type(e).__name__
                    events[i].set()

                ch.read_blocks([loc], W.Listener(ok, err))

            issue(0, W.BlockLocation(0, len(big), seg_big.mkey))
            for i in range(1, 8):
                issue(i, W.BlockLocation(0, len(small), seg_small.mkey))
            for ev in events:
                assert ev.wait(timeout=30), "read did not complete"
            assert results[0] == bytes(big)
            assert all(results[i] == bytes(small) for i in range(1, 8))
            return [len(results[i]) for i in range(8)]
        finally:
            teardown(net, a, b)

    both(wires, case)


@pytest.mark.cluster
def test_tcp_executor_sigkill_mid_shuffle_matches_jax(wires):
    """A SIGKILLed executor process fails the read promptly with a
    stage-retriable error, while the survivor's blocks stay readable: the
    same outcome in both packages (the JAX package with map outputs on
    the host, the port on the host and staged)."""
    def case(W, stage):
        base = PORTS["sigkill"] + 40 * stage + W.off
        driver = W.Manager(tcp_conf(W, base), True, W.TcpNetwork(), stage,
                           port=base)
        ev = {}
        try:
            handle = driver.register_shuffle(7, 2, W.Hash(4))
            with executor_procs(W, stage, base, [base + 20, base + 30],
                                ev) as procs:
                mbh = _wait_published(driver, 7, 2, ev["failed"])
                assert not ev["failed"].is_set(), "executor process crashed"
                assert sum(len(v) for v in mbh.values()) == 2
                ev["killed"] = (1,)
                procs[1].kill()
                procs[1].join(timeout=10)
                t0 = time.monotonic()
                with pytest.raises(W.fetch_errors) as err:
                    dict(driver.get_reader(handle, 0, 4, mbh).read())
                took = time.monotonic() - t0
                assert took < 15, f"dead-socket fetch took {took:.1f}s"
                mbh0 = {s: m for s, m in mbh.items()
                        if s.block_manager_id.executor_id == "0"}
                got = dict(driver.get_reader(handle, 0, 4, mbh0).read())
        finally:
            driver.stop()
        assert got == {f"w0-{j}": j for j in range(30)}
        return issubclass(err.type, W.fetch_errors), got

    jw, pw = wires
    with cluster_lock(PORTS["sigkill"]):
        want = case(jw, False)
        for stage in (False, True):
            assert case(pw, stage) == want


# -- the async engine (tests/test_async_dispatcher.py) -------------------------

_LOCS_SPEC = [
    (3, 100),              # tiny (small-read lane)
    (103, 128 << 10),      # == threshold: not striped
    (5, (128 << 10) + 1),  # barely striped
    (1 << 20, 3 << 20),    # bulk striped
    (0, 1),
]


def async_conf(W, mode, extra=None):
    return W.Conf({
        "spark.shuffle.tpu.transportAsyncDispatcher": mode,
        "spark.shuffle.tpu.transportNumStripes": 2,
        "spark.shuffle.tpu.transportStripeThreshold": "128k",
        **(extra or {}),
    })


def read_locs(W, mkey, spec=_LOCS_SPEC):
    return [W.BlockLocation(a, n, mkey) for a, n in spec]


def rpc_echo(W, a, b, net, payload=b"ping-frame", timeout=10):
    got, pong = {}, threading.Event()
    b.set_receive_listener(
        lambda ch, frame: ch.reply_channel().send_rpc([frame], W.Listener()))
    a.set_receive_listener(
        lambda _ch, frame: (got.setdefault("frame", frame), pong.set()))
    ch = a.get_channel(b.address, W.ChannelType.RPC_REQUESTOR, net.connect)
    ch.send_rpc([payload], W.Listener())
    assert pong.wait(timeout), "rpc echo hung"
    return got["frame"]


def test_async_vs_threaded_vs_loopback_matches_jax(wires):
    """The mixed small/striped batch reads bit-identical on the async
    engine, the threaded one and loopback, in both packages."""
    def case(W):
        out = {}
        for name, netcls, mode, port in [
                ("async", W.TcpNetwork, "on", PORTS["engines"]),
                ("threaded", W.TcpNetwork, "off", PORTS["engines"] + 10),
                ("loopback", W.LoopbackNetwork, "on", 0)]:
            net, a, b, mkey = pair(W, netcls, port, async_conf(W, mode))
            try:
                out[name] = payloads(group_read(
                    W, a.get_read_group(b.address, net.connect),
                    read_locs(W, mkey)))
            finally:
                teardown(net, a, b)
        assert out["async"] == out["threaded"] == out["loopback"] \
            == pattern_of(_LOCS_SPEC)
        return out

    both(wires, case)


@pytest.mark.parametrize("client,server", [("on", "off"), ("off", "on")])
def test_wire_interop_mixed_modes_matches_jax(wires, client, server):
    """Striped reads and an RPC echo across a mixed-engine pair, both
    ways."""
    port = PORTS["interop"] + 10 * (client == "off")

    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, port, async_conf(W, client),
                               async_conf(W, server))
        try:
            got = payloads(group_read(
                W, a.get_read_group(b.address, net.connect),
                read_locs(W, mkey)))
            assert got == pattern_of(_LOCS_SPEC)
            return got, rpc_echo(W, a, b, net)
        finally:
            teardown(net, a, b)

    both(wires, case)


def _concurrent_reads(W, group, mkey, reads, timeout=60):
    """Issue ``reads`` ((address, length) each) at once; the count done
    and any error or corruption."""
    done, lock = threading.Event(), threading.Lock()
    res = {"ok": 0, "err": None}

    def one(addr, n):
        def ok(blocks):
            with lock:
                res["ok"] += 1
                if not np.array_equal(as_np(blocks[0]),
                                      _PATTERN[addr:addr + n]):
                    res["err"] = "corrupt"
                if res["ok"] == len(reads):
                    done.set()

        def bad(e):
            res["err"] = type(e).__name__
            done.set()

        group.read_blocks([W.BlockLocation(addr, n, mkey)],
                          W.Listener(ok, bad))

    for addr, n in reads:
        one(addr, n)
    assert done.wait(timeout), "credit-bounded reads hung"
    return res


def test_async_serve_credit_bounding_matches_jax(wires):
    """Serve credits far below one response: six 3 MiB reads all complete
    exactly, no deadlock."""
    def case(W):
        conf = async_conf(W, "on", {
            "spark.shuffle.tpu.transportServeCreditBytes": "1m",
            "spark.shuffle.tpu.transportServeThreads": 2})
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["serve_credit"], conf)
        try:
            group = a.get_read_group(b.address, net.connect)
            return _concurrent_reads(W, group, mkey, [(0, 3 << 20)] * 6)
        finally:
            teardown(net, a, b)

    assert both(wires, case) == {"ok": 6, "err": None}


def test_async_write_backpressure_tiny_backlog_matches_jax(wires):
    """A 64 KiB send backlog cycles the responder's pause/resume many
    times; 4 MiB reads stay exact."""
    def case(W):
        conf = async_conf(W, "on", {
            "spark.shuffle.tpu.transportSendBacklogBytes": "64k"})
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["backpressure"], conf)
        try:
            group = a.get_read_group(b.address, net.connect)
            return [payloads(group_read(
                W, group, [W.BlockLocation(1 << 20, 4 << 20, mkey)]))
                == pattern_of([(1 << 20, 4 << 20)]) for _ in range(3)]
        finally:
            teardown(net, a, b)

    assert both(wires, case) == [True] * 3


def test_async_dead_peer_fails_fast_matches_jax(wires):
    """Stopping the responder mid-read ends the read (whole or failed
    cleanly); the surviving node's loop serves a fresh peer at once."""
    def case(W):
        conf = async_conf(W, "on")
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["dead_peer"], conf)
        served = b._block_stores[mkey]  # b's stop() forgets it
        try:
            group = a.get_read_group(b.address, net.connect)
            first = payloads(group_read(
                W, group, [W.BlockLocation(0, 2 << 20, mkey)]))
            failed, res = threading.Event(), {}
            group.read_blocks([W.BlockLocation(0, 4 << 20, mkey)], W.Listener(
                lambda blks: (res.setdefault("blocks", blks), failed.set()),
                lambda e: (res.setdefault("error", e), failed.set())))
            b.stop()
            net.unregister(b)
            assert failed.wait(30), "read against dead peer hung"
            if "blocks" in res:
                assert as_np(res["blocks"][0]).shape[0] == 4 << 20
            else:
                assert isinstance(res["error"], Exception)
            c = W.Node(("127.0.0.1", PORTS["dead_peer"] + 9 + W.off), conf)
            net.register(c)
            bound(c, want=[PORTS["dead_peer"] + 9 + W.off])
            arena = W.ArenaManager()
            seg = arena.register(_PATTERN, zero_copy_ok=True)
            c.register_block_store(seg.mkey, arena)
            try:
                fresh = payloads(group_read(
                    W, a.get_read_group(c.address, net.connect),
                    [W.BlockLocation(7, 1 << 20, seg.mkey)]))
            finally:
                teardown(net, c)
            return first == pattern_of([(0, 2 << 20)]), \
                fresh == pattern_of([(7, 1 << 20)])
        finally:
            teardown(net, a)
            served.release(mkey)

    assert both(wires, case) == (True, True)


def _census_settled(W, pred, timeout=10):
    deadline = time.monotonic() + timeout
    while True:
        c = W.census()
        if pred(c) or time.monotonic() > deadline:
            return c
        time.sleep(0.05)


def test_async_node_runs_one_event_loop_thread_matches_jax(wires):
    """Two nodes, one peer, four stripes: one event-loop thread per node
    and no reader or accept thread, back to the floor after teardown.
    Both packages name their threads alike, so each half waits for the
    other's to drain first."""
    def case(W):
        before = _census_settled(
            W, lambda c: c["by_role"].get("tcp", 0) == 0
            and c["by_role"].get("disp", 0) == 0)
        tcp_floor = before["by_role"].get("tcp", 0)
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["census"], async_conf(W, "on", {
            "spark.shuffle.tpu.transportNumStripes": 4}))
        try:
            group_read(W, a.get_read_group(b.address, net.connect),
                       read_locs(W, mkey))
            during = W.census()
        finally:
            teardown(net, a, b)
        disp0 = before["by_role"].get("disp", 0)
        after = _census_settled(
            W, lambda c: c["by_role"].get("disp", 0) == disp0)
        return (during["by_role"].get("disp", 0) - disp0,
                during["by_role"].get("tcp", 0) - tcp_floor,
                after["by_role"].get("disp", 0) - disp0)

    assert both(wires, case) == (2, 0, 0)


def _shuffle_roundtrip(W, port, stage, async_mode, decode_threads):
    conf = W.Conf({
        "spark.shuffle.tpu.driverPort": port,
        "spark.shuffle.tpu.transportAsyncDispatcher": async_mode,
        "spark.shuffle.tpu.transportNumStripes": 2,
        "spark.shuffle.tpu.transportStripeThreshold": "64k",
        "spark.shuffle.tpu.transportServeCreditBytes": "2m",
        "spark.shuffle.tpu.decodeThreads": decode_threads,
        "spark.shuffle.tpu.compress": True,
        "spark.shuffle.tpu.shuffleReadBlockSize": "1m",
        "spark.shuffle.tpu.maxBytesInFlight": "4m",
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "30s",
    })
    port += W.off
    driver = W.Manager(conf, True, W.TcpNetwork(), stage, port=port)
    ex = W.Manager(conf, False, W.TcpNetwork(), stage, port=port + 11,
                   executor_id="x")
    try:
        bound(driver, ex, want=[port, port + 11])
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(ex._peers) < 1:
            time.sleep(0.01)
        handle = driver.register_shuffle(31, 1, W.Hash(2), key_ordering=True)
        w = ex.get_writer(handle, 0)
        w.write([(f"k{j:05d}", bytes([j % 251]) * 4096) for j in range(700)])
        w.stop(True)
        out = []
        for pid in range(2):
            rd = driver.get_reader(handle, pid, pid + 1, {ex.local_smid: [0]})
            out.extend((k, bytes(memoryview(v))) for k, v in rd.read())
        return sorted(out)
    finally:
        ex.stop()
        driver.stop()


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("decode_threads", [0, 2])
def test_e2e_shuffle_async_vs_threaded_matches_jax(wires, stage,
                                                   decode_threads):
    """Striped fetches x bounded serve credits x the decode pipeline over
    real sockets: the async engine returns the threaded one's records."""
    base = PORTS["e2e_engines"] + 40 * (decode_threads + stage)

    def case(W):
        got = _shuffle_roundtrip(W, base, stage, "on", decode_threads)
        assert got == _shuffle_roundtrip(W, base + 20, stage, "off",
                                         decode_threads)
        assert len(got) == 700
        return got

    with cluster_lock(base):
        both(wires, case)


# -- the bounded channel cache and lane pool (tests/test_channel_cache.py) -----


def eviction_twin(wires, case):
    """Run an eviction case through both packages, the JAX package as it
    is.  Its channel cache can stop a channel that a post reached after
    the eviction's in-flight check, and its striped post re-resolves an
    evicted lane only once, so under a small cap a JAX read may fail
    cleanly (ROADMAP §C.4); the port evicts atomically with admission
    and re-resolves a bounded number of times.  ``case`` returns its
    invariants, which must be equal, and the reads that failed, which
    must all have failed cleanly (the package's ``TransportError``): in
    the port there must be none."""
    (want, jfail), (got, tfail) = (case(W) for W in wires)
    assert got == want
    for W, failed in zip(wires, (jfail, tfail)):
        assert all(isinstance(e, W.TransportError) for e in failed), failed
    assert tfail == []
    return got


def exact_or_fail(W, failed, read, locs):
    """One read: its blocks checked against the pattern, or its error
    kept in ``failed``."""
    try:
        blocks = read(locs)
    except Exception as e:  # noqa: BLE001 - classified by the caller
        failed.append(e)
        return
    for loc, blk in zip(locs, blocks):
        check_block(blk, loc)


def cache_conf(W, extra=None):
    return W.Conf({"spark.shuffle.tpu.transportNumStripes": 2,
                   "spark.shuffle.tpu.transportStripeThreshold": "64k",
                   **(extra or {})})


def check_block(blk, loc):
    got = as_np(blk)
    assert got.shape[0] == loc.length
    assert np.array_equal(got, _PATTERN[loc.address:loc.address + loc.length]
                          ), f"corrupt block {loc}"


@contextlib.contextmanager
def fleet_and_node(W, n_peers, fleet_port, node_port, conf):
    fleet_port += W.off
    fleet = W.simfleet.SimPeerFleet(n_peers, fleet_port, _PATTERN[:4 << 20])
    node = W.Node(("127.0.0.1", node_port), conf)
    try:
        bound(fleet, want=range(fleet_port, fleet_port + n_peers))
        yield fleet, node
    finally:
        fleet.close()  # the serving side first, as in teardown()
        node.stop()


@pytest.mark.parametrize("async_disp", ["off", "on"])
def test_striped_reads_across_forced_evictions_match_jax(wires, async_disp):
    """A cache cap far below one peer's lanes evicts on every cycle; every
    striped read is exact or fails cleanly on both engines, the churn
    counters move, and the cache settles at its cap."""
    base = PORTS["evictions"] + 10 * (async_disp == "on")

    def case(W):
        restore = registry_on(W)
        conf = cache_conf(W, {
            "spark.shuffle.tpu.transportMaxCachedChannels": 2,
            "spark.shuffle.tpu.transportAsyncDispatcher": async_disp})
        failed = []
        try:
            with fleet_and_node(W, 3, base, base + 10, conf) as (fleet, node):
                if async_disp == "on":
                    node.get_dispatcher()
                ev0 = counter(W, "transport_channel_evictions_total")
                rc0 = counter(W, "transport_channel_reconnects_total")
                L = W.BlockLocation
                locs = [L(11, 900_000, 1), L(3, 1000, 1)]
                connect = W.TcpNetwork().connect
                for _cycle in range(6):
                    for peer in fleet.addresses:
                        exact_or_fail(W, failed, lambda ls, peer=peer: (
                            group_read(W, node.get_read_group(peer, connect),
                                       ls)), locs)
                # a pass that found the last read's lanes still busy
                # leaves the cache over its cap until the next pass
                # (tolerated overflow, in both packages): settle it
                deadline = time.monotonic() + 5
                while True:
                    node._maybe_evict()
                    with node._active_lock:
                        cached = len(node._active)
                    if cached <= 2 or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
                return (cached,
                        counter(W, "transport_channel_evictions_total") > ev0,
                        counter(W, "transport_channel_reconnects_total") > rc0
                        ), failed
        finally:
            restore()

    assert eviction_twin(wires, case) == (2, True, True)


def test_eviction_refuses_in_flight_channels_matches_jax(wires):
    """A channel with an outstanding op is never evicted: the cache runs
    over its cap (refusal counted) and shrinks once the op settles."""
    def case(W):
        restore = registry_on(W)
        conf = cache_conf(W, {
            "spark.shuffle.tpu.transportMaxCachedChannels": 1,
            "spark.shuffle.tpu.transportServeThreads": 1})
        net = W.LoopbackNetwork()
        a, b, c = (W.Node(("127.0.0.1", 26400 + i), conf) for i in range(3))
        for n in (a, b, c):
            net.register(n)
        arena = W.ArenaManager()
        seg = arena.register(_PATTERN, zero_copy_ok=True)
        b.register_block_store(seg.mkey, arena)
        gate = threading.Event()
        b.submit_serve(gate.wait, (30,), cost=0)
        try:
            T = W.ChannelType
            ch_b = a.get_channel(b.address, T.READ_REQUESTOR, net.connect)
            done, res = threading.Event(), {}
            loc = W.BlockLocation(0, 4096, seg.mkey)
            ch_b.read_blocks([loc], W.Listener(
                lambda blocks: (res.setdefault("ok", blocks), done.set()),
                lambda e: (res.setdefault("error", e), done.set())))
            in_flight = ch_b.in_flight() > 0
            r0 = counter(W, "transport_channel_evict_refusals_total")
            ch_c = a.get_channel(c.address, T.RPC_REQUESTOR, net.connect)
            refused = counter(W, "transport_channel_evict_refusals_total") > r0
            both_up = ch_b.is_connected() and ch_c.is_connected()
            with a._active_lock:
                over = len(a._active)
            gate.set()
            assert done.wait(10), "gated read never completed"
            check_block(res["ok"][0], loc)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                a._maybe_evict()
                with a._active_lock:
                    if len(a._active) <= 1:
                        break
                time.sleep(0.02)
            with a._active_lock:
                shrunk = len(a._active) <= 1
            return in_flight, refused, both_up, over, shrunk
        finally:
            gate.set()
            teardown(net, a, b, c)
            restore()

    assert both(wires, case) == (True, True, True, 2, True)


def test_chaos_tiny_cap_concurrent_multi_peer_fetch_matches_jax(wires):
    """A cap of 3 under six threads of seeded striped fetches from six
    peers: every read exact or a clean failure, evictions counted, the
    cache back at its cap once the threads are done."""
    def case(W):
        restore = registry_on(W)
        conf = cache_conf(W, {
            "spark.shuffle.tpu.transportMaxCachedChannels": 3,
            "spark.shuffle.tpu.transportLanePoolSize": 4})
        failed, ev0 = [], counter(W, "transport_channel_evictions_total")
        try:
            with fleet_and_node(W, 6, PORTS["tiny_cap"], PORTS["tiny_cap"] + 10,
                                conf) as (fleet, node):
                connect = W.TcpNetwork().connect

                def work(seed):
                    rng = np.random.default_rng(seed)
                    for _i in range(8):
                        peer = fleet.addresses[int(rng.integers(6))]
                        size = int(rng.integers(200, 600_000))
                        addr = int(rng.integers(0, (4 << 20) - size))
                        exact_or_fail(W, failed, lambda ls, peer=peer: (
                            group_read(W, node.get_read_group(peer, connect),
                                       ls, timeout=60)),
                            [W.BlockLocation(addr, size, 1)])

                threads = [threading.Thread(target=work, args=(s,),
                                            daemon=True) for s in range(6)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                    assert not t.is_alive(), "chaos worker hung"
                deadline = time.monotonic() + 5
                while True:
                    node._maybe_evict()
                    with node._active_lock:
                        cached = len(node._active)
                    if cached <= 3 or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
            return (cached, counter(
                W, "transport_channel_evictions_total") > ev0), failed
        finally:
            restore()

    assert eviction_twin(wires, case) == (3, True)


def test_lane_pool_bounds_borrowed_width_matches_jax(wires):
    """A one-token lane pool narrows striping to one lane; an empty pool
    demotes the read to the small lane: both exact, tokens returned."""
    def case(W):
        restore = registry_on(W)
        conf = cache_conf(W, {"spark.shuffle.tpu.transportLanePoolSize": 1})
        try:
            with fleet_and_node(W, 1, PORTS["lane_pool"], PORTS["lane_pool"] + 10,
                                conf) as (fleet, node):
                loc = W.BlockLocation(7, 1 << 20, 1)
                group = node.get_read_group(fleet.addresses[0],
                                            W.TcpNetwork().connect)
                check_block(group_read(W, group, [loc])[0], loc)
                returned = node.lane_pool._free
                took = node.lane_pool.try_borrow(1)
                ex0 = counter(W, "transport_lane_pool_exhausted_total")
                check_block(group_read(W, group, [loc])[0], loc)
                exhausted = counter(
                    W, "transport_lane_pool_exhausted_total") > ex0
                node.lane_pool.release(1)
                return returned, took, exhausted
        finally:
            restore()

    assert both(wires, case) == (1, 1, True)


def test_read_group_invalidated_when_peer_unreachable_matches_jax(wires):
    """A dead peer's read group is dropped once a resolve exhausts its
    connect attempts."""
    def case(W):
        restore = registry_on(W)
        net = W.LoopbackNetwork()
        conf = cache_conf(W, {"spark.shuffle.tpu.maxConnectionAttempts": 2})
        a = W.Node(("127.0.0.1", 26700), conf)
        b = W.Node(("127.0.0.1", 26701), conf)
        net.register(a)
        net.register(b)
        try:
            group = a.get_read_group(b.address, net.connect)
            had = b.address in a._read_groups
            b.stop()
            net.unregister(b)
            with pytest.raises(Exception) as first:
                group_read(W, group, [W.BlockLocation(0, 4096, 1)])
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with contextlib.suppress(Exception):
                    group_read(W, group, [W.BlockLocation(0, 4096, 1)])
                if b.address not in a._read_groups:
                    break
            return had, type(first.value).__name__, \
                b.address not in a._read_groups
        finally:
            a.stop()
            net.unregister(a)
            restore()

    assert both(wires, case)[::2] == (True, True)


def test_read_group_invalidated_when_lanes_evicted_matches_jax(wires):
    """Evicting a peer's last cached channel drops its read group; the
    next fetch rebuilds it.  Every read exact or a clean failure."""
    def case(W):
        restore = registry_on(W)
        conf = cache_conf(W, {
            "spark.shuffle.tpu.transportMaxCachedChannels": 2})
        failed = []
        try:
            with fleet_and_node(W, 4, PORTS["lanes_evicted"],
                                PORTS["lanes_evicted"] + 10, conf) as (fleet, node):
                connect = W.TcpNetwork().connect
                first = fleet.addresses[0]
                loc = W.BlockLocation(0, 300_000, 1)

                def read(peer):
                    exact_or_fail(W, failed, lambda ls: group_read(
                        W, node.get_read_group(peer, connect), ls), [loc])

                read(first)
                had = first in node._read_groups
                for peer in fleet.addresses[1:]:
                    read(peer)
                with node._active_lock:
                    lanes_left = any(k[0] == first for k in node._active)
                dropped = first not in node._read_groups
                read(first)
                rebuilt = first in node._read_groups
                return (had, lanes_left, dropped, rebuilt), failed
        finally:
            restore()

    assert eviction_twin(wires, case) == (True, False, True, True)


def _fds():
    return len(os.listdir("/proc/self/fd"))


def test_responder_prunes_passive_channel_and_fd_matches_jax(wires):
    """Threaded engine: a requester closing its end leaves the responder
    neither the accepted socket's fd nor its passive entry."""
    def case(W):
        conf = cache_conf(W, THREADED)
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["prune"], conf)
        try:
            fds0 = _fds()
            ch = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                               net.connect)
            done = threading.Event()
            ch.read_blocks([W.BlockLocation(0, 4096, mkey)], W.Listener(
                lambda blocks: done.set(), lambda e: done.set()))
            assert done.wait(10)
            with b._passive_lock:
                one = len(b._passive)
            ch.stop()
            with a._active_lock:
                a._active.clear()
                a._last_use.clear()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with b._passive_lock:
                    if not b._passive and _fds() <= fds0:
                        break
                time.sleep(0.02)
            with b._passive_lock:
                pruned = not b._passive
            return one, pruned, _fds() <= fds0
        finally:
            teardown(net, a, b)

    assert both(wires, case) == (1, True, True)


def test_stop_interrupts_connect_backoff_matches_jax(wires):
    """Node teardown mid-retry ends the connect backoff at once."""
    def case(W):
        conf = cache_conf(W, {"spark.shuffle.tpu.maxConnectionAttempts": 100,
                              "spark.shuffle.tpu.connectTimeout": "1s"})
        node = W.Node(("127.0.0.1", PORTS["backoff"] + W.off), conf)
        net, finished = W.TcpNetwork(), threading.Event()

        def connect_forever():
            # nothing listens there: every attempt fails and backs off
            with contextlib.suppress(Exception):
                node.get_channel(("127.0.0.1", PORTS["backoff"] + 1 + W.off),
                                 W.ChannelType.READ_REQUESTOR, net.connect)
            finished.set()

        threading.Thread(target=connect_forever, daemon=True).start()
        time.sleep(0.6)
        early = finished.is_set()
        t0 = time.monotonic()
        node.stop()
        return early, finished.wait(1.0), time.monotonic() - t0 < 1.0

    assert both(wires, case) == (False, True, True)


# -- striped reads over TCP (tests/test_striped_transport.py) ------------------


def stripe_conf(W, stripes, threshold, extra=None):
    return W.Conf({"spark.shuffle.tpu.transportNumStripes": stripes,
                   "spark.shuffle.tpu.transportStripeThreshold": threshold,
                   **(extra or {})})


SWEEP = [(1, "128k"), (2, "128k"), (3, "64k"), (4, "256k")]


@pytest.mark.parametrize("engine", ["threaded", "async", "loopback"])
@pytest.mark.parametrize("stripes,threshold", SWEEP)
def test_striped_read_sweep_matches_jax(wires, engine, stripes, threshold):
    """Each (engine, stripe count, threshold): the mixed batch, with the
    at-threshold and threshold+1 sizes, reads exactly, and the blocks
    above the threshold arrive as read-only stripe-assembled arrays."""
    port = PORTS["sweep"] + 10 * SWEEP.index((stripes, threshold)) + (
        40 if engine == "async" else 0)

    def case(W):
        netcls = W.LoopbackNetwork if engine == "loopback" else W.TcpNetwork
        conf = stripe_conf(W, stripes, threshold, THREADED
                           if engine == "threaded" else None)
        net, a, b, mkey = pair(W, netcls, port, conf)
        try:
            th = conf.transport_stripe_threshold
            spec = [(3, 100), (103, th), (5, th + 1), (1 << 20, 3 << 20),
                    (0, 1)]
            blocks = group_read(W, a.get_read_group(b.address, net.connect),
                                read_locs(W, mkey, spec))
            assert payloads(blocks) == pattern_of(spec)
            return [isinstance(blocks[i], np.ndarray)
                    and not blocks[i].flags.writeable for i in (2, 3)]
        finally:
            teardown(net, a, b)

    got = both(wires, case)
    if stripes > 1:
        assert got == [True, True]


def test_striped_matches_single_channel_and_loopback_matches_jax(wires):
    """Four stripes read what one channel reads, and TCP what loopback
    reads."""
    spec = [(11, 900_000), (950_000, 2 << 20), (7, 64)]

    def case(W):
        out = {}
        for name, netcls, port, stripes in [
                ("tcp1", W.TcpNetwork, PORTS["single"], 1),
                ("tcp4", W.TcpNetwork, PORTS["single"] + 10, 4),
                ("loop4", W.LoopbackNetwork, 0, 4)]:
            net, a, b, mkey = pair(W, netcls, port,
                                   stripe_conf(W, stripes, "128k"))
            try:
                out[name] = payloads(group_read(
                    W, a.get_read_group(b.address, net.connect),
                    read_locs(W, mkey, spec)))
            finally:
                teardown(net, a, b)
        assert out["tcp1"] == out["tcp4"] == out["loop4"] == pattern_of(spec)
        return out

    both(wires, case)


def test_scatter_gather_off_interop_matches_jax(wires):
    """transportScatterGather=off: the concat+sendall wire path reads
    exactly."""
    spec = [(9, 2 << 20), (1, 50)]

    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["scatter"], stripe_conf(
            W, 2, "128k", {"spark.shuffle.tpu.transportScatterGather": "off"}))
        try:
            return payloads(group_read(
                W, a.get_read_group(b.address, net.connect),
                read_locs(W, mkey, spec))) == pattern_of(spec)
        finally:
            teardown(net, a, b)

    assert both(wires, case) is True


def test_progress_accounts_every_stripe_byte_matches_jax(wires):
    """on_progress sums to the bytes asked for, the 2 MiB block in more
    than one step."""
    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["progress"],
                               stripe_conf(W, 4, "128k"))
        try:
            prog = []
            group_read(W, a.get_read_group(b.address, net.connect),
                       read_locs(W, mkey, [(0, 2 << 20), (5, 10)]),
                       on_progress=prog.append)
            return sum(prog), len([n for n in prog if n > 10]) > 1
        finally:
            teardown(net, a, b)

    assert both(wires, case) == ((2 << 20) + 10, True)


def test_serve_pool_credits_bound_but_never_deadlock_matches_jax(wires):
    """A 1 MiB credit budget under six concurrent 2 MiB serves throttles
    yet completes every read exactly."""
    def case(W):
        restore = registry_on(W)
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["credits"], stripe_conf(
            W, 2, "256k", {"spark.shuffle.tpu.transportServeThreads": 2,
                           "spark.shuffle.tpu.transportServeCreditBytes":
                           "1m"}))
        try:
            group = a.get_read_group(b.address, net.connect)
            return _concurrent_reads(
                W, group, mkey, [(i * 100, 2 << 20) for i in range(6)],
                timeout=30)
        finally:
            teardown(net, a, b)
            restore()

    assert both(wires, case) == {"ok": 6, "err": None}


def _outcome(res):
    """'exact' or the failure's class name."""
    return "exact" if "ok" in res else type(res["error"]).__name__


def test_killed_data_channel_fails_group_promptly_matches_jax(wires):
    """Stopping one data lane mid-read ends the group read within 15 s:
    exact, or failed cleanly."""
    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["lane_kill"],
                               stripe_conf(W, 2, "128k"))
        try:
            group = a.get_read_group(b.address, net.connect)
            lanes = group.data_channels()
            done, res = threading.Event(), {}
            group.read_blocks([W.BlockLocation(0, 4 << 20, mkey)], W.Listener(
                lambda blocks: (res.setdefault("ok", blocks), done.set()),
                lambda e: (res.setdefault("error", e), done.set())))
            lanes[0].stop()
            assert done.wait(15), "striped read hung after lane death"
            if "ok" in res:
                assert payloads(res["ok"]) == pattern_of([(0, 4 << 20)])
            return _outcome(res) in ("exact", "TransportError")
        finally:
            teardown(net, a, b)

    assert both(wires, case) is True


def test_peer_death_mid_response_body_fails_listener_matches_jax(wires):
    """A peer that sends a response header and half a block, then dies,
    fails that read's listener promptly."""
    def case(W):
        wire = W.tcp
        port = PORTS["evil"] + W.off
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port + 7))
        srv.listen(4)

        def evil_server():
            while True:
                try:
                    sock, _addr = srv.accept()
                except OSError:
                    return
                try:
                    sock.recv(wire._HELLO.size)
                    sock.sendall(b"\x01")
                    _op, ln = wire._HDR.unpack(sock.recv(wire._HDR.size))
                    req = b""
                    while len(req) < ln:
                        req += sock.recv(ln - len(req))
                    (req_id,) = struct.unpack_from("<Q", req, 0)
                    sock.sendall(wire._HDR.pack(
                        wire.OP_READ_RESP,
                        wire._RESP_HDR.size + wire._LEN.size + 1000))
                    sock.sendall(wire._RESP_HDR.pack(req_id, 0))
                    sock.sendall(wire._LEN.pack(1000) + b"x" * 500)
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                finally:
                    sock.close()

        threading.Thread(target=evil_server, daemon=True).start()
        net = W.TcpNetwork()
        a = W.Node(("127.0.0.1", port), stripe_conf(W, 1, "128k"))
        net.register(a)
        try:
            bound(a, want=[port])
            group = a.get_read_group(("127.0.0.1", port + 7), net.connect)
            done, res = threading.Event(), {}
            group.read_blocks([W.BlockLocation(0, 1000, 1)], W.Listener(
                lambda blocks: (res.setdefault("ok", blocks), done.set()),
                lambda e: (res.setdefault("error", e), done.set())))
            assert done.wait(10), "listener stranded after peer death"
            return "error" in res
        finally:
            a.stop()
            net.unregister(a)
            srv.close()

    assert both(wires, case) is True


def test_malformed_read_request_keeps_channel_alive_matches_jax(wires):
    """A READ_REQ that overruns its payload, and one with a garbage
    header, leave the serving channel answering real reads."""
    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["malformed"],
                               stripe_conf(W, 1, "128k"))
        try:
            ch = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                               net.connect)
            ch._send_msg(W.tcp.OP_READ_REQ, (struct.pack("<QI", 999, 5),))
            ch._send_msg(W.tcp.OP_READ_REQ, (b"\x01",))
            time.sleep(0.2)
            done, res = threading.Event(), {}
            ch.read_blocks([W.BlockLocation(0, 4096, mkey)], W.Listener(
                lambda blocks: (res.setdefault("ok", blocks), done.set()),
                lambda e: (res.setdefault("error", e), done.set())))
            assert done.wait(10), "read after malformed request hung"
            return _outcome(res), payloads(res.get("ok", []))
        finally:
            teardown(net, a, b)

    assert both(wires, case) == ("exact", pattern_of([(0, 4096)]))


def test_group_read_failure_on_dead_peer_matches_jax(wires):
    """A read group whose peer died fails its read within 15 s."""
    def case(W):
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["dead_group"],
                               stripe_conf(W, 2, "128k"))
        served = b._block_stores[mkey]  # b's stop() forgets it
        try:
            group = a.get_read_group(b.address, net.connect)
            b.stop()
            t0 = time.monotonic()
            done, res = threading.Event(), {}
            try:
                group.read_blocks(
                    [W.BlockLocation(0, 2 << 20, mkey)], W.Listener(
                        lambda blocks: (res.setdefault("ok", blocks),
                                        done.set()),
                        lambda e: (res.setdefault("error", e), done.set())))
            except Exception as e:
                res["error"] = e
                done.set()
            assert done.wait(15), "read against dead peer hung"
            return "error" in res, time.monotonic() - t0 < 15
        finally:
            a.stop()
            net.unregister(a)
            net.unregister(b)
            served.release(mkey)

    assert both(wires, case) == (True, True)


def test_failed_striped_read_keeps_lanes_balanced_matches_jax(wires):
    """A striped read that fails (unknown mkey) under a raising listener
    returns every lane token once: the pool refills, the ledger shows
    nothing outstanding and no double release."""
    def case(W):
        led = W.ledger.get_resource_ledger()
        was = led.enabled
        led.reset()
        led.enabled = True
        net, a, b, mkey = pair(W, W.TcpNetwork, PORTS["tokens"],
                               stripe_conf(W, 2, "64k"))
        try:
            group = a.get_read_group(b.address, net.connect)
            pool, done = a.lane_pool, threading.Event()
            free0 = pool._free

            def angry_failure(e):
                done.set()
                raise RuntimeError("listener exploded") from e

            group.read_blocks([W.BlockLocation(0, 1 << 20, mkey + 4077)],
                              W.Listener(lambda blocks: done.set(),
                                         angry_failure))
            assert done.wait(15), "failed striped read hung"
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if pool._free == free0 and not led.outstanding().get(
                        "node.lane_tokens"):
                    break
                time.sleep(0.02)
            return (pool._free == free0,
                    led.outstanding().get("node.lane_tokens", 0),
                    led.double_releases())
        finally:
            teardown(net, a, b)
            led.enabled = was
            led.reset()

    assert both(wires, case) == (True, 0, 0)


def test_serve_pool_cancelled_queue_holds_no_credits_matches_jax(wires):
    """Serves still queued when the pool stops never took credits: none
    outstanding after the one running serve settles."""
    def case(W):
        led = W.ledger.get_resource_ledger()
        was = led.enabled
        led.reset()
        led.enabled = True
        try:
            pool = W.node._ServePool("t", workers=1, credit_bytes=1 << 16)
            started, unblock = threading.Event(), threading.Event()

            def blocker():
                started.set()
                unblock.wait(10)

            pool.submit(blocker, (), cost=1024)
            assert started.wait(5), "serve worker never took the task"
            for _ in range(4):
                pool.submit(lambda: None, (), cost=1024)
            pool.stop()
            unblock.set()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if not led.outstanding().get("serve.credit_bytes"):
                    break
                time.sleep(0.02)
            return (led.outstanding().get("serve.credit_bytes", 0),
                    led.double_releases())
        finally:
            led.enabled = was
            led.reset()

    assert both(wires, case) == (0, 0)


# -- the two packages on one socket --------------------------------------------


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
@pytest.mark.parametrize("engine", ["threaded", "async"])
def test_cross_package_read_over_tcp(wires, direction, engine):
    """A node of one package reads, over a live socket, the blocks a node
    of the other serves: the mixed small/striped batch exactly and an RPC
    echo, on each engine.  Wire parity on the socket, where
    tests/test_torch_host_planes.py checks the message bytes."""
    jw, pw = wires
    reader, server = (pw, jw) if direction == "port_reads_jax" else (jw, pw)
    port = PORTS["cross"] + 10 * (2 * (engine == "async")
                                  + (direction == "jax_reads_port"))
    mode = "off" if engine == "threaded" else "on"
    net_r, net_s = reader.TcpNetwork(), server.TcpNetwork()
    a = reader.Node(("127.0.0.1", port), async_conf(reader, mode))
    b = server.Node(("127.0.0.1", port + 7), async_conf(server, mode))
    net_r.register(a)
    net_s.register(b)
    arena = server.ArenaManager()
    seg = arena.register(_PATTERN, zero_copy_ok=True)
    try:
        bound(a, b, want=[port, port + 7])
        b.register_block_store(seg.mkey, arena)
        group = a.get_read_group(b.address, net_r.connect)
        got = payloads(group_read(reader, group,
                                  read_locs(reader, seg.mkey)))
        assert got == pattern_of(_LOCS_SPEC)
        pong = threading.Event()
        echoed = {}
        b.set_receive_listener(lambda ch, frame: ch.reply_channel().send_rpc(
            [frame], server.Listener()))
        a.set_receive_listener(
            lambda _ch, frame: (echoed.setdefault("f", frame), pong.set()))
        ch = a.get_channel(b.address, reader.ChannelType.RPC_REQUESTOR,
                           net_r.connect)
        ch.send_rpc([b"cross-package"], reader.Listener())
        assert pong.wait(10), "cross-package rpc echo hung"
        assert echoed["f"] == b"cross-package"
    finally:
        b.stop()
        a.stop()
        net_r.unregister(a)
        net_s.unregister(b)
        arena.release(seg.mkey)


# -- a TCP-fetched block staged through the resolver ---------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_tcp_fetched_block_stages_through_resolver(wires, stage):
    """A block that crossed a socket into a pooled row of the reader's
    staging pool goes through ``resolver._to_device`` (``memory/staging``
    and ``shuffle/resolver.py``'s copy to the manager's device: the CPU
    here, the card on a GPU machine) and reads back byte for byte; the
    JAX package's row is the same bytes, and the staging counters count
    the copy."""
    jw, pw = wires
    base = PORTS["resolver"] + 30 * stage
    rows = {}

    def fetch(W):
        with tcp_managers(W, base, stage) as (driver, exs):
            handle = driver.register_shuffle(5, 1, W.Hash(1))
            w = exs[1].get_writer(handle, 0)
            w.write([(f"k{i}", bytes([i % 251]) * 3000) for i in range(300)])
            w.stop(True)
            captured = []
            Channel = W.channel.Channel
            orig = Channel._complete

            def spy(self, listener, result):
                if isinstance(result, list):
                    captured.extend(b for b in result
                                    if isinstance(b, np.ndarray))
                return orig(self, listener, result)

            Channel._complete = spy
            try:
                out = list(exs[0].get_reader(
                    handle, 0, 1, {exs[1].local_smid: [0]}).read())
            finally:
                Channel._complete = orig
            assert len(out) == 300 and captured
            # the blocks land in no fixed order: compare them as a set
            rows[W.name] = sorted(bytes(b) for b in captured)
            if W.is_port and stage:
                res = exs[0].resolver
                for block in captured:
                    h0 = res._m_h2d_bytes.value
                    t = res._to_device(block)
                    assert t.dtype.itemsize == 1
                    assert t.device == exs[0].device
                    assert t.cpu().numpy().tobytes() == bytes(block)
                    assert res._m_h2d_bytes.value - h0 == block.shape[0]
                del t, block
            del captured, out
            return pool_in_use(exs[0].staging_pool)

    with cluster_lock(base):
        assert both(wires, fetch) == 0
    assert rows[pw.name] == rows[jw.name]


# -- api.py over TcpNetwork ----------------------------------------------------


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("serializer", ["pickle", "columnar"])
def test_api_over_tcp_matches_jax(wires, serializer, stage):
    """``reduce_by_key``, ``group_by_key`` and ``sort_by_key`` through
    ``TpuShuffleContext(network=TcpNetwork())``: the JAX package's
    results and the oracle's, on the ports asserted."""
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 40, 1500).astype(np.int64)
    vals = rng.integers(0, 1000, 1500).astype(np.int64)
    records = list(zip(keys.tolist(), vals.tolist()))

    def case(W):
        base = PORTS["api"] + 20 * (2 * (serializer == "columnar") + stage) \
            + W.off
        conf = W.Conf({"spark.shuffle.tpu.serializer": serializer})
        out = {}
        with W.P.Context(num_executors=2, conf=conf,
                         network=W.TcpNetwork(), base_port=base,
                         stage_to_device=stage) as ctx:
            bound(ctx.driver, *ctx.executors,
                  want=[base, base + 100, base + 110])
            for op in ("reduce", "group", "sort"):
                ds = (ctx.parallelize_columns(keys, vals, num_slices=4)
                      if serializer == "columnar"
                      else ctx.parallelize(records, num_slices=4))
                out[op] = canon(run_op(ds, op, serializer == "columnar"), op)
                assert out[op] == oracle(records, op), (W.name, op)
        return out

    with cluster_lock(PORTS["api"] + 20 * (2 * (serializer == "columnar")
                                       + stage)):
        both(wires, case)


# -- the repair ----------------------------------------------------------------


def test_threaded_listener_frees_its_port(wires):
    """A node on the threaded engine, unregistered and stopped, frees its
    port at once: a new listener binds it (with ``SO_REUSEADDR``, as
    every listener of the transport does, which a socket left in
    TIME_WAIT does not block but a listening one does).  The
    JAX package's ``TcpNetwork.unregister`` closes the socket while its
    accept thread sits in ``accept()``, which leaves the port bound until
    the next connection; the port shuts the socket down first (ROADMAP
    §C.4)."""
    _jw, W = wires
    port = PORTS["backoff"] + 5 + W.off
    net = W.TcpNetwork()
    node = W.Node(("127.0.0.1", port), W.Conf(THREADED))
    net.register(node)
    bound(node, want=[port])
    # a connection proves the accept thread is back in accept()
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(W.tcp._HELLO.pack(
            W.tcp._MAGIC, W.tcp._TYPE_BY_INDEX.index(
                W.ChannelType.RPC_REQUESTOR), port + 1, W.tcp.WIRE_VERSION))
        assert s.recv(1) == b"\x01"
    time.sleep(0.05)
    node.stop()
    net.unregister(node)
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        probe.bind(("127.0.0.1", port))
        probe.listen(1)
    finally:
        probe.close()


def test_eviction_never_fails_a_post_through_its_listener(wires):
    """A post that reaches a channel after the cache chose it for
    eviction is refused synchronously (its caller re-resolves through
    the cache) instead of being admitted and then failed through its
    listener by the eviction's ``stop()``.  The JAX package's check
    (``in_flight()``, then ``stop()`` outside any lock the post takes)
    admits it; the port stops the channel atomically with admission
    (``Channel.stop_if_idle``, ROADMAP §C.4)."""
    _jw, W = wires
    conf = cache_conf(W, {"spark.shuffle.tpu.transportMaxCachedChannels": 1})
    net = W.LoopbackNetwork()
    a, b, c = (W.Node(("127.0.0.1", 26800 + i), conf) for i in range(3))
    for n in (a, b, c):
        net.register(n)
    b.register_block_store(1, W.BytesBlockStore(b"x" * 64))
    try:
        ch_b = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                             net.connect)
        seen, real_stop = [], ch_b.stop

        def racing_stop():
            # a read that reached the channel after the eviction chose it
            try:
                ch_b.read_blocks([W.BlockLocation(0, 4, 1)], W.Listener(
                    lambda r: seen.append("completed"),
                    lambda e: seen.append("failed")))
                seen.append("admitted")
            except W.TransportError:
                seen.append("refused")
            real_stop()

        ch_b.stop = racing_stop
        a.get_channel(c.address, W.ChannelType.RPC_REQUESTOR, net.connect)
        time.sleep(0.2)
        assert seen == ["refused"]
        again = a.get_channel(b.address, W.ChannelType.READ_REQUESTOR,
                              net.connect)
        assert again is not ch_b
    finally:
        teardown(net, a, b, c)


def test_promoted_post_is_never_idle_to_the_cache(wires):
    """A post queued behind an exhausted send budget and promoted when
    the op ahead of it completes is in flight throughout: the cache's
    eviction test, run in the instant between the promotion's removal
    from the pending queue and its tracking, finds the channel busy.
    Before the repair the promotion tracked the op after dropping the
    pending lock, ``in_flight()`` read 0 there, and the cache stopped a
    channel whose promoted op then posted on it."""
    _jw, W = wires

    class Held(W.channel.Channel):
        """Posts that complete only when the test completes them."""

        def __init__(self):
            super().__init__(W.ChannelType.READ_REQUESTOR, send_queue_depth=1)
            self.posted = []
            self._set_state(W.channel.ChannelState.CONNECTED)

        def _post_read(self, locations, listener, *_a):
            self.posted.append(listener)

    ch = Held()
    failed = []
    first, second = (W.Listener(lambda r: None, failed.append)
                     for _ in range(2))
    loc = [W.BlockLocation(0, 4, 1)]
    ch.read_blocks(loc, first)
    ch.read_blocks(loc, second)  # the budget is spent: queued
    assert (ch.posted, ch.in_flight()) == ([first], 2)
    evicted, real_track = [], ch._track
    cache = threading.Thread(target=lambda: evicted.append(ch.stop_if_idle()))

    def track_racing_the_cache(listener):
        # the cache's eviction test from another thread, given time to
        # run to its end before the op is tracked
        cache.start()
        cache.join(0.5)
        real_track(listener)

    ch._track = track_racing_the_cache
    ch._complete(first, [b"xxxx"])
    ch._release_budget()  # promotes the queued post
    cache.join(10)
    assert not cache.is_alive() and evicted == [False]
    assert ch.is_connected() and ch.posted == [first, second]
    assert ch.in_flight() == 1 and failed == []
    ch.stop()
    assert len(failed) == 1 and ch.in_flight() == 0
