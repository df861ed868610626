"""One rank of a gloo world for tests/test_torch_multihost.py.

    python tests/torch_multihost_worker.py PHASE RANK WORLD STORE OUT_DIR

One executor per process: each rank joins the world through
``parallel/multihost.initialize`` (gloo on the CPU, a ``file://``
store), runs a ``TpuShuffleManager`` over a real TCP control plane (rank
0 also runs the driver), and reads through the bulk and windowed planes,
whose exchange is rank-local over the world.  Results go to
``OUT_DIR/rank<RANK>.pkl``.  Imports torch, numpy and
``sparkrdma_tpu_torch`` only: neither JAX nor the tests' conftest.

- ``two`` (tests/multihost_worker.py): an all-reduce and an all-to-all
  across the process boundary, ``exchange_bytes`` with a guarded remote
  row, the bulk shuffle (70), the windowed bulk shuffle with a straggler
  map (71), the windowed plane through ``get_reader`` (72), and two
  windowed shuffles whose pumps run at once (73, 74).
- ``four`` (tests/multihost4_worker.py): the windowed plane at 4
  processes, 8 maps in windows of 3, straggler overlap; then rank 3
  SIGKILLs itself and every survivor's pending reader must fail
  promptly with a stage-retriable error.
- ``late``: the windowed plane at 2 processes, windows of one map,
  while every message the last rank's executor sends the driver (its
  hello, publishes and plan requests) lands ``LATE_S`` late.  The
  driver pins the plan's host set at the first window, so the other
  rank's first plan request must wait until the late executor is
  announced, or the late one is refused its plans and the exchange
  stalls.

The TCP ports are fixed (driver at BASE, executor r at BASE + 10 + r),
so canonical host order equals rank order: ``TWO_BASE`` 29920 puts the
two-process plane at 29920, 29930 and 29931, clear of the 16-port bind
hunt above the JAX tiered store's executor at 29900; ``FOUR_BASE``
29950 puts the four-process plane at 29950 and 29960-29963;
``LATE_BASE`` 29980 puts the late-executor plane at 29980, 29990 and
29991.  Each rank reports the ports it bound (``res["ports"]``).
"""

import os
import pickle
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TWO_BASE = 29920
FOUR_BASE = 29950
LATE_BASE = 29980
# how late the last rank's messages reach the driver
LATE_S = 0.3
NUM_PARTS = 8
# collectives with a dead peer fail after this long, well inside the
# test's limit
COLLECTIVE_TIMEOUT_S = 30.0


def records(tag, m, n):
    return [(f"{tag}{m}-k{j}", (m, j)) for j in range(n)]


def owned(all_records, part, p):
    return sorted(kv for kv in all_records if part.partition(kv[0]) == p)


def _wait(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    assert cond(), what


def _manager(conf, base, rank):
    """This rank's executor.  Nothing waits here for the other
    executors' hellos: a plan request waits until the driver has
    announced every row of the exchange (``BulkExchangeReader``)."""
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.transport import TcpNetwork

    return TpuShuffleManager(conf, is_driver=False, network=TcpNetwork(),
                             port=base + 10 + rank, executor_id=str(rank),
                             device="cpu")


def _write(mgr, handle, map_id, recs):
    w = mgr.get_writer(handle, map_id)
    w.write(recs)
    w.stop(True)


def _read_parts(mgr, handle, parts, out, errs):
    def task(p):
        try:
            out[p] = sorted(mgr.get_reader(handle, p, p + 1, {}).read())
        except BaseException as e:
            errs[p] = e

    ts = [threading.Thread(target=task, args=(p,), daemon=True)
          for p in parts]
    for t in ts:
        t.start()
    return ts


def phase_two(rank, world, store, out_dir):
    import torch
    import torch.distributed as dist

    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.parallel import multihost
    from sparkrdma_tpu_torch.parallel.exchange import (
        HostLocalStreams,
        NonAddressableStreamError,
        TileExchange,
    )
    from sparkrdma_tpu_torch.shuffle.bulk import (
        BulkExchangeReader,
        WindowedReadPlane,
    )
    from sparkrdma_tpu_torch.shuffle.manager import (
        ShuffleHandle,
        TpuShuffleManager,
    )
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.transport import TcpNetwork

    res = {}
    driver_port = TWO_BASE
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.driverPort": driver_port,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "60s",
        "spark.shuffle.tpu.connectTimeout": "10s",
    })
    wconf = TpuShuffleConf({
        "spark.shuffle.tpu.driverPort": driver_port,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "60s",
        "spark.shuffle.tpu.connectTimeout": "10s",
        "spark.shuffle.tpu.bulkWindowMaps": "2",
    })
    part = HashPartitioner(NUM_PARTS)
    driver = None
    if rank == 0:
        # listening before the rendezvous, so every executor's hello
        # lands
        driver = TpuShuffleManager(wconf, is_driver=True,
                                   network=TcpNetwork(), port=driver_port,
                                   device="cpu")
        driver.register_shuffle(70, 2, part)
        for sid in (71, 72, 73, 74):
            driver.register_shuffle(sid, 4, part)

    assert not multihost.is_multihost()
    multihost.initialize()  # no arguments, single host: a no-op
    assert not dist.is_initialized()
    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         device="cpu")  # idempotent
    assert multihost.is_multihost()
    group = multihost.global_group("cpu")
    assert (group.rank, group.size) == (rank, world)
    res["local"] = multihost.host_local_indices(group)

    # cross-process all-reduce of each rank's sum: every rank sees the
    # global total (the JAX worker's psum over 16 values per process)
    t = (torch.ones(16, dtype=torch.int32) * (rank + 1)).sum().reshape(1)
    dist.all_reduce(t)
    res["psum"] = int(t[0])

    # cross-process all_to_all: x[src, dst] = src * D + dst
    D = world
    mat = np.arange(D * D, dtype=np.int32).reshape(D, D)
    got = group.all_to_all(torch.from_numpy(mat[rank].reshape(D, 1).copy()))
    res["a2a"] = got.reshape(-1).tolist()

    # the byte engine across the boundary: this rank's row only, the
    # agreed lengths, and a guarded remote row
    def payload(s, d):
        return bytes([(7 * s + 3 * d + 1) % 251]) * (100 * (s + d + 1))

    lengths = np.array([[100 * (s + d + 1) for d in range(D)]
                        for s in range(D)], np.int64)
    streams = [[payload(s, d) if s == rank else b"" for d in range(D)]
               for s in range(D)]
    out = TileExchange(group, tile_bytes=1 << 10).exchange_bytes(
        streams, lengths=lengths)
    assert isinstance(out, HostLocalStreams)
    res["exchange_addressable"] = sorted(out.addressable)
    res["exchange_ok"] = all(out[rank][s] == payload(s, rank)
                             for s in range(D))
    try:
        out[1 - rank]
        res["remote_guarded"] = False
    except NonAddressableStreamError:
        res["remote_guarded"] = True

    ex_mgr = _manager(conf, driver_port, rank)
    res["ports"] = dict(
        executor=ex_mgr.node.address[1],
        driver=None if driver is None else driver.node.address[1])

    # the bulk-synchronous shuffle: the reader's default exchange is the
    # initialised world on the manager's device
    handle = ShuffleHandle(70, 2, part)
    _write(ex_mgr, handle, rank, records("p", rank, 60))
    reader = BulkExchangeReader(ex_mgr)
    assert reader.exchange.n_devices == world
    res["bulk70"] = sorted(reader.read(70))

    # windowed bulk (71): window 0's collective lands before this
    # rank's straggler map is written
    conf.set("bulkWindowMaps", "2")
    handle71 = ShuffleHandle(71, 4, part)
    _write(ex_mgr, handle71, rank, records("w", rank, 40))
    reader71 = BulkExchangeReader(ex_mgr, TileExchange(group,
                                                       tile_bytes=1 << 12))
    box = {}

    def read71():
        try:
            box["got"] = sorted(reader71.read(71))
        except BaseException as e:
            box["err"] = e

    th = threading.Thread(target=read71, daemon=True)
    th.start()
    _wait(lambda: reader71.window_events, 30,
          f"rank {rank}: window 0 never exchanged before the straggler")
    res["w71_early"] = "got" not in box
    _write(ex_mgr, handle71, rank + 2, records("w", rank + 2, 40))
    th.join(timeout=60)
    assert "err" not in box, f"rank {rank}: {box.get('err')!r}"
    res["bulk71"] = box["got"]
    res["w71_windows"] = [w for w, _t, _b in reader71.window_events]

    # the unified plane (72): reducer-issued reads, straggler overlap
    conf.set("readPlane", "windowed")
    ex_mgr.windowed_plane = WindowedReadPlane(
        ex_mgr, exchange=TileExchange(group, tile_bytes=1 << 12))
    handle72 = ShuffleHandle(72, 4, part)
    _write(ex_mgr, handle72, rank, records("u", rank, 50))
    mine = [p for p in range(NUM_PARTS) if p % world == rank]
    out72, err72 = {}, {}
    ts = _read_parts(ex_mgr, handle72, mine, out72, err72)
    _wait(lambda: ex_mgr.windowed_plane.window_events(72), 30,
          f"rank {rank}: no reactive window before the straggler")
    res["w72_early"] = not out72
    _write(ex_mgr, handle72, rank + 2, records("u", rank + 2, 50))
    for t in ts:
        t.join(timeout=60)
    assert not err72, f"rank {rank}: {err72!r}"
    res["w72"] = out72
    res["w72_windows"] = [w for w, _t, _b in
                          ex_mgr.windowed_plane.window_events(72)]

    # two shuffles at once (73, 74): both pumps and all readers run
    # together; 74's maps are written once 73 has landed on every rank
    # (store keys, not a collective), so each rank issues 73's
    # collectives before 74's
    sync = dist.FileStore(f"{store}.sync", world)
    handles = {sid: ShuffleHandle(sid, 4, part) for sid in (73, 74)}
    outs = {sid: ({}, {}) for sid in handles}
    threads = []
    for sid, h in handles.items():
        threads += _read_parts(ex_mgr, h, mine, *outs[sid])
    for m in (rank, rank + 2):
        _write(ex_mgr, handles[73], m, records("a", m, 30))
    _wait(lambda: len(outs[73][0]) + len(outs[73][1]) == len(mine), 60,
          f"rank {rank}: shuffle 73 never finished")
    sync.set(f"done73-{rank}", "1")
    sync.wait([f"done73-{r}" for r in range(world)])
    for m in (rank, rank + 2):
        _write(ex_mgr, handles[74], m, records("b", m, 30))
    for t in threads:
        t.join(timeout=60)
    for sid in handles:
        assert not outs[sid][1], f"rank {rank} shuffle {sid}: {outs[sid][1]}"
        res[f"c{sid}"] = outs[sid][0]

    ex_mgr.stop()
    if driver is not None:
        driver.stop()
    dist.barrier()
    dist.destroy_process_group()
    return res


def phase_four(rank, world, store, out_dir):
    import random
    import signal

    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.parallel import multihost
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange
    from sparkrdma_tpu_torch.shuffle.bulk import WindowedReadPlane
    from sparkrdma_tpu_torch.shuffle.manager import (
        ShuffleHandle,
        TpuShuffleManager,
    )
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.shuffle.reader import (
        FetchFailedError,
        MetadataFetchFailedError,
    )
    from sparkrdma_tpu_torch.transport import TcpNetwork

    NUM_MAPS, SHUFFLE, LOSS_SHUFFLE, VICTIM = 8, 73, 91, 3
    res = {}
    driver_port = FOUR_BASE
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.driverPort": driver_port,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "60s",
        "spark.shuffle.tpu.connectTimeout": "10s",
        "spark.shuffle.tpu.bulkWindowMaps": "3",
        "spark.shuffle.tpu.readPlane": "windowed",
        "spark.shuffle.tpu.heartbeatInterval": "500ms",
        "spark.shuffle.tpu.heartbeatTimeout": "8s",
    })
    part = HashPartitioner(NUM_PARTS)
    driver = None
    if rank == 0:
        driver = TpuShuffleManager(conf, is_driver=True,
                                   network=TcpNetwork(), port=driver_port,
                                   device="cpu")
        driver.register_shuffle(SHUFFLE, NUM_MAPS, part)
        driver.register_shuffle(LOSS_SHUFFLE, NUM_MAPS, part)
    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    ex_mgr = _manager(conf, driver_port, rank)
    res["ports"] = dict(
        executor=ex_mgr.node.address[1],
        driver=None if driver is None else driver.node.address[1])
    ex_mgr.windowed_plane = WindowedReadPlane(
        ex_mgr, exchange=TileExchange(multihost.global_group("cpu"),
                                      tile_bytes=1 << 12))

    handle = ShuffleHandle(SHUFFLE, NUM_MAPS, part)
    _write(ex_mgr, handle, rank, records("q", rank, 40))
    mine = [p for p in range(NUM_PARTS) if p % world == rank]
    out, errs = {}, {}
    ts = _read_parts(ex_mgr, handle, mine, out, errs)
    _wait(lambda: ex_mgr.windowed_plane.window_events(SHUFFLE), 60,
          f"rank {rank}: no window landed before the stragglers")
    res["early"] = not out
    _write(ex_mgr, handle, rank + world, records("q", rank + world, 40))
    for t in ts:
        t.join(timeout=90)
    assert not errs, f"rank {rank}: {errs!r}"
    res["parts"] = out
    res["windows"] = [w for w, _t, _b in
                      ex_mgr.windowed_plane.window_events(SHUFFLE)]
    # the survivors' report must not depend on the victim's: write it
    # now, and again after the loss phase
    _dump(res, rank, out_dir)
    print(f"rank {rank}: 4-process windowed plane OK", flush=True)

    rng = random.Random(int(os.environ.get("SPARKRDMA_TEST_CHAOS_SEED",
                                           "4091")) + rank)
    handle2 = ShuffleHandle(LOSS_SHUFFLE, NUM_MAPS, part)
    if rank == VICTIM:
        # die without goodbye before any map of the loss shuffle is
        # written, so no window plan strands a survivor in a collective
        time.sleep(rng.uniform(0.0, 0.5))
        os.kill(os.getpid(), signal.SIGKILL)

    loss_done, loss_errs = {}, {}

    def loss_reduce(p):
        try:
            loss_done[p] = list(ex_mgr.get_reader(handle2, p, p + 1,
                                                  {}).read())
        except (FetchFailedError, MetadataFetchFailedError) as e:
            loss_errs[p] = type(e).__name__

    lts = [threading.Thread(target=loss_reduce, args=(p,), daemon=True)
           for p in mine]
    t0 = time.time()
    for t in lts:
        t.start()
    for t in lts:
        t.join(timeout=45)
    res["loss_hung"] = any(t.is_alive() for t in lts)
    res["loss_done"] = loss_done
    res["loss_errors"] = loss_errs
    res["loss_seconds"] = time.time() - t0
    _dump(res, rank, out_dir)
    print(f"rank {rank}: windowed executor-loss fails prompt OK",
          flush=True)
    # the world lost a member: leave without the process group's
    # teardown, which would wait for the dead rank
    sys.stdout.flush()
    os._exit(0)


def phase_late(rank, world, store, out_dir):
    import torch.distributed as dist

    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.parallel import multihost
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange
    from sparkrdma_tpu_torch.shuffle.bulk import WindowedReadPlane
    from sparkrdma_tpu_torch.shuffle.manager import (
        ShuffleHandle,
        TpuShuffleManager,
    )
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu_torch.transport import TcpNetwork

    SHUFFLE = 75
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.driverPort": LATE_BASE,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "30s",
        "spark.shuffle.tpu.connectTimeout": "10s",
        "spark.shuffle.tpu.bulkWindowMaps": "1",
        "spark.shuffle.tpu.bulkBarrierTimeout": "20s",
        "spark.shuffle.tpu.readPlane": "windowed",
    })
    part = HashPartitioner(NUM_PARTS)
    driver = None
    if rank == 0:
        driver = TpuShuffleManager(conf, is_driver=True,
                                   network=TcpNetwork(), port=LATE_BASE,
                                   device="cpu")
        driver.register_shuffle(SHUFFLE, world, part)
    if rank == world - 1:
        send = TpuShuffleManager._send_driver_msg

        def late(self, msg, on_failure=None):
            def deliver():
                try:
                    send(self, msg, on_failure)
                except Exception:  # noqa: BLE001 - the manager stopped
                    pass

            threading.Timer(LATE_S, deliver).start()

        TpuShuffleManager._send_driver_msg = late
    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    ex_mgr = _manager(conf, LATE_BASE, rank)
    ex_mgr.windowed_plane = WindowedReadPlane(
        ex_mgr, exchange=TileExchange(multihost.global_group("cpu"),
                                      tile_bytes=1 << 12))
    handle = ShuffleHandle(SHUFFLE, world, part)
    _write(ex_mgr, handle, rank, records("l", rank, 40))
    mine = [p for p in range(NUM_PARTS) if p % world == rank]
    out, errs = {}, {}
    for t in _read_parts(ex_mgr, handle, mine, out, errs):
        t.join(timeout=60)
    assert not errs, f"rank {rank}: {errs!r}"
    res = {"parts": out, "windows": [
        w for w, _t, _b in ex_mgr.windowed_plane.window_events(SHUFFLE)]}
    res["ports"] = dict(
        executor=ex_mgr.node.address[1],
        driver=None if driver is None else driver.node.address[1])
    dist.barrier()  # the driver outlives every read
    ex_mgr.stop()
    if driver is not None:
        driver.stop()
    dist.destroy_process_group()
    return res


def _dump(res, rank, out_dir):
    tmp = os.path.join(out_dir, f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))


def main():
    phase, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    fn = {"two": phase_two, "four": phase_four, "late": phase_late}[phase]
    res = fn(rank, world, store, out_dir)
    _dump(res, rank, out_dir)
    print(f"rank {rank}: {phase} OK", flush=True)


if __name__ == "__main__":
    main()
