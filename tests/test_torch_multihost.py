"""The port's multi-process planes (``parallel/multihost.py`` and the
bulk and windowed planes with one executor per process) on gloo CPU
worlds.

Each world is spawned once per module (tests/torch_multihost_worker.py,
which imports neither JAX nor this conftest), over a ``file://`` store,
with its control plane on fixed TCP ports (``TWO_BASE``, ``FOUR_BASE``
and ``LATE_BASE`` of the worker: 29920, 29930-29931, 29950,
29960-29963, 29980 and 29990-29991), which no JAX test binds or reaches
by its bind hunt.  The JAX
counterparts (tests/test_multihost.py) skip on the CPU, whose JAX
backend has no multi-process collectives, so the expectations come from
the records themselves, as the JAX workers compute them, and from the
JAX package's in-process windowed plane on ``make_mesh(4)`` fed the same
maps.

- 2 processes: an all-reduce, an all-to-all and ``exchange_bytes``
  across the boundary (a remote row refuses access); the bulk shuffle,
  the windowed bulk shuffle with a straggler map, the windowed plane
  through ``get_reader``, and two shuffles whose pumps run at once with
  their windows ordered alike on both ranks (see ROADMAP: across
  processes, collectives run in the order plans land on each rank).
- 4 processes: the windowed plane over 8 maps in windows of 3 with the
  straggler overlap, then rank 3 SIGKILLs itself and every survivor's
  pending reader fails promptly with a stage-retriable error.
- 2 processes, one executor's messages to the driver held back: the
  windowed plane still completes, because a plan request waits until
  the driver has announced every row of the exchange (before that
  repair the first window pinned the prompt executor alone and the
  exchange stalled).
"""

import fcntl
import os
import pathlib
import pickle
import signal
import subprocess
import sys
import tempfile
import time

import pytest

import torch_multihost_worker as worker

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = {"two": 150, "four": 200, "late": 120}
VICTIM = 3


def _run_world(phase, world, tmp, sigkilled=()):
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # a world binds fixed ports, and two test workers may each spawn the
    # same module-scoped world: the worlds take turns under a lock file
    lock = open(os.path.join(tempfile.gettempdir(),
                             "sparkrdma_tpu_torch_multihost_ports.lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    procs = [
        subprocess.Popen(
            [sys.executable, str(pathlib.Path(worker.__file__)), phase,
             str(r), str(world), str(store), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO),
        )
        for r in range(world)
    ]
    outs = []
    t0 = time.monotonic()
    try:
        for p in procs:
            left = max(1.0, WORLD_TIMEOUT_S[phase] - (time.monotonic() - t0))
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        lock.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r in sigkilled:
            assert p.returncode == -signal.SIGKILL, (r, p.returncode, out)
        else:
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))  # written by our own workers
    return ranks, outs


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_world("two", 2, tmp_path_factory.mktemp("mh2"))[0]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_world("four", 4, tmp_path_factory.mktemp("mh4"),
                      sigkilled=(VICTIM,))


@pytest.fixture(scope="module")
def late(tmp_path_factory):
    return _run_world("late", 2, tmp_path_factory.mktemp("mhl"))[0]


def _part():
    from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner

    return HashPartitioner(worker.NUM_PARTS)


def test_multihost_module_single_process():
    """Before any world exists: a no-argument initialize is a no-op, the
    global group is a world of one, and partial arguments raise."""
    from sparkrdma_tpu_torch.parallel import multihost

    multihost.initialize()
    assert not multihost.is_multihost()
    g = multihost.global_group("cpu")
    assert (g.rank, g.size) == (0, 1)
    assert multihost.host_local_indices(g) == [0]
    assert multihost.supports_multiprocess_collectives()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="127.0.0.1:1")


def test_initialize_failure_raises(tmp_path):
    """Explicit arguments that cannot rendezvous raise instead of
    running a job of one (here: a world of two whose peer never comes,
    bounded by the timeout)."""
    code = (
        "import sys; from sparkrdma_tpu_torch.parallel import multihost\n"
        "try:\n"
        f"    multihost.initialize('file://{tmp_path}/s', 2, 0, "
        "device='cpu', timeout_s=2)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__); sys.exit(0)\n"
        "sys.exit(3)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "raised" in out.stdout, out


def test_worlds_bind_their_fixed_ports(two, four):
    """Every rank bound the port its world's base gives it (driver at
    the base on rank 0, executor r at base + 10 + r): a move of these
    constants shows up here."""
    assert (worker.TWO_BASE, worker.FOUR_BASE) == (29920, 29950)
    for base, ranks in ((worker.TWO_BASE, two),
                        (worker.FOUR_BASE, four[0])):
        for r, res in enumerate(ranks):
            assert res["ports"] == dict(
                executor=base + 10 + r, driver=base if r == 0 else None)


def test_two_process_windowed_plane_waits_for_a_late_executor(late):
    """Every message rank 1's executor sends the driver lands
    ``LATE_S`` late, and nothing in the worker waits for the hellos.
    The driver pins the host set at the first window; rank 0's first
    plan request waits inside the library until rank 1 is announced,
    so both ranks read every partition they own, window by window."""
    assert worker.LATE_BASE == 29980
    part = _part()
    recs = [kv for m in range(2) for kv in worker.records("l", m, 40)]
    for r, res in enumerate(late):
        assert res["ports"] == dict(executor=worker.LATE_BASE + 10 + r,
                                    driver=worker.LATE_BASE if r == 0
                                    else None)
        assert res["windows"] == [0, 1]
        mine = [p for p in range(worker.NUM_PARTS) if p % 2 == r]
        assert sorted(res["parts"]) == mine
        for p in mine:
            assert res["parts"][p] == worker.owned(recs, part, p)


def test_two_process_collectives(two):
    for r, res in enumerate(two):
        assert res["local"] == [r]
        assert res["psum"] == 16 * 1 + 16 * 2
        assert res["a2a"] == [s * 2 + r for s in range(2)]
        assert res["exchange_addressable"] == [r]
        assert res["exchange_ok"] and res["remote_guarded"]


def test_two_process_bulk_shuffle(two):
    part = _part()
    recs = [kv for q in range(2) for kv in worker.records("p", q, 60)]
    for r, res in enumerate(two):
        want = sorted(kv for kv in recs if part.partition(kv[0]) % 2 == r)
        assert res["bulk70"] == want


def test_two_process_windowed_bulk(two):
    part = _part()
    recs = [kv for m in range(4) for kv in worker.records("w", m, 40)]
    for r, res in enumerate(two):
        assert res["w71_early"], "read returned before the straggler map"
        assert res["w71_windows"] == [0, 1]
        want = sorted(kv for kv in recs if part.partition(kv[0]) % 2 == r)
        assert res["bulk71"] == want


def test_two_process_windowed_plane(two):
    part = _part()
    recs = [kv for m in range(4) for kv in worker.records("u", m, 50)]
    for r, res in enumerate(two):
        assert res["w72_early"], "a reducer finished before the straggler"
        assert res["w72_windows"] == [0, 1]
        mine = [p for p in range(worker.NUM_PARTS) if p % 2 == r]
        assert sorted(res["w72"]) == mine
        for p in mine:
            assert res["w72"][p] == worker.owned(recs, part, p)


@pytest.mark.parametrize("sid,tag", [(73, "a"), (74, "b")])
def test_two_process_concurrent_shuffles(two, sid, tag):
    part = _part()
    recs = [kv for m in range(4) for kv in worker.records(tag, m, 30)]
    for r, res in enumerate(two):
        got = res[f"c{sid}"]
        for p in [p for p in range(worker.NUM_PARTS) if p % 2 == r]:
            assert got[p] == worker.owned(recs, part, p)


@pytest.fixture(scope="module")
def jax_four(devices):
    """The same 4-executor windowed shuffle through the JAX package's
    in-process plane on ``make_mesh(4)``: partition -> records, and each
    executor's window indices."""
    import threading

    from sparkrdma_tpu.conf import TpuShuffleConf
    from sparkrdma_tpu.parallel.exchange import TileExchange
    from sparkrdma_tpu.parallel.mesh import make_mesh
    from sparkrdma_tpu.shuffle.bulk import (
        BulkShuffleSession,
        WindowedReadPlane,
    )
    from sparkrdma_tpu.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu.shuffle.partitioner import HashPartitioner
    from sparkrdma_tpu.transport import LoopbackNetwork

    net = LoopbackNetwork()
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.driverPort": worker.FOUR_BASE,
        "spark.shuffle.tpu.bulkWindowMaps": "3",
        "spark.shuffle.tpu.readPlane": "windowed",
    })
    driver = TpuShuffleManager(conf, is_driver=True, network=net)
    exs = [TpuShuffleManager(conf, is_driver=False, network=net,
                             port=worker.FOUR_BASE + 10 + r,
                             executor_id=str(r)) for r in range(4)]
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not all(
                len(e._peers) == 4 for e in exs):
            time.sleep(0.01)
        session = BulkShuffleSession(
            TileExchange(make_mesh(4), tile_bytes=1 << 12), 4)
        for e in exs:
            e.windowed_plane = WindowedReadPlane(e, session=session)
        part = HashPartitioner(worker.NUM_PARTS)
        handle = driver.register_shuffle(73, 8, part)
        for m in range(8):
            w = exs[m % 4].get_writer(handle, m)
            w.write(worker.records("q", m, 40))
            w.stop(True)
        out = {}

        def task(p):
            out[p] = sorted(exs[p % 4].get_reader(handle, p, p + 1,
                                                  {}).read())

        ts = [threading.Thread(target=task, args=(p,))
              for p in range(worker.NUM_PARTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        wins = [[w for w, _t, _b in e.windowed_plane.window_events(73)]
                for e in exs]
        return out, wins
    finally:
        for m in exs + [driver]:
            m.stop()


def test_four_process_windowed_plane(four, jax_four):
    ranks, _outs = four
    want, jwins = jax_four
    part = _part()
    recs = [kv for m in range(8) for kv in worker.records("q", m, 40)]
    for r, res in enumerate(ranks):
        assert res["early"], f"rank {r}: a reducer beat the stragglers"
        assert res["windows"] == jwins[r] == [0, 1, 2]
        mine = [p for p in range(worker.NUM_PARTS) if p % 4 == r]
        assert sorted(res["parts"]) == mine
        for p in mine:
            assert res["parts"][p] == want[p] == worker.owned(recs, part, p)


def test_four_process_executor_loss(four):
    ranks, outs = four
    assert "4-process windowed plane OK" in outs[VICTIM]
    for r, res in enumerate(ranks):
        if r == VICTIM:
            assert "loss_errors" not in res
            continue
        mine = [p for p in range(worker.NUM_PARTS) if p % 4 == r]
        assert not res["loss_hung"], f"rank {r}: reader hung"
        assert not res["loss_done"], res["loss_done"]
        assert sorted(res["loss_errors"]) == mine, res["loss_errors"]
        assert res["loss_seconds"] < 40, res["loss_seconds"]
        assert "executor-loss fails prompt OK" in outs[r]
