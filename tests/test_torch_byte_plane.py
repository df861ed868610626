"""The port's byte data plane against the JAX package, on the CPU.

``sparkrdma_tpu_torch.parallel.exchange`` (``TileExchange``,
``ExchangePlan`` and the row views), ``memory/device_arena.py``
(``DeviceArena``, ``DeviceStagingBridge``) and ``memory/arena.py``
(``ArenaManager`` and its segments).

The port's ``TileExchange`` runs rank-locally, one process per device:
every rank passes the same lengths and its own source row and keeps its
own destination row.  D = 1 runs in-process; D = 2 and 4 run in a gloo
world of D worker processes (tests/torch_byte_plane_worker.py, which
imports neither JAX nor this conftest), spawned once per module and per
D over a ``file://`` store.  The JAX ``TileExchange(make_mesh(D))``
runs the same cases on the same seeded streams on the conftest's CPU
mesh, as one controller over all D devices.  Rank d's result must equal
JAX's ``out[d]`` bit for bit, with the same plan, the same ``stats()``
(both count the whole exchange), the same ``on_round`` events and, summed
over the ranks, the same metric counter increments (the JAX controller
counts every rank's streams at once).  Arena and registry cases hold the
port's offsets, free extents, stats, bytes and errors to the JAX
package's.

The JAX ``test_exchange_padded_rejects_multiprocess`` has no
counterpart: the port is one process per device by design, and its
D = 2 and 4 worlds are the multi-process case.  The ``StagingPool``
and native cases of tests/test_memory.py wait for ``memory/staging.py``.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_byte_plane_worker as worker
from sparkrdma_tpu.conf import TpuShuffleConf
from sparkrdma_tpu.memory import arena as jarena
from sparkrdma_tpu.memory import device_arena as jdev
from sparkrdma_tpu.metrics import GLOBAL_REGISTRY as JREG
from sparkrdma_tpu.parallel import exchange as jex
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu.utils.types import BlockLocation as JBlockLocation
from sparkrdma_tpu_torch import ExchangeGroup
from sparkrdma_tpu_torch.memory import arena as tarena
from sparkrdma_tpu_torch.memory import device_arena as tdev
from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY as TREG
from sparkrdma_tpu_torch.parallel import exchange as tex
from sparkrdma_tpu_torch.transport.channel import TransportError
from sparkrdma_tpu_torch.utils.types import BlockLocation

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 180
DS = [1, 2, 4]
CPU = torch.device("cpu")


def _run_world(world, tmp):
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, str(pathlib.Path(worker.__file__)), str(r),
             str(world), str(store), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO),
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))  # written by our own workers
    return ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(D)``: each rank's case results; D = 1 in-process, D > 1
    in a gloo world spawned once per module and per D."""
    cache = {}

    def get(D):
        if D not in cache:
            if D == 1:
                cache[D] = [worker.run_cases(ExchangeGroup(device=CPU))]
            else:
                cache[D] = _run_world(D, tmp_path_factory.mktemp(f"gloo{D}"))
        return cache[D]

    return get


# -- the JAX side -------------------------------------------------------------


def _jax_counted(fn):
    prev = JREG.enabled
    JREG.reset()
    JREG.enabled = True
    try:
        res = fn()
        snap = JREG.snapshot()
    finally:
        JREG.enabled = prev
        JREG.reset()
    return res, {c["name"]: c["value"] for c in snap["counters"]}


def _rows(out, D):
    return [[bytes(memoryview(out[d][s])) for s in range(D)]
            for d in range(D)]


def _jax_cases(D):
    """The worker's cases through the JAX ``TileExchange`` on
    ``make_mesh(D)``, one controller holding every source row."""
    mesh = make_mesh(D)
    res = {}

    def ex(**kw):
        return jex.TileExchange(mesh, **kw)

    def bytes_case(name, streams, **kw):
        e = ex(**kw)
        out = e.exchange_bytes(streams)
        res[name] = dict(rows=_rows(out, D), stats=e.stats())

    bytes_case("single_round", worker.make_streams(0, D), tile_bytes=1 << 20)
    bytes_case("multi_round", worker.make_streams(1, D, max_len=20000),
               tile_bytes=512, max_rounds_in_flight=3)
    bytes_case("skewed", worker.skewed_streams(D), tile_bytes=1024)
    bytes_case("all_empty", [[b""] * D for _ in range(D)])
    bytes_case("integrity_ok", worker.make_streams(8, D, max_len=2000),
               tile_bytes=512, verify_integrity=True)

    lengths, streams = worker.random_plan(31, D, max_len=3000)
    e = ex(tile_bytes=1024, verify_integrity=True)
    out = e.exchange_bytes(streams, lengths=lengths)
    res["lengths_given"] = dict(rows=_rows(out, D), stats=e.stats())

    lengths, streams = worker.random_plan(32, D, max_len=20000)
    e = ex(tile_bytes=4096, verify_integrity=True)
    out, counters = _jax_counted(lambda: e.exchange_into(
        lengths, {s: worker.contig_row(lengths, streams, s)
                  for s in range(D)}))
    res["into"] = dict(rows=_rows(out, D), stats=e.stats(),
                       counters=counters)

    for name, (tile, window, seed, max_len) in worker.PADDED.items():
        lengths, streams = worker.random_plan(seed + D, D, max_len=max_len)
        e = ex(tile_bytes=tile, verify_integrity=True)
        cols = e.plan(lengths).total_cols
        events = []
        out, counters = _jax_counted(lambda: e.exchange_padded(
            lengths,
            {s: jex.PaddedSourceRow(
                worker.padded_row(lengths, streams, s, cols), cols)
             for s in range(D)},
            window_rounds=window,
            on_round=lambda r, lo, hi, rows: events.append((r, lo, hi))))
        e.exchange_into(lengths, {s: worker.contig_row(lengths, streams, s)
                                  for s in range(D)})
        res[name] = dict(rows=_rows(out, D), stats=e.stats(),
                         counters=counters, events=events,
                         streams=streams, plan=e.plan(lengths))

    e = ex()
    out = e.exchange_padded(np.zeros((D, D), np.int64),
                            {0: jex.PaddedSourceRow(np.empty(0, np.uint8),
                                                    0)})
    res["padded_empty"] = dict(rows=_rows(out, D), stats=e.stats())

    lengths, streams = worker.random_plan(9, D, max_len=500)
    e = ex(tile_bytes=1 << 12, verify_integrity=True)
    cols = e.plan(lengths).total_cols
    rows = {s: jex.PaddedSourceRow(
        worker.padded_row(lengths, streams, s, cols), cols)
        for s in range(D)}
    e.exchange_padded(lengths, rows)
    d_bad = int(np.argmax(lengths[0]))
    bad = rows[0].buf.copy()
    bad[d_bad * cols] ^= 0xFF
    out = e.exchange_padded(lengths,
                            {**rows, 0: jex.PaddedSourceRow(bad, cols)})
    res["padded_corrupt_row"] = dict(rows=_rows(out, D), d_bad=d_bad,
                                     stats=e.stats(), bad=int(bad[d_bad * cols]))

    x = worker.a2a_input(D)
    res["a2a"] = dict(out=np.asarray(ex().a2a(jnp.asarray(x))))
    return res


@pytest.fixture(scope="module")
def jax_ref():
    cache = {}

    def get(D):
        if D not in cache:
            cache[D] = _jax_cases(D)
        return cache[D]

    return get


def _check_rows(got_ranks, want, name, D, guarded=True):
    """Rank d's row is JAX's ``out[d]``, with JAX's stats; with
    ``guarded``, every other row refuses access."""
    for rank, r in enumerate(got_ranks):
        got = r[name]
        assert got["row"] == want["rows"][rank], (name, D, rank)
        assert got["others_refused"] == guarded or D == 1, (name, D, rank)
        assert got["stats"] == want["stats"], (name, D, rank)


# the bytes the port's exchange group sends to other ranks
# (``parallel/group.py``), which the JAX controller has no group to count
PORT_ONLY = ("exchange_bytes_total",)


def _summed_counters(got_ranks, name):
    """The counters summed over the ranks, but for :data:`PORT_ONLY`,
    which counts bytes exactly when the world has more than one rank."""
    total = {}
    for r in got_ranks:
        for k, v in r[name]["counters"].items():
            total[k] = total.get(k, 0) + v
    off_rank = sum(total.pop(k, 0) for k in PORT_ONLY)
    assert (off_rank > 0) == (len(got_ranks) > 1), (name, off_rank)
    return total


# -- exchange_bytes / exchange_into --------------------------------------------

BYTES_CASES = ["single_round", "multi_round", "skewed", "all_empty",
               "integrity_ok", "lengths_given"]


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", BYTES_CASES)
def test_exchange_bytes_matches_jax(ranks, jax_ref, name, D):
    """tests/test_exchange.py's exchanges (one round, many rounds through
    a window of 3, one huge pair and a self-loop, all empty, integrity
    on) and the rank-local contract (the whole lengths, only this rank's
    streams): rank d receives JAX's ``out[d]``."""
    got = ranks(D)
    want = jax_ref(D)[name]
    # an empty exchange is the plain all-empty list on every rank, as in
    # the JAX package; otherwise a plain list in a group of one and a
    # guarded row past it
    empty = name == "all_empty"
    _check_rows(got, want, name, D, guarded=not empty)
    if name != "lengths_given":
        assert all(r[name]["plain_list"] == (D == 1 or empty) for r in got)
    if name == "multi_round":
        assert want["stats"]["rounds_executed"] > 3
    if empty:
        assert want["stats"]["rounds_executed"] == 0


@pytest.mark.parametrize("D", DS)
def test_exchange_into_matches_jax(ranks, jax_ref, D):
    got = ranks(D)
    want = jax_ref(D)["into"]
    _check_rows(got, want, "into", D)
    assert _summed_counters(got, "into") == want["counters"]


# -- exchange_padded -----------------------------------------------------------


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", sorted(worker.PADDED))
def test_exchange_padded_matches_jax(ranks, jax_ref, name, D):
    """Full shot and windowed rounds, integrity on: each rank's row is
    JAX's, byte for byte, and equals ``exchange_into`` and the sent
    streams; the same stats, ``on_round`` events and (summed) counters."""
    got = ranks(D)
    want = jax_ref(D)[name]
    _check_rows(got, want, name, D)
    streams = want["streams"]
    for rank, r in enumerate(got):
        g = r[name]
        assert g["same_as_into"]
        assert g["row"] == [streams[s][rank] for s in range(D)]
        assert [e[:3] for e in g["events"]] == want["events"]
        assert all(e[3] for e in g["events"])
    assert _summed_counters(got, name) == want["counters"]


@pytest.mark.parametrize("D", DS)
def test_exchange_padded_on_round_sequence(ranks, jax_ref, D):
    """The windowed shape reports each landed round in order with the
    plan's [lo, hi) column spans."""
    want = jax_ref(D)["padded_w1_tiny"]
    plan = want["plan"]
    assert plan.rounds > 1
    for r in ranks(D):
        events = r["padded_w1_tiny"]["events"]
        assert [e[0] for e in events] == list(range(plan.rounds))
        assert events[0][1] == 0 and events[-1][2] == plan.total_cols
        for (_, _, hi_prev, _), (_, lo, _, _) in zip(events, events[1:]):
            assert lo == hi_prev


@pytest.mark.parametrize("D", DS)
def test_exchange_padded_empty_plan(ranks, jax_ref, D):
    want = jax_ref(D)["padded_empty"]
    for r in ranks(D):
        assert r["padded_empty"]["rows"] == want["rows"]
        assert r["padded_empty"]["stats"] == want["stats"]


@pytest.mark.parametrize("D", DS)
def test_exchange_padded_integrity_check(ranks, jax_ref, D):
    """A source row corrupted after framing: the exchange is
    self-consistent, so the integrity check passes and the corrupted
    byte arrives, as in the JAX package."""
    want = jax_ref(D)["padded_corrupt_row"]
    d_bad = want["d_bad"]
    got = ranks(D)
    _check_rows(got, want, "padded_corrupt_row", D)
    assert got[d_bad]["padded_corrupt_row"]["row"][0][0] == want["bad"]


@pytest.mark.parametrize("D", DS)
def test_exchange_padded_unaligned_row_ships_bytes(ranks, D):
    """Rank 0's row sits at an odd address, so it cannot ship 4-byte
    words: the ranks agree on uint8 lanes and every stream arrives."""
    for r in ranks(D):
        got = r["padded_unaligned"]
        assert got["row"] == got["sent"]
        assert got["others_refused"]
        assert got["stats"]["device_exchanges"] == 1


@pytest.mark.parametrize("D", DS)
def test_a2a_matches_jax(ranks, jax_ref, D):
    """Rank d's ``[D, C]`` goes out row by row; it gets JAX's
    ``out[d]``, from a tensor, a numpy array or int32 words."""
    want = jax_ref(D)["a2a"]["out"]
    for rank, r in enumerate(ranks(D)):
        got = r["a2a"]
        assert got["dtype"] == "torch.uint8"
        np.testing.assert_array_equal(got["out"], want[rank])
        np.testing.assert_array_equal(got["from_numpy"], want[rank])
        np.testing.assert_array_equal(got["int32"].view(np.uint8),
                                      want[rank])
        np.testing.assert_array_equal(got["odd_cols"], want[rank][:, :255])


def test_a2a_donate_and_shape():
    ex = tex.TileExchange(device=CPU)
    x = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    assert ex.a2a(x, donate=True) is x
    y = ex.a2a(x)
    assert y is not x and torch.equal(y, x)
    with pytest.raises(ValueError):
        ex.a2a(torch.zeros(2, 8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        jex.TileExchange(make_mesh(1)).a2a(jnp.zeros((2, 2, 8), jnp.uint8))


# -- plans, validation, views (host only) ---------------------------------------

PLAN_LENGTHS = {
    "tiles_and_rounds": (np.array([[0, 1000], [70000, 5]]), 16384),
    "tiny": (np.array([[3]]), 1 << 20),
    "empty": (np.zeros((4, 4), np.int64), 1 << 20),
    "exact_tile": (np.array([[4 << 20, 0], [0, 1]]), 4 << 20),
    "past_tile": (np.array([[(4 << 20) + 1, 7], [9, 0]]), 4 << 20),
}


def _plan_fields(p):
    return (p.tile_bytes, p.rounds, p.total_cols, p.payload_bytes,
            p.moved_bytes, p.n_devices,
            [p.round_slice(r) for r in range(p.rounds)])


@pytest.mark.parametrize("name", sorted(PLAN_LENGTHS))
def test_plan_matches_jax(name):
    lengths, tile = PLAN_LENGTHS[name]
    assert _plan_fields(tex.ExchangePlan(lengths, tile)) == \
        _plan_fields(jex.ExchangePlan(lengths, tile))


def test_plan_tile_ladder_matches_jax():
    """The power-of-two ladder of TILE_ALIGN units below the tile."""
    assert tex.TILE_ALIGN == jex.TILE_ALIGN
    for n in list(range(1, 100_000, 777)) + [4 << 20, 64 << 20,
                                             (4 << 20) + 1, 100_001]:
        lengths = np.zeros((4, 4), np.int64)
        lengths[0, 1] = n
        assert _plan_fields(tex.ExchangePlan(lengths, 4 << 20)) == \
            _plan_fields(jex.ExchangePlan(lengths, 4 << 20)), n


def _same_error(fn_t, fn_j, exc=ValueError):
    with pytest.raises(exc) as et:
        fn_t()
    with pytest.raises(exc) as ej:
        fn_j()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("lengths", [np.zeros((2, 3)),
                                     np.array([[-1, 0], [0, 0]]),
                                     np.zeros(4)])
def test_plan_validation_matches_jax(lengths):
    _same_error(lambda: tex.ExchangePlan(lengths, 1024),
                lambda: jex.ExchangePlan(lengths, 1024))


def _bad_calls(mod, ex):
    """Calls each package must refuse with the same ``ValueError``, on a
    group (mesh) of one."""
    good = np.array([[8]])
    return {
        "streams_shape": lambda: ex.exchange_bytes([[b""], [b""]]),
        "lengths_shape": lambda: ex.exchange_bytes([[b"x"]],
                                                   lengths=np.zeros((2, 2))),
        "lengths_mismatch": lambda: ex.exchange_bytes([[b"abc"]],
                                                      lengths=good),
        "into_negative": lambda: ex.exchange_into(np.array([[-1]]), {}),
        "into_missing_row": lambda: ex.exchange_into(good, {}),
        "into_row_size": lambda: ex.exchange_into(
            good, {0: np.zeros(7, np.uint8)}),
        "into_row_dtype": lambda: ex.exchange_into(
            good, {0: np.zeros(2, np.int32)}),
        "padded_shape": lambda: ex.exchange_padded(np.zeros((2, 2)), {}),
        "padded_missing_row": lambda: ex.exchange_padded(good, {}),
        "padded_cols": lambda: ex.exchange_padded(
            good, {0: mod.PaddedSourceRow(np.zeros(256, np.uint8), 256)}),
        "padded_row_size": lambda: ex.exchange_padded(
            good, {0: mod.PaddedSourceRow(np.zeros(64, np.uint8), 128)}),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls(tex, None)))
def test_exchange_validation_matches_jax(case):
    t = _bad_calls(tex, tex.TileExchange(device=CPU))[case]
    j = _bad_calls(jex, jex.TileExchange(make_mesh(1)))[case]
    _same_error(t, j)


def test_exchange_integrity_detects_corruption():
    """``_verify`` on a stream corrupted in flight raises the transport
    error with both CRCs, for the pairs whose source is vouched for."""
    D = 4
    ex = tex.TileExchange(device=CPU, tile_bytes=256, verify_integrity=True)
    streams = [[bytes([s * D + d]) * 100 for d in range(D)] for s in range(D)]
    received = [[bytearray(streams[s][d]) for s in range(D)]
                for d in range(D)]
    received[2][1][50] ^= 0xFF
    corrupted = [[bytes(b) for b in row] for row in received]
    with pytest.raises(tex.ExchangeIntegrityError) as ei:
        ex._verify(streams, corrupted, set(range(D)), frozenset(range(D)))
    assert isinstance(ei.value, TransportError)
    assert ex.stats()["integrity_failures"] == 1
    assert "1->2" in str(ei.value) and "crc32" in str(ei.value)
    assert ei.value.src == 1 and ei.value.dst == 2
    jx = jex.TileExchange(make_mesh(D), tile_bytes=256,
                          verify_integrity=True)
    with pytest.raises(jex.ExchangeIntegrityError) as ej:
        jx._verify(streams, corrupted, set(range(D)))
    assert str(ei.value) == str(ej.value)
    # this rank's own pairs only by default: the corrupt pair 1->2 is
    # another rank's to check
    ex._verify(streams, corrupted, {0})


def test_exchange_from_conf():
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.exchangeTileBytes": "128k",
        "spark.shuffle.tpu.exchangeMaxRoundsInFlight": "4",
        "spark.shuffle.tpu.verifyExchangeIntegrity": "true",
    })
    ex = tex.TileExchange.from_conf(conf, ExchangeGroup(device=CPU))
    jx = jex.TileExchange.from_conf(conf, make_mesh(1))
    assert (ex.tile_bytes, ex.max_rounds_in_flight, ex.verify_integrity) \
        == (jx.tile_bytes, jx.max_rounds_in_flight, jx.verify_integrity) \
        == (128 << 10, 4, True)
    ex2 = tex.TileExchange.from_conf(TpuShuffleConf(),
                                     ExchangeGroup(device=CPU))
    assert ex2.verify_integrity is False and ex2.device == CPU


def test_tile_exchange_runs_on_cuda_unless_asked(monkeypatch):
    """No group: a world of one on CUDA, which raises without CUDA
    rather than dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tex.TileExchange()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdev.DeviceArena(4096)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdev.DeviceStagingBridge()
    assert tex.TileExchange(device="cpu").n_devices == 1


def test_host_local_streams_guard():
    rows = [[b"aa", b"bb"], [b"cc", b"dd"]]
    res = tex.HostLocalStreams(rows, frozenset({1}), rank=1)
    assert len(res) == 2
    assert res[1] == [b"cc", b"dd"]
    with pytest.raises(tex.NonAddressableStreamError,
                       match="destination 0 .*group rank 1"):
        res[0]
    with pytest.raises(tex.NonAddressableStreamError):
        list(res)
    assert list(res.items()) == [(1, [b"cc", b"dd"])]
    assert isinstance(tex.NonAddressableStreamError(0), TransportError)


def test_row_offsets_and_padded_row_views():
    lengths = np.array([3, 0, 5, 2])
    np.testing.assert_array_equal(tex.row_offsets(lengths),
                                  jex.row_offsets(lengths))
    buf = np.arange(20, dtype=np.uint8)
    src = tex.PaddedSourceRow(buf, 10)
    assert src.nbytes == 20
    assert src.stream(0, 4).tolist() == [0, 1, 2, 3]
    assert src.stream(1, 3).tolist() == [10, 11, 12]
    mat = np.arange(12, dtype=np.uint8).reshape(2, 6)
    view = tex.PaddedDestRowView(mat, np.array([4, 2]))
    assert len(view) == 2
    assert view[0].tolist() == [0, 1, 2, 3]
    assert view[1].tolist() == [6, 7]
    assert view.nbytes == 6
    dv = tex.DestRowView(buf, tex.row_offsets([4, 6]))
    assert len(dv) == 2 and dv.nbytes == 10 and dv[1].tolist() == list(
        range(4, 10))


# -- DeviceStagingBridge ---------------------------------------------------------


def test_bridge_as_words_alignment():
    base = np.zeros(13, np.uint8)
    rows = [np.zeros(128, np.uint8), np.zeros(9, np.uint8), base[1:],
            np.zeros(0, np.uint8)]
    for row in rows:
        t = tdev.DeviceStagingBridge.as_words(row)
        j = jdev.DeviceStagingBridge.as_words(row)
        assert (t is None) == (j is None)
        if t is not None:
            assert t.dtype == j.dtype == np.uint32 and t.nbytes == row.nbytes
    assert tdev.DeviceStagingBridge.WORD == jdev.DeviceStagingBridge.WORD


def _port_counted(fn):
    prev = TREG.enabled
    TREG.reset()
    TREG.enabled = True
    try:
        res = fn()
        snap = TREG.snapshot()
    finally:
        TREG.enabled = prev
        TREG.reset()
    return res, {c["name"]: c["value"] for c in snap["counters"]}


def test_bridge_to_device_counts_avoided_bytes():
    bridge = tdev.DeviceStagingBridge(CPU)
    row = bridge.alloc_row(256)
    assert row.dtype == np.uint8 and row.shape == (256,)
    assert bridge.alloc_row(0).shape == (0,)
    row[:] = np.arange(256, dtype=np.uint8)
    arr, counters = _port_counted(
        lambda: bridge.to_device(row, CPU, avoided_bytes=row.nbytes))
    assert np.array_equal(arr.numpy(), row)
    row[0] = 99  # a copy, not a view of the row
    assert int(arr[0]) == 0
    jrow = jdev.DeviceStagingBridge().alloc_row(256)
    jrow[:] = row
    _, jcounters = _jax_counted(lambda: jdev.DeviceStagingBridge().to_device(
        jrow, jax.devices()[0], avoided_bytes=jrow.nbytes))
    assert counters == jcounters == {
        "device_exchange_h2d_bytes_avoided_total": 256}


# -- DeviceArena ---------------------------------------------------------------


def _arena_state(arena):
    return dict(stats=arena.stats(), free=list(arena._free))


def test_device_arena_sequence_matches_jax():
    """Alloc, free (coalescing both ways), write (padded to the size
    class) and read in one sequence: the port's spans, free extents,
    stats and bytes are the JAX arena's."""
    rng = np.random.default_rng(5)
    cap = (1 << 20) + 100  # rounds up to WRITE_ALIGN
    t = tdev.DeviceArena(cap, device=CPU)
    j = jdev.DeviceArena(cap, device=jax.devices()[0])
    assert (t.capacity, t.rows) == (j.capacity, j.rows)
    sizes = [100, 4096, 5000, 70_000, 3 << 14, 200_000, 1]
    tspans, jspans = [], []
    for n in sizes:
        a, b = t.alloc(n), j.alloc(n)
        assert (a.offset, a.nbytes) == (b.offset, b.nbytes), n
        tspans.append(a)
        jspans.append(b)
        data = rng.integers(0, 256, n, dtype=np.uint8)
        t.write(a, data)
        j.write(b, data)
    assert _arena_state(t) == _arena_state(j)
    for i in (1, 3, 2, 5):  # frees that coalesce left, right and both
        tspans[i].free()
        jspans[i].free()
        assert _arena_state(t) == _arena_state(j)
    tspans[1].free()  # a double free is a no-op
    for n in (9000, 300_000, 4096):
        a, b = t.alloc(n), j.alloc(n)
        assert (a.offset, a.nbytes) == (b.offset, b.nbytes), n
        data = rng.integers(0, 256, n, dtype=np.uint8)
        t.write(a, data)
        j.write(b, data)
    assert _arena_state(t) == _arena_state(j)
    for off, ln in ((0, 100), (4096, 5000), (3, 1000), (0, t.capacity),
                    (t.capacity - 7, 7)):
        assert t.read(off, ln) == j.read(off, ln), (off, ln)
    assert _arena_state(t) == _arena_state(j)


def test_device_arena_errors_match_jax():
    t = tdev.DeviceArena(1 << 16, device=CPU)
    j = jdev.DeviceArena(1 << 16, device=jax.devices()[0])
    a, b = t.alloc(100), j.alloc(100)
    _same_error(lambda: t.write(a, np.zeros(5000, np.uint8)),
                lambda: j.write(b, np.zeros(5000, np.uint8)))
    _same_error(lambda: t.read(-1, 4), lambda: j.read(-1, 4))
    _same_error(lambda: t.read(1 << 16, 1), lambda: j.read(1 << 16, 1))
    t.alloc(1 << 15)
    j.alloc(1 << 15)
    _same_error(lambda: t.alloc(1 << 15), lambda: j.alloc(1 << 15),
                MemoryError)


# -- ArenaManager (tests/test_memory.py's arena cases) ---------------------------


def test_arena_register_read_release():
    mgr = tarena.ArenaManager()
    data = np.arange(4096, dtype=np.uint8)
    seg = mgr.register(torch.from_numpy(data.copy()), shuffle_id=3)
    assert seg.mkey >= 1
    loc = BlockLocation(address=100, length=16, mkey=seg.mkey)
    assert mgr.read_block(loc) == bytes(data[100:116])
    assert mgr.total_bytes == 4096
    mgr.release(seg.mkey)
    with pytest.raises(TransportError):
        mgr.read_block(loc)
    assert mgr.total_bytes == 0


def test_arena_release_by_shuffle():
    mgr = tarena.ArenaManager()
    for sid in (1, 1, 2):
        mgr.register(torch.zeros(1024, dtype=torch.uint8), shuffle_id=sid)
    assert mgr.stats()["segments"] == 3
    assert mgr.release_shuffle(1) == 2
    assert mgr.stats()["segments"] == 1
    assert mgr.total_bytes == 1024


def test_arena_budget_and_validation():
    mgr = tarena.ArenaManager(max_bytes=2048)
    mgr.register(torch.zeros(2048, dtype=torch.uint8))
    with pytest.raises(MemoryError):
        mgr.register(torch.zeros(1, dtype=torch.uint8))
    j = jarena.ArenaManager(max_bytes=2048)
    for bad_t, bad_j in ((torch.zeros((2, 2), dtype=torch.uint8),
                          jnp.zeros((2, 2), jnp.uint8)),
                         (np.zeros((2, 2), np.uint8),
                          np.zeros((2, 2), np.uint8)),
                         (np.zeros(4, np.float32), np.zeros(4, np.float32))):
        _same_error(lambda: mgr.register(bad_t), lambda: j.register(bad_j))
    with pytest.raises(ValueError):
        mgr.register(torch.zeros(4, dtype=torch.float32))


def test_arena_out_of_bounds_read():
    mgr = tarena.ArenaManager()
    seg = mgr.register(torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(TransportError):
        mgr.read_block(BlockLocation(60, 8, seg.mkey))


def test_arena_unbudgeted_file_segment():
    arena = tarena.ArenaManager(max_bytes=1024)
    seg = arena.register(np.zeros(4096, np.uint8), budgeted=False)
    assert arena.total_bytes == 0
    assert arena.stats()["file_bytes"] == 4096
    arena.register(np.zeros(512, np.uint8))
    with pytest.raises(MemoryError):
        arena.register(np.zeros(1024, np.uint8))
    arena.release(seg.mkey)
    assert arena.stats()["file_bytes"] == 0


def test_segment_keepalive_released_with_segment():
    class FakeBuf:
        freed = 0

        def free(self):
            FakeBuf.freed += 1

    mgr = tarena.ArenaManager()
    seg = mgr.register(torch.zeros(64, dtype=torch.uint8), shuffle_id=1,
                       keepalive=FakeBuf())
    assert FakeBuf.freed == 0
    mgr.release(seg.mkey)
    assert FakeBuf.freed == 1
    mgr.register(torch.zeros(64, dtype=torch.uint8), shuffle_id=2,
                 keepalive=FakeBuf())
    mgr.release_shuffle(2)
    assert FakeBuf.freed == 2
    mgr.register(torch.zeros(64, dtype=torch.uint8), keepalive=FakeBuf())
    mgr.stop()
    assert FakeBuf.freed == 3


def test_read_spans_clustered_skips_large_gaps():
    fetched = []

    def fetch(lo, hi):
        fetched.append((lo, hi))
        return bytes(i % 251 for i in range(lo, hi))

    assert tarena.READ_MANY_MAX_GAP == jarena.READ_MANY_MAX_GAP
    far = tarena.READ_MANY_MAX_GAP * 3
    spans = [(far + 100, 50), (0, 10), (far + 500, 20), (40, 5)]
    out = tarena._read_spans_clustered(spans, fetch)
    assert len(fetched) == 2, fetched
    assert sum(hi - lo for lo, hi in fetched) < tarena.READ_MANY_MAX_GAP
    for (o, ln), b in zip(spans, out):
        assert b == bytes(i % 251 for i in range(o, o + ln))
    assert tarena._read_spans_clustered([], fetch) == []
    jfetched = []
    jarena._read_spans_clustered(
        spans, lambda lo, hi: jfetched.append((lo, hi)) or fetch(lo, hi))
    assert jfetched == fetched[2:]


def test_registry_reads_match_jax():
    """Device segments, host segments and arena spans behind one
    registry: mkeys, single and batched reads, stats and the release
    paths, against the JAX registry on the same bytes."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 3 << 16, dtype=np.uint8)
    t, j = tarena.ArenaManager(), jarena.ArenaManager()
    ta = tdev.DeviceArena(1 << 20, device=CPU)
    ja = jdev.DeviceArena(1 << 20, device=jax.devices()[0])
    segs = []
    for mgr, arena, as_dev in ((t, ta, torch.from_numpy),
                               (j, ja, jnp.asarray)):
        dev = mgr.register(as_dev(data.copy()), shuffle_id=1)
        host = mgr.register(data.copy(), shuffle_id=2, zero_copy_ok=True)
        span = arena.alloc(70_000)
        arena.write(span, data[:70_000])
        sp = mgr.register_arena_span(span, shuffle_id=1)
        segs.append((dev.mkey, host.mkey, sp.mkey))
    assert segs[0] == segs[1]
    spans = [(0, 100), (5000, 3), (60_000, 9999), (10, 1)]
    for mkey in segs[0]:
        locs = [BlockLocation(o, ln, mkey) for o, ln in spans]
        jlocs = [JBlockLocation(o, ln, mkey) for o, ln in spans]
        assert [bytes(b) for b in t.read_blocks(locs)] == \
            [bytes(b) for b in j.read_blocks(jlocs)]
        assert bytes(t.read_block(locs[2])) == bytes(j.read_block(jlocs[2]))
    assert t.stats() == j.stats()
    assert t.release_shuffle(1) == j.release_shuffle(1) == 2
    assert t.stats() == j.stats()
    assert ta.stats() == ja.stats()
    t.stop()
    j.stop()
    assert t.stats() == j.stats()
