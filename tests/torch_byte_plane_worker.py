"""One rank of a gloo world for tests/test_torch_byte_plane.py.

    python tests/torch_byte_plane_worker.py RANK WORLD STORE_FILE OUT_DIR

Joins a ``world``-rank gloo group over a ``file://`` store (no TCP
port), runs every case of :data:`CASES` on this rank through the port's
``TileExchange`` (rank-locally: each rank passes the same lengths and
its own source row, and keeps its own destination row), and pickles
the results to ``OUT_DIR/rank<RANK>.pkl``.  Imports torch, numpy and
``sparkrdma_tpu_torch`` only: neither JAX nor the tests' conftest.  The
test module imports it for the input builders and runs the same cases
in-process at D = 1, so both sides build the same inputs from the same
seeds.
"""

import os
import pickle
import sys

import numpy as np
import torch


# -- inputs ------------------------------------------------------------------


def make_streams(seed, D, max_len=5000):
    """``streams[s][d]``: random bytes of random length below
    ``max_len`` (tests/test_exchange.py's builder)."""
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 256, size=int(rng.integers(0, max_len)),
                      dtype=np.uint8).tobytes() for _ in range(D)]
        for _ in range(D)
    ]


def random_plan(seed, D, max_len=4000):
    """(lengths, streams) of tests/test_device_exchange.py."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, size=(D, D)).astype(np.int64)
    streams = [[rng.bytes(int(lengths[s, d])) for d in range(D)]
               for s in range(D)]
    return lengths, streams


def skewed_streams(D):
    """One huge pair, one self-loop, everything else empty."""
    streams = [[b"" for _ in range(D)] for _ in range(D)]
    streams[0][D - 1] = bytes(range(256)) * 100
    streams[min(3, D - 1)][min(3, D - 1)] = b"self-loop"
    return streams


def padded_row(lengths, streams, s, cols):
    """Source ``s``'s payload in the padded device framing."""
    D = len(streams)
    buf = np.zeros(D * cols, np.uint8)
    for d in range(D):
        n = int(lengths[s, d])
        if n:
            buf[d * cols:d * cols + n] = np.frombuffer(streams[s][d],
                                                       np.uint8)
    return buf


def contig_row(lengths, streams, s):
    """Source ``s``'s payload laid out per ``row_offsets(lengths[s])``."""
    return np.frombuffer(b"".join(streams[s]), np.uint8).copy()


def a2a_input(D):
    rng = np.random.default_rng(2)
    return rng.integers(0, 256, size=(D, D, 256), dtype=np.uint8)


# tile, window and seed of each exchange_padded case (D is added to the
# seed, as tests/test_device_exchange.py does)
PADDED = {"padded_w0": (1 << 16, 0, 20, 90_000),
          "padded_w2": (1 << 16, 2, 22, 90_000),
          "padded_w1_tiny": (1 << 10, 1, 5, 4_000)}


# -- cases -------------------------------------------------------------------


def _counted(fn):
    """(result of ``fn()``, the port's counter values it added)."""
    from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY

    prev = GLOBAL_REGISTRY.enabled
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        res = fn()
        snap = GLOBAL_REGISTRY.snapshot()
    finally:
        GLOBAL_REGISTRY.enabled = prev
        GLOBAL_REGISTRY.reset()
    return res, {c["name"]: c["value"] for c in snap["counters"]}


def _own_row(out, rank, D):
    """This rank's destination row as bytes, and whether every other
    row refuses access."""
    from sparkrdma_tpu_torch.parallel.exchange import (
        NonAddressableStreamError,
    )

    row = [bytes(memoryview(out[rank][s])) for s in range(D)]
    others = True
    for d in range(D):
        if d == rank:
            continue
        try:
            out[d]
            others = False
        except NonAddressableStreamError:
            pass
    return row, others


def run_cases(group):
    """Every case on ``group`` (an ``ExchangeGroup``): name -> result."""
    from sparkrdma_tpu_torch.parallel.exchange import (
        PaddedSourceRow,
        TileExchange,
    )

    rank, D = group.rank, group.size
    res = {}

    def ex(**kw):
        return TileExchange(group, **kw)

    def bytes_case(name, streams, **kw):
        e = ex(**kw)
        out = e.exchange_bytes(streams)
        row, others = _own_row(out, rank, D)
        res[name] = dict(row=row, others_refused=others, stats=e.stats(),
                         plain_list=isinstance(out, list))

    bytes_case("single_round", make_streams(0, D), tile_bytes=1 << 20)
    bytes_case("multi_round", make_streams(1, D, max_len=20000),
               tile_bytes=512, max_rounds_in_flight=3)
    bytes_case("skewed", skewed_streams(D), tile_bytes=1024)
    bytes_case("all_empty", [[b""] * D for _ in range(D)])
    bytes_case("integrity_ok",
               make_streams(8, D, max_len=2000), tile_bytes=512,
               verify_integrity=True)

    # the rank-local contract: the whole lengths matrix, only this
    # rank's row of streams
    lengths, streams = random_plan(31, D, max_len=3000)
    mine = [[streams[s][d] if s == rank else b"" for d in range(D)]
            for s in range(D)]
    e = ex(tile_bytes=1024, verify_integrity=True)
    out = e.exchange_bytes(mine, lengths=lengths)
    row, others = _own_row(out, rank, D)
    res["lengths_given"] = dict(row=row, others_refused=others,
                                stats=e.stats())

    # exchange_into over contiguous rows
    lengths, streams = random_plan(32, D, max_len=20000)
    e = ex(tile_bytes=4096, verify_integrity=True)
    out, counters = _counted(lambda: e.exchange_into(
        lengths, {rank: contig_row(lengths, streams, rank)}))
    row, others = _own_row(out, rank, D)
    res["into"] = dict(row=row, others_refused=others, stats=e.stats(),
                       counters=counters)

    # exchange_padded: full shot and windowed, bit-exact with
    # exchange_into
    for name, (tile, window, seed, max_len) in PADDED.items():
        lengths, streams = random_plan(seed + D, D, max_len=max_len)
        e = ex(tile_bytes=tile, verify_integrity=True)
        cols = e.plan(lengths).total_cols
        events = []
        out, counters = _counted(lambda: e.exchange_padded(
            lengths,
            {rank: PaddedSourceRow(padded_row(lengths, streams, rank, cols),
                                   cols)},
            window_rounds=window,
            on_round=lambda r, lo, hi, rows: events.append(
                (r, lo, hi, rows[rank] is not None))))
        ref = e.exchange_into(lengths,
                              {rank: contig_row(lengths, streams, rank)})
        row, others = _own_row(out, rank, D)
        res[name] = dict(
            row=row, others_refused=others, stats=e.stats(),
            counters=counters, events=events,
            same_as_into=row == [bytes(memoryview(ref[rank][s]))
                                 for s in range(D)])

    # exchange_padded over an empty plan
    e = ex()
    out = e.exchange_padded(np.zeros((D, D), np.int64),
                            {rank: PaddedSourceRow(np.empty(0, np.uint8),
                                                   0)})
    res["padded_empty"] = dict(
        rows=[[bytes(memoryview(out[d][s])) for s in range(D)]
              for d in range(D)], stats=e.stats())

    # a source row corrupted after framing rides through unchanged: the
    # exchange is self-consistent, the integrity check passes
    lengths, streams = random_plan(9, D, max_len=500)
    e = ex(tile_bytes=1 << 12, verify_integrity=True)
    cols = e.plan(lengths).total_cols
    buf = padded_row(lengths, streams, rank, cols)
    e.exchange_padded(lengths, {rank: PaddedSourceRow(buf, cols)})
    d_bad = int(np.argmax(lengths[0]))
    if rank == 0:
        buf = buf.copy()
        buf[d_bad * cols] ^= 0xFF
    out = e.exchange_padded(lengths, {rank: PaddedSourceRow(buf, cols)})
    row, others = _own_row(out, rank, D)
    res["padded_corrupt_row"] = dict(row=row, others_refused=others,
                                     d_bad=d_bad, stats=e.stats())

    # one rank's row cannot take the 4-byte view (its base address is
    # odd): every rank must ship uint8 lanes, or the collective's element
    # type would differ between ranks
    lengths, streams = random_plan(41, D, max_len=3000)
    e = ex(tile_bytes=1 << 12, verify_integrity=True)
    cols = e.plan(lengths).total_cols
    buf = np.zeros(D * cols + 1, np.uint8)
    buf = buf[1:] if rank == 0 else buf[:-1]
    buf[:] = padded_row(lengths, streams, rank, cols)
    out = e.exchange_padded(lengths, {rank: PaddedSourceRow(buf, cols)})
    row, others = _own_row(out, rank, D)
    res["padded_unaligned"] = dict(
        row=row, others_refused=others, stats=e.stats(),
        sent=[streams[s][rank] for s in range(D)])

    # a2a of this rank's [D, C] tensor, as bytes and as int32 words
    x = a2a_input(D)
    e = ex()
    got = e.a2a(torch.from_numpy(x[rank].copy()))
    got_np = e.a2a(x[rank])
    got_i32 = e.a2a(torch.from_numpy(x[rank].view(np.int32).copy()))
    got_u8 = e.a2a(torch.from_numpy(x[rank][:, :255].copy()))  # uint8
    res["a2a"] = dict(out=got.numpy(), from_numpy=got_np.numpy(),
                      int32=got_i32.numpy(), dtype=str(got.dtype),
                      odd_cols=got_u8.numpy())
    return res


CASES = ("single_round", "multi_round", "skewed", "all_empty",
         "integrity_ok", "lengths_given", "into", *PADDED, "padded_empty",
         "padded_corrupt_row", "padded_unaligned", "a2a")


def run_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from sparkrdma_tpu_torch import ExchangeGroup

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = run_cases(ExchangeGroup(dist.group.WORLD, device="cpu"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
