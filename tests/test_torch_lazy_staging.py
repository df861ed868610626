"""The port's lazy-staging seams against the JAX package, on the CPU.

``lazyStaging=true`` keeps commits in host memory; on the windowed
plane each executor gets a device arena (the port's: a ``DeviceArena``
on the context's device, ``api.py``), and ``prefetch_shuffle`` stages a
shuffle's segments into it under their original mkeys (the port's
resolver copies them with ``_to_device``).  The cases of
tests/test_lazy_staging.py that need no ``CollectiveNetwork`` (a JAX
test fixture) run through both packages, the port on
``device="cpu"``, over ``LoopbackNetwork`` (no socket): the segment
types before and after the sweep, the mkeys, the sweep's counts, the
blocks read and the shuffle results must be equal.
"""

import importlib

import numpy as np
import pytest

ROOTS = ("sparkrdma_tpu", "sparkrdma_tpu_torch")


class Pkg:
    def __init__(self, root):
        imp = importlib.import_module
        self.port = root.endswith("_torch")
        self.api = imp(f"{root}.api")
        self.conf = imp(f"{root}.conf")
        self.arena = imp(f"{root}.memory.arena")
        self.part = imp(f"{root}.shuffle.partitioner")

    def Context(self, conf, base_port):
        kw = {"device": "cpu"} if self.port else {}
        return self.api.TpuShuffleContext(num_executors=2, conf=conf,
                                          base_port=base_port, **kw)

    def Conf(self, lazy, plane=None):
        conf = self.conf.TpuShuffleConf()
        if plane is not None:
            conf.set("readPlane", plane)
            conf.set("deviceArenaBytes", 8 << 20)
            conf.set("serializer", "columnar")
        if lazy:
            conf.set("lazyStaging", "true")
        return conf

    def segments(self, ex):
        """(mkey, staged in the device arena) of each committed
        segment, in mkey order."""
        with ex.arena._lock:
            segs = list(ex.arena._segments.values())
        return sorted((s.mkey, isinstance(s, self.arena.ArenaSpanSegment))
                      for s in segs)


@pytest.fixture(scope="module")
def pkgs(devices):
    return [Pkg(r) for r in ROOTS]


def both(pkgs, fn):
    """``fn`` through the JAX package, then the port; equal results."""
    want = fn(pkgs[0])
    got = fn(pkgs[1])
    assert got == want
    return got


def _bytes(block):
    return bytes(np.asarray(memoryview(block)).view(np.uint8).tobytes())


def test_lazy_without_device_arena_is_host_only(pkgs):
    """lazyStaging on the plain host plane: commits stay on the host,
    reads work, ``ensure_staged`` and the sweep do nothing."""
    def run(P):
        with P.Context(P.Conf(lazy=True), 54000) as ctx:
            handle = ctx.driver.register_shuffle(
                0, 1, P.part.HashPartitioner(4))
            ex = ctx.executors[0]
            assert ex.device_arena is None
            w = ex.get_writer(handle, 0)
            w.write([(i % 7, i) for i in range(400)])
            w.stop(True)
            segs = P.segments(ex)
            assert segs and not any(staged for _m, staged in segs)
            staged = ex.resolver.ensure_staged(segs[0][0])
            swept = ex.resolver.prefetch_shuffle(0)
            block = ex.resolver.get_local_block(0, 0, 0)
            assert isinstance(block, (bytes, np.ndarray, memoryview))
            return segs, staged, swept, P.segments(ex), _bytes(block)
    segs, staged, swept, after, _block = both(pkgs, run)
    assert staged is None and swept == 0 and after == segs


def test_lazy_staging_on_windowed_plane(pkgs):
    """The windowed plane: lazy commits stay on the host,
    ``prefetch_shuffle`` stages every segment under its original mkey,
    and the windowed read of the staged segments is exact."""
    def run(P):
        with P.Context(P.Conf(lazy=True, plane="windowed"), 57000) as ctx:
            part = P.part.HashPartitioner(4)
            handle = ctx.driver.register_shuffle(9, 2, part)
            maps_by_host = {}
            for map_id in range(2):
                ex = ctx.executors[map_id]
                w = ex.get_writer(handle, map_id)
                w.write([(i % 5, i) for i in range(300)])
                w.stop(True)
                maps_by_host.setdefault(ex.local_smid, []).append(map_id)
            before = [P.segments(ex) for ex in ctx.executors]
            swept = [ex.resolver.prefetch_shuffle(9) for ex in ctx.executors]
            after = [P.segments(ex) for ex in ctx.executors]
            # every host joins the window collectives before any
            # sequential read blocks
            for ex in ctx.executors:
                ex.windowed_plane.join(9)
            got = {}
            for pid in range(4):
                reader = ctx.executors[pid % 2].get_reader(
                    handle, pid, pid + 1, dict(maps_by_host))
                for k, v in reader.read():
                    got.setdefault(int(k), []).extend(
                        np.asarray(v).ravel().tolist()
                        if hasattr(v, "__len__") else [int(v)])
            return before, swept, after, {k: sorted(v)
                                          for k, v in got.items()}
    before, swept, after, got = both(pkgs, run)
    for b, s, a in zip(before, swept, after):
        assert b and not any(staged for _m, staged in b)
        assert s >= 1
        # the same mkeys, every one now an arena span
        assert [m for m, _s in a] == [m for m, _s in b]
        assert all(staged for _m, staged in a)
    assert sum(map(len, got.values())) == 600
    assert got == {k: sorted(2 * list(range(k, 300, 5))) for k in range(5)}


def test_lazy_read_result_matches_eager(pkgs):
    """A reduceByKey on the windowed plane gives the same result with
    lazy staging and without."""
    data = [(i % 11, i) for i in range(2000)]

    def run(P):
        res = []
        for lazy, port in ((False, 55000), (True, 56000)):
            with P.Context(P.Conf(lazy=lazy, plane="windowed"),
                           port) as ctx:
                res.append(sorted(
                    ctx.parallelize(data, num_slices=4)
                    .reduce_by_key(lambda a, b: a + b, num_partitions=4)
                    .collect()))
        return res
    eager, lazy = both(pkgs, run)
    assert lazy == eager
    assert eager == sorted((k, sum(range(k, 2000, 11))) for k in range(11))
