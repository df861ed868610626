"""The port's copies of the JAX package's host planes held against the
originals: the RPC wire bytes, the serializers and columnar batches,
every conf key, the native staging library (built here with g++ from
``native/staging_allocator.cpp``) against the JAX package's committed
``_staging.so``, the import purity of every module of the port, and the
repo's four static analysers (``tools/``) over the port."""

import base64
import dataclasses
import importlib.util
import inspect
import json
import pathlib
import pickle
import random

import numpy as np
import pytest

import sparkrdma_tpu.memory.staging as jstaging
import sparkrdma_tpu.rpc.messages as jmsg
import sparkrdma_tpu.utils.types as jtypes
import sparkrdma_tpu_torch.memory.staging as tstaging
import sparkrdma_tpu_torch.rpc.messages as tmsg
import sparkrdma_tpu_torch.utils.types as ttypes
from sparkrdma_tpu import conf as jconf
from sparkrdma_tpu.utils import columns as jcols
from sparkrdma_tpu.utils import serde as jserde
from sparkrdma_tpu_torch import conf as tconf
from sparkrdma_tpu_torch.utils import columns as tcols
from sparkrdma_tpu_torch.utils import serde as tserde

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "data" /
                     "wire_golden_frames.json").read_text())


def _golden_frames():
    out = {}
    for name, rec in sorted(GOLDEN.items()):
        frames = rec["frames"] if "frames" in rec else [rec["frame"]]
        out[name] = [base64.b64decode(f) for f in frames]
    return out


FRAMES = _golden_frames()


# -- rpc wire bytes -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_golden_frame_decodes_and_reencodes_in_port(name):
    """Every golden frame decodes in the port as the recorded class and
    re-encodes to the same bytes, as it does in the JAX package."""
    for frame in FRAMES[name]:
        msg = tmsg.decode_msg(frame)
        assert type(msg).__name__ == GOLDEN[name]["cls"]
        assert msg.encode() == frame == jmsg.decode_msg(frame).encode()


def _seeded_value(v, rng, types):
    """A seeded stand-in of the same shape as ``v``, built from one
    package's types (``types`` is its ``utils/types.py``)."""
    if isinstance(v, bool):
        return bool(rng.getrandbits(1))
    if isinstance(v, int):
        return rng.randrange(0, 1 << 20)
    if isinstance(v, str):
        return "".join(rng.choice("abcxyz0189-_.") for _ in v)
    if isinstance(v, bytes):
        return bytes(rng.getrandbits(8) for _ in v)
    if type(v).__name__ == "ShuffleManagerId":
        i = rng.randrange(1 << 12)
        return types.ShuffleManagerId(
            f"host{i}.example", rng.randrange(1, 1 << 16),
            types.BlockManagerId(f"exec-{i}", f"host{i}.example",
                                 rng.randrange(1, 1 << 16)))
    if type(v).__name__ == "BlockLocation":
        return types.BlockLocation(rng.randrange(1 << 40),
                                   rng.randrange(1 << 30),
                                   rng.randrange(1, 1 << 30))
    if isinstance(v, tuple):
        return tuple(_seeded_value(e, rng, types) for e in v)
    raise TypeError(type(v))


def _seeded_msg(frame, mod, types, seed):
    """The golden frame's message with every field replaced by a seeded
    value of the same shape (the entries table keeps its length)."""
    msg = mod.decode_msg(frame)
    rng = random.Random(seed)
    fields = {f.name: _seeded_value(getattr(msg, f.name), rng, types)
              for f in dataclasses.fields(msg)}
    if "entries" in fields:  # the reduce range must match the table
        fields["last_reduce_id"] = (fields["first_reduce_id"] - 1 +
                                    len(fields["entries"]) //
                                    types.LOCATION_ENTRY_SIZE)
    return type(msg)(**fields)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_seeded_messages_same_bytes_and_decode_across(name):
    """Seeded messages of every class encode to the same bytes in both
    packages, and each package decodes the other's frames back to the
    same bytes (JAX -> port and port -> JAX)."""
    frame = FRAMES[name][0]
    for seed in range(3):
        try:
            jm = _seeded_msg(frame, jmsg, jtypes, seed)
            jb = jm.encode()
        except (ValueError, TypeError) as e:
            # a class whose fields constrain each other rejects the
            # seeded values: the port must reject them the same way
            with pytest.raises(type(e)):
                tmsg_ = _seeded_msg(frame, tmsg, ttypes, seed)
                tmsg_.encode()
            continue
        tm = _seeded_msg(frame, tmsg, ttypes, seed)
        tb = tm.encode()
        assert tb == jb
        assert jmsg.decode_msg(tb).encode() == jb
        assert tmsg.decode_msg(jb).encode() == tb
        for size in (128, 512):
            try:
                jseg = jm.encode_segments(max_segment_size=size)
            except ValueError:
                with pytest.raises(ValueError):
                    tm.encode_segments(max_segment_size=size)
                continue
            assert tm.encode_segments(max_segment_size=size) == jseg


def test_message_type_table_matches():
    assert {k: v.__name__ for k, v in tmsg.MSG_TYPES.items()} == \
        {k: v.__name__ for k, v in jmsg.MSG_TYPES.items()}
    for k, cls in jmsg.MSG_TYPES.items():
        tcls = tmsg.MSG_TYPES[k]
        assert [(f.name, f.kind, f.code, f.since)
                for f in tcls.WIRE_SCHEMA] == \
            [(f.name, f.kind, f.code, f.since) for f in cls.WIRE_SCHEMA]


# -- serializers and columns --------------------------------------------------


def _records(seed, n=500):
    rng = random.Random(seed)
    return [(rng.randrange(-1000, 1000),
             rng.choice([rng.random(), "v" * rng.randrange(30), (1, "t"),
                         rng.randrange(1 << 40), b"\x00raw"]))
            for _ in range(n)]


SERIALIZERS = {
    "pickle": lambda m: m.PickleSerializer(),
    "pickle_batch7": lambda m: m.PickleSerializer(batch_size=7),
    "zlib": lambda m: m.CompressedSerializer(frame_records=64),
    "lzma": lambda m: m.CompressedSerializer(codec="lzma", min_size=16),
}


@pytest.mark.parametrize("ser", list(SERIALIZERS))
def test_record_serializer_bytes_equal(ser):
    recs = _records(1)
    jb = SERIALIZERS[ser](jserde).serialize(recs)
    tb = SERIALIZERS[ser](tserde).serialize(recs)
    assert tb == jb
    assert list(SERIALIZERS[ser](tserde).deserialize(jb)) == recs
    assert SERIALIZERS[ser](tserde).frame_spans(tb) == \
        SERIALIZERS[ser](jserde).frame_spans(jb)


def _batch(mod, seed, n=3000, val="i8"):
    rng = np.random.default_rng(seed)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                        dtype=np.int64)
    keys[: n // 3] = rng.integers(0, 40, n // 3)
    if val == "S12":
        vals = np.frombuffer(rng.bytes(n * 12), dtype="S12")
    else:
        vals = rng.integers(-5, 5, n).astype(val)
    return mod.ColumnBatch(keys, vals)


@pytest.mark.parametrize("val", ["i8", "f4", "S12"])
@pytest.mark.parametrize("compressed", [False, True])
def test_columnar_serializer_bytes_equal(val, compressed):
    def ser(m):
        s = m.ColumnarSerializer()
        return m.CompressedSerializer(s) if compressed else s

    jb = ser(jserde).serialize(_batch(jcols, 3, val=val))
    tb = ser(tserde).serialize(_batch(tcols, 3, val=val))
    assert tb == jb
    back = list(ser(tserde).deserialize_columns(jb))
    ref = list(ser(jserde).deserialize_columns(jb))
    assert len(back) == len(ref)
    for a, b in zip(back, ref):
        assert a.keys.tobytes() == b.keys.tobytes()
        assert a.vals.tobytes() == b.vals.tobytes()


@pytest.mark.parametrize("kind", ["sum", "min", "max", "group"])
def test_column_kernels_equal(kind):
    jb, tb = _batch(jcols, 5), _batch(tcols, 5)
    for fn in ("stable_key_order",):
        assert np.array_equal(getattr(tcols, fn)(tb.keys),
                              getattr(jcols, fn)(jb.keys))
    a, b = tcols.combine_columns(tb, kind), jcols.combine_columns(jb, kind)
    assert a.keys.tobytes() == b.keys.tobytes()
    assert a.vals.tobytes() == b.vals.tobytes()
    (ka, ga), (kb, gb) = tcols.group_columns(tb), jcols.group_columns(jb)
    assert ka.tobytes() == kb.tobytes()
    assert pickle.dumps([v.tobytes() for v in ga]) == \
        pickle.dumps([v.tobytes() for v in gb])
    idx = np.random.default_rng(9).integers(0, len(tb), 700)
    assert np.array_equal(tcols.take_rows(tb.vals, idx),
                          jcols.take_rows(jb.vals, idx))


# -- conf ---------------------------------------------------------------------


def _conf_properties():
    return sorted(n for n, o in inspect.getmembers(
        jconf.TpuShuffleConf, lambda o: isinstance(o, property)))


def _read(conf, name):
    try:
        v = getattr(conf, name)
    except Exception as e:  # a property that refuses this conf
        return ("raises", type(e).__name__)
    return repr(v)


CONF_DICTS = [
    {},
    {"spark.shuffle.tpu.deviceCensus": 4,
     "spark.shuffle.tpu.readPlane": "host",
     "spark.shuffle.tpu.serializer": "columnar",
     "spark.shuffle.tpu.compress": "true",
     "spark.shuffle.tpu.shuffleSpillRecordThreshold": "1k",
     "spark.shuffle.tpu.partitionLocationFetchTimeout": "250ms",
     "spark.shuffle.rdma.shuffleReadBlockSize": "2m",
     "spark.shuffle.tpu.maxBufferAllocationSize": "garbage"},
]


@pytest.mark.parametrize("census", [1, 8])
@pytest.mark.parametrize("which", range(len(CONF_DICTS)))
def test_conf_same_value_for_every_key(which, census):
    props = _conf_properties()
    assert props == sorted(n for n, o in inspect.getmembers(
        tconf.TpuShuffleConf, lambda o: isinstance(o, property)))
    d = dict(CONF_DICTS[which])
    d.setdefault("spark.shuffle.tpu.deviceCensus", census)
    jc, tc = jconf.TpuShuffleConf(dict(d)), tconf.TpuShuffleConf(dict(d))
    diff = {n: (_read(jc, n), _read(tc, n)) for n in props
            if _read(jc, n) != _read(tc, n)}
    assert not diff


def test_conf_device_census_without_setting():
    """Without ``deviceCensus`` the port counts CUDA devices (1 on a
    host without CUDA), never the XLA_FLAGS forcing the JAX package
    reads."""
    import torch

    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert tconf.device_census() == want
    assert tconf.TpuShuffleConf().device_census == want
    assert tconf.TpuShuffleConf(
        {"spark.shuffle.tpu.deviceCensus": 6}).device_census == 6


# -- the native staging library ----------------------------------------------


def test_native_library_builds_from_source():
    lib = tstaging._lib()
    assert lib is not None
    path = pathlib.Path(tstaging.BUILD_INFO["path"])
    assert path.is_file() and path.parent.parent == tstaging.BUILD_DIR
    assert path.parent.name == f"staging-{tstaging.source_hash()}"
    assert tstaging.SOURCE == REPO / "native" / "staging_allocator.cpp"
    assert jstaging._NATIVE is not None  # the committed library


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tstaging, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(tstaging.StagingBuildError):
        tstaging.source_hash()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tstaging, "SOURCE", bad)
    monkeypatch.setattr(tstaging, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(tstaging.StagingBuildError, match="g\\+\\+ failed"):
        tstaging._build(tmp_path / "build" / "out")


I64 = np.iinfo(np.int64)


def _edge_keys(seed, n):
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    if n == 0:
        return k
    edges = np.array([I64.min, I64.max, 0, -1, 1, I64.min + 1, I64.max - 1,
                      1 << 32, -(1 << 32), (1 << 48) + 7], np.int64)
    k[rng.integers(0, n, 3 * len(edges))] = np.tile(edges, 3)
    return k


@pytest.mark.parametrize("n", [0, 1, 17, 5000, 70000])
def test_native_radix_argsort_equal(n):
    keys = _edge_keys(n, n)
    a, b = tstaging.native_radix_argsort(keys), \
        jstaging.native_radix_argsort(keys)
    assert a is not None and np.array_equal(a, b)
    assert np.array_equal(keys[a], np.sort(keys, kind="stable"))


@pytest.mark.parametrize("P,krange", [(4, 100), (7, 9000), (64, 1024)])
def test_native_hash_partition_order_equal(P, krange):
    rng = np.random.default_rng(P)
    kmin = -(krange // 3)
    keys = rng.integers(kmin, kmin + krange, 20000).astype(np.int64)
    a = tstaging.native_hash_partition_order(keys, P, kmin, krange)
    b = jstaging.native_hash_partition_order(keys, P, kmin, krange)
    assert a is not None and b is not None
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("runs", [1, 3, 16])
def test_native_kway_merge_equal(runs):
    rng = np.random.default_rng(runs)
    parts = [np.sort(_edge_keys(runs * 10 + i, int(rng.integers(0, 900))),
                     kind="stable") for i in range(runs)]
    keys = np.concatenate(parts) if parts else np.empty(0, np.int64)
    offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])]) \
        .astype(np.int64)
    a = tstaging.native_kway_merge(keys, offs)
    b = jstaging.native_kway_merge(keys, offs)
    assert a is not None and np.array_equal(a, b)
    assert np.array_equal(a, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("distinct", [1, 300, 65536, 65537])
def test_native_rank_compress_equal(distinct):
    rng = np.random.default_rng(distinct)
    pool = _edge_keys(distinct, max(distinct, 10))[:distinct]
    pool = np.unique(np.concatenate([pool, rng.integers(
        I64.min, I64.max, distinct, dtype=np.int64)]))[:distinct]
    keys = pool[rng.integers(0, len(pool), 100000)]
    keys[: len(pool)] = pool
    a = tstaging.native_rank_compress(keys)
    b = jstaging.native_rank_compress(keys)
    if b is None:
        assert a is None and distinct > 65536
        return
    assert a[1] == b[1] and np.array_equal(a[0], b[0])


def test_native_gather_blocks_equal():
    rng = np.random.default_rng(4)
    blocks = [rng.integers(0, 256, int(rng.integers(0, 5000)),
                           dtype=np.uint8) for _ in range(40)]
    lens = np.array([len(b) for b in blocks], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens + 3)[:-1]]).astype(np.int64)
    addrs = np.array([b.ctypes.data for b in blocks], np.uint64)
    total = int(offs[-1] + lens[-1])
    outs = []
    for mod in (tstaging, jstaging):
        dst = np.full(total, 7, np.uint8)
        assert mod.native_gather_blocks(dst, addrs, lens, offs)
        outs.append(dst)
    assert np.array_equal(outs[0], outs[1])
    for b, o in zip(blocks, offs):
        assert np.array_equal(outs[0][o:o + len(b)], b)


def _pool_script(mod, force_python):
    pool = mod.StagingPool(4 << 20, force_python=force_python)
    stats = [pool.stats()]
    bufs = [pool.alloc(n) for n in (100, 16 << 10, 70000, 1 << 20, 5)]
    stats.append(pool.stats())
    for b in bufs[::2]:
        b.free()
    stats.append(pool.stats())
    views = [pool.alloc_gc(3000) for _ in range(4)]
    stats.append(pool.stats())
    del views
    try:
        pool.alloc(8 << 20)
    except MemoryError:
        stats.append("exhausted")
    pool.trim(0)
    stats.append(pool.stats())
    for b in bufs[1::2]:
        b.free()
    pool.close()
    return pool.is_native, stats


@pytest.mark.parametrize("force_python", [False, True])
def test_staging_pool_stats_equal(force_python):
    import gc

    gc.collect()
    t = _pool_script(tstaging, force_python)
    gc.collect()
    j = _pool_script(jstaging, force_python)
    assert t == j
    assert t[0] is (not force_python)


# -- import purity and the analysers -----------------------------------------


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"sparkrdma_tpu_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm(findings, pkg):
    """Findings keyed by path inside the package, code and message, so
    the port's copy of a file lines up with its original."""
    out = {}
    for rel, _line, code, msg in findings:
        key = (str(rel).split(f"{pkg}/", 1)[-1], code,
               msg.replace("sparkrdma_tpu_torch", "sparkrdma_tpu"))
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("tool", ["concheck", "statecheck", "wirecheck",
                                  "flowcheck"])
def test_analyser_finds_nothing_new_in_port(tool):
    """Each analyser reports nothing over ``sparkrdma_tpu_torch/`` that
    it does not also report over the JAX original."""
    mod = _load_tool(tool)
    if tool == "wirecheck":
        jax_paths = list(mod.DEFAULT_PATHS)
        port_paths = [REPO / "sparkrdma_tpu_torch" /
                      p.relative_to(REPO / "sparkrdma_tpu")
                      for p in jax_paths]
    else:
        jax_paths = [REPO / "sparkrdma_tpu"]
        port_paths = [REPO / "sparkrdma_tpu_torch"]
    ref = _norm(mod.analyze(jax_paths, REPO), "sparkrdma_tpu")
    port = _norm(mod.analyze(port_paths, REPO), "sparkrdma_tpu_torch")
    extra = {k: n for k, n in port.items() if n > ref.get(k, 0)}
    assert not extra, extra
