"""The port's storage and wire-format conf matrix held against the JAX
package: the twin of tests/test_conf_matrix.py.

Every cell of serializer x compress x spill x directIO runs ``group``,
``reduce`` and ``sort`` through ``TpuShuffleContext`` in both packages on
the same seeded records, with map outputs staged to the device (CPU
tensors in the port, JAX CPU arrays in the reference) and kept on the
host.  The port's results must equal the JAX package's and a Python
oracle, its spill count and spilled bytes must equal the JAX run's, and
neither may leave a spill or shuffle file behind.  The helpers here
(``Pkg``, ``counters``, ``canon``, ``oracle``) and fixtures are shared
with tests/test_torch_features.py.
"""

import importlib
from collections import defaultdict

import numpy as np
import pytest

OPS = ("group", "reduce", "sort")
STAGES = [pytest.param(False, id="host"), pytest.param(True, id="staged")]


class Pkg:
    """One package's record-plane entry points, and the keyword
    arguments they need on the CPU."""

    def __init__(self, root: str, kw: dict):
        imp = importlib.import_module
        self.name = root
        self.api = imp(f"{root}.api")
        self.conf = imp(f"{root}.conf")
        self.manager = imp(f"{root}.shuffle.manager")
        self.part = imp(f"{root}.shuffle.partitioner")
        self.reader = imp(f"{root}.shuffle.reader")
        self.transport = imp(f"{root}.transport")
        self.columns = imp(f"{root}.utils.columns")
        self.registry = imp(f"{root}.metrics").GLOBAL_REGISTRY
        self.faults = imp(f"{root}.faults.injector").FAULTS
        self.skew = imp(f"{root}.skew.registry")
        self.qos = imp(f"{root}.qos.registry")
        self.ledger = imp(f"{root}.utils.ledger")
        self.kw = kw

    def Conf(self, d=None):
        return self.conf.TpuShuffleConf(dict(d or {}))

    def Manager(self, conf, is_driver, net, **kw):
        return self.manager.TpuShuffleManager(
            conf, is_driver=is_driver, network=net, **self.kw, **kw)

    def Context(self, **kw):
        return self.api.TpuShuffleContext(**self.kw, **kw)


@pytest.fixture(scope="module")
def pkgs(devices):
    return (Pkg("sparkrdma_tpu", {}),
            Pkg("sparkrdma_tpu_torch", {"device": "cpu"}))


@pytest.fixture(autouse=True)
def registries_on(pkgs):
    """Both packages' metrics registries record for the test (each
    package has its own), as the JAX feature tests switch theirs on."""
    prev = [P.registry.enabled for P in pkgs]
    for P in pkgs:
        P.registry.enabled = True
    yield
    for P, was in zip(pkgs, prev):
        P.registry.enabled = was


@pytest.fixture(autouse=True)
def jax_free_keeps_mapping(monkeypatch):
    """The JAX package's ``MappedFile.free`` closes the ``np.memmap``'s
    mapping under live views, and a tier warm still copying from one
    then dies of SIGSEGV (ROADMAP §C.4; repaired in the port only).
    The JAX half of every twin here runs with the port's ``free``,
    which leaves the unmap to the last view's collection: no result
    depends on when the pages are unmapped, and a crash of the
    reference would take the whole test worker down with it."""
    from sparkrdma_tpu.memory import mapped_file as jax_mapped_file
    from sparkrdma_tpu_torch.memory.mapped_file import MappedFile

    monkeypatch.setattr(jax_mapped_file.MappedFile, "free", MappedFile.free)


def counters(P) -> dict:
    """{name: value summed over labels} of one package's registry;
    {(name, label value): value} for the labelled ones."""
    out = defaultdict(int)
    for c in P.registry.snapshot()["counters"]:
        out[c["name"]] += c["value"]
        for v in c["labels"].values():
            out[(c["name"], v)] += c["value"]
    return out


def delta(before, after, *names) -> dict:
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def oracle(records, op):
    if op == "reduce":
        out = defaultdict(int)
        for k, v in records:
            out[k] += v
        return sorted(out.items())
    out = defaultdict(list)
    for k, v in records:
        out[k].append(v)
    return sorted((k, sorted(vs)) for k, vs in out.items())


def canon(got, op):
    """A job's output in canonical form: (key, value) pairs sorted for
    ``reduce``; (key, sorted values) per key for ``group``; for
    ``sort`` the keys must come in order (checked here), and equal
    keys' values, which arrive in no defined order, are sorted."""
    def py(x):
        return x.item() if isinstance(x, np.generic) else x

    if op == "reduce":
        return sorted((py(k), py(v)) for k, v in got)
    if op == "sort":
        keys = [py(k) for k, _v in got]
        assert keys == sorted(keys), "sort_by_key out of key order"
    by = defaultdict(list)
    for k, v in got:
        vs = v.tolist() if isinstance(v, np.ndarray) else v
        if op == "group":
            by[py(k)].extend(py(x) for x in vs)
        else:
            by[py(k)].append(py(vs))
    return sorted((k, sorted(vs)) for k, vs in by.items())


def run_op(ds, op, columnar):
    if op == "reduce":
        # the string form keeps the columnar plane vectorized
        f = "sum" if columnar else (lambda a, b: a + b)
        return ds.reduce_by_key(f, num_partitions=3).collect()
    if op == "sort":
        return ds.sort_by_key(num_partitions=3).collect()
    return ds.group_by_key(num_partitions=3).collect()


SPILL_COUNTERS = ("shuffle_spills_total", "shuffle_spill_bytes_total")


def _cell(P, tmp, serializer, compress, spill, direct_io, stage):
    n = 1500
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 40, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    records = list(zip(keys.tolist(), vals.tolist()))
    conf = P.Conf({
        "spark.shuffle.tpu.serializer": serializer,
        "spark.shuffle.tpu.compress": str(compress).lower(),
        "spark.shuffle.tpu.directIO": direct_io,
        "spark.shuffle.tpu.spillDir": str(tmp),
        **({"spark.shuffle.tpu.shuffleSpillRecordThreshold": "200"}
           if spill else {}),
    })
    before = counters(P)
    out = {}
    with P.Context(num_executors=2, conf=conf,
                   stage_to_device=stage) as ctx:
        for op in OPS:
            if serializer == "columnar":
                ds = ctx.parallelize_columns(keys, vals, num_slices=4)
            else:
                ds = ctx.parallelize(records, num_slices=4)
            out[op] = canon(run_op(ds, op, serializer == "columnar"), op)
            assert out[op] == oracle(records, op), (P.name, op)
    leaked = sorted(p.name for p in tmp.iterdir()
                    if p.name.startswith("sparkrdma"))
    return out, delta(before, counters(P), *SPILL_COUNTERS), leaked


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("serializer", ["pickle", "columnar"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("direct_io", ["auto", "off"])
def test_conf_matrix_matches_jax(pkgs, tmp_path, serializer, compress,
                                 spill, direct_io, stage):
    got = []
    for P in pkgs:
        tmp = tmp_path / P.name
        tmp.mkdir()
        got.append(_cell(P, tmp, serializer, compress, spill, direct_io,
                         stage))
    (want, want_spills, want_leaked), (out, spills, leaked) = got
    assert out == want
    assert spills == want_spills
    assert (spills["shuffle_spills_total"] > 0) == spill, spills
    assert leaked == want_leaked == []
