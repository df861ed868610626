"""The port's stage ranges and exchange byte counter
(``sparkrdma_tpu_torch/utils/trace.py``, ``parallel/group.py``) on the
CPU.

``stage()`` and ``Tracer.span`` hand back one shared no-op context while
neither the torch profiler nor the tracer is on.  Under
``torch.profiler`` (CPU activity) each step records its stages as
``sparkrdma.*`` ranges, nested as the calls nest: TeraSort at D = 1 in
process, the query-55 driver of ``shufflebench`` at its test size, and
TeraSort and the hash join at D = 4 in a gloo world of
``tests/torch_stages_worker.py`` ranks (spawned once for the module),
where ``exchange_bytes_total`` is held to the bytes the exchange sends
to other ranks.  The tracer stamps its spans on the profiler's clock.
"""

import json
import os
import tempfile
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_stages_worker as worker
from sparkrdma_tpu_torch.entry import spawn_world
from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models.join import make_broadcast_join_step
from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup
from sparkrdma_tpu_torch.utils import trace as T

P = T.RANGE_PREFIX
WORLD = 4
TERASORT_D4 = ["terasort.local_sort", "terasort.splitters",
               "exchange.all_gather", "terasort.fill_windows",
               "exchange.all_to_all", "terasort.merge"]
QUERY55 = ["join.pack", "join.probe", "join_aggregate.pack",
           "join_aggregate.probe", "join_aggregate.aggregate"]


@pytest.fixture
def tracer():
    """The global tracer, on and empty for the test."""
    tr = T.get_tracer()
    was = tr.enabled
    tr.clear()
    tr.enabled = True
    try:
        yield tr
    finally:
        tr.enabled = was
        tr.clear()


def _profiled(fn):
    """(what ``fn()`` returned, the Chrome trace of its profile)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return out, doc


def _ranges(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(P)]


def _names(doc):
    return [e["name"][len(P):] for e in sorted(_ranges(doc),
                                               key=lambda e: e["ts"])]


def _inside(inner, outer):
    a, b = inner[1], inner[1] + inner[2]
    return outer[1] <= a and b <= outer[1] + outer[2]


# -- the facility --------------------------------------------------------------


def test_stage_is_one_shared_no_op_while_nothing_records():
    tr = T.get_tracer()
    was = tr.enabled
    tr.enabled = False
    try:
        assert not T.profiling()
        a, b = T.stage("terasort.pad"), T.stage("join.probe")
        assert a is b
        with a:
            pass
        n = len(tr.events)
    finally:
        tr.enabled = was
    assert n == len(tr.events)


def test_a_disabled_tracer_span_is_the_same_no_op():
    tr = T.Tracer(enabled=False)
    assert tr.span("x", shuffle=1) is T.stage("y")
    with tr.span("x"):
        pass
    assert tr.events == []


def test_stage_records_a_host_span_while_the_tracer_is_on(tracer):
    with T.stage("join.pack"):
        with T.stage("join.probe"):
            pass
    names = [e["name"] for e in tracer.events]
    assert names == ["join.probe", "join.pack"]
    inner, outer = tracer.events
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_a_record_plane_span_lands_in_the_profiler_trace():
    tr = T.Tracer(enabled=False)

    def run():
        with tr.span("shuffle.write.commit", shuffle=3, map=0):
            torch.ones(8).sum()

    _, doc = _profiled(run)
    assert _names(doc) == ["shuffle.write.commit"]
    assert tr.events == []


def test_tracer_and_profiler_agree_on_the_clock(tracer, tmp_path):
    """A tracer span and the profiler's range of the same stage line up
    within 1 ms once each document's ``baseTimeNanoseconds`` is
    applied."""
    def run():
        with T.stage("warm"):
            pass
        for _ in range(3):
            with T.stage("terasort.merge"):
                torch.randn(1 << 14).sort()

    _, doc = _profiled(run)
    tracer.dump(str(tmp_path / "tracer.json"))
    mine = json.loads((tmp_path / "tracer.json").read_text())
    shift = (mine["baseTimeNanoseconds"] - doc["baseTimeNanoseconds"]) / 1e3
    spans = [e for e in mine["traceEvents"] if e["name"] == "terasort.merge"]
    ranges = sorted((e for e in _ranges(doc)
                     if e["name"] == P + "terasort.merge"),
                    key=lambda e: e["ts"])
    assert len(spans) == len(ranges) == 3
    for s, r in zip(spans, ranges):
        assert abs(s["ts"] + shift - r["ts"]) < 1e3
        assert abs(s["ts"] + s["dur"] + shift - r["ts"] - r["dur"]) < 1e3


def test_tracer_stamps_on_the_wall_clock_since_its_base(tracer, tmp_path):
    before = time.time_ns()
    with tracer.span("x"):
        pass
    after = time.time_ns()
    (e,) = tracer.events
    at = tracer.base_ns + e["ts"] * 1e3
    assert before - 1e3 <= at <= after + 1e3
    tracer.dump(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["baseTimeNanoseconds"] == tracer.base_ns
    assert doc["traceEvents"][0]["ts"] == e["ts"]


# -- the steps' ranges at D = 1 ------------------------------------------------


def _wide_sort():
    g = torch.Generator().manual_seed(5)
    keys = torch.randint(-(1 << 62), 1 << 62, (512,), generator=g)
    payload = torch.randint(0, 1 << 30, (512, 23), generator=g,
                            dtype=torch.int32)
    (k, _p, n_valid, _m), cap = TeraSorter(device="cpu").sort_device_wide(
        keys, payload)
    return k, n_valid, cap


def _narrow_sort():
    g = torch.Generator().manual_seed(6)
    keys = torch.randint(0, 1 << 30, (512,), generator=g, dtype=torch.int32)
    valid = (torch.arange(512) < 500).to(torch.int32)
    (k, _v, n_valid, _m), cap = TeraSorter(device="cpu").sort_device(
        keys, keys.clone(), valid)
    return k, n_valid, cap


@pytest.mark.parametrize("sort", [_wide_sort, _narrow_sort],
                         ids=["wide", "narrow"])
def test_terasort_at_one_rank_records_its_sort_and_pad(sort):
    (k, n_valid, cap), doc = _profiled(sort)
    assert _names(doc) == ["terasort.local_sort", "terasort.pad"]
    assert k.shape == (cap,) and int(n_valid[0]) in (500, 512)


@pytest.mark.parametrize("sort", [_wide_sort, _narrow_sort],
                         ids=["wide", "narrow"])
def test_terasort_at_one_rank_copies_no_sorted_row(sort):
    """The sort and the gather write into the capacity-sized outputs, so
    no ``cat`` copies the sorted run; ``terasort.pad`` fills the tail."""
    (k, _n_valid, cap), doc = _profiled(sort)
    ops = [e["name"] for e in doc["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert "aten::sort" in ops and "aten::cat" not in ops
    assert _names(doc) == ["terasort.local_sort", "terasort.pad"]
    assert k.untyped_storage().nbytes() == cap * k.element_size()


def test_broadcast_join_records_pack_and_probe():
    cols = [torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32),
            torch.arange(5, dtype=torch.int32),
            torch.ones(5, dtype=torch.int32),
            torch.tensor([1, 3, 5], dtype=torch.int32),
            torch.tensor([10, 30, 50], dtype=torch.int32),
            torch.ones(3, dtype=torch.int32)]
    step = make_broadcast_join_step(1, 5, 3)
    (_k, _fp, _dp, found, _f), doc = _profiled(lambda: step(*cols))
    assert _names(doc) == ["join.pack", "join.probe"]
    assert int(found.sum()) == 4


def test_query55_driver_records_the_five_join_ranges():
    from shufflebench import common
    from shufflebench.tests import sizes

    config = dict(common.data("configs", "tpcds_sf100"))
    config.update(sizes.TPCDS)
    driver = common.module("drivers", "tpcds_sf100")
    job = driver.Job(config, 17, 0, 1, None, torch.device("cpu"))
    job.step()  # the first step builds what later steps reuse
    out, doc = _profiled(job.step)
    assert _names(doc) == QUERY55
    assert int(out[2].sum()) > 0  # matched rows were aggregated
    job.release()


def test_exchange_counts_nothing_at_one_rank():
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        g = ExchangeGroup(device="cpu")
        x = torch.arange(8).reshape(1, 8)
        assert g.all_to_all(x) is x
        g.all_gather(x)
        names = [c["name"] for c in GLOBAL_REGISTRY.snapshot()["counters"]]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    assert "exchange_bytes_total" not in names


# -- D = 4 in a gloo world -----------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("stages_world")
    spawn_world(worker.run_rank, WORLD, "cpu", 240.0, args=(str(out),))
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def test_terasort_over_four_ranks_records_its_six_ranges(world):
    assert sum(r["n_valid"] for r in world) == WORLD * worker.N_LOCAL
    for r in world:
        names = {n[len(P):] for n, _ts, _dur in r["sort_ranges"]}
        assert names == set(TERASORT_D4), r["rank"]
        order = [n[len(P):] for n, _ts, _dur in
                 sorted(r["sort_ranges"], key=lambda x: x[1])]
        assert order == ["terasort.local_sort", "terasort.splitters",
                         "exchange.all_gather", "terasort.fill_windows",
                         "exchange.all_to_all", "exchange.all_to_all",
                         "exchange.all_to_all", "terasort.merge"]


def test_the_sample_gather_nests_in_the_splitters(world):
    for r in world:
        by = {n[len(P):]: (n, ts, dur) for n, ts, dur in r["sort_ranges"]}
        assert _inside(by["exchange.all_gather"], by["terasort.splitters"])
        assert not _inside(by["exchange.all_gather"],
                           by["terasort.local_sort"])


def test_exchange_bytes_are_what_the_all_to_alls_send_off_rank(world):
    """(D - 1) x (capacity x (8 + 4 W) + 4) a rank a step: the keys,
    the W payload words and the valid count of every window but its
    own."""
    for r in world:
        cap = r["capacity"]
        assert r["counters"]["all_to_all"] == (WORLD - 1) * (
            cap * (8 + 4 * worker.PAYLOAD_WORDS) + 4)


def test_exchange_bytes_of_the_sample_gather(world):
    sample = min(1024, worker.N_LOCAL)
    for r in world:
        assert r["counters"]["all_gather"] == (WORLD - 1) * sample * 8


def test_hash_join_over_four_ranks_records_buckets_exchange_and_probe(world):
    for r in world:
        names = [n[len(P):] for n, _ts, _dur in
                 sorted(r["join_ranges"], key=lambda x: x[1])]
        assert names == ["join.pack", "join.buckets", "exchange.all_to_all",
                         "exchange.all_to_all", "exchange.all_to_all",
                         "join.probe"]
