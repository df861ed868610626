"""The yardstick's arithmetic: the least bytes of the scans, the
trace reduction, the metric readers and BENCHMARK.json's contract."""

import json
import re
import statistics

import pytest

from shufflebench import common, harness, kernels
from shufflebench import trace as tracing


def test_scan_bytes_hand_count():
    cfg = common.data("configs", "tpcds_sf100")
    scan_bytes = common.module("drivers", "tpcds_sf100").scan_bytes
    # m1 = 67108864 + 73049 = 67181913 rows through the date join's
    # probe fill at 1 + 8 + 8 bytes in and 8 + 1 out (int64 transport
    # words); m2 = m1 + 204000 = 67385913 rows through the item join's
    # probe and the aggregate's scans at 1 + 4 + 4 + 1 in and the int64
    # sum, int32 count, int64 min and max out
    assert scan_bytes(cfg) == 26 * 67181913 + 38 * 67385913
    assert scan_bytes(cfg) == 4307394432


def _ev(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)


def _trace():
    return {"traceEvents": [
        _ev("user_annotation", tracing.STEP, 0, 10),
        _ev("user_annotation", tracing.SYNC, 10, 90),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 10, 90),
        _ev("user_annotation", tracing.STEP, 100, 10),
        _ev("cpu_op", "aten::sort", 101, 5),
        _ev("user_annotation", tracing.SYNC, 110, 90),
        _ev("kernel", "void cub::DeviceRadixSortOnesweepKernel<long>(int)",
            5, 40),
        _ev("kernel", "void at::native::index_elementwise_kernel<128>(x)",
            30, 30),
        _ev("kernel", "ncclDevKernel_SendRecv(x)", 120, 50),
        _ev("kernel", "void (anonymous namespace)::scan_tiles<0>(x)",
            175, 10),
        _ev("gpu_user_annotation", tracing.STEP, 0, 200),
        _ev("kernel", "outside", 300, 10),
    ]}


def test_summarize_union_gaps_and_kernels():
    s = tracing.summarize(_trace())
    assert s["steps"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    # [5, 60] + [120, 170] + [175, 185]: overlapping kernels once
    assert s["busy_s"] == pytest.approx(115e-6)
    assert s["kernels"]["void at::native::index_elementwise_kernel<128>(x)"] \
        == pytest.approx(30e-6)
    assert "outside" not in s["kernels"]
    gaps = s["gaps"]
    # [0, 5) under step 1's call; [60, 120) begins in its wait;
    # [170, 175) and [185, 200) in step 2's wait
    assert gaps[tracing.STEP] == pytest.approx(5e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(60e-6)
    assert gaps[tracing.SYNC] == pytest.approx(20e-6)
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_summarize_without_steps():
    assert tracing.summarize({"traceEvents": []}) is None


def test_merge_and_breakdown():
    s = tracing.summarize(_trace())
    m = tracing.merge([s, s])
    assert m["busy_s"] == pytest.approx(s["busy_s"])
    assert tracing.merge([s, None]) is None
    b = tracing.breakdown(m)
    names = [k for k, _ in b["device_ops"]]
    assert names[:2] == ["ncclDevKernel_SendRecv",
                         "cub::DeviceRadixSortOnesweepKernel"]
    assert "scan_tiles" in names
    assert tracing.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(x)"
    ) == "at::native::CatArrayBatchedCopy"
    assert tracing.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD"
    assert len(b["device_ops"]) <= tracing.TOP
    assert b["idle_gaps"][0][0] == "cudaDeviceSynchronize"


class _Run:
    def __init__(self, trace=None, **kw):
        self.trace = trace
        self.config = common.data("configs", "tpcds_sf100")
        self.steps_s = [0.01 * (i + 1) for i in range(100)]
        self.host_s = [[0.001, False]] * 10 + [[0.5, True]]
        self.window_s = 2.0
        self.ok_steps = 100
        self.bytes_per_step = 10 ** 9
        self.info = {}
        self.setup_s = 12.5
        self.__dict__.update(kw)


def _read(name, run):
    return common.module("metrics", name).read(run)


def test_end_to_end_readers():
    run = _Run()
    assert _read("shuffle_gbps", run) == pytest.approx(50.0)
    want = statistics.quantiles(run.steps_s, n=20, method="inclusive")[18]
    assert _read("step_p95_ms", run) == pytest.approx(want * 1e3)
    assert 950 <= _read("step_p95_ms", run) <= 960
    assert _read("setup_s", run) == 12.5
    # the traced steps' host times are left out
    assert _read("host_ms", run) == pytest.approx(1.0)


def test_device_readers():
    s = tracing.summarize(_trace())
    run = _Run(trace=s, info={"scan_bytes_per_step": 4307394432})
    assert _read("sort_ms", run) == pytest.approx(40e-3 / 2)
    assert _read("gather_ms", run) == pytest.approx(30e-3 / 2)
    assert _read("collective_ms", run) == pytest.approx(50e-3 / 2)
    assert _read("idle_share", run) == pytest.approx(100 * (1 - 115 / 200))
    want = 100 * 4307394432 / 3.35e12 / 5e-6
    assert _read("scan_roofline", run) == pytest.approx(want)
    # nothing to read: nothing returned, never 0
    for name in ("sort_ms", "gather_ms", "collective_ms", "scan_roofline",
                 "idle_share"):
        assert _read(name, _Run()) is None
    s2 = dict(s, kernels={})
    assert _read("scan_roofline", _Run(trace=s2)) is None
    # a step that counts no scan bytes has no scan roofline
    assert _read("scan_roofline", _Run(trace=s)) is None


def test_patterns_keep_layers_apart():
    assert kernels.matches("ncclDevKernel_AllGather_RING_LL",
                           kernels.GATHER, kernels.NCCL) is False
    assert kernels.matches(
        "void at::native::_scatter_gather_elementwise_kernel<128, 8>",
        kernels.GATHER, kernels.NCCL)
    assert not kernels.matches("void bitonic_block_sort<8>", kernels.SORT)
    assert kernels.matches(
        "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<x>",
        kernels.SORT)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_contract():
    raw = common.BENCHMARK_JSON.read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["shufflebench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        cfg = common.load_json(common.ROOT / c["file"])
        assert c["file"] == f"shufflebench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in ("drivers", "reference", "inputs"):
            assert (common.BENCH_DIR / key / f"{c['name']}.py").is_file()
    cells = set()
    four = 0
    # a pair of configuration and traffic mix appears once
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in cells
        cells.add(w["name"])
        assert w["config"] in names and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
        assert (common.BENCH_DIR / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        four += w["chips"] == 4
    assert four <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"shuffle_gbps", "step_p95_ms", "setup_s"} <= e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in b["end_to_end"]:
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        assert harness.metric_specs(b, w, True), w["name"]
    assert [m["name"] for m in harness.metric_specs(
        b, harness.find_cell(b, "tpcds.d1"), True)] == [
        "host_ms", "sort_ms", "gather_ms", "scan_roofline", "idle_share"]
