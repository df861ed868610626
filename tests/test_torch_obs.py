"""The port's metrics and observability planes held against the JAX
package: the twins of tests/test_{metrics,metrics_http,obs,trace}.py.

``metrics/``, ``obs/``, ``utils/trace.py`` and ``stats.py`` are copies of
the JAX modules; their unit cases (instruments, exposition, histogram
edges, tracer bounds, the recorder ring, sampling) run as the cases of
one parametrised test, each through both packages, with equal results.
The cases that drive nodes and managers (the instrumented shuffle, the
scrape endpoint over real HTTP, the wire-version fallback, the chaos
auto-dump, the two-process merged trace, the manager's wiring) run each
package's own cluster, with map outputs staged and on the host, and
compare what the run fixes: counter names, record and byte counts, event
names, endpoint payloads.

Listeners bind in 64300-65299 (``BAND``): the JAX package's at ``PORTS``,
the port's ``HALF`` above; each case asserts the ports it bound.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_conf_matrix import STAGES, pkgs  # noqa: F401
from tests.test_torch_transport import Wire

REPO = Path(__file__).resolve().parent.parent
TRACE_REPORT = REPO / "tools" / "trace_report.py"
METRICS_REPORT = REPO / "tools" / "metrics_report.py"
BAND = (64300, 65300)
HALF = 500
PORTS = {  # the JAX half; the port's is HALF above
    "scrape": 64300,        # 2 x 10: driver's endpoint, executors' +1, +2
    "health": 64320,        # two endpoints, +0 and +1
    "v1_server": 64330,     # a version-1 acceptor
    "v1_listener": 64340,   # a node taking a version-1 hello
    "fleet": 64350,         # a SimPeerFleetProc of one peer
}
# forced counters of the port's device seams, which the JAX package has
# no counterpart of
PORT_ONLY = {"staging_h2d_bytes_total", "staging_device_segments_total",
             "staging_commit_fallbacks_total",
             "arena_device_read_bytes_total"}


class Obs(Wire):
    """A package's transport modules (``Wire``) and its observability
    planes."""

    def __init__(self, P):
        super().__init__(P)
        obs = self.imp("obs")
        self.RECORDER, self.TRACING, self.fr_event = (
            obs.RECORDER, obs.TRACING, obs.fr_event)
        self.collect = self.imp("obs.collect")
        self.http = self.imp("qos.http")
        self.QOS = self.imp("qos.registry").GLOBAL_QOS
        self.Tracer = self.imp("utils.trace").Tracer
        self.FetchHistogram = self.imp("stats").FetchHistogram
        self.MetricsRegistry = self.metrics.MetricsRegistry

    def port(self, name, k=0):
        return PORTS[name] + k + (HALF if self.is_port else 0)


@pytest.fixture(scope="module")
def obses(pkgs):
    return tuple(Obs(P) for P in pkgs)


@pytest.fixture(autouse=True)
def obs_reset(obses):
    """Both packages' observability planes end the test as they began
    (owner counts, registries), as the JAX files' fixtures keep theirs."""
    prev = [O.registry.enabled for O in obses]
    for O in obses:
        O.QOS.reset()
    yield
    for O, was in zip(obses, prev):
        O.registry.enabled = was
        O.QOS.enabled = False
        O.QOS.reset()
        while O.RECORDER.enabled:
            O.RECORDER.release()
        while O.TRACING.enabled:
            O.TRACING.release()


@contextlib.contextmanager
def fresh_registry(O, enabled=True):
    """The package's global registry reset and switched on (or off) for
    the block, as tests/test_metrics.py's ``registry`` fixture, and the
    package's resource ledger held off: a ``resourceDebug`` manager of an
    earlier test in the process leaves it on, and it then adds its own
    counters to the registry."""
    led = O.imp("utils.ledger").get_resource_ledger()
    prev, was = O.registry.enabled, led.enabled
    led.enabled = False
    O.registry.reset()
    O.registry.enabled = enabled
    try:
        yield O.registry
    finally:
        O.registry.enabled = prev
        O.registry.reset()
        led.enabled = was


def both(obses, case, *args):
    want, got = (case(O, *args) for O in obses)
    assert got == want
    return got


def bound(*ports, want):
    assert list(ports) == list(want), ports
    assert all(BAND[0] <= p < BAND[1] for p in ports), ports


def get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        assert resp.status == 200
        return resp.read()


def parse_prom(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, _sp, value = line.rpartition(" ")
            out[series] = float(value)
    return out


@contextlib.contextmanager
def loop_cluster(O, conf, stage, n=2, confs=None):
    """Driver + ``n`` executors on one loopback network; ``confs`` gives
    each manager its own conf (driver first)."""
    confs = confs or [conf] * (n + 1)
    net = O.LoopbackNetwork()
    driver = O.Manager(confs[0], True, net, stage)
    execs = []
    try:
        execs.extend(O.Manager(confs[i + 1], False, net, stage,
                               port=conf.driver_port + 100 + i * 10,
                               executor_id=str(i)) for i in range(n))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(len(e._peers) == n for e in execs):
                break
            time.sleep(0.01)
        yield net, driver, execs
    finally:
        for m in execs + [driver]:
            m.stop()


def write_two_maps(O, driver, execs, sid, records):
    handle = driver.register_shuffle(sid, 2, O.Hash(2))
    mbh = defaultdict(list)
    for m in range(2):
        w = execs[m].get_writer(handle, m)
        w.write(records)
        w.stop(True)
        mbh[execs[m].local_smid].append(m)
    return handle, dict(mbh)


# -- instruments, exposition, tracer, histograms, recorder ---------------------


def _counter_concurrent_increments(O):
    c = O.MetricsRegistry(enabled=True).counter("c_total")

    def work():
        for _ in range(10_000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return c.value


def _instrument_identity_and_labels(O):
    reg = O.MetricsRegistry(enabled=True)
    a = reg.counter("x_total", transport="tcp")
    b = reg.counter("x_total", transport="tcp")
    c = reg.counter("x_total", transport="loopback")
    a.inc(2)
    vals = {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in reg.snapshot()["counters"]}
    return a is b, a is not c, sorted(vals.items())


def _disabled_registry_returns_noop_handles(O):
    reg = O.MetricsRegistry(enabled=False)
    m = O.metrics
    nulls = (reg.counter("a") is m.NULL_COUNTER,
             reg.gauge("b") is m.NULL_GAUGE,
             reg.histogram("c") is m.NULL_HISTOGRAM)
    reg.counter("a").inc(5)
    reg.histogram("c").observe(1.0)
    with reg.histogram("c").time():
        pass
    empty = reg.snapshot()["counters"] == []
    real = reg.counter("a", force=True)
    real.inc(5)
    return nulls, empty, real.value


def _histogram_edges_are_exclusive_upper_bounds(O):
    h = O.MetricsRegistry(enabled=True).histogram("h_ms", edges=[1.0, 10.0])
    for v in (0.0, 0.99, 1.0, 9.99, 10.0, 1e9):
        h.observe(v)
    return h.counts, h.count, h.sum


def _histogram_time_context(O):
    h = O.MetricsRegistry(enabled=True).histogram("t_ms")
    with h.time():
        time.sleep(0.002)
    return h.count, h.sum >= 1.0


def _gauge_inc_dec(O):
    g = O.MetricsRegistry(enabled=True).gauge("g")
    g.inc(3)
    g.dec()
    first = g.value
    g.set(7.5)
    return first, g.value


def _prometheus_exposition_shape(O):
    reg = O.MetricsRegistry(enabled=True)
    reg.counter("n_total", layer="t").inc(4)
    reg.gauge("active").set(2)
    h = reg.histogram("lat_ms", edges=[1.0, 5.0])
    for v in (0.5, 3.0, 100.0):
        h.observe(v)
    text = O.metrics.to_prometheus(reg)
    for want in ("# TYPE n_total counter", 'n_total{layer="t"} 4',
                 "# TYPE active gauge", "# TYPE lat_ms histogram",
                 'lat_ms_bucket{le="1"} 1', 'lat_ms_bucket{le="5"} 2',
                 'lat_ms_bucket{le="+Inf"} 3', "lat_ms_count 3"):
        assert want in text
    return text


def _diff_snapshots_subtracts_counters_and_histograms(O):
    reg = O.MetricsRegistry(enabled=True)
    c, h = reg.counter("c_total"), reg.histogram("h_ms", edges=[1.0])
    c.inc(5)
    h.observe(0.5)
    base = reg.snapshot()
    c.inc(3)
    h.observe(2.0)
    d = O.metrics.diff_snapshots(reg.snapshot(), base)
    return (d["counters"][0]["value"], d["histograms"][0]["counts"],
            d["histograms"][0]["count"])


def _publish_to_tracer_bridges_counters(O):
    reg = O.MetricsRegistry(enabled=True)
    reg.counter("br_total", k="v").inc(9)
    reg.gauge("br_gauge").set(4)
    tr = O.Tracer(enabled=True)
    reg.publish_to_tracer(tr)
    ev = {e["name"]: e for e in tr.events}
    return (ev["br_total{k=v}"]["args"]["value"],
            ev["br_gauge"]["args"]["value"],
            all(e["ph"] == "C" for e in tr.events))


def _prometheus_parse_round_trips_with_snapshot_render(O):
    spec = importlib.util.spec_from_file_location(
        "sparkrdma_tpu_metrics_report", METRICS_REPORT)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    reg = O.MetricsRegistry(enabled=True)
    reg.counter("shuffle_write_bytes_total").inc(123456)
    reg.counter("resource_acquires_total", resource="x.pins").inc(3)
    reg.counter("resource_leaked_total", resource="x.pins").inc(1)
    reg.counter("resource_double_release_total").inc(2)
    reg.gauge("resource_outstanding", resource="x.pins").set(2)
    reg.gauge("arena_bytes_in_use").set(4096)
    h = reg.histogram("fetch_ms", edges=[1.0, 5.0, 25.0])
    for v in (0.5, 3.0, 3.0, 17.0, 99.0):
        h.observe(v)
    hl = reg.histogram("lock_hold_us", edges=[10.0, 100.0], lock="arena")
    for v in (4.0, 40.0, 400.0):
        hl.observe(v)
    snap = reg.snapshot()
    parsed = report.parse_prometheus(O.metrics.to_prometheus(reg))
    assert report.render(parsed) == report.render(snap)
    assert parsed["counters"] == snap["counters"]
    assert parsed["gauges"] == snap["gauges"]
    return report.render(parsed)


def _tracer_bounded_append_sets_dropped(O, tmp):
    tr = O.Tracer(enabled=True, max_events=5)
    for i in range(8):
        tr.instant(f"e{i}")
    tr.dump(str(tmp / "trace.json"))
    doc = json.loads((tmp / "trace.json").read_text())
    return (len(tr.events), tr.dropped, doc["metadata"]["dropped_events"],
            [e["name"] for e in doc["traceEvents"]])


def _tracer_bound_applies_to_every_event_kind(O, tmp):
    tr = O.Tracer(enabled=True, max_events=2)
    with tr.span("s0"):
        pass
    tr.counter("c0", value=1)
    with tr.span("s1"):
        pass
    tr.instant("i0")
    tr.dump(str(tmp / "t.json"))
    doc = json.loads((tmp / "t.json").read_text())
    return len(tr.events), tr.dropped, doc["metadata"]["dropped_events"]


def _tracer_disabled_records_nothing(O):
    tr = O.Tracer(enabled=False, max_events=2)
    with tr.span("s"):
        pass
    tr.instant("i")
    tr.counter("c", value=3)
    return tr.events, tr.dropped


def _fetch_histogram_bucket_edges(O):
    fh = O.FetchHistogram(bucket_ms=300, num_buckets=5)
    for v in (0, 299.999, 300, 599.999, 600, 1200, 10**9):
        fh.add_sample(v)
    return fh.total, fh.to_string()


def _fetch_histogram_single_bucket_ms(O):
    fh = O.FetchHistogram(bucket_ms=1, num_buckets=3)
    for v in (0.0, 0.5, 1.0, 1.5, 2.0, 99.0):
        fh.add_sample(v)
    return fh.to_string()


def _tracing_off_is_none_and_zero_cost(O):
    return O.TRACING.enabled, O.TRACING.start()


def _tracing_start_child_and_sampling(O):
    T = O.TRACING
    T.retain(1.0)
    try:
        a, b = T.start(), T.start()
        child = a.child()
        ids = (a.trace_id != b.trace_id, a.trace_id != 0 and a.span_id != 0,
               child.trace_id == a.trace_id, child.span_id != a.span_id)
    finally:
        T.release()
    T.retain(0.0)
    try:
        none = all(T.start() is None for _ in range(8))
    finally:
        T.release()
    T.retain(0.5)
    try:
        half = [T.start() is not None for _ in range(8)]
    finally:
        T.release()
    # every other start traces; which one comes first depends on the
    # starts made before in this process
    return ids, none, (sum(half), all(x != y for x, y in zip(half, half[1:])))


def _recorder_off_fr_event_is_noop(O):
    off = not O.RECORDER.enabled
    O.fr_event("reader", "fetch_issue", bytes=1)
    return off


def _ring_overflow_drops_oldest_and_counts(O):
    O.registry.enabled = True
    dropped = O.metrics.counter("obs_events_dropped_total", plane="qos")
    base = dropped.value
    O.RECORDER.retain(ring_size=64)
    try:
        for i in range(100):
            O.fr_event("qos", "credit_block", pool="serve", bytes=i)
        ring = O.RECORDER.snapshot()["planes"]["qos"]
        return (len(ring["events"]), ring["dropped"],
                ring["events"][0][2]["bytes"], dropped.value - base)
    finally:
        O.RECORDER.release()


def _recorder_retain_is_owner_counted(O):
    R = O.RECORDER
    R.retain(ring_size=64)
    R.retain(ring_size=64)
    R.release()
    held = R.enabled
    R.release()
    return held, R.enabled


def _dump_and_auto_dump_rate_cap(O, tmp):
    O.registry.enabled = True
    R = O.RECORDER
    R.retain(ring_size=64, dump_dir=str(tmp))
    try:
        O.fr_event("faults", "breaker_trip", peer="p1", strikes=3)
        p1 = R.auto_dump("breaker_trip")
        doc = json.load(open(p1))
        names = [e[1] for e in doc["planes"]["faults"]["events"]]
        p2 = R.dump("on_demand")
        return ("breaker_trip" in os.path.basename(p1), doc["reason"],
                doc["pid"] == os.getpid(), "breaker_trip" in names,
                R.auto_dump("breaker_trip"), p2 is not None and p2 != p1)
    finally:
        R.release()


def _req_trace_tail_parses_and_requires_nonzero(O):
    wire = O.tcp
    base = wire._REQ_HDR.pack(7, 1) + wire._LOC.pack(0, 16, 1)
    return (wire._req_trace(base),
            wire._req_trace(base + wire._TRACE_CTX.pack(0xAB, 0xCD)),
            wire._req_trace(base + wire._TRACE_CTX.pack(0, 0xCD)), base)


UNIT_CASES = {f.__name__[1:]: f for f in (
    _counter_concurrent_increments, _instrument_identity_and_labels,
    _disabled_registry_returns_noop_handles,
    _histogram_edges_are_exclusive_upper_bounds, _histogram_time_context,
    _gauge_inc_dec, _prometheus_exposition_shape,
    _diff_snapshots_subtracts_counters_and_histograms,
    _publish_to_tracer_bridges_counters,
    _prometheus_parse_round_trips_with_snapshot_render,
    _tracer_bounded_append_sets_dropped,
    _tracer_bound_applies_to_every_event_kind,
    _tracer_disabled_records_nothing, _fetch_histogram_bucket_edges,
    _fetch_histogram_single_bucket_ms, _tracing_off_is_none_and_zero_cost,
    _tracing_start_child_and_sampling, _recorder_off_fr_event_is_noop,
    _ring_overflow_drops_oldest_and_counts,
    _recorder_retain_is_owner_counted, _dump_and_auto_dump_rate_cap,
    _req_trace_tail_parses_and_requires_nonzero)}
TMP_CASES = {"tracer_bounded_append_sets_dropped",
             "tracer_bound_applies_to_every_event_kind",
             "dump_and_auto_dump_rate_cap"}
WANT = {
    "counter_concurrent_increments": 80_000,
    "histogram_time_context": (1, True),
    "gauge_inc_dec": (2, 7.5),
    "diff_snapshots_subtracts_counters_and_histograms": (3, [0, 1], 1),
    "publish_to_tracer_bridges_counters": (9, 4, True),
    "tracer_bounded_append_sets_dropped":
        (5, 3, 3, [f"e{i}" for i in range(5)]),
    "tracer_bound_applies_to_every_event_kind": (2, 2, 2),
    "tracer_disabled_records_nothing": ([], 0),
    "fetch_histogram_bucket_edges": (7, "[0-300ms]: 2, [300-600ms]: 2, "
                                     "[600-900ms]: 1, [900-1200ms]: 0, "
                                     "[1200ms+]: 2"),
    "fetch_histogram_single_bucket_ms": "[0-1ms]: 2, [1-2ms]: 2, [2ms+]: 2",
    "tracing_off_is_none_and_zero_cost": (False, None),
    "tracing_start_child_and_sampling":
        ((True, True, True, True), True, (4, True)),
    "recorder_off_fr_event_is_noop": True,
    "ring_overflow_drops_oldest_and_counts": (64, 36, 36, 36),
    "recorder_retain_is_owner_counted": (True, False),
    "dump_and_auto_dump_rate_cap": (True, "breaker_trip", True, True, None,
                                    True),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_obs_units_match_jax(obses, tmp_path, case):
    """The unit cases of tests/test_{metrics,trace,obs}.py, through both
    packages' copies of the modules: equal results."""
    def run(O):
        if case in TMP_CASES:
            tmp = tmp_path / O.name
            tmp.mkdir()
            return UNIT_CASES[case](O, tmp)
        return UNIT_CASES[case](O)

    got = both(obses, run)
    if case in WANT:
        assert got == WANT[case]


# -- the instrumented shuffle (tests/test_metrics.py) --------------------------


def _sum_counter(snap, name):
    return sum(c["value"] for c in snap["counters"] if c["name"] == name)


@pytest.mark.parametrize("stage", STAGES)
def test_e2e_shuffle_metrics_match_jax(obses, tmp_path, stage):
    """A loopback shuffle with ``metrics`` on: nonzero transport, writer,
    fetch-latency and arena counters; the driver's telemetry; the stop-time
    JSON and Prometheus exports, rendered by tools/metrics_report.py; the
    same counter names in both packages (but the port's device-seam
    counters), and equal record and written-byte counts."""
    def case(O):
        tmp = tmp_path / O.name
        tmp.mkdir()
        json_path, prom_path = tmp / "metrics.json", tmp / "metrics.prom"
        conf = O.Conf({
            "spark.shuffle.tpu.metrics": True,
            "spark.shuffle.tpu.collectShuffleReaderStats": True,
            "spark.shuffle.tpu.driverPort": 37310,
            "spark.shuffle.tpu.metricsJsonPath": str(json_path),
            "spark.shuffle.tpu.metricsPromPath": str(prom_path),
        })
        with fresh_registry(O) as reg:
            with loop_cluster(O, conf, stage, n=3) as (_n, driver, execs):
                handle = driver.register_shuffle(0, 4, O.Hash(6))
                mbh = defaultdict(list)
                for m in range(4):
                    ex = execs[m % 3]
                    w = ex.get_writer(handle, m)
                    w.write([(f"k{j}", (m, j)) for j in range(100)])
                    w.stop(True)
                    mbh[ex.local_smid].append(m)
                got = sum(sum(1 for _ in execs[p % 3].get_reader(
                    handle, p, p + 1, dict(mbh)).read()) for p in range(6))
                driver.unregister_shuffle(0)
                for ex in execs:
                    ex.unregister_shuffle(0)
                deadline, tel = time.monotonic() + 5, {}
                while time.monotonic() < deadline:
                    tel = driver.shuffle_telemetry(0)
                    if tel["total"].get("map_tasks", 0) >= 4 and \
                            tel["total"].get("reduce_tasks", 0) >= 6:
                        break
                    time.sleep(0.01)
                snap = reg.snapshot()
            fetch = sum(h["count"] for h in snap["histograms"] if h["name"] in
                        ("shuffle_fetch_latency_ms", "shuffle_remote_fetch_ms"))
            nonzero = {n: _sum_counter(snap, n) > 0 for n in (
                "transport_bytes_sent_total", "shuffle_write_bytes_total",
                "arena_segments_registered_total", "shuffle_read_bytes_total",
                "transport_connect_attempts_total")}
            names = sorted({c["name"] for c in snap["counters"]} - PORT_ONLY)
            hists = sorted({h["name"] for h in snap["histograms"]})
        doc = json.loads(json_path.read_text())
        out = subprocess.run([sys.executable, str(METRICS_REPORT),
                              str(json_path)], capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr
        out2 = subprocess.run([sys.executable, str(METRICS_REPORT),
                               str(json_path), str(json_path)],
                              capture_output=True, text=True, timeout=60)
        assert out2.returncode == 0, out2.stderr
        t = tel["total"]
        return dict(
            records=got, fetch_counts=fetch > 0, nonzero=nonzero, names=names,
            histograms=hists,
            telemetry=(t["map_tasks"], t["reduce_tasks"], t["write_records"],
                       t["records_read"], t["write_bytes"] > 0,
                       len(tel["per_host"])),
            write_bytes=_sum_counter(snap, "shuffle_write_bytes_total"),
            exports=((tmp / "metrics.json.0").exists(), prom_path.exists(),
                     _sum_counter(doc, "shuffle_write_bytes_total") > 0,
                     "transport_bytes_sent_total" in prom_path.read_text()),
            report=("shuffle_write_bytes_total" in out.stdout,
                    "histograms" in out.stdout, "diff" in out2.stdout))

    got = both(obses, case)
    assert got["records"] == 400 and got["fetch_counts"]
    assert all(got["nonzero"].values()), got["nonzero"]
    assert got["telemetry"] == (4, 6, 400, 400, True, 3)
    assert got["exports"] == (True,) * 4 and got["report"] == (True,) * 3


@pytest.mark.parametrize("stage", STAGES)
def test_metrics_disabled_leaves_registry_empty_matches_jax(obses, stage):
    """Default conf: the instrumented paths create no instrument and the
    driver keeps no telemetry.  The port's forced device-seam counters
    (``PORT_ONLY``, always on) are the one difference, and only when map
    outputs are staged."""
    def case(O):
        with fresh_registry(O, enabled=False) as reg:
            conf = O.Conf({"spark.shuffle.tpu.driverPort": 37350})
            with loop_cluster(O, conf, stage, n=1) as (_n, driver, execs):
                ex = execs[0]
                handle = driver.register_shuffle(0, 1, O.Hash(2))
                w = ex.get_writer(handle, 0)
                w.write([(1, 2), (3, 4)])
                w.stop(True)
                list(ex.get_reader(handle, 0, 1, {ex.local_smid: [0]}).read())
                driver.unregister_shuffle(0)
                ex.unregister_shuffle(0)
            snap = reg.snapshot()
            return ([c for c in snap["counters"]
                     if c["name"] not in PORT_ONLY],
                    snap["gauges"], driver.shuffle_telemetry(0)["per_host"])

    assert both(obses, case) == ([], [], {})


# -- the scrape endpoint (tests/test_metrics_http.py, tests/test_obs.py) -------


@pytest.mark.parametrize("stage", STAGES)
def test_scrape_endpoint_and_clean_shutdown_match_jax(obses, stage):
    """Every manager serves ``/metrics``, ``/metrics.json`` and
    ``/tenants`` over real HTTP on the port asked for; a tenant-labelled
    shuffle shows in the scrape mid-run; an unknown path is a 404 and
    the endpoint answers after it; after stop the port refuses and no
    serving thread or transport thread is left."""
    def case(O):
        census0 = O.census()
        http = [O.port("scrape", 10 * stage + i) for i in range(3)]
        base = {"spark.shuffle.tpu.driverPort": 31500,
                "spark.shuffle.tpu.qosEnabled": True,
                "spark.shuffle.tpu.tenant": "scraped"}
        confs = [O.Conf({**base, "spark.shuffle.tpu.metricsHttpPort": p})
                 for p in http]
        with loop_cluster(O, confs[0], stage, confs=confs) as (_n, drv, exs):
            assert O.registry.enabled
            bound(*(m.metrics_http.port for m in [drv] + exs), want=http)
            handle, mbh = write_two_maps(O, drv, exs, 3,
                                         [(j % 7, j) for j in range(300)])
            records = [r for p in range(2) for r in exs[(p + 1) % 2]
                       .get_reader(handle, p, p + 1, mbh).read()]
            series = parse_prom(get(drv.metrics_http.url()).decode())
            tenant = sorted(s.split("{")[0] for s in series
                            if 'tenant="scraped"' in s)
            snap = json.loads(get(drv.metrics_http.url("/metrics.json")))
            tenants = json.loads(get(drv.metrics_http.url("/tenants")))
            with pytest.raises(urllib.error.HTTPError):
                get(drv.metrics_http.url("/nope"))
            again = bool(get(drv.metrics_http.url()))
            drv.unregister_shuffle(3)
        with pytest.raises(Exception):
            get(f"http://127.0.0.1:{http[0]}/metrics")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            left = [t.name for t in threading.enumerate()
                    if t.name.startswith("metrics-http-")]
            if not left:
                break
            time.sleep(0.05)
        census = O.census()
        return dict(
            records=len(records), tenant_series="qos_granted_bytes_total"
            in tenant, snap_keys={"counters", "gauges", "histograms"}
            <= set(snap), tenants=(tenants["enabled"], any(
                t["name"] == "scraped" for t in tenants["tenants"]),
                "3" in json.dumps(tenants["shuffles"])),
            again=again, left=left,
            threads=census["transport_threads"]
            <= census0["transport_threads"])

    got = both(obses, case)
    assert got == dict(records=600, tenant_series=True, snap_keys=True,
                       tenants=(True, True, True), again=True, left=[],
                       threads=True)


def test_health_and_flightrecorder_endpoints_match_jax(obses):
    """``/health`` and ``/flightrecorder`` answer over HTTP, with the
    recorder on and off."""
    def case(O):
        srv = O.http.MetricsHttpServer(O.port("health"))
        O.RECORDER.retain(ring_size=64)
        try:
            health = json.loads(get(srv.url("/health")))
            O.fr_event("tier", "warm", mkey=7, blocks=3)
            tier = json.loads(get(srv.url("/flightrecorder")))[
                "planes"]["tier"]["events"]
        finally:
            O.RECORDER.release()
            srv.stop()
        srv2 = O.http.MetricsHttpServer(O.port("health", 1))
        try:
            bound(srv.port, srv2.port,
                  want=[O.port("health"), O.port("health", 1)])
            off = json.loads(get(srv2.url("/flightrecorder")))
        finally:
            srv2.stop()
        return (health["status"], health["pid"] == os.getpid(),
                health["uptime_s"] >= 0,
                any(e[1] == "warm" and e[2]["mkey"] == 7 for e in tier), off)

    assert both(obses, case) == ("ok", True, True, True,
                                 {"enabled": False, "planes": {}})


# -- wire-version negotiation (tests/test_obs.py) ------------------------------


def test_connector_downgrades_to_v1_acceptor_matches_jax(obses):
    """An acceptor that NAKs with ``srv_ver=1`` is re-dialed at version 1,
    and the channel pins it."""
    def case(O):
        O.registry.enabled = True
        wire, port = O.tcp, O.port("v1_server")
        ready, hellos = threading.Event(), []

        def v1_server():
            srv = socket.create_server(("127.0.0.1", port))
            srv.settimeout(10)
            ready.set()
            for _ in range(2):
                sock, _addr = srv.accept()
                hello = b""
                while len(hello) < wire._HELLO.size:
                    hello += sock.recv(wire._HELLO.size - len(hello))
                ver = wire._HELLO.unpack(hello)[3]
                hellos.append(ver)
                if ver != 1:
                    sock.sendall(b"\x00" + wire._HELLO_REJ.pack(1, ver))
                    sock.close()
                    continue
                sock.sendall(b"\x01")
                srv.close()
                return sock

        t = threading.Thread(target=v1_server, daemon=True)
        t.start()
        assert ready.wait(5)
        node = O.Node(("127.0.0.1", port + 1), O.Conf(
            {"spark.shuffle.tpu.connectTimeout": "5s"}))
        downgrades = O.metrics.counter("wire_version_downgrades_total",
                                       transport="tcp")
        base = downgrades.value
        try:
            ch = O.TcpNetwork().connect(node, ("127.0.0.1", port),
                                        O.ChannelType.RPC_REQUESTOR)
            got = (ch.wire_version, hellos == [wire.WIRE_VERSION, 1],
                   downgrades.value - base)
            ch.stop()
        finally:
            node.stop()
            t.join(timeout=10)
        return got

    assert both(obses, case) == (1, True, 1)


def test_listener_accepts_v1_hello_matches_jax(obses):
    """A version-1 peer dialing a node's acceptor is admitted."""
    def case(O):
        port, wire = O.port("v1_listener"), O.tcp
        net = O.TcpNetwork()
        node = O.Node(("127.0.0.1", port), O.Conf({}))
        net.register(node)
        try:
            bound(node.address[1], want=[port])
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.settimeout(10)
            s.sendall(wire._HELLO.pack(wire._MAGIC, wire._TYPE_BY_INDEX.index(
                O.ChannelType.RPC_REQUESTOR), 55321, 1))
            ack = s.recv(1)
            s.close()
            return ack
        finally:
            node.stop()
            net.unregister(node)

    assert both(obses, case) == b"\x01"


# -- the chaos auto-dump and the merged trace (tests/test_obs.py) --------------


def report(*paths):
    out = subprocess.run([sys.executable, str(TRACE_REPORT),
                          *map(str, paths)], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("stage", STAGES)
def test_chaos_fetch_failure_auto_dumps_match_jax(obses, tmp_path, stage):
    """A serve fault on every read exhausts the retries; the terminal
    FetchFailedError auto-dumps the flight recorder, and
    tools/trace_report.py names the injected fault point in the dump."""
    def case(O):
        tmp = tmp_path / O.name
        tmp.mkdir()
        conf = O.Conf({
            "spark.shuffle.tpu.driverPort": 34220,
            "spark.shuffle.tpu.metrics": True,
            "spark.shuffle.tpu.faultInject": "serve:p=1;seed=11",
            "spark.shuffle.tpu.fetchRetryCount": 1,
            "spark.shuffle.tpu.fetchRetryWaitMs": "10ms",
            "spark.shuffle.tpu.flightRecorderDumpPath": str(tmp),
        })
        try:
            with loop_cluster(O, conf, stage) as (_n, driver, execs):
                handle, mbh = write_two_maps(O, driver, execs, 21,
                                             [(j % 5, j) for j in range(100)])
                with pytest.raises(O.reader.FetchFailedError):
                    list(execs[0].get_reader(handle, 0, 1, mbh).read())
        finally:
            O.imp("faults.injector").FAULTS.reset()
        dumps = sorted(tmp / f for f in os.listdir(tmp) if "fetch_failed" in f)
        assert dumps, os.listdir(tmp)
        text = report(dumps[0])
        return ("injected fault points:" in text,
                "serve" in text.split("injected fault points:")[-1],
                "reader/fetch_fail" in text, "faults/fault_fired" in text)

    assert both(obses, case) == (True,) * 4


def test_two_process_merged_trace_matches_jax(obses, tmp_path):
    """A peer fleet serving from its own process: the requester's trace
    context rides the READ_REQ tail, the child's ``serve_read`` events
    carry its trace id, and the two dumps merge into one trace over both
    pids, rendered as one waterfall."""
    pattern = (np.arange(1 << 16, dtype=np.uint32) % 251).astype(np.uint8)

    def case(O):
        tmp = tmp_path / O.name
        tmp.mkdir()
        fleet_dump = str(tmp / "fleet.json")
        fleet = O.simfleet.SimPeerFleetProc(1, O.port("fleet"),
                                            pattern.tobytes(),
                                            dump_path=fleet_dump)
        O.RECORDER.retain(ring_size=4096)
        O.TRACING.retain(1.0)
        node = O.Node(("127.0.0.1", O.port("fleet", 10)), O.Conf({}))
        ctx = O.TRACING.start()
        try:
            bound(fleet.addresses[0][1], want=[O.port("fleet")])
            L = O.BlockLocation
            locs = [L(64, 4096, 1), L(8192, 1024, 1)]
            done, res = threading.Event(), {}
            group = node.get_read_group(fleet.addresses[0],
                                        O.TcpNetwork().connect)
            group.read_blocks(locs, O.Listener(
                lambda blocks: (res.setdefault("blocks", blocks), done.set()),
                lambda e: (res.setdefault("error", e), done.set())),
                ctx=ctx.child())
            assert done.wait(30), "fleet read hung"
            exact = [bytes(memoryview(b)) == pattern[
                loc.address:loc.address + loc.length].tobytes()
                for loc, b in zip(locs, res["blocks"])]
        finally:
            node.stop()
            fleet.close()
        my_dump = str(tmp / "requester.json")
        assert O.collect.write_dump(my_dump, reason="test") == my_dump
        O.TRACING.release()
        O.RECORDER.release()
        doc = O.collect.merge_dumps([my_dump, fleet_dump])
        events = [e for e in O.collect.merged_events(doc)
                  if e["fields"].get("trace_id") == ctx.trace_id]
        pids = {e["pid"] for e in events}
        names = {(e["plane"], e["name"]) for e in events}
        server = pids - {os.getpid()}
        text = report(my_dump, fleet_dump)
        return (exact, len(pids), ("transport", "wire_send") in names,
                ("transport", "serve_read") in names,
                any(e["pid"] in server and e["name"] == "serve_read"
                    for e in events),
                f"trace 0x{ctx.trace_id:016x}" in text,
                "2 process(es)" in text)

    assert both(obses, case) == ([True, True], 2, True, True, True, True,
                                 True)


# -- the manager's wiring (tests/test_obs.py) ----------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_manager_retains_recorder_and_tracing_matches_jax(obses, tmp_path,
                                                          stage):
    """``traceEnabled`` and a dump path: the manager holds the recorder and
    the tracing plane for its lifetime and leaves a ``manager_stop``
    dump."""
    def case(O):
        tmp = tmp_path / O.name
        tmp.mkdir()
        mgr = O.Manager(O.Conf({
            "spark.shuffle.tpu.driverPort": 34260,
            "spark.shuffle.tpu.traceEnabled": True,
            "spark.shuffle.tpu.flightRecorderDumpPath": str(tmp)}),
            True, O.LoopbackNetwork(), stage)
        try:
            held = (O.RECORDER.enabled, O.TRACING.enabled)
        finally:
            mgr.stop()
        return held, (O.RECORDER.enabled, O.TRACING.enabled), any(
            "manager_stop" in f for f in os.listdir(tmp))

    assert both(obses, case) == ((True, True), (False, False), True)


@pytest.mark.parametrize("stage", STAGES)
def test_trace_off_shuffle_has_no_trace_events_matches_jax(obses, stage):
    """``traceEnabled`` off with the recorder on: no event carries a trace
    id, and the reader still records its lifecycle."""
    def case(O):
        conf = O.Conf({"spark.shuffle.tpu.driverPort": 34270,
                       "spark.shuffle.tpu.flightRecorder": True})
        with loop_cluster(O, conf, stage) as (_n, driver, execs):
            on = (O.RECORDER.enabled, O.TRACING.enabled)
            handle, mbh = write_two_maps(O, driver, execs, 22,
                                         [(j % 5, j) for j in range(100)])
            records = [r for p in range(2) for r in execs[(p + 1) % 2]
                       .get_reader(handle, p, p + 1, mbh).read()]
            snap = O.RECORDER.snapshot()
            traced = [(plane, name) for plane, rec in snap["planes"].items()
                      for _t, name, fields in rec["events"]
                      if fields.get("trace_id")]
            reader = {e[1] for e in snap["planes"]["reader"]["events"]}
            driver.unregister_shuffle(22)
        return on, len(records), traced, "fetch_enqueue" in reader

    assert both(obses, case) == ((True, False), 200, [], True)
