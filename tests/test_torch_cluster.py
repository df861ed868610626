"""The port's multi-process cluster harness
(``sparkrdma_tpu_torch.transport.simfleet.ProcessCluster``): the cases of
tests/test_cluster.py, with every manager on the CPU (``device="cpu"``).

Shuffles across real processes over sockets read back bit for bit
against a parent-side recomputation (the JAX package's record
generators and digests give the same values), the fleet census and
flight-recorder collection work, and an executor SIGKILLed mid-stage
leaves its reader a clean FetchFailedError while the survivor keeps
serving.  Each cluster binds its driver at 29700 (executors at 29800 and
29840), inside the range no other test uses; the clusters run one after
another, and the listeners reuse their addresses.
"""

import pytest

from sparkrdma_tpu.shuffle.partitioner import HashPartitioner as JHash
from sparkrdma_tpu.transport import simfleet as jfleet
from sparkrdma_tpu_torch.shuffle.partitioner import HashPartitioner
from sparkrdma_tpu_torch.transport.simfleet import (
    ExecutorCommandError,
    ProcessCluster,
    _gen_records,
    records_digest,
)

pytestmark = pytest.mark.cluster

NUM_PARTS = 4
SHUFFLE = 7
BASE_PORT = 29700


@pytest.fixture
def cluster(tmp_path):
    c = ProcessCluster(
        2, BASE_PORT,
        conf={
            "spark.shuffle.tpu.partitionLocationFetchTimeout": "15s",
            "spark.shuffle.tpu.connectTimeout": "10s",
            "spark.shuffle.tpu.fetchRetryWaitMs": "100ms",
        },
        workdir=str(tmp_path / "cluster"),
        device="cpu",
    )
    yield c
    c.stop()
    c.collect()


def _expected_partitions(gen, num_maps, num_parts):
    """Parent-side recomputation of every reducer's records; the JAX
    package's generators and partitioner give the same."""
    part, jpart = HashPartitioner(num_parts), JHash(num_parts)
    by_part = {p: [] for p in range(num_parts)}
    for map_id in range(num_maps):
        recs = list(_gen_records(gen, map_id))
        assert recs == list(jfleet._gen_records(gen, map_id))
        for k, v in recs:
            p = part.partition(k)
            assert p == jpart.partition(k)
            by_part[p].append((k, v))
    return by_part


def _write_all(cluster, shuffle_id, num_maps, gen):
    for map_id in range(num_maps):
        cluster.call(map_id % cluster.n_executors, "write",
                     shuffle_id=shuffle_id, map_id=map_id, gen=gen)
    cluster.wait_published(shuffle_id, num_maps)


def test_cross_process_shuffle_bit_exact(cluster):
    assert cluster.executor_devices == ["cpu", "cpu"]
    gen = {"kind": "terasort", "records": 300, "value_len": 32}
    cluster.register(SHUFFLE, num_maps=2, partitioner=("hash", NUM_PARTS))
    _write_all(cluster, SHUFFLE, 2, gen)
    expected = _expected_partitions(gen, 2, NUM_PARTS)
    total = 0
    for p in range(NUM_PARTS):
        out = cluster.read(p % 2, SHUFFLE, p, p + 1, digest=True)
        want = records_digest(expected[p])
        assert want == jfleet.records_digest(expected[p])
        assert out["digest"] == want, f"partition {p} diverged"
        total += out["records"]
    assert total == 2 * 300


def test_cross_process_wordcount_aggregated(cluster):
    gen = {"kind": "wordcount", "records": 400, "vocab": 23}
    cluster.register(SHUFFLE + 1, num_maps=2,
                     partitioner=("hash", NUM_PARTS), aggregator="sum",
                     map_side_combine=True)
    _write_all(cluster, SHUFFLE + 1, 2, gen)
    tally = {}
    for map_id in range(2):
        for k, v in _gen_records(gen, map_id):
            tally[k] = tally.get(k, 0) + v
    part = HashPartitioner(NUM_PARTS)
    got = {}
    for p in range(NUM_PARTS):
        out = cluster.read(p % 2, SHUFFLE + 1, p, p + 1)
        for k, v in out["data"]:
            assert part.partition(k) == p
            assert k not in got, f"key {k} emitted twice"
            got[k] = v
    assert got == tally


def test_fleet_census_and_obs_collection(cluster):
    census = cluster.census()
    assert sorted(census["executors"]) == [0, 1]
    for info in census["executors"].values():
        c = info["census"]
        assert c["pid"] != census["driver"]["pid"]
        assert c["fds"] > 0 and c["threads"] >= 1
        assert c["cpu_user_s"] >= 0.0
    cluster.stop()
    merged = cluster.collect()
    assert len(merged["dump_paths"]) >= 3
    assert len(merged["processes"]) == len(merged["dump_paths"])
    assert len(merged["log_paths"]) == 2


def test_executor_crash_mid_stage(cluster):
    gen = {"kind": "terasort", "records": 120, "value_len": 16}
    cluster.register(SHUFFLE + 2, num_maps=2,
                     partitioner=("hash", NUM_PARTS))
    _write_all(cluster, SHUFFLE + 2, 2, gen)
    cluster.kill(1)
    assert not cluster.executors[1].alive
    with pytest.raises(ExecutorCommandError) as exc:
        cluster.read(0, SHUFFLE + 2, 0, 1, timeout=120.0)
    assert exc.value.kind == "FetchFailedError"
    cluster.call(0, "register", shuffle_id=SHUFFLE + 3, num_maps=1,
                 partitioner=("hash", 2))
    cluster.call(0, "write", shuffle_id=SHUFFLE + 3, map_id=0, gen=gen)
    cluster.wait_published(SHUFFLE + 3, 1)
    expected = _expected_partitions(gen, 1, 2)
    for p in range(2):
        out = cluster.read(0, SHUFFLE + 3, p, p + 1, digest=True)
        assert out["digest"] == records_digest(expected[p])
