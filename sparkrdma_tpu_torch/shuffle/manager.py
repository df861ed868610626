"""TpuShuffleManager: the plugin-root API + driver control plane.

Analog of RdmaShuffleManager (RdmaShuffleManager.scala:38-388), the L1
surface of SURVEY.md §1: ``register_shuffle`` / ``get_writer`` /
``get_reader`` / ``unregister_shuffle`` / ``stop``, plus the
driver-mediated control plane:

- executors **hello** the driver on lazy start
  (startRdmaNodeIfMissing, :277-318),
- the driver **announces** full membership so executors pre-connect the
  peer mesh hot (:70-118),
- map tasks **publish** their location tables (:120-141),
- reducers **fetch-status** and the driver answers once the relevant
  tables' fill-futures resolve (:143-216),
- executor loss **prunes** driver maps (onBlockManagerRemoved,
  :253-263).

One manager per process; driver and executors are distinguished by
``is_driver`` exactly like the reference.  Each manager runs on one
device (``device=``, CUDA unless the caller asks for the CPU): on the
host read plane its committed map outputs are tensors there.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.conf import TpuShuffleConf
from sparkrdma_tpu_torch.faults.injector import FAULTS, FaultInjectedError
from sparkrdma_tpu_torch.memory.arena import ArenaManager
from sparkrdma_tpu_torch.memory.staging import StagingPool
from sparkrdma_tpu_torch.metrics import (
    counter,
    get_registry,
    write_json_snapshot,
    write_prometheus,
)
from sparkrdma_tpu_torch.obs import RECORDER, TRACING
from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device
from sparkrdma_tpu_torch.qos import WeightedCreditBroker, get_qos
from sparkrdma_tpu_torch.skew import get_skew
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock, dbg_rlock
from sparkrdma_tpu_torch.utils.statemachine import StateMachine
from sparkrdma_tpu_torch.utils.trace import get_tracer
from sparkrdma_tpu_torch.rpc.messages import (
    AnnounceShuffleManagersMsg,
    CleanShuffleMsg,
    ExchangePlanMsg,
    FetchExchangePlanMsg,
    FetchMapStatusFailedMsg,
    FetchMapStatusMsg,
    FetchMapStatusResponseMsg,
    FetchMergeStatusMsg,
    HeartbeatMsg,
    HelloMsg,
    MergeStatusResponseMsg,
    PrefetchHintMsg,
    PublishMapTaskOutputMsg,
    PublishShuffleMetricsMsg,
    PushSubBlockMsg,
    PUSH_MIN_WIRE_VERSION,
    RpcMsg,
    WireFormatError,
    decode_msg,
    hex_context,
)
from sparkrdma_tpu_torch.shuffle.map_output import MapTaskOutput
from sparkrdma_tpu_torch.shuffle.partitioner import Partitioner
from sparkrdma_tpu_torch.shuffle.push import PushMerger
from sparkrdma_tpu_torch.shuffle.resolver import ShuffleBlockResolver
from sparkrdma_tpu_torch.shuffle.writer import ShuffleWriter
from sparkrdma_tpu_torch.stats import ShuffleReaderStats
from sparkrdma_tpu_torch.transport.channel import (
    Channel,
    ChannelType,
    FnCompletionListener,
    TransportError,
)
from sparkrdma_tpu_torch.transport.node import Node
from sparkrdma_tpu_torch.utils.serde import (
    CompressedSerializer,
    PickleSerializer,
    Serializer,
)
from sparkrdma_tpu_torch.utils.types import (
    BlockLocation,
    BlockManagerId,
    ShuffleManagerId,
    get_cached_shuffle_manager_id,
)

logger = logging.getLogger(__name__)

# sentinel: the exchange-plan barrier is not failed, just not ready
# (e.g. a publisher's hello has not landed yet) — keep waiters queued
_PLAN_WAIT = object()

# driver keeps per-shuffle telemetry for this many recent shuffles
_TELEMETRY_KEEP = 64


def _fold_telemetry(acc, key: str, v):
    """Telemetry merge rule, applied identically at every aggregation
    layer (task→executor, executor→driver per-host, per-host→total):
    ``max_``-prefixed keys are maxima (summing a max across tasks or
    hosts corrupts it — the skew partition-balance stats ride this),
    everything else sums."""
    return max(acc, v) if key.startswith("max_") else acc + v


@dataclass
class Aggregator:
    """Combiner triple (Spark Aggregator analog)."""

    create_combiner: Callable[[Any], Any]
    merge_value: Callable[[Any, Any], Any]
    merge_combiners: Callable[[Any, Any], Any]


@dataclass
class ColumnarAggregator(Aggregator):
    """Aggregator the columnar plane can vectorize.

    ``kind`` names the combine: ``"group"`` (group_by_key — values
    collected per key) or a reduction ``"sum"``/``"min"``/``"max"``.
    The inherited scalar callables keep tuple-plane interop working, so
    a ColumnarAggregator is always safe to hand to the generic path."""

    kind: str = "group"

    _REDUCERS = {
        "sum": (lambda a, b: a + b),
        "min": min,
        "max": max,
    }

    @classmethod
    def group(cls) -> "ColumnarAggregator":
        return cls(
            create_combiner=lambda v: [v],
            merge_value=lambda c, v: c + [v],
            merge_combiners=lambda a, b: a + b,
            kind="group",
        )

    @classmethod
    def reduce(cls, kind: str) -> "ColumnarAggregator":
        if kind not in cls._REDUCERS:
            raise ValueError(
                f"unknown columnar reduction {kind!r} "
                f"(have {sorted(cls._REDUCERS)})"
            )
        f = cls._REDUCERS[kind]
        return cls(
            create_combiner=lambda v: v,
            merge_value=f,
            merge_combiners=f,
            kind=kind,
        )


@dataclass
class ShuffleHandle:
    """Returned by register_shuffle; carried to writers and readers
    (reference: Serialized/BaseShuffleHandle selection,
    RdmaShuffleManager.scala:267-274 — serialization strategy here is a
    Serializer instance rather than a handle subclass)."""

    shuffle_id: int
    num_maps: int
    partitioner: Partitioner
    aggregator: Optional[Aggregator] = None
    map_side_combine: bool = False
    key_ordering: bool = False
    # QoS tenant id this shuffle registered under (qos/registry.py);
    # empty until stamped by register_shuffle with qosEnabled
    tenant: str = ""

    def __post_init__(self):
        if self.map_side_combine and self.aggregator is None:
            raise ValueError("map_side_combine requires an aggregator")


class _FetchCallback:
    """Reassembles segmented fetch-status responses by (index, total)
    and fires once complete (registry analog of
    RdmaShuffleManager.scala:378-387); ``on_error`` fires instead when
    the driver answers with FetchMapStatusFailedMsg."""

    def __init__(self, on_locations: Callable[[List[BlockLocation]], None],
                 on_error: Optional[Callable[[str], None]] = None):
        self.on_locations = on_locations
        self.on_error = on_error
        self._parts: Dict[int, Tuple[BlockLocation, ...]] = {}  # guarded-by: _lock
        self._got = 0  # guarded-by: _lock
        self._lock = dbg_lock("manager.fetch_callback", 22)

    def on_response(self, msg: FetchMapStatusResponseMsg) -> None:
        with self._lock:
            if msg.index in self._parts:
                return  # duplicate segment
            self._parts[msg.index] = msg.locations
            self._got += len(msg.locations)
            done = self._got >= msg.total
            # snapshot under the lock; the callback runs outside it
            # (it issues fetches) and a straggling duplicate segment
            # must not mutate what we iterate
            parts = dict(self._parts) if done else None
        if done:
            locs: List[BlockLocation] = []
            for idx in sorted(parts):
                locs.extend(parts[idx])
            self.on_locations(locs)

    def on_failed(self, reason: str) -> None:
        if self.on_error is not None:
            self.on_error(reason)


class _PlanCallback:
    """Registry entry for a pending bulk-exchange plan request
    (shuffle/bulk.py); shares the callback id space and the negative
    FetchMapStatusFailed path with _FetchCallback."""

    def __init__(self, on_plan: Callable, on_error: Callable[[str], None]):
        self.on_plan = on_plan
        self.on_error = on_error

    def on_failed(self, reason: str) -> None:
        self.on_error(reason)


class _MergeCallback:
    """Registry entry for a pending merge-status query (push-based
    merged shuffle): accumulates one answer per reduce id — a wide
    answer's provenance may split across segments, each repeating
    ``rows_total`` — and fires ``on_status`` once every queried id has
    a full answer.  Shares the callback id space and the negative
    FetchMapStatusFailed path with _FetchCallback."""

    def __init__(self, on_status: Callable[[Dict], None],
                 on_error: Callable[[str], None]):
        self.on_status = on_status
        self.on_error = on_error
        # reduce_id -> (mkey, length, rows_total)
        self._meta: Dict[int, Tuple[int, int, int]] = {}  # guarded-by: _lock
        # reduce_id -> {rel_off: (map_id, rel_off, rel_len)}
        self._rows: Dict[int, Dict] = {}  # guarded-by: _lock
        self._done: set = set()  # guarded-by: _lock
        self._fired = False  # guarded-by: _lock
        self._lock = dbg_lock("manager.merge_callback", 23)

    def on_response(self, msg: MergeStatusResponseMsg) -> None:
        with self._lock:
            if self._fired or msg.reduce_id in self._done:
                return
            meta = self._meta.setdefault(
                msg.reduce_id, (msg.mkey, msg.length, msg.rows_total)
            )
            rows = self._rows.setdefault(msg.reduce_id, {})
            for row in msg.provenance:
                rows[row[1]] = row  # rel_off-keyed: dedups resent rows
            if len(rows) < meta[2]:
                return  # more provenance segments in flight
            self._done.add(msg.reduce_id)
            if len(self._done) < msg.total:
                return
            self._fired = True
            result = {
                rid: (
                    self._meta[rid][0], self._meta[rid][1],
                    tuple(sorted(self._rows[rid].values(),
                                 key=lambda r: r[1])),
                )
                for rid in self._done
            }
        # fires outside the lock — the reader enqueues fetches from it
        self.on_status(result)

    def on_failed(self, reason: str) -> None:
        self.on_error(reason)


class TpuShuffleManager(StateMachine):
    """One per process.  ``network`` supplies the transport connector
    (LoopbackNetwork in-process; a real fabric connector on a pod)."""

    MACHINE = "manager.lifecycle"
    STATES = ("running", "stopping", "stopped")
    INITIAL = "running"
    TERMINAL = ("stopped",)
    TRANSITIONS = {
        "running": ("stopping",),
        "stopping": ("stopped",),
    }

    def __init__(
        self,
        conf: TpuShuffleConf,
        is_driver: bool,
        network,
        host: str = "127.0.0.1",
        port: int = 0,
        executor_id: str = "driver",
        serializer: Optional[Serializer] = None,
        stage_to_device: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        # the executor's card (CUDA unless the caller asks for the
        # CPU): committed map outputs are staged there
        self.device = resolve_device(device)
        if stage_to_device is None:
            # plane-aware default: windowed/bulk exchanges source their
            # streams from HOST block reads (the collective stages the
            # bytes itself), so committing map outputs into device
            # memory first would only add a per-block device round
            # trip.  The host plane resolves to device staging.
            stage_to_device = conf.read_plane not in ("bulk", "windowed")
        self.conf = conf
        self.is_driver = is_driver
        self.network = network
        self.executor_id = executor_id
        if conf.metrics_enabled:
            # flip the process-wide registry on BEFORE any instrumented
            # object (node, arena, pool, writer) fetches its handles
            get_registry().enabled = True
        if conf.lock_debug:
            # same flow for the lock sanitizer: locks created from here
            # on are rank-checked DebugLock wrappers (utils/dbglock.py)
            from sparkrdma_tpu_torch.utils.dbglock import get_lock_factory

            get_lock_factory().enabled = True
        if conf.resource_debug:
            # and the resource-lifecycle ledger (utils/ledger.py):
            # every annotated acquire from here on hands out a live
            # ticket; stop() renders the leak report
            from sparkrdma_tpu_torch.utils.ledger import get_resource_ledger

            get_resource_ledger().enabled = True
            # register as an owner: in a multi-manager process only
            # the LAST manager's stop flushes the leak report (the
            # others' live channels are not leaks)
            get_resource_ledger().retain()
        if conf.wire_debug:
            # and the wire-frame validator (utils/wiredbg.py): every
            # frame both engines and the loopback plane receive from
            # here on is header- and schema-checked before dispatch
            from sparkrdma_tpu_torch.utils.wiredbg import set_wire_debug

            set_wire_debug(True)
        if conf.state_debug:
            # and the lifecycle state-machine validator
            # (utils/statemachine.py): every _transition() from here on
            # is checked against its declared table; a non-zero
            # schedShake seed additionally perturbs the schedule at
            # each validated transition
            from sparkrdma_tpu_torch.utils.statemachine import get_state_debug

            get_state_debug().enabled = True
            get_state_debug().shake_seed = conf.sched_shake
        # deterministic fault plane (faults/): arm the process-global
        # injector from the seeded spec BEFORE building the node, so
        # every fault point the transport/memory/control planes pass
        # through sees the schedule from the first call.  Empty spec
        # (the default) leaves FAULTS.enabled False — each woven point
        # costs one attribute check and nothing else.
        self._faults_armed = False
        if conf.fault_inject:
            FAULTS.arm(conf.fault_inject)
            self._faults_armed = True
        # multi-tenant QoS (qos/): flip the process-global tenant
        # registry on BEFORE building the node, exactly like the
        # metrics registry — the node's pools classify/broker through
        # it from their first task.  None keeps every edge plain FIFO.
        self.qos = None
        if conf.qos_enabled:
            self.qos = get_qos()
            self.qos.enabled = True
        # skew-adaptive partitioning (skew/): same process-global
        # registry flip — writers consult it at commit to split hot
        # partitions into sub-blocks, readers to resolve the markers.
        # None (the default) keeps every commit and fetch bit-identical
        # to the pre-skew path.
        self.skew = None
        if conf.skew_enabled:
            self.skew = get_skew()
            self.skew.enabled = True
        # live scrape endpoint (qos/http.py): serves /metrics,
        # /metrics.json and /tenants for the manager's lifetime
        self.metrics_http = None
        if conf.metrics_http_port >= 0:
            from sparkrdma_tpu_torch.qos.http import MetricsHttpServer

            try:
                self.metrics_http = MetricsHttpServer(
                    conf.metrics_http_port,
                    host=conf.metrics_http_host,
                )
            except OSError:
                logger.exception(
                    "metrics scrape endpoint on port %d failed to bind "
                    "— continuing without it", conf.metrics_http_port,
                )
        if serializer is not None:
            self.serializer = serializer
        else:
            name = conf.serializer_name
            if name == "columnar":
                from sparkrdma_tpu_torch.utils.serde import ColumnarSerializer

                inner: Serializer = ColumnarSerializer()
            elif name in ("", "pickle"):
                inner = PickleSerializer()
            else:
                raise ValueError(
                    f"unknown serializer {name!r} (want columnar|pickle)"
                )
            self.serializer = (
                CompressedSerializer(
                    inner, codec=conf.compress_codec,
                    frame_records=conf.compress_frame_records,
                )
                if conf.compress else inner
            )
        self.stats = (
            ShuffleReaderStats(conf)
            if conf.collect_shuffle_reader_stats else None
        )

        if is_driver:
            port = port or conf.driver_port or 37000
        else:
            # reference: spark.shuffle.rdma.executorPort (+ retries)
            port = port or conf.executor_port
        self.node = self._bind_node(host, port)
        self.node.set_receive_listener(self._receive)
        if is_driver:
            conf.set_driver_port(self.node.address[1])
            conf.set("driverHost", host)
        self.local_smid = get_cached_shuffle_manager_id(
            ShuffleManagerId(
                self.node.address[0],
                self.node.address[1],
                BlockManagerId(executor_id, host, self.node.address[1]),
            )
        )

        if conf.trace:
            get_tracer().enabled = True
        # observability plane (obs/): the flight recorder's per-plane
        # event rings and the distributed-trace context generator.
        # Owner-counted like the fault injector — in-process clusters
        # retain per manager, and only the LAST stop() turns them off.
        self._obs_retained = False
        self._tracing_retained = False
        if conf.flight_recorder:
            RECORDER.retain(
                ring_size=conf.flight_recorder_ring_size,
                dump_dir=conf.flight_recorder_dump_path,
            )
            self._obs_retained = True
        if conf.trace_enabled:
            TRACING.retain(conf.trace_sample_rate)
            self._tracing_retained = True
        # persistent per-device HBM arena — set when a CollectiveNetwork
        # attaches this executor to a mesh device
        self.device_arena = None
        self.arena = ArenaManager(conf.max_buffer_allocation_size)
        self.staging_pool = StagingPool(conf.max_buffer_allocation_size)
        # bulk TCP receives land in pooled buffers served as zero-copy
        # slices (release tied to slice GC, the
        # BufferReleasingInputStream analog)
        self.node.staging_pool = self.staging_pool
        if not is_driver and conf.max_agg_prealloc > 0:
            # warm the pool off the critical path (reference: async
            # preallocation, RdmaBufferManager.java:112-120)
            threading.Thread(
                target=self.staging_pool.prealloc,
                args=(conf.max_agg_prealloc, conf.max_agg_block),
                daemon=True,
            ).start()
        # tiered residency for file-backed commits (memory/tier.py):
        # hot blocks in budgeted pooled rows, cold blocks on disk with
        # prefetch promotion riding the node's serve-pool credits
        from sparkrdma_tpu_torch.memory.tier import TieredBlockStore
        from sparkrdma_tpu_torch.qos import BULK as _QOS_BULK

        self.tier_store = TieredBlockStore(
            staging_pool=self.staging_pool,
            hot_bytes=conf.tier_hot_bytes,
            prefetch_blocks=(
                conf.tier_prefetch_blocks if conf.tier_prefetch else 0
            ),
            # readahead warms ride the serve pool at BULK class — a
            # prefetch storm never outranks demand serves
            submitter=lambda fn, args, cost: self.node.submit_serve(
                fn, args, cost, cls=_QOS_BULK
            ),
            qos=self.qos,
        )
        self.node.tier_store = self.tier_store
        self.resolver = ShuffleBlockResolver(
            self.arena, self.node,
            stage_to_device=stage_to_device and not conf.lazy_staging,
            staging_pool=self.staging_pool,
            file_backed_threshold=conf.file_backed_commit_bytes,
            spill_dir=conf.spill_dir,
            lazy_staging=conf.lazy_staging,
            write_block_size=conf.shuffle_write_block_size,
            direct_io=conf.direct_io,
            tier_store=self.tier_store,
            device=self.device,
        )
        # push-based merged shuffle (shuffle/push.py): every manager
        # runs a merger endpoint — receiving is cheap and peers' conf
        # may differ — but nothing arrives unless a writer with
        # pushEnabled selects this node for a reduce partition
        self.push_merger = PushMerger(
            conf, self.arena, tier_store=self.tier_store,
            node=self.node, spill_dir=conf.spill_dir,
            direct_io=conf.direct_io,
        )

        # driver-side metadata (RdmaShuffleManager.scala:46-57)
        # join order  # (see README "Concurrency discipline" rank table)
        self._executors: List[ShuffleManagerId] = []  # guarded-by: _executors_lock
        # tombstones for pruned executors
        self._removed: set = set()  # guarded-by: _executors_lock
        self._executors_lock = dbg_lock("manager.executors", 16)
        self._shuffle_partitions: Dict[int, int] = {}
        self._shuffle_num_maps: Dict[int, int] = {}
        # shuffle -> host smid -> map_id -> table
        self._outputs: Dict[
            int, Dict[ShuffleManagerId, Dict[int, MapTaskOutput]]
        ] = {}  # guarded-by: _outputs_lock
        self._outputs_lock = dbg_lock("manager.outputs", 14)
        # pending bulk-exchange plan requests (driver): shuffle_id →
        # [(msg, reply channel)], answered once every map published
        self._plan_waiters: Dict[int, List] = {}  # guarded-by: _plan_lock
        self._plan_cache: Dict[int, tuple] = {}  # guarded-by: _plan_lock
        # bulk plans are only valid for the membership they were
        # registered under: every executor REMOVAL bumps the epoch and
        # dooms shuffles registered before it (additions are safe — the
        # cached snapshot keeps all requesters consistent)
        self._membership_epoch = 0  # guarded-by: _plan_lock
        self._shuffle_epoch: Dict[int, int] = {}  # guarded-by: _plan_lock
        self._plan_lock = dbg_lock("manager.plan", 12)
        # bumped (under _plan_lock) on every hello: lets the barrier
        # detect a hello that raced its pop/requeue of plan waiters
        self._hello_gen = 0
        # incremental (windowed) bulk plans: per-shuffle window state —
        # built in order under _window_lock (see _maybe_answer_windows)
        self._window_state: Dict[int, dict] = {}  # guarded-by: _window_lock
        # the OUTERMOST rank: window planning calls into the plan/
        # outputs/executors locks below it; reentrant because
        # _pin_window_hosts re-enters from _try_build_window
        self._window_lock = dbg_rlock("manager.window", 10)
        # shuffle → first-seen plan mode (True = windowed); mixed modes
        # across hosts (conf skew) are rejected at request time
        self._plan_mode: Dict[int, bool] = {}
        # shuffle → hosts that requested windowed plans (participation
        # evidence for host-set pinning ahead of a racing hello)
        self._window_requesters: Dict[int, set] = {}
        self._fetch_pool = (
            ThreadPoolExecutor(max_workers=8, thread_name_prefix="drv-fetch")
            if is_driver
            else None
        )

        # executor-side state
        self._peers: List[ShuffleManagerId] = []
        self._callbacks: Dict[int, _FetchCallback] = {}  # guarded-by: _callbacks_lock
        self._callbacks_lock = dbg_lock("manager.callbacks", 18)
        self._next_callback_id = 1
        self._hello_sent = False
        # manager lifecycle: check-and-flip UNDER _life_lock — two
        # concurrent stop() calls (SparkContext teardown racing an
        # atexit hook or a test fixture) must not both run the
        # teardown body, which releases owner-counted globals
        # (RECORDER/TRACING/ledger) and would double-release them
        self._life_lock = dbg_lock("manager.lifecycle", 16)
        self._state = "running"  # state: manager.lifecycle guarded-by: _life_lock
        # per-shuffle telemetry: local accumulators (writers/readers
        # record in), published to the driver at unregister time the
        # same way map-output locations flow; the driver keeps the last
        # _TELEMETRY_KEEP shuffles' per-host snapshots
        self._telemetry: Dict[int, Dict[str, float]] = {}  # guarded-by: _telemetry_lock
        self._telemetry_lock = dbg_lock("manager.telemetry", 20)
        self._shuffle_telemetry: Dict[
            int, Dict[str, Dict[str, float]]
        ] = {}  # guarded-by: _telemetry_lock
        # unified reactive device plane (readPlane=windowed): attached
        # by the job layer (shared in-process session) or lazily built
        # by get_reader (one exchange per process on a multi-host mesh)
        self.windowed_plane = None
        # reduce-side decode pool (shuffle/decode.py): lazily built on
        # the first pipelined read when conf decodeThreads > 0; shared
        # by every reader of this manager like the node's serve pool
        # (same double-checked create: benign unlocked fast-path read)
        self._decode_pool = None
        self._decode_lock = dbg_lock("manager.decode_pool", 21)
        # brokered in-flight fetch window (qos/): every reader of this
        # manager shares ONE weighted maxBytesInFlight budget across
        # tenants (per-tenant qosTenantMaxInFlight caps ride on it);
        # None (QoS off) keeps each reader's private window alone
        self._qos_inflight = None
        if self.qos is not None:
            from sparkrdma_tpu_torch.utils.dbglock import dbg_condition

            self._qos_inflight_cv = dbg_condition(
                "manager.qos_inflight", 31
            )
            self._qos_inflight = WeightedCreditBroker(
                "inflight", conf.max_bytes_in_flight,
                self._qos_inflight_cv,
                qos=self.qos, classed=True,
                aging_ms=conf.qos_aging_ms, quota_inflight=True,
                wait_counter=counter(
                    "shuffle_inflight_credit_waits_total"
                ),
            )

        # heartbeat plane (driver side): last ack time per executor +
        # monitor thread — the CM DISCONNECTED/onBlockManagerRemoved
        # analog (RdmaNode.java:176-189, RdmaShuffleManager.scala:253-263)
        self._last_ack: Dict[ShuffleManagerId, float] = {}
        self._hb_seq = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if is_driver and conf.heartbeat_interval_ms > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="drv-heartbeat",
            )
            self._hb_thread.start()

        if not is_driver:
            self._say_hello()

    # -- node binding with port retries (RdmaNode.java:73-87) ---------------
    def _bind_node(self, host: str, port: int) -> Node:
        last_err = None
        base = port or 38000
        for attempt in range(self.conf.port_max_retries):
            node = Node((host, base + attempt), self.conf,
                        is_executor=not self.is_driver)
            try:
                self.network.register(node)
                return node
            except Exception as e:
                node.stop()  # release the failed node's dispatcher threads
                last_err = e
                # a silent move is a debugging nightmare: every peer
                # that dials the CONFIGURED port sees dead refusals,
                # so the move must at least be visible in the log
                logger.warning(
                    "bind at %s:%d failed (%s) — retrying at %d",
                    host, base + attempt, e, base + attempt + 1,
                )
        raise RuntimeError(f"could not bind node near {host}:{base}") from last_err

    # -- control-plane send helpers -----------------------------------------
    def _driver_channel(self) -> Channel:
        addr = (self.conf.driver_host, self.conf.driver_port)
        return self.node.get_channel(
            addr, ChannelType.RPC_REQUESTOR, self.network.connect
        )

    def _send_msg(self, channel: Channel, msg: RpcMsg,
                  on_failure: Optional[Callable] = None
                  ) -> None:
        # pin the frames to the channel's negotiated wire generation so
        # v2-only tail fields stay off frames bound for v1 peers
        # (wire_version 0 = unversioned/in-process = current)
        frames = msg.encode_segments(
            self.conf.recv_wr_size,
            wire_version=channel.wire_version or None,
        )
        channel.send_rpc(
            frames,
            FnCompletionListener(on_failure=on_failure or (
                lambda e: logger.warning("rpc send failed: %s", e)
            )),
        )

    def _send_via(self, addr: Tuple[str, int], channel_type: ChannelType,
                  msg: RpcMsg, on_failure: Optional[Callable] = None,
                  must_retry: bool = True) -> None:
        """get_channel + send with ONE eviction-race retry: the node's
        bounded channel cache may evict an RPC channel between the
        cache lookup and the post (synchronous TransportError, listener
        untouched) — the retried get_channel reconnects the evicted
        key.  A genuinely dead peer still fails: the reconnect itself
        raises, or the retried post's failure propagates."""
        for attempt in (0, 1):
            ch = self.node.get_channel(
                addr, channel_type, self.network.connect,
                must_retry=must_retry,
            )
            try:
                self._send_msg(ch, msg, on_failure)
                return
            except TransportError:
                if attempt:
                    raise
                counter("transport_channel_evict_races_total").inc()

    def _send_driver_msg(self, msg: RpcMsg,
                         on_failure: Optional[Callable] = None) -> None:
        self._send_via(
            (self.conf.driver_host, self.conf.driver_port),
            ChannelType.RPC_REQUESTOR, msg, on_failure,
        )

    def _say_hello(self) -> None:
        if self._hello_sent:
            return
        self._hello_sent = True
        msg = HelloMsg(self.local_smid, self.node.address[1])
        self._send_driver_msg(msg)

    # -- receive dispatch ----------------------------------------------------
    def _receive(self, channel: Channel, frame: bytes) -> None:
        try:
            msg = decode_msg(frame)
        except WireFormatError as e:
            # one-frame blast radius: the channel stays up, the frame
            # is counted and dropped with structured context — an
            # unknown MSG_TYPE (future peer?) is tallied apart from a
            # frame whose declared type fails its own schema
            kind = "msg_type" if e.unknown_type else "malformed"
            counter(
                "wire_unknown_frames_total", engine="control", kind=kind
            ).inc()
            logger.warning(
                "dropping control frame (%s): %s (frame %s)",
                kind, e, hex_context(bytes(frame)),
            )
            return
        except ValueError:
            logger.exception("dropping malformed control frame")
            return
        if isinstance(msg, HelloMsg):
            self._handle_hello(msg)
        elif isinstance(msg, AnnounceShuffleManagersMsg):
            self._handle_announce(msg)
        elif isinstance(msg, PublishMapTaskOutputMsg):
            self._handle_publish(msg)
        elif isinstance(msg, FetchMapStatusMsg):
            self._handle_fetch_status(msg, channel)
        elif isinstance(msg, FetchMapStatusResponseMsg):
            self._handle_fetch_response(msg)
        elif isinstance(msg, FetchMapStatusFailedMsg):
            self._handle_fetch_failed(msg)
        elif isinstance(msg, HeartbeatMsg):
            self._handle_heartbeat(msg, channel)
        elif isinstance(msg, FetchExchangePlanMsg):
            self._handle_fetch_plan(msg, channel)
        elif isinstance(msg, ExchangePlanMsg):
            self._handle_exchange_plan(msg)
        elif isinstance(msg, PublishShuffleMetricsMsg):
            self._handle_shuffle_metrics(msg)
        elif isinstance(msg, PrefetchHintMsg):
            self._handle_prefetch_hint(msg)
        elif isinstance(msg, CleanShuffleMsg):
            self._handle_clean_shuffle(msg)
        elif isinstance(msg, PushSubBlockMsg):
            self._handle_push_sub_block(msg)
        elif isinstance(msg, FetchMergeStatusMsg):
            self._handle_fetch_merge_status(msg, channel)
        elif isinstance(msg, MergeStatusResponseMsg):
            self._handle_merge_response(msg)

    # -- heartbeat / failure detection ---------------------------------------
    def _heartbeat_loop(self) -> None:
        """Driver liveness monitor: ping every executor each interval;
        prune executors whose acks stop (or whose ping can't even be
        posted — the loopback-partition / dead-TCP-peer fast path)."""
        import time as _time

        interval = self.conf.heartbeat_interval_ms / 1000.0
        timeout = self.conf.heartbeat_timeout_ms / 1000.0
        while not self._hb_stop.wait(interval):
            self._hb_seq += 1
            now = _time.monotonic()
            for smid in self.executors:
                if self._hb_stop.is_set():
                    break  # quiesced mid-sweep: stop probing/pruning
                # the monitor must survive anything one executor's
                # bookkeeping throws — a dead monitor silently disables
                # failure detection for the rest of the job
                try:
                    last = self._last_ack.get(smid, now)
                    if now - last > timeout:
                        logger.warning(
                            "driver: executor %s missed heartbeats for "
                            "%.1fs — pruning",
                            smid.block_manager_id.executor_id, now - last,
                        )
                        self.remove_executor(smid)
                        continue
                    if FAULTS.enabled and FAULTS.fires("heartbeat"):
                        # dropped probe, NOT a raised error: a raised
                        # send failure would prune the executor, but
                        # this point models a lost packet — the peer
                        # stays alive and the next sweep probes again
                        continue
                    try:
                        # _send_via retries once on the eviction race:
                        # a cache-evicted (healthy) channel must not
                        # read as a dead executor and trigger a prune
                        self._send_via(
                            (smid.host, smid.port),
                            ChannelType.RPC_REQUESTOR,
                            HeartbeatMsg(self.local_smid, self._hb_seq,
                                         False),
                            on_failure=lambda e, smid=smid:
                                self._on_executor_send_failure(smid, e),
                            must_retry=False,
                        )
                    except Exception as e:
                        self._on_executor_send_failure(smid, e)
                except Exception:
                    logger.exception(
                        "heartbeat monitor: probe of %s failed", smid.host
                    )

    def _on_executor_send_failure(self, smid: ShuffleManagerId,
                                  err: BaseException) -> None:
        """A control-plane send to an executor failed outright: its
        channel is dead (partition / closed peer).  Prune immediately —
        the reference gets this signal from CM DISCONNECTED events."""
        # racy shutdown hint only — stop() re-checks under _life_lock
        if self._state != "running" or self._hb_stop.is_set():  # noqa: SC03 hint
            return
        import sys as _sys

        # racy quiescence probe, not a decision point
        if (self._state != "running" or self.node._stopped.is_set()  # noqa: SC03
                or _sys.is_finalizing()):
            # OUR node (or the interpreter) is shutting down — that is
            # quiescence, not an executor failure; stop probing instead
            # of spamming prunes.  Classified by explicit state ONLY:
            # manager.stop() and node.stop() both set their flag before
            # shutting any pool, and sys.is_finalizing() covers the
            # interpreter-shutdown RuntimeError — so a foreign
            # RuntimeError whose message merely LOOKS like a pool
            # shutdown ("cannot schedule new futures ...") still falls
            # through and prunes the dead peer (round-4 verdict: the
            # old substring heuristic silently reverted to the round-3
            # bug class whenever CPython reworded the message).
            logger.info("heartbeat monitor quiescing (%s)", err)
            self._hb_stop.set()
            return
        with self._executors_lock:
            known = smid in self._executors
        if known:
            logger.warning(
                "driver: channel to executor %s dead (%s) — pruning",
                smid.block_manager_id.executor_id, err,
            )
            self.remove_executor(smid)

    def _handle_heartbeat(self, msg: HeartbeatMsg, channel: Channel) -> None:
        if msg.is_ack:
            import time as _time

            self._last_ack[msg.shuffle_manager_id] = _time.monotonic()
            return
        # executor side: echo on the receiving channel's reply path
        try:
            self._send_msg(
                channel.reply_channel(),
                HeartbeatMsg(self.local_smid, msg.seq, True),
            )
        except Exception:
            logger.warning("heartbeat ack failed", exc_info=True)

    # -- driver handlers -----------------------------------------------------
    def _handle_hello(self, msg: HelloMsg) -> None:
        assert self.is_driver, "hello must only reach the driver"
        import time as _time

        smid = msg.shuffle_manager_id
        with self._executors_lock:
            self._removed.discard(smid)  # re-join after a prune is legal
            if smid not in self._executors:
                self._executors.append(smid)
            members = list(self._executors)
            # a hello is liveness proof: REFRESH the ack clock
            # (setdefault would keep a pre-partition timestamp, and the
            # monitor's next sweep would re-prune a healed executor
            # that re-helloed before its first fresh ack landed — found
            # by the seeded chaos sweep).  Inside the membership lock
            # so a concurrent sweep can't interleave its stale read
            # between this handler's membership write and clock write
            # (remove_executor prunes under the same lock).
            self._last_ack[smid] = _time.monotonic()
        logger.info("driver: hello from %s (now %d executors)",
                    smid.block_manager_id.executor_id, len(members))
        announce = AnnounceShuffleManagersMsg(members)
        for peer in members:
            try:
                self._send_via(
                    (peer.host, peer.port), ChannelType.RPC_REQUESTOR,
                    announce,
                )
            except Exception:
                logger.exception("driver: announce to %s failed", peer.host)
        # a bulk-plan barrier may be waiting on exactly this hello (a
        # publish can land before its publisher's hello — separate
        # channels): re-trigger pending barriers
        with self._plan_lock:
            self._hello_gen += 1
            pending = list(self._plan_waiters.keys())
        for sid in pending:
            self._maybe_answer_plans(sid)

    def _handle_announce(self, msg: AnnounceShuffleManagersMsg) -> None:
        with self._executors_lock:
            for smid in msg.shuffle_manager_ids:
                if smid not in self._peers:
                    self._peers.append(smid)
            peers = [p for p in self._peers if p != self.local_smid]
        # pre-connect the peer mesh in the background so the first fetch
        # is hot (reference: RdmaShuffleManager.scala:111-118) — but
        # only up to the bounded cache's free room: warming past the
        # cap would be pure connect/evict churn that also evicts
        # genuinely hot channels (at 256-peer fan-out the mesh cannot
        # be all-hot by definition; fetches connect lazily instead)
        def warm():
            cap = self.node._max_cached
            for peer in peers:
                if cap > 0:
                    with self.node._active_lock:
                        room = cap - len(self.node._active)
                    if room <= 0:
                        logger.info(
                            "mesh pre-connect stopped at the channel-"
                            "cache cap (%d): remaining peers connect "
                            "lazily on first fetch", cap,
                        )
                        return
                try:
                    self.node.get_channel(
                        (peer.host, peer.port), ChannelType.READ_REQUESTOR,
                        self.network.connect,
                    )
                except Exception:
                    logger.warning("pre-connect to %s:%d failed",
                                   peer.host, peer.port)
        threading.Thread(target=warm, daemon=True).start()

    def _get_or_create_mto(
        self, shuffle_id: int, host: ShuffleManagerId, map_id: int,
        num_partitions: Optional[int] = None,
    ) -> MapTaskOutput:
        with self._outputs_lock:
            by_host = self._outputs.setdefault(shuffle_id, {})
            by_map = by_host.setdefault(host, {})
            mto = by_map.get(map_id)
            if mto is None:
                n = num_partitions or self._shuffle_partitions.get(shuffle_id)
                if n is None:
                    raise KeyError(
                        f"shuffle {shuffle_id} not registered on driver"
                    )
                mto = by_map.setdefault(map_id, MapTaskOutput(n))
            return mto

    def _handle_publish(self, msg: PublishMapTaskOutputMsg) -> None:
        assert self.is_driver, "publish must only reach the driver"
        with self._executors_lock:
            tombstoned = msg.shuffle_manager_id in self._removed
        if tombstoned:
            # an in-flight publish racing the executor's prune must not
            # resurrect its outputs (they are unreachable: fetch-status
            # fails fast for tombstoned hosts, and a later duplicate
            # prune no longer re-clears state)
            logger.warning(
                "dropping publish from removed executor %s (shuffle=%d "
                "map=%d)", msg.shuffle_manager_id, msg.shuffle_id,
                msg.map_id,
            )
            return
        mto = self._get_or_create_mto(
            msg.shuffle_id, msg.shuffle_manager_id, msg.map_id,
            msg.total_num_partitions,
        )
        # skew-split outputs publish EXTRA sub-block rows past the
        # logical partition count, but an early fetch-status query may
        # have pre-created this table at the logical size — widen to
        # the sender's row count BEFORE any segment lands, so the fill
        # future can only complete at the extended threshold
        mto.ensure_capacity(msg.total_num_partitions)
        mto.put_range(
            msg.first_reduce_id, msg.last_reduce_id, msg.entries,
            epoch=msg.epoch,
        )
        self._maybe_answer_plans(msg.shuffle_id)

    def _handle_fetch_status(self, msg: FetchMapStatusMsg, channel: Channel) -> None:
        assert self.is_driver, "fetch-status must only reach the driver"

        def reply_failed(reason: str) -> None:
            # immediate negative answer → requester converts to a
            # metadata fetch failure and the stage retries NOW instead
            # of riding out the full location timeout
            logger.warning("fetch-status failed (shuffle=%d): %s",
                           msg.shuffle_id, reason)
            try:
                self._send_msg(
                    channel.reply_channel(),
                    FetchMapStatusFailedMsg(msg.callback_id, reason),
                )
            except Exception:
                logger.exception("fetch-status failure reply failed")

        with self._executors_lock:
            tombstoned = msg.host in self._removed
        if tombstoned:
            reply_failed(
                f"executor {msg.host.host}:{msg.host.port} was removed"
            )
            return
        try:
            mtos = {
                mid: self._get_or_create_mto(msg.shuffle_id, msg.host, mid)
                for mid in {m for m, _ in msg.block_ids}
            }
        except KeyError:
            reply_failed(f"shuffle {msg.shuffle_id} not registered on driver")
            return

        def answer():
            # all futures are complete (or failed) by the time this runs
            try:
                failed = [
                    m for m, t in mtos.items()
                    if t.fill_future.exception() is not None
                ]
                if failed:
                    # executor lost mid-publish
                    reply_failed(
                        f"maps {sorted(failed)} lost before publish "
                        f"completed (executor removed)"
                    )
                    return
                locs = [mtos[m].get_location(r) for m, r in msg.block_ids]
                resp = FetchMapStatusResponseMsg(
                    msg.callback_id, msg.total, msg.index, locs
                )
                self._send_msg(channel.reply_channel(), resp)
            except Exception:
                logger.exception(
                    "fetch-status reply failed (shuffle=%d host=%s)",
                    msg.shuffle_id, msg.host.host,
                )

        # chain on the fill futures instead of blocking a pool thread, so
        # a straggler map can never starve answerable requests
        self._when_all_filled(mtos.values(), answer)

    def _when_all_filled(self, mtos, fn) -> None:
        """Run ``fn`` on the fetch pool once every table's fill future
        is done (completed OR failed) — chained, never blocking a pool
        thread.  Shared by the pull path (fetch-status) and the bulk
        plan barrier."""
        remaining = [t for t in mtos if not t.fill_future.done()]
        if not remaining:
            self._fetch_pool.submit(fn)
            return
        countdown = {"n": len(remaining)}
        lock = threading.Lock()

        def on_done(_fut):
            with lock:
                countdown["n"] -= 1
                last = countdown["n"] == 0
            if last:
                self._fetch_pool.submit(fn)

        for t in remaining:
            t.fill_future.add_done_callback(on_done)

    # -- bulk-exchange plan (shuffle/bulk.py) --------------------------------
    def _handle_fetch_plan(self, msg: FetchExchangePlanMsg,
                           channel: Channel) -> None:
        assert self.is_driver, "fetch-plan must only reach the driver"

        def reply_failed(reason: str) -> None:
            self._reply_plan_failed(channel, msg.callback_id, reason)

        if msg.shuffle_id not in self._shuffle_num_maps:
            reply_failed(
                f"shuffle {msg.shuffle_id} not registered on driver"
            )
            return
        # one plan mode per shuffle: a windowed host and a full-barrier
        # host would run DIFFERENT collective sequences against the
        # same exchange (conf skew) — reject the latecomer's mode
        # loudly instead of letting the barrier hang to timeout
        windowed = msg.window >= 0
        with self._window_lock:
            prev = self._plan_mode.setdefault(msg.shuffle_id, windowed)
        if prev != windowed:
            mine = "windowed" if windowed else "full-barrier"
            served = "windowed" if prev else "full-barrier"
            reply_failed(
                f"shuffle {msg.shuffle_id} plan mode mismatch: this "
                f"host requested {mine} plans but the shuffle is being "
                f"served {served} — align "
                f"spark.shuffle.tpu.bulkWindowMaps across hosts"
            )
            return
        if windowed:
            # a fetch-plan request proves the requester participates:
            # remember it so the window host set pinned below includes
            # hosts whose hello is still in flight
            with self._window_lock:
                self._window_requesters.setdefault(
                    msg.shuffle_id, set()
                ).add(msg.requester)
        with self._plan_lock:
            stale = (
                self._shuffle_epoch.get(msg.shuffle_id)
                != self._membership_epoch
            )
            if not stale:
                self._plan_waiters.setdefault(msg.shuffle_id, []).append(
                    (msg, channel)
                )
        if stale:
            # membership changed since registration: the barrier may
            # never pass and any earlier plan is invalid — fail fast
            # (the job layer re-registers and retries the stage)
            reply_failed(
                f"membership changed since shuffle {msg.shuffle_id} was "
                f"registered (executor lost) — retry the stage"
            )
            return
        self._maybe_answer_plans(msg.shuffle_id)

    def _maybe_answer_plans(self, shuffle_id: int) -> None:
        """Answer pending plan requests: full-barrier waiters
        (``window == -1``) once EVERY registered map has published and
        filled; windowed waiters (``window >= 0``) as soon as their
        window's map quota is met (_maybe_answer_windows)."""
        if not self.is_driver:
            return
        num_maps = self._shuffle_num_maps.get(shuffle_id)
        if num_maps is None:
            return
        with self._plan_lock:
            waiters_now = self._plan_waiters.get(shuffle_id, [])
            any_windowed = any(m.window >= 0 for m, _ in waiters_now)
            any_legacy = any(m.window < 0 for m, _ in waiters_now)
        if any_windowed:
            self._maybe_answer_windows(shuffle_id, num_maps)
        if not any_legacy:
            return
        with self._outputs_lock:
            mtos = [
                m for bm in self._outputs.get(shuffle_id, {}).values()
                for m in bm.values()
            ]
        if len(mtos) < num_maps:
            return  # more publishes coming; re-checked on each publish

        def answer_all():
            while True:
                with self._plan_lock:
                    gen = self._hello_gen
                waiters = self._take_plan_waiters(
                    shuffle_id, lambda m: m.window < 0
                )
                if not waiters:
                    return
                plan = self._get_or_build_plan(shuffle_id, num_maps)
                if plan is not _PLAN_WAIT:
                    break
                # a publisher's hello hasn't landed yet (publish and
                # hello race on separate channels): keep the waiters —
                # _handle_hello re-triggers this barrier.  A hello that
                # arrived between our pop and this requeue saw an empty
                # waiter list and will never re-trigger — detect it via
                # the generation counter and re-check ourselves.
                with self._plan_lock:
                    self._plan_waiters.setdefault(
                        shuffle_id, []
                    ).extend(waiters)
                    raced = self._hello_gen != gen
                if not raced:
                    return
            for msg, channel in waiters:
                if isinstance(plan, str):
                    reply: RpcMsg = FetchMapStatusFailedMsg(
                        msg.callback_id, plan
                    )
                else:
                    hosts, flat, full_manifest, idx = plan
                    me = idx.get(msg.requester)
                    if me is None:
                        reply = FetchMapStatusFailedMsg(
                            msg.callback_id,
                            f"requester {msg.requester.host}:"
                            f"{msg.requester.port} is not in the plan's "
                            f"host set",
                        )
                    else:
                        reply = ExchangePlanMsg(
                            msg.callback_id, hosts, flat,
                            [row[me] for row in full_manifest],
                        )
                try:
                    self._send_msg(channel.reply_channel(), reply)
                except Exception:
                    logger.exception("plan reply failed")

        self._when_all_filled(mtos, answer_all)

    def _get_or_build_plan(self, shuffle_id: int, num_maps: int):
        """Build (once) and cache the shuffle's exchange plan so every
        requester sees ONE membership snapshot — divergent host sets
        would compile different collectives and deadlock (SPMD).
        Returns (hosts, flat_lengths, manifest[s][d], idx) or an error
        string.  Re-validates the barrier: fills may have FAILED or
        maps been pruned (executor loss) since the publish count
        passed."""
        with self._plan_lock:
            if (self._shuffle_epoch.get(shuffle_id)
                    != self._membership_epoch):
                return (
                    "membership changed since shuffle registration "
                    "(executor lost) — retry the stage"
                )
            cached = self._plan_cache.get(shuffle_id)
        if cached is not None:
            return cached
        with self._outputs_lock:
            snapshot = {
                h: dict(bm)
                for h, bm in self._outputs.get(shuffle_id, {}).items()
            }
        mtos = [m for bm in snapshot.values() for m in bm.values()]
        if len(mtos) < num_maps:
            return (
                f"maps lost before the plan was built "
                f"({len(mtos)}/{num_maps} remain — executor removed?)"
            )
        failed = [
            m for m in mtos
            if m.fill_future.done() and m.fill_future.exception() is not None
        ]
        if failed:
            return (
                f"{len(failed)} map table(s) failed before publish "
                f"completed (executor removed)"
            )
        hosts = sorted(self.executors, key=lambda s: (s.host, s.port))
        E = len(hosts)
        idx = {h: i for i, h in enumerate(hosts)}
        num_parts = self._shuffle_partitions[shuffle_id]
        lengths = [[0] * E for _ in range(E)]
        # manifest[s][d]: (map, reduce, length) blocks of src s → dst d
        manifest = [[[] for _ in range(E)] for _ in range(E)]
        for host, by_map in snapshot.items():
            s = idx.get(host)
            if s is None:
                with self._executors_lock:
                    tombstoned = host in self._removed
                if not tombstoned:
                    # published before its hello landed (separate
                    # channels): not an error — wait for the hello
                    return _PLAN_WAIT
                return (
                    f"publisher {host.host}:{host.port} is not a "
                    f"registered executor (bulk mode needs stable "
                    f"membership)"
                )
            for map_id in sorted(by_map):
                mto = by_map[map_id]
                for r in range(num_parts):
                    loc = mto.get_location(r)
                    if loc.is_empty or loc.length == 0:
                        continue
                    d = r % E
                    lengths[s][d] += loc.length
                    manifest[s][d].append((map_id, r, loc.length))
        flat = [lengths[s][d] for s in range(E) for d in range(E)]
        plan = (tuple(hosts), flat, manifest, idx)
        with self._plan_lock:
            if (self._shuffle_epoch.get(shuffle_id)
                    != self._membership_epoch):
                # an executor was removed while we built: this plan's
                # host set is already invalid — do NOT reinstate it
                return (
                    "membership changed while the exchange plan was "
                    "being built (executor lost) — retry the stage"
                )
            self._plan_cache.setdefault(shuffle_id, plan)
            return self._plan_cache[shuffle_id]

    # -- incremental (windowed) bulk plans -----------------------------------
    # The overlap the reference gets from partial-fill futures + a
    # bounded in-flight window (RdmaMapTaskOutput.scala:41-44,
    # RdmaShuffleFetcherIterator.scala:241-251), re-architected for
    # symmetric collectives: instead of one all-maps barrier the driver
    # cuts plan windows of `bulkWindowMaps` maps as they publish+fill;
    # every host runs one collective per window, so early bytes move
    # while straggler maps still write.

    def _maybe_answer_windows(self, shuffle_id: int,
                              num_maps: int) -> None:
        with self._window_lock:
            st = self._window_state.setdefault(shuffle_id, {
                "hosts": None,      # pinned at first window build
                "idx": None,
                "assigned": {},     # host → set(map_id)
                "total_assigned": 0,
                "next": 0,          # next window number to build
                "plans": {},        # window → (flat, manifest, final,
                                    #           my_maps_by_host)
                "failure": None,    # sticky error string
                "hooked": set(),    # id(mto) with fill retriggers
            })
            progress = True
            while progress:
                progress = False
                with self._plan_lock:
                    win = [
                        w for w in self._plan_waiters.get(shuffle_id, [])
                        if w[0].window >= 0
                    ]
                    stale = (
                        self._shuffle_epoch.get(shuffle_id)
                        != self._membership_epoch
                    )
                if not win:
                    return
                fail = st["failure"]
                if fail is None and stale:
                    fail = st["failure"] = (
                        "membership changed since shuffle "
                        "registration (executor lost) — retry "
                        "the stage"
                    )
                if fail is not None:
                    self._fail_window_waiters(shuffle_id, fail)
                    return
                if any(m.window == st["next"] for m, _ in win):
                    if self._try_build_window(shuffle_id, num_maps, st):
                        progress = True
                        if st["failure"] is not None:
                            continue  # dispatch the failure above
                # answer every waiter whose window is already built
                done_all = st["total_assigned"] >= num_maps
                taken = self._take_plan_waiters(
                    shuffle_id,
                    lambda m: 0 <= m.window < st["next"]
                    or (done_all and m.window >= st["next"]),
                )
                ready = [w for w in taken if w[0].window < st["next"]]
                beyond = [w for w in taken if w[0].window >= st["next"]]
                for m, ch in ready:
                    self._send_window_plan(m, ch, st)
                    progress = True
                for m, ch in beyond:
                    self._reply_plan_failed(
                        ch, m.callback_id,
                        f"window {m.window} is beyond the final window "
                        f"({st['next'] - 1})",
                    )

    def _try_build_window(self, shuffle_id: int, num_maps: int,
                          st: dict) -> bool:
        """Build window ``st['next']`` if its quota of published+filled
        maps is available.  Returns True when state advanced (a window
        was built OR a sticky failure was recorded)."""
        remaining = num_maps - st["total_assigned"]
        if remaining <= 0:
            if num_maps == 0 and st["next"] == 0:
                # zero-map shuffle (empty upstream stage): cut one
                # empty FINAL window so readers complete with no
                # records, exactly like the legacy full-barrier path
                self._pin_window_hosts(st, shuffle_id, ())
                E = len(st["hosts"])
                st["plans"][0] = (
                    [0] * (E * E),
                    [[[] for _ in range(E)] for _ in range(E)],
                    True, {},
                )
                st["next"] = 1
                return True
            return False
        with self._outputs_lock:
            snapshot = {
                h: dict(bm)
                for h, bm in self._outputs.get(shuffle_id, {}).items()
            }
        eligible: List = []
        pending: List = []
        for host, by_map in snapshot.items():
            assigned = st["assigned"].get(host, set())
            for map_id, mto in by_map.items():
                if map_id in assigned:
                    continue
                f = mto.fill_future
                if not f.done():
                    pending.append(mto)
                elif f.exception() is not None:
                    st["failure"] = (
                        f"map {map_id} of {host.host}:{host.port} "
                        f"failed before publish completed "
                        f"(executor removed)"
                    )
                    return True
                else:
                    eligible.append((host, map_id, mto))
        window_maps = self.conf.bulk_window_maps
        need = min(window_maps, remaining) if window_maps > 0 else remaining
        if len(eligible) < need:
            # not enough filled maps yet: retrigger when fills land
            for mto in pending:
                key = id(mto)
                if key not in st["hooked"]:
                    st["hooked"].add(key)
                    mto.fill_future.add_done_callback(
                        lambda _f, sid=shuffle_id:
                            self._maybe_answer_plans(sid)
                    )
            return False
        if st["hosts"] is None:
            self._pin_window_hosts(st, shuffle_id, snapshot.keys())
        idx = st["idx"]
        unknown = [h for (h, _m, _t) in eligible if h not in idx]
        if unknown:
            h = unknown[0]
            st["failure"] = (
                f"publisher {h.host}:{h.port} is not in the pinned "
                f"window host set (joined after window 0 — windowed "
                f"bulk needs stable membership)"
            )
            return True
        eligible.sort(key=lambda e: (e[0].host, e[0].port, e[1]))
        selected = eligible[:need]
        E = len(st["hosts"])
        num_parts = self._shuffle_partitions[shuffle_id]
        lengths = [[0] * E for _ in range(E)]
        manifest = [[[] for _ in range(E)] for _ in range(E)]
        my_maps_by_host: Dict[ShuffleManagerId, List[int]] = {}
        for host, map_id, mto in selected:
            s = idx[host]
            my_maps_by_host.setdefault(host, []).append(map_id)
            for r in range(num_parts):
                loc = mto.get_location(r)
                if loc.is_empty or loc.length == 0:
                    continue
                d = r % E
                lengths[s][d] += loc.length
                manifest[s][d].append((map_id, r, loc.length))
        flat = [lengths[s][d] for s in range(E) for d in range(E)]
        final = st["total_assigned"] + len(selected) >= num_maps
        st["plans"][st["next"]] = (flat, manifest, final, my_maps_by_host)
        for host, map_id, _mto in selected:
            st["assigned"].setdefault(host, set()).add(map_id)
        st["total_assigned"] += len(selected)
        logger.info(
            "shuffle %d: window %d planned (%d map(s), final=%s, "
            "%d assigned / %d total)",
            shuffle_id, st["next"], len(selected), final,
            st["total_assigned"], num_maps,
        )
        st["next"] += 1
        return True

    def _pin_window_hosts(self, st: dict, shuffle_id: int,
                          publishers) -> None:
        """Pin ONE membership snapshot for every window of a shuffle
        (divergent host sets across windows would shift partition
        ownership r % E and compile different collectives).  Publishers
        and plan REQUESTERS whose hello hasn't landed yet are still
        included — a publish or a plan request proves the executor
        participates, and the legacy path's wait-for-hello (_PLAN_WAIT)
        would stall the whole window on a control-plane race the data
        plane has already won."""
        with self._executors_lock:
            members = set(self._executors)
            removed = set(self._removed)
        with self._window_lock:
            requesters = set(
                self._window_requesters.get(shuffle_id, ())
            )
        members.update(
            h for h in list(publishers) + sorted(
                requesters, key=lambda s: (s.host, s.port)
            )
            if h not in removed
        )
        hosts = sorted(members, key=lambda s: (s.host, s.port))
        st["hosts"] = tuple(hosts)
        st["idx"] = {h: i for i, h in enumerate(hosts)}

    def _send_window_plan(self, msg: FetchExchangePlanMsg,
                          channel: Channel, st: dict) -> None:
        flat, manifest, final, my_maps_by_host = st["plans"][msg.window]
        me = st["idx"].get(msg.requester)
        if me is None:
            self._reply_plan_failed(
                channel, msg.callback_id,
                f"requester {msg.requester.host}:{msg.requester.port} "
                f"is not in the plan's host set",
            )
            return
        reply = ExchangePlanMsg(
            msg.callback_id, st["hosts"], flat,
            [row[me] for row in manifest],
            window=msg.window, final=final,
            my_maps=sorted(my_maps_by_host.get(msg.requester, [])),
        )
        try:
            self._send_msg(channel.reply_channel(), reply)
        except Exception:
            logger.exception("window plan reply failed")

    def _take_plan_waiters(self, shuffle_id: int, pred) -> List:
        """Pop (under _plan_lock) the plan waiters whose request
        matches ``pred``; the rest stay queued."""
        with self._plan_lock:
            cur = self._plan_waiters.get(shuffle_id, [])
            taken = [w for w in cur if pred(w[0])]
            rest = [w for w in cur if not pred(w[0])]
            if rest:
                self._plan_waiters[shuffle_id] = rest
            else:
                self._plan_waiters.pop(shuffle_id, None)
        return taken

    def _fail_window_waiters(self, shuffle_id: int, reason: str) -> None:
        taken = self._take_plan_waiters(
            shuffle_id, lambda m: m.window >= 0
        )
        for m, ch in taken:
            self._reply_plan_failed(ch, m.callback_id, reason)

    def _reply_plan_failed(self, channel: Channel, callback_id: int,
                           reason: str) -> None:
        try:
            self._send_msg(
                channel.reply_channel(),
                FetchMapStatusFailedMsg(callback_id, reason),
            )
        except Exception:
            logger.exception("plan failure reply failed")

    # -- prefetch hints (memory/tier.py) -------------------------------------
    def _handle_prefetch_hint(self, msg: PrefetchHintMsg) -> None:
        """A reader announced the blocks it is about to request: warm
        them through the serve pool so the disk reads finish before
        the read RPCs arrive.  Advisory — any failure is swallowed."""
        try:
            n = self.node.warm_blocks(msg.locations)
        except Exception:
            logger.warning("prefetch hint handling failed", exc_info=True)
            return
        if n:
            counter("tier_hint_blocks_total").inc(n)

    def send_prefetch_hint(self, host: ShuffleManagerId, shuffle_id: int,
                           locations) -> None:
        """Reader-side: ship the next-N fetch-plan locations to the
        peer that will serve them (local hints short-circuit to our
        own node).  Best-effort — a hint must never fail a fetch."""
        msg = PrefetchHintMsg(shuffle_id, locations)
        counter("tier_hint_msgs_total").inc()
        if host == self.local_smid:
            self._handle_prefetch_hint(msg)
            return
        try:
            self._send_via(
                (host.host, host.port), ChannelType.RPC_REQUESTOR, msg,
                must_retry=False,
            )
        except Exception:
            logger.debug("prefetch hint to %s dropped", host.host,
                         exc_info=True)

    # -- push-based merged shuffle (shuffle/push.py) --------------------------
    def push_merger_for(self, reduce_id: int):
        """Deterministic merger for one reduce partition: every member
        of the fleet maps ``reduce_id`` onto the same executor from the
        announced membership, sorted canonically — no coordination RPC.
        A membership mismatch (joiner mid-stage) only means a writer
        pushes where no reader will look: the blocks pull instead, and
        the driver's clean-shuffle broadcast sweeps the orphan merge
        state.  Falls back to SELF when no membership was announced
        (single-manager/in-process runs merge locally)."""
        with self._executors_lock:
            peers = list(self._executors if self.is_driver else self._peers)
        if not peers:
            return self.local_smid
        peers.sort(key=lambda s: (s.host, s.port))
        return peers[reduce_id % len(peers)]

    def push_partition(self, host, msgs) -> None:
        """Writer-side: best-effort push of ONE partition's sub-block
        messages to its merger (prefetch-hint posture: a failed or
        skipped push costs pull traffic, never the commit).  Local
        mergers short-circuit; remote sends are gated on the channel's
        negotiated wire generation so pre-v3 peers never see type-13
        frames."""
        if host == self.local_smid:
            for m in msgs:
                self._handle_push_sub_block(m)
            counter("push_pushes_total", target="local").inc()
            return
        try:
            ch = self.node.get_channel(
                (host.host, host.port), ChannelType.RPC_REQUESTOR,
                self.network.connect, must_retry=False,
            )
            if ch.wire_version and ch.wire_version < PUSH_MIN_WIRE_VERSION:
                counter("push_version_skips_total").inc()
                return
            def on_fail(e):
                counter("push_send_failures_total").inc()
                logger.debug("push send to %s failed: %s", host.host, e)
            for m in msgs:
                self._send_msg(ch, m, on_failure=on_fail)
            counter("push_pushes_total", target="remote").inc()
        except Exception:
            counter("push_send_failures_total").inc()
            logger.debug("push to %s dropped", host.host, exc_info=True)

    def send_merge_query(self, host, msg: FetchMergeStatusMsg,
                         on_failure: Callable) -> None:
        """Reader-side: post one merge-status query to a merger.  Any
        inability to send — a pre-v3 peer that has no merge plane, a
        connect failure — reports through ``on_failure``, which the
        reader treats as no coverage (pull everything)."""
        try:
            ch = self.node.get_channel(
                (host.host, host.port), ChannelType.RPC_REQUESTOR,
                self.network.connect, must_retry=False,
            )
            if ch.wire_version and ch.wire_version < PUSH_MIN_WIRE_VERSION:
                counter("push_version_skips_total").inc()
                on_failure(TransportError(
                    f"peer {host.host} negotiated wire v{ch.wire_version} "
                    f"< v{PUSH_MIN_WIRE_VERSION}: no merge plane"
                ))
                return
            self._send_msg(ch, msg, on_failure=on_failure)
        except Exception as e:
            on_failure(e)

    def _handle_push_sub_block(self, msg: PushSubBlockMsg) -> None:
        self.push_merger.on_sub_block(
            msg.shuffle_id, msg.map_id, msg.reduce_id,
            msg.total_len, msg.offset, msg.data,
        )

    def _handle_fetch_merge_status(self, msg: FetchMergeStatusMsg,
                                   channel: Channel) -> None:
        """Merger side of the reader's merged-location query: seal the
        queried reduce partitions and answer one response per id (the
        fetch-status response convention).  Any failure — including the
        dead-merger fault drill — replies failed, which the reader
        treats as no coverage → pull."""
        try:
            answers = self.push_merger.merge_status(
                msg.shuffle_id, msg.reduce_ids
            )
        except Exception as e:
            try:
                self._send_msg(
                    channel.reply_channel(),
                    FetchMapStatusFailedMsg(
                        msg.callback_id, f"merger unavailable: {e}"
                    ),
                )
            except Exception:
                logger.debug("merge-status failure reply failed",
                             exc_info=True)
            return
        total = len(answers)
        for idx, (rid, mkey, length, prov) in enumerate(answers):
            try:
                self._send_msg(
                    channel.reply_channel(),
                    MergeStatusResponseMsg(
                        msg.callback_id, total, idx, rid, mkey,
                        length, prov,
                    ),
                )
            except Exception:
                logger.warning("merge-status reply failed", exc_info=True)
                return

    def _handle_merge_response(self, msg: MergeStatusResponseMsg) -> None:
        with self._callbacks_lock:
            cb = self._callbacks.get(msg.callback_id)
        if cb is None or not isinstance(cb, _MergeCallback):
            logger.warning("merge response for unknown callback %d",
                           msg.callback_id)
            return
        cb.on_response(msg)

    def register_merge_callback(self, on_status: Callable,
                                on_error: Callable[[str], None]) -> int:
        with self._callbacks_lock:
            cb_id = self._next_callback_id
            self._next_callback_id += 1
            self._callbacks[cb_id] = _MergeCallback(on_status, on_error)
        return cb_id

    # -- executor handlers ---------------------------------------------------
    def _handle_fetch_response(self, msg: FetchMapStatusResponseMsg) -> None:
        with self._callbacks_lock:
            cb = self._callbacks.get(msg.callback_id)
        if cb is None:
            logger.warning("fetch response for unknown callback %d",
                           msg.callback_id)
            return
        cb.on_response(msg)

    def _handle_fetch_failed(self, msg: FetchMapStatusFailedMsg) -> None:
        with self._callbacks_lock:
            cb = self._callbacks.get(msg.callback_id)
        if cb is None:
            return  # reader already gone (timeout fired / task ended)
        cb.on_failed(msg.reason)

    def _handle_exchange_plan(self, msg: ExchangePlanMsg) -> None:
        with self._callbacks_lock:
            cb = self._callbacks.get(msg.callback_id)
        if cb is None or not isinstance(cb, _PlanCallback):
            logger.warning("plan response for unknown callback %d",
                           msg.callback_id)
            return
        cb.on_plan(msg)

    def register_plan_callback(self, on_plan: Callable,
                               on_error: Callable[[str], None]) -> int:
        with self._callbacks_lock:
            cb_id = self._next_callback_id
            self._next_callback_id += 1
            self._callbacks[cb_id] = _PlanCallback(on_plan, on_error)
        return cb_id

    def unregister_plan_callback(self, cb_id: int) -> None:
        with self._callbacks_lock:
            self._callbacks.pop(cb_id, None)

    def register_fetch_callback(
        self, on_locations: Callable[[List[BlockLocation]], None],
        on_error: Optional[Callable[[str], None]] = None,
    ) -> int:
        with self._callbacks_lock:
            cb_id = self._next_callback_id
            self._next_callback_id += 1
            self._callbacks[cb_id] = _FetchCallback(on_locations, on_error)
        return cb_id

    def unregister_fetch_callback(self, cb_id: int) -> None:
        with self._callbacks_lock:
            self._callbacks.pop(cb_id, None)

    # -- multi-tenant QoS helpers (qos/) -------------------------------------
    def qos_tenant_for(self, handle) -> Optional[object]:
        """Resolve (get-or-create) the tenant a shuffle runs under:
        the handle's stamped tenant id, else this manager's conf
        ``tenant``, else one tenant per shuffle (``shuffle-<id>``).
        Conf weight/priority/quotas apply on every resolution (last
        writer wins — that is how policy changes land).  None with
        QoS off."""
        qos = self.qos
        if qos is None:
            return None
        name = (
            getattr(handle, "tenant", "")
            or self.conf.tenant
            or f"shuffle-{handle.shuffle_id}"
        )
        return qos.tenant(
            name,
            weight=self.conf.qos_tenant_weight,
            priority=self.conf.qos_tenant_priority,
            max_bytes=self.conf.qos_tenant_max_bytes,
            max_inflight=self.conf.qos_tenant_max_inflight,
        )

    def qos_inflight_broker(self):
        return self._qos_inflight

    def _qos_bind(self, handle) -> None:
        """Bind shuffle → tenant in the process-global registry so the
        SERVING side (``Node.tenant_of_mkey``) can classify incoming
        reads — called wherever a shuffle becomes live in this
        process (registration, writers, readers)."""
        if self.qos is not None:
            self.qos.bind_shuffle(
                handle.shuffle_id, self.qos_tenant_for(handle)
            )

    def qos_admit(self, handle, nbytes: int) -> bool:
        """Admission control on registration: account ``nbytes`` of
        committed map output under the tenant's registered-byte quota
        (writers call this at commit).  Over quota the commit queues
        up to ``qosAdmissionWait`` then the tenant DEGRADES rather
        than OOM the node.  True = within quota (or QoS off)."""
        if self.qos is None or nbytes <= 0:
            return True
        return self.qos.admit(
            handle.shuffle_id, self.qos_tenant_for(handle), nbytes,
            wait_s=self.conf.qos_admission_wait_ms / 1000.0,
        )

    # -- public API (the ShuffleManager SPI) ---------------------------------
    def register_shuffle(
        self,
        shuffle_id: int,
        num_maps: int,
        partitioner: Partitioner,
        aggregator: Optional[Aggregator] = None,
        map_side_combine: bool = False,
        key_ordering: bool = False,
    ) -> ShuffleHandle:
        """Driver-side registration (reference:
        RdmaShuffleManager.scala:242-274)."""
        handle = ShuffleHandle(
            shuffle_id, num_maps, partitioner, aggregator,
            map_side_combine, key_ordering,
        )
        if self.qos is not None:
            # stamp the tenant id so executors sharing the handle
            # resolve the same tenant, and bind it for the serve path
            handle.tenant = self.qos_tenant_for(handle).name
            self._qos_bind(handle)
        self._shuffle_partitions[shuffle_id] = partitioner.num_partitions
        self._shuffle_num_maps[shuffle_id] = num_maps
        with self._plan_lock:
            self._shuffle_epoch[shuffle_id] = self._membership_epoch
        return handle

    def get_writer(self, handle: ShuffleHandle, map_id: int) -> ShuffleWriter:
        # executor-side binding: the writer's process serves the blocks
        self._qos_bind(handle)
        return ShuffleWriter(self, handle, map_id)

    def get_reader(
        self,
        handle: ShuffleHandle,
        start_partition: int,
        end_partition: int,
        maps_by_host: Dict[ShuffleManagerId, List[int]],
    ):
        """maps_by_host plays the MapOutputTracker's
        getMapSizesByExecutorId role (RdmaShuffleReader.scala:44-49):
        which host ran which map tasks — known to the job scheduler.

        With ``readPlane=windowed`` the reader instead rides the
        unified device plane: blocks arrive via driver-planned window
        collectives (maps_by_host is unused — the plan carries the
        manifest)."""
        self._qos_bind(handle)
        if self.conf.read_plane == "windowed":
            from sparkrdma_tpu_torch.shuffle.bulk import WindowedReadPlane

            if self.windowed_plane is None:
                self.windowed_plane = WindowedReadPlane(self)
            return self.windowed_plane.reader(
                handle, start_partition, end_partition
            )
        from sparkrdma_tpu_torch.shuffle.reader import ShuffleReader

        return ShuffleReader(
            self, handle, start_partition, end_partition, maps_by_host
        )

    def get_decode_pool(self):
        """Get-or-create the manager's shared decode pool — ``None``
        when ``decodeThreads`` is 0 (serial fallback) or the manager
        stopped.  Workers pin to ``dispatcherCpuList`` exactly like the
        transport dispatcher and serve-pool threads."""
        n = self.conf.decode_threads
        if n <= 0 or self._state != "running":  # noqa: SC03 re-checked below
            return None
        pool = self._decode_pool
        if pool is None:
            from sparkrdma_tpu_torch.shuffle.decode import DecodePool

            with self._decode_lock:
                # _decode_lock (not _life_lock) orders this against
                # _stop_decode_pool
                if self._state != "running":  # noqa: SC03 ordered by _decode_lock
                    # re-checked under the lock: a create racing
                    # manager.stop() must not resurrect a pool whose
                    # stop already ran (leaked pinned workers)
                    return None
                if self._decode_pool is None:
                    self._decode_pool = DecodePool(
                        self.executor_id, n,
                        self.conf.decode_ahead_bytes,
                        init_fn=self.node._pin_worker_thread,
                        qos=self.qos,
                    )
                pool = self._decode_pool
        return pool

    def publish_map_output(
        self, shuffle_id: int, map_id: int, mto: MapTaskOutput
    ) -> Tuple[int, int, int]:
        """Executor → driver publish (RdmaWrapperShuffleWriter.scala:115-149).

        DELTA-SYNCED: only the entries changed since the table's last
        publish ship, as epoch-tagged contiguous runs (the first
        publish after commit is the whole table — everything is dirty).
        A republish after relocating a few blocks therefore costs
        O(changed) wire bytes, not O(partitions); the driver's
        per-entry epoch guard makes out-of-order segment application
        safe.  Returns (segments, entries, entry_bytes) published."""
        n = mto.num_partitions
        epoch, runs = mto.take_delta()
        entries = 0
        nbytes = 0
        for first, last, raw in runs:
            msg = PublishMapTaskOutputMsg(
                self.local_smid, shuffle_id, map_id, n, first, last,
                raw, epoch,
            )
            if self.is_driver:
                # driver-local writer (local[*] mode): install directly
                self._handle_publish(msg)
            else:
                def requeue(e, first=first, last=last):
                    # the dirty bits were consumed by take_delta: a
                    # send lost AFTER the synchronous-retry window
                    # must re-dirty its run or no later publish would
                    # ever re-ship it (the pre-delta full publish
                    # self-healed by always resending everything)
                    logger.warning(
                        "publish of shuffle %d map %d [%d,%d] failed "
                        "(%s) — re-marked dirty for the next publish",
                        shuffle_id, map_id, first, last, e,
                    )
                    mto.mark_dirty(first, last)

                if FAULTS.enabled and FAULTS.fires("publish"):
                    # a LOST publish, not a raised one: the run
                    # re-dirties (delta plane's self-heal) and ships
                    # with the next publish instead of failing the
                    # commit — this point exercises exactly that path
                    requeue(FaultInjectedError("publish"))
                    continue
                try:
                    self._send_driver_msg(msg, on_failure=requeue)
                except BaseException:
                    mto.mark_dirty(first, last)
                    raise
            entries += last - first + 1
            nbytes += len(raw)
        if runs:
            counter("shuffle_publish_segments_total").inc(len(runs))
            counter("shuffle_publish_entries_total").inc(entries)
            counter("shuffle_publish_entry_bytes_total").inc(nbytes)
        return len(runs), entries, nbytes

    # -- per-shuffle telemetry (metrics/ tentpole) ---------------------------
    def record_shuffle_write(self, shuffle_id: int, wm) -> None:
        """Writer commit hook: fold one map task's WriteMetrics into
        the shuffle's telemetry accumulator (no-op unless conf
        ``metrics`` is on — the default path stays untouched)."""
        if not self.conf.metrics_enabled:
            return
        self._telemetry_add(
            shuffle_id,
            map_tasks=1,
            write_bytes=wm.bytes_written,
            write_records=wm.records_written,
            spills=wm.spills,
            spill_bytes=wm.bytes_spilled,
            write_time_ms=wm.write_time_ms,
        )

    def record_shuffle_skew(self, shuffle_id: int, snap: Dict) -> None:
        """Writer commit hook: fold one map task's partition-balance /
        split snapshot (skew/registry.py's ``record_commit`` return)
        into the shuffle's telemetry, ``skew_``-prefixed so the report
        can find them.  Rides the telemetry plane — published even
        when splitting is off, so ``metrics_report.py`` shows a
        partition-balance view either way."""
        if not self.conf.metrics_enabled or not snap:
            return
        self._telemetry_add(
            shuffle_id,
            **{
                (k if k.startswith("max_") else f"skew_{k}"): v
                for k, v in snap.items()
            },
        )

    def record_shuffle_read(self, shuffle_id: int, rm) -> None:
        """Reader completion hook: fold one reduce task's ReadMetrics
        into the shuffle's telemetry accumulator."""
        if not self.conf.metrics_enabled:
            return
        self._telemetry_add(
            shuffle_id,
            reduce_tasks=1,
            local_blocks=rm.local_blocks,
            remote_blocks=rm.remote_blocks,
            local_bytes=rm.local_bytes,
            remote_bytes=rm.remote_bytes,
            records_read=rm.records_read,
            fetch_wait_ms=rm.fetch_wait_ms,
            decode_wait_ms=getattr(rm, "decode_wait_ms", 0.0),
        )

    def _telemetry_add(self, shuffle_id: int, **kv) -> None:
        with self._telemetry_lock:
            d = self._telemetry.setdefault(shuffle_id, {})
            for k, v in kv.items():
                d[k] = _fold_telemetry(d.get(k, 0), k, v)

    def _publish_shuffle_telemetry(self, shuffle_id: int) -> None:
        """Ship this manager's accumulated per-shuffle telemetry to the
        driver over the control plane — the same executor → driver flow
        the map-output location publishes ride."""
        with self._telemetry_lock:
            snap = self._telemetry.pop(shuffle_id, None)
        if not snap:
            return
        import json as _json

        msg = PublishShuffleMetricsMsg(
            self.local_smid, shuffle_id,
            _json.dumps(snap).encode("utf-8"),
        )
        if self.is_driver:
            self._handle_shuffle_metrics(msg)
        else:
            try:
                self._send_driver_msg(msg)
            except Exception:
                logger.warning(
                    "shuffle %d telemetry publish failed", shuffle_id,
                    exc_info=True,
                )

    def _handle_shuffle_metrics(self, msg: PublishShuffleMetricsMsg) -> None:
        import json as _json

        try:
            snap = _json.loads(bytes(msg.payload).decode("utf-8"))
        except ValueError:
            logger.warning("dropping malformed shuffle telemetry")
            return
        exec_id = msg.shuffle_manager_id.block_manager_id.executor_id
        with self._telemetry_lock:
            per_host = self._shuffle_telemetry.setdefault(
                msg.shuffle_id, {}
            )
            mine = per_host.setdefault(exec_id, {})
            for k, v in snap.items():
                mine[k] = _fold_telemetry(mine.get(k, 0), k, v)
            while len(self._shuffle_telemetry) > _TELEMETRY_KEEP:
                oldest = min(self._shuffle_telemetry)
                del self._shuffle_telemetry[oldest]

    def shuffle_telemetry(self, shuffle_id: int) -> Dict:
        """Driver-side aggregated view of one shuffle's telemetry:
        ``{"per_host": {executor_id: {...}}, "total": {...}}`` — the
        per-shuffle snapshot the issue's observability layer exposes
        next to the registry dump."""
        with self._telemetry_lock:
            per_host = {
                h: dict(m)
                for h, m in self._shuffle_telemetry.get(
                    shuffle_id, {}
                ).items()
            }
        total: Dict[str, float] = {}
        for m in per_host.values():
            for k, v in m.items():
                total[k] = _fold_telemetry(total.get(k, 0), k, v)
        return {"per_host": per_host, "total": total}

    def unregister_shuffle(self, shuffle_id: int) -> None:
        if self.windowed_plane is not None and self.conf.metrics_enabled:
            # fold the zero-copy plane's window landings into the
            # shuffle's telemetry before it ships to the driver
            evs = self.windowed_plane.window_events(shuffle_id)
            if evs:
                self._telemetry_add(
                    shuffle_id,
                    exchange_windows=len(evs),
                    exchange_window_payload_bytes=sum(
                        b for _w, _t, b in evs
                    ),
                )
        self._publish_shuffle_telemetry(shuffle_id)
        if (self.conf.metrics_enabled and self.conf.trace
                and self.conf.metrics_trace_bridge):
            # sample registry counters onto the Perfetto timeline at
            # every shuffle boundary (counter tracks)
            get_registry().publish_to_tracer(get_tracer())
        # merger first: its segments release by mkey, and the
        # resolver's arena.release_shuffle sweep must not find them
        self.push_merger.remove_shuffle(shuffle_id)
        self.resolver.remove_shuffle(shuffle_id)
        if self.windowed_plane is not None:
            self.windowed_plane.forget(shuffle_id)
        with self._plan_lock:
            self._plan_cache.pop(shuffle_id, None)
            self._shuffle_epoch.pop(shuffle_id, None)
        with self._window_lock:
            self._window_state.pop(shuffle_id, None)
            self._plan_mode.pop(shuffle_id, None)
            self._window_requesters.pop(shuffle_id, None)
        with self._outputs_lock:
            self._outputs.pop(shuffle_id, None)
        self._shuffle_partitions.pop(shuffle_id, None)
        self._shuffle_num_maps.pop(shuffle_id, None)
        if self.qos is not None:
            # return the shuffle's admitted registered bytes: a tenant
            # back under quota leaves degraded mode, queued admissions
            # re-check
            self.qos.release_shuffle(shuffle_id)
        # drop the shuffle's skew accounting (written even with
        # splitting off when telemetry is on)
        get_skew().release_shuffle(shuffle_id)
        if self.is_driver:
            # broadcast so every executor releases its OWN side of the
            # shuffle (registered segments, block-store mkeys, QoS
            # quota): without this, executor resources for a finished
            # shuffle survive until manager stop — the resource ledger
            # (conf resourceDebug) flagged exactly that leak.  Best
            # effort, like the membership announce: a lost clean only
            # delays the release to the executor's stop sweep.
            clean = CleanShuffleMsg(shuffle_id)
            for peer in self.executors:
                try:
                    # no connect retries (the heartbeat posture): an
                    # unregister racing executor teardown must not
                    # stall the caller through the full reconnect
                    # budget of a peer that is already gone
                    self._send_via(
                        (peer.host, peer.port), ChannelType.RPC_REQUESTOR,
                        clean, on_failure=lambda e: None,
                        must_retry=False,
                    )
                except Exception:
                    logger.info(
                        "driver: clean-shuffle %d to %s failed",
                        shuffle_id, peer.host,
                    )

    def _handle_clean_shuffle(self, msg: CleanShuffleMsg) -> None:
        """Executor side of the driver's unregister broadcast: run the
        local unregister sweep (idempotent — every pop tolerates an
        already-unknown shuffle, so a duplicate clean is a no-op)."""
        if self.is_driver:
            return  # drivers originate cleans, they don't follow them
        self.unregister_shuffle(msg.shuffle_id)

    def remove_executor(self, smid: ShuffleManagerId) -> None:
        """Elastic membership pruning (reference onBlockManagerRemoved,
        RdmaShuffleManager.scala:253-263).  Unfilled tables from the lost
        executor get their futures failed so driver-side fetch-status
        waits unblock immediately instead of timing out."""
        with self._executors_lock:
            was_member = smid in self._executors
            if was_member:
                self._executors.remove(smid)
            self._removed.add(smid)
        self._last_ack.pop(smid, None)
        if not was_member:
            # duplicate prune (heartbeat timeout racing a send-failure
            # callback): membership did not change again, so do NOT
            # bump the epoch — that would doom shuffles registered
            # after the first prune and clear valid waiters/plans
            return
        # bulk-mode plan waiters can never be satisfied once a member is
        # lost (stable membership is the mode's contract): answer them
        # negatively NOW so readers fail fast instead of timing out
        with self._plan_lock:
            self._membership_epoch += 1
            doomed_waiters = [
                (sid, w) for sid, ws in self._plan_waiters.items()
                for w in ws
            ]
            self._plan_waiters.clear()
            self._plan_cache.clear()
        with self._window_lock:
            self._window_state.clear()
            self._plan_mode.clear()
            self._window_requesters.clear()
        for sid, (msg, channel) in doomed_waiters:
            try:
                self._send_msg(
                    channel.reply_channel(),
                    FetchMapStatusFailedMsg(
                        msg.callback_id,
                        f"executor {smid.host}:{smid.port} lost while "
                        f"awaiting the exchange plan of shuffle {sid}",
                    ),
                )
            except Exception:
                logger.exception("plan-failure reply failed")
        with self._outputs_lock:
            doomed: List[MapTaskOutput] = []
            for by_host in self._outputs.values():
                by_map = by_host.pop(smid, None)
                if by_map:
                    doomed.extend(by_map.values())
        for mto in doomed:
            # check-then-set races a concurrently completing publish;
            # losing that race is fine (the table filled — readers can
            # use it), it must just not kill the caller
            try:
                if not mto.fill_future.done():
                    mto.fill_future.set_exception(
                        RuntimeError(
                            f"executor lost: {smid.host}:{smid.port}"
                        )
                    )
            except Exception:
                pass

    # -- in-process helpers for the job layer --------------------------------
    def maps_by_host(self, shuffle_id: int) -> Dict[ShuffleManagerId, List[int]]:
        """Driver-side view of which host published which maps."""
        with self._outputs_lock:
            by_host = self._outputs.get(shuffle_id, {})
            return {h: sorted(m.keys()) for h, m in by_host.items()}

    @property
    def executors(self) -> List[ShuffleManagerId]:
        with self._executors_lock:
            return list(self._executors)

    def await_peers(self, n: int, timeout_s: float) -> None:
        """Executor: block until the driver has announced ``n``
        executors (this one included).  A bulk or windowed shuffle's
        driver pins ONE host set at its first plan (window), from the
        hellos, publishes and plan requests landed by then: an executor
        none of whose messages had landed is refused its plans, and the
        others wait for its row at the exchange until the barrier times
        out.  The driver announces its whole membership on every hello,
        so once ``n`` executors are announced here, every plan request
        sent afterwards reaches a driver that already knows all ``n``
        of the exchange's rows (``BulkExchangeReader`` waits here before
        each plan request)."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while True:
            with self._executors_lock:
                have = len(self._peers)
            if have >= n:
                return
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"{have} of the exchange's {n} executors announced "
                    f"within {timeout_s:.0f}s")
            _time.sleep(0.001)

    def quiesce(self) -> None:
        """Stop the background liveness plane (heartbeat monitor)
        WITHOUT tearing the manager down.  Call on the driver before
        stopping executors: a deliberate shutdown must not race the
        monitor into reporting healthy executors as dead ("channel to
        executor N dead — pruning" noise at exit)."""
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None:
            t.join(timeout=2.0)
            if not t.is_alive():
                self._hb_thread = None

    def _dump_metrics(self) -> None:
        """Stop-time registry exports: JSON snapshot and/or Prometheus
        text when the conf paths are set (executors suffix their id so
        multi-process runs don't clobber the driver's file), plus a
        final bridge of counters into the trace stream."""
        suffix = "" if self.is_driver else f".{self.executor_id}"
        if self.conf.trace and self.conf.metrics_trace_bridge:
            get_registry().publish_to_tracer(get_tracer())
        path = self.conf.metrics_json_path
        if path:
            try:
                write_json_snapshot(path + suffix)
            except OSError:
                logger.exception("metrics JSON dump to %s failed", path)
        path = self.conf.metrics_prom_path
        if path:
            try:
                write_prometheus(path + suffix)
            except OSError:
                logger.exception("metrics prom dump to %s failed", path)

    def stop(self) -> None:
        """Teardown (reference: RdmaShuffleManager.scala:348-357)."""
        with self._life_lock:
            if self._state != "running":
                # a second stop() — concurrent or repeated — must
                # observe the flip atomically with the check: the old
                # unguarded check-then-set let two racing callers both
                # enter the teardown body and double-release the
                # owner-counted RECORDER/TRACING/ledger globals
                return
            self._transition("stopping", frm="running")
        self.quiesce()
        if self.stats is not None:
            self.stats.print_stats()
        if self.conf.metrics_enabled:
            self._dump_metrics()
        if self.conf.trace:
            tracer = get_tracer()
            # only the FIRST manager to stop dumps and clears: the
            # tracer is process-global, so in-process clusters (driver
            # + executors sharing one conf) would otherwise overwrite
            # the dump with the cleared tracer's empty event list,
            # losing every span and bridged counter
            if tracer.enabled:
                try:
                    tracer.dump(self.conf.trace_path)
                except OSError:
                    logger.exception(
                        "trace dump to %s failed", self.conf.trace_path
                    )
                tracer.enabled = False
                tracer.clear()
        if self._obs_retained:
            self._obs_retained = False
            if self.conf.flight_recorder_dump_path:
                # final black-box snapshot before the rings go away —
                # this is how each fleet process leaves its dump for
                # the cross-process merge (obs/collect.py)
                RECORDER.dump("manager_stop")
            RECORDER.release()
        if self._tracing_retained:
            self._tracing_retained = False
            TRACING.release()
        logger.info("staging pool at stop: %s", self.staging_pool.stats())
        logger.info("tier store at stop: %s", self.tier_store.stats())
        if self.metrics_http is not None:
            # the scrape endpoint dies with the manager: synchronous
            # shutdown so the census sees no leaked serving thread
            self.metrics_http.stop()
        if self._qos_inflight is not None:
            self._qos_inflight.stop()
        with self._decode_lock:
            decode_pool, self._decode_pool = self._decode_pool, None
        if decode_pool is not None:
            decode_pool.stop()
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=False)
        self.push_merger.stop()
        self.resolver.stop()
        self.node.stop()
        self.network.unregister(self.node)
        self.arena.stop()
        # entries normally drain via segment release above; sweep any
        # stragglers (adoption racing teardown) before the pool closes
        self.tier_store.stop()
        self.staging_pool.close()
        if self.conf.resource_debug:
            # leak report LAST, after every pool above returned its
            # resources.  Non-raising here: GC-tied tier views may
            # legitimately outlive the manager and settle their pins
            # from finalizers (the ledger epoch-bumps so those late
            # releases become silent no-ops); the raising form is for
            # tests that fully drain first.
            from sparkrdma_tpu_torch.utils.ledger import get_resource_ledger

            get_resource_ledger().stop(raise_on_leak=False)
        if self._faults_armed:
            # owner-counted like the ledger: only the LAST armed
            # manager in the process disarms the injector, so an
            # in-process cluster keeps one deterministic stream alive
            # until every member has stopped
            FAULTS.stop()
            self._faults_armed = False
        with self._life_lock:
            self._transition("stopped", frm="stopping")
