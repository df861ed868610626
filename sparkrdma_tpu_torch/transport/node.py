"""Per-process transport endpoint: channel cache, dispatch, teardown.

TPU-native re-design of the reference's RdmaNode (RdmaNode.java:36-397):
one ``Node`` per process (driver and each executor) owning

- the process's listening address,
- the receive dispatcher for incoming control-plane frames (the
  reference's receiveListener wiring),
- the block-store registry serving one-sided reads (the PD + registered
  MRs in the reference; HBM arenas / host stores here),
- an active-channel cache with racy-create resolution and bounded
  connect retries (RdmaNode.java:277-351),
- parallel teardown of all channels on stop (RdmaNode.java:353-394).

The CM event channel / listening thread has no analog: backends
(loopback now, ICI exchange for bulk) register passive channels directly
via ``register_passive_channel``.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.conf import TpuShuffleConf
from sparkrdma_tpu_torch.faults.breaker import PeerHealthRegistry
from sparkrdma_tpu_torch.metrics import counter, gauge
from sparkrdma_tpu_torch.qos import (
    BULK,
    INTERACTIVE,
    ClassedTaskQueue,
    WeightedCreditBroker,
    get_qos,
)
from sparkrdma_tpu_torch.utils.dbglock import dbg_condition, dbg_lock
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.transport.channel import (
    BlockStore,
    Channel,
    ChannelType,
    FatalTransportError,
    TransportError,
)
from sparkrdma_tpu_torch.utils.types import BlockLocation

logger = logging.getLogger(__name__)

Address = Tuple[str, int]

# Frames arriving on a channel are handed to: (source_channel, frame_bytes)
ReceiveListener = Callable[[Channel, bytes], None]

#: thread-name prefixes of every transport/shuffle plane thread this
#: library spawns — the census (and the scale tests) count by these
TRANSPORT_THREAD_PREFIXES = (
    "disp-",        # async dispatcher event loops
    "tcp-",         # threaded-mode channel readers + accept loops
    "serve-",       # bounded read-serve pool workers
    "node-",        # completion/dispatch pool + teardown workers
    "decode-",      # reduce-side decode pool workers
)


def transport_census() -> Dict[str, object]:
    """Thread/fd census of the transport planes: live library threads
    grouped by role prefix, total Python threads, and this process's
    open fd count (Linux; -1 elsewhere).  Refreshes the
    ``transport_threads`` gauge so scrapes see the census too.  The
    async dispatcher's acceptance criterion — O(1) transport threads
    per node regardless of peer × stripe fan-out — is asserted against
    this (tests/test_dryrun_scale.py)."""
    by_role: Dict[str, int] = {}
    for t in threading.enumerate():
        for prefix in TRANSPORT_THREAD_PREFIXES:
            if t.name.startswith(prefix):
                by_role[prefix.rstrip("-")] = (
                    by_role.get(prefix.rstrip("-"), 0) + 1
                )
                break
    n = sum(by_role.values())
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = -1
    gauge("transport_threads").set(n)
    return {
        "transport_threads": n,
        "by_role": by_role,
        "python_threads": threading.active_count(),
        "open_fds": fds,
    }


class _ServePool:
    """Bounded read-serve pool: fixed worker threads drain serve tasks
    under a byte-credit budget — the responder-side flow control of
    the one-sided READ service.  A serve's cost is the requested byte
    total; workers block until enough credits are free, so a slow
    reducer draining many multi-MB responses can never pin unbounded
    server memory (the serve holds its resolved block views only while
    it owns credits).  A single serve larger than the whole budget
    clamps to it and runs alone rather than deadlocking.

    Credits flow through a :class:`WeightedCreditBroker` (qos/): with
    QoS off that is plain FIFO handoff over one budget (and the
    explicit FIFO is itself the fairness fix — grants go to credit
    waiters in arrival order, so a clamped oversized serve can no
    longer be bypassed indefinitely by a stream of small serves that
    happen to fit the remaining credits); with QoS on, tenants take
    weighted max-min shares, interactive-class serves (small reads,
    interactive tenants) dequeue AND acquire ahead of bulk, and aging
    keeps bulk from starving."""

    def __init__(self, name: str, workers: int, credit_bytes: int,
                 init_fn=None, conf: Optional[TpuShuffleConf] = None):
        qos = (
            get_qos() if conf is not None and conf.qos_enabled else None
        )
        self._qos = qos
        self._interactive_bytes = (
            conf.qos_interactive_bytes if conf is not None else 512 << 10
        )
        aging_ms = conf.qos_aging_ms if conf is not None else 100
        # both conditions are created HERE (and handed to the qos/
        # machinery) so their ranks land in this file's hierarchy
        self._queue_cv = dbg_condition("node.serve_queue", 49)
        self._queue = ClassedTaskQueue(
            self._queue_cv,
            classed=qos is not None, aging_ms=aging_ms,
        )
        self._stopped = False
        self._m_depth = gauge("transport_serve_queue_depth")
        self._m_tasks = counter("transport_serve_tasks_total")
        self._m_credit_waits = counter("transport_serve_credit_waits_total")
        self._cv = dbg_condition("node.serve_credits", 50)
        # resource: serve.credit_bytes
        self._broker = WeightedCreditBroker(
            "serve", max(int(credit_bytes), 1), self._cv,
            qos=qos, classed=qos is not None, aging_ms=aging_ms,
            wait_counter=self._m_credit_waits,
        )
        self._workers = [
            threading.Thread(
                target=self._run, daemon=True, name=f"serve-{name}-{i}",
                args=(init_fn,),
            )
            for i in range(max(1, workers))
        ]
        for t in self._workers:
            t.start()

    def _classify(self, cost: int, tenant, cls: Optional[str]) -> str:
        if cls is not None:
            return cls
        if self._qos is None:
            return BULK
        if cost <= self._interactive_bytes:
            return INTERACTIVE  # the small-read-lane lineage
        if tenant is not None and tenant.interactive:
            return INTERACTIVE
        return BULK

    def submit(self, fn, args: tuple, cost: int,
               deferred: bool = False, tenant=None,
               cls: Optional[str] = None) -> None:
        """Never blocks the caller (channel reader loops and the async
        dispatcher post here).  ``deferred=True`` is the
        completion-driven contract: the worker calls
        ``fn(*args, release)`` and the CALLEE owns returning the
        credits via the idempotent ``release()`` — typically from the
        response's send-completion event — so credits keep bounding
        resident serve memory without a worker blocked in the send."""
        if self._stopped:
            raise TransportError("serve pool stopped")
        cost = max(int(cost), 0)
        cls = self._classify(cost, tenant, cls)
        self._m_depth.inc()
        self._queue.put((fn, args, cost, deferred, tenant, cls), cls=cls)

    def _make_release(self, cost: int, tenant, tkt=NOOP_TICKET):
        """Idempotent credit return, safe from any thread (list.pop is
        atomic under the GIL — exactly one caller wins the token)."""
        token = [None]

        def release() -> None:
            try:
                token.pop()
            except IndexError:
                return
            self._broker.release(cost, tenant)  # releases: serve.credit_bytes
            tkt.release()

        return release

    def _run(self, init_fn) -> None:
        if init_fn is not None:
            init_fn()
        g = gauge("transport_threads", role="serve")
        g.inc()
        try:
            self._drain(init_fn)
        finally:
            g.dec()

    def _drain(self, _init_fn) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            self._m_depth.dec()
            fn, args, cost, deferred, tenant, cls = item
            cost = self._broker.clamp(cost)
            # owns: serve.credit_bytes -> release  (every exit of the
            # try below — including the deferred contract, where the
            # callee's completion event settles it — funnels through
            # the idempotent closure)
            if not self._broker.acquire(  # acquires: serve.credit_bytes
                    cost, tenant, cls):
                return  # pool stopped while credit-waiting
            self._m_tasks.inc()
            tkt = ledger_acquire("serve.credit_bytes", cost)
            release = self._make_release(cost, tenant, tkt)
            try:
                if deferred:
                    fn(*args, release)
                else:
                    fn(*args)
            except BaseException:
                logger.exception("read serve failed")
                release()
            finally:
                if not deferred:
                    release()

    def stop(self) -> None:
        self._stopped = True
        self._broker.stop()
        # abandon queued serves (their channels are tearing down) and
        # keep the queue-depth gauge honest for the next node in this
        # process
        for _item in self._queue.drain_nowait():
            self._m_depth.dec()
        for _ in self._workers:
            self._queue.put_sentinel()
        for t in self._workers:
            t.join(timeout=2.0)


class _LanePool:
    """Fixed per-node budget of borrowable data lanes (the RDMAvisor /
    fabric-lib bounded-channel idiom): a striped read borrows up to
    ``transportNumStripes`` tokens for its duration and returns them on
    completion, so concurrent stripe fan-out across ALL peers is capped
    at ``transportLanePoolSize`` instead of every peer owning
    ``transportNumStripes`` dedicated sockets.  Borrowing never blocks:
    an empty pool means the read falls back to the peer's dedicated
    small-read lane, unstriped (narrower, never wrong).  Size 0 is the
    unbounded pre-fabric sentinel.

    With QoS on, ``reserve`` lane tokens are withheld from BULK-class
    borrows (qos/ priority grants): an interactive tenant's striped
    read always finds width even while bulk fan-out saturates the
    pool — the lane-scheduler half of the small-read-lane
    generalization."""

    def __init__(self, size: int, reserve: int = 0):
        self.size = max(int(size), 0)
        # a reserve covering the whole pool would demote EVERY bulk
        # read to the small lane — cap it below the pool size
        self.reserve = (
            min(max(int(reserve), 0), max(self.size - 1, 0))
            if self.size else 0
        )
        self._free = self.size  # resource: node.lane_tokens  # guarded-by: _lock
        self._lock = dbg_lock("node.lane_pool", 45)
        self._m_in_use = gauge("transport_lane_pool_in_use")
        self._m_borrows = counter("transport_lane_borrows_total")
        self._m_exhausted = counter("transport_lane_pool_exhausted_total")

    def try_borrow(self, want: int, cls: str = BULK) -> int:
        """Take up to ``want`` lane tokens without blocking; returns
        how many were granted (0 when the pool is dry).  BULK-class
        borrows leave the interactive reserve untouched."""
        if want <= 0:
            return 0
        if self.size == 0:
            return want
        floor = self.reserve if cls != INTERACTIVE else 0
        with self._lock:
            got = min(want, max(self._free - floor, 0))
            self._free -= got
        if got:
            self._m_in_use.inc(got)
            self._m_borrows.inc(got)
        else:
            self._m_exhausted.inc()
        return got

    def release(self, n: int) -> None:
        if n <= 0 or self.size == 0:
            return
        with self._lock:
            self._free = min(self.size, self._free + n)
        self._m_in_use.dec(n)


class Node:
    """One transport endpoint per process."""

    def __init__(
        self,
        address: Address,
        conf: Optional[TpuShuffleConf] = None,
        is_executor: bool = False,
    ):
        self.address = address
        self.conf = conf or TpuShuffleConf()
        self.is_executor = is_executor
        # optional pooled-buffer source for bulk receives (set by the
        # owning manager; TCP read responses land in pooled buffers)
        self.staging_pool = None
        # optional tiered block store (memory/tier.py, set by the
        # owning manager): prefetch hints warm its cold blocks through
        # the serve pool before the read RPCs arrive (warm_blocks)
        self.tier_store = None
        self._receive_listener: Optional[ReceiveListener] = None
        self._block_stores: Dict[int, BlockStore] = {}  # guarded-by: _block_store_lock
        self._block_store_lock = dbg_lock("node.block_stores", 48)
        # active (locally initiated) channels keyed by (peer, type, slot)
        # — slots > 0 are the striped data lanes of a peer's channel
        # group (transport/stripe.py)
        self._active: Dict[
            Tuple[Address, ChannelType, int], Channel
        ] = {}  # guarded-by: _active_lock
        self._active_lock = dbg_lock("node.active", 42)
        # LRU bookkeeping for the bounded channel cache: last-use
        # sequence per key, keys evicted at least once (so a
        # reconnect is countable), and the conf cap (0 = unbounded)
        self._last_use: Dict[
            Tuple[Address, ChannelType, int], int
        ] = {}  # guarded-by: _active_lock
        self._use_seq = 0  # guarded-by: _active_lock
        self._evicted_keys: set = set()  # guarded-by: _active_lock
        self._max_cached = self.conf.transport_max_cached_channels
        # multi-tenant QoS (qos/): the process-global tenant registry
        # when policy is on for this node's conf — pools classify and
        # broker through it; None keeps every edge plain FIFO
        self.qos = get_qos() if self.conf.qos_enabled else None
        # fixed borrowable data-lane budget for striped reads
        # (transport/stripe.py borrows per read, releases on completion);
        # QoS withholds a reserve slice from bulk-class borrows
        self.lane_pool = _LanePool(
            self.conf.transport_lane_pool_size,
            reserve=(
                self.conf.qos_lane_reserve if self.qos is not None else 0
            ),
        )
        self._m_cached = gauge("transport_cached_channels")
        self._m_evictions = counter("transport_channel_evictions_total")
        self._m_evict_refusals = counter(
            "transport_channel_evict_refusals_total")
        self._m_reconnects = counter("transport_channel_reconnects_total")
        # per-peer striped read groups (lazy; share the channel cache)
        self._read_groups: Dict[Address, object] = {}  # guarded-by: _read_groups_lock
        self._read_groups_lock = dbg_lock("node.read_groups", 44)
        # per-peer recovery state (faults/breaker.py): circuit breaker
        # + stripe health.  Node-resident — NOT on the ReadGroup, which
        # invalidate_read_group destroys on exactly the failures this
        # history must survive
        self._peer_health = PeerHealthRegistry(self.conf)
        self._passive: List[Channel] = []  # guarded-by: _passive_lock
        self._passive_lock = dbg_lock("node.passive", 46)
        # completion/dispatch pool — the RdmaThread analog: completions and
        # inbound frames are delivered off the caller's thread.  When
        # conf dispatcherCpuList (legacy alias: spark.shuffle.rdma
        # .cpuList) names a CPU subset, every worker pins itself to it
        # — the RdmaThread comp-vector affinity (RdmaNode.java:216-273)
        self._cpu_pins = self._parse_cpu_pins()
        self._dispatcher = ThreadPoolExecutor(
            max_workers=4,
            thread_name_prefix=f"node-{address[0]}:{address[1]}",
            initializer=self._init_pool_thread,
        )
        # the read service runs on its OWN bounded serve pool so
        # multi-MB block serves can never starve control-plane traffic
        # (a starved heartbeat ack would get a healthy executor pruned)
        # nor the channel reader loops, and its byte credits bound how
        # much registered memory concurrent serves pin
        self._serve_pool: Optional[_ServePool] = None
        self._serve_lock = dbg_lock("node.serve_pool", 40)
        # async transport core (transport/dispatcher.py): ONE selector
        # event-loop thread owning every transport socket, created
        # lazily by the first socket-backed registration under
        # conf transportAsyncDispatcher
        self._async_dispatcher = None
        self._disp_lock = dbg_lock("node.disp", 41)
        self._stopped = threading.Event()

    # -- dispatcher thread placement ----------------------------------------
    def _parse_cpu_pins(self) -> Optional[frozenset]:
        """Expand conf dispatcherCpuList against this host's CPUs for
        dispatcher-thread affinity.  None (no pinning) when the knob is
        unset, the platform has no ``sched_setaffinity``, or the parse
        resolves to every CPU anyway."""
        spec = self.conf.dispatcher_cpu_list.strip()
        if not spec or not hasattr(os, "sched_setaffinity"):
            return None
        ncpu = os.cpu_count() or 1
        pins = frozenset(self.conf.parse_dispatcher_cpu_list(ncpu))
        if not pins or pins == frozenset(range(ncpu)):
            return None
        return pins

    def _init_pool_thread(self) -> None:
        gauge("transport_threads", role="completion_pool").inc()
        self._pin_worker_thread()

    def _pin_worker_thread(self) -> None:
        if not self._cpu_pins:
            return
        try:
            os.sched_setaffinity(0, self._cpu_pins)
            counter("transport_threads_pinned_total").inc()
        except OSError as e:
            logger.warning(
                "%s: could not pin dispatcher thread to CPUs %s: %s",
                self, sorted(self._cpu_pins), e,
            )

    # -- receive dispatch ---------------------------------------------------
    def set_receive_listener(self, listener: ReceiveListener) -> None:
        self._receive_listener = listener

    def dispatch_frame(self, channel: Channel, frame: bytes,
                       on_consumed=None) -> None:
        """Deliver one inbound control-plane frame on the dispatcher.
        ``on_consumed`` fires once the frame's recv slot is free (credit
        accounting) — including on drop paths, so senders never starve."""
        listener = self._receive_listener
        if self._stopped.is_set() or listener is None:
            if listener is None and not self._stopped.is_set():
                logger.warning("%s: dropping frame, no receive listener", self)
            if on_consumed is not None:
                try:
                    on_consumed()
                except BaseException:
                    pass
            return
        self._dispatcher.submit(
            self._safe_dispatch, listener, channel, frame, on_consumed
        )

    @staticmethod
    def _safe_dispatch(listener, channel, frame, on_consumed=None) -> None:
        try:
            listener(channel, frame)
        except BaseException:
            logger.exception("receive listener raised")
        finally:
            if on_consumed is not None:
                try:
                    on_consumed()
                except BaseException:
                    pass

    def submit(self, fn, *args):
        """Run fn on the dispatcher (async completion delivery)."""
        return self._dispatcher.submit(fn, *args)

    def tenant_of_mkey(self, mkey) -> Optional[object]:
        """Resolve the QoS tenant owning a registered segment: the
        serve path classifies an incoming read by the TARGET block's
        owner (mkey → segment → shuffle → tenant), so the responder
        applies per-tenant policy with zero wire-format change.  None
        without QoS, for unknown mkeys, or for unbound shuffles."""
        qos = self.qos
        if qos is None or mkey is None:
            return None
        with self._block_store_lock:
            store = self._block_stores.get(mkey)
        get = getattr(store, "get", None)  # ArenaManager-backed stores
        if get is None:
            return None
        try:
            seg = get(mkey)
        except Exception:
            return None
        return qos.tenant_of_shuffle(getattr(seg, "shuffle_id", None))

    def submit_serve(self, fn, args: tuple = (), cost: int = 0,
                     deferred: bool = False, mkey=None,
                     cls: Optional[str] = None):
        """Run one read serve on the node's bounded serve pool (created
        on first use; workers pin to ``dispatcherCpuList`` like the
        dispatcher).  ``cost`` is the serve's requested byte total —
        the pool's credit budget throttles admission on it.
        ``deferred=True`` hands ``fn`` an idempotent ``release``
        callable that returns the credits (the async dispatcher's
        send-completion events release there instead of a worker
        blocking through the send).  ``mkey`` (the read's first target
        segment) resolves the owning tenant for QoS accounting;
        ``cls`` pins the priority class (tier warms pass BULK so a
        prefetch storm can never outrank demand serves)."""
        if self._stopped.is_set():
            raise TransportError(f"{self}: stopped")
        pool = self._serve_pool
        if pool is None:
            with self._serve_lock:
                if self._serve_pool is None:
                    self._serve_pool = _ServePool(
                        f"{self.address[0]}:{self.address[1]}",
                        self.conf.transport_serve_threads,
                        self.conf.transport_serve_credit_bytes,
                        init_fn=self._pin_worker_thread,
                        conf=self.conf,
                    )
                pool = self._serve_pool
        pool.submit(fn, args, cost, deferred,
                    tenant=self.tenant_of_mkey(mkey), cls=cls)

    def warm_blocks(self, locations) -> int:
        """Serve-side warm-before-read: promote the hinted block spans
        into the tier store's hot rows through the bounded serve pool —
        each warm is byte-credited exactly like a real serve, so a
        prefetch storm queues behind (and can never starve or out-pin)
        the serves it is trying to accelerate.  Returns warms
        submitted; a no-op without a tier store or for non-tiered
        mkeys."""
        tier = self.tier_store
        if tier is None:
            return 0
        n = 0
        for loc in locations:
            if loc.is_empty or not tier.would_warm(loc.mkey):
                continue
            try:
                self.submit_serve(
                    tier.warm, (loc.mkey, loc.address, loc.length),
                    cost=loc.length, mkey=loc.mkey, cls=BULK,
                )
            except TransportError:
                break  # node stopping: drop the remaining hints
            n += 1
        return n

    def get_dispatcher(self):
        """The node's async transport event loop (the submission/
        completion-queue progress engine, transport/dispatcher.py) —
        created lazily so loopback-only nodes never pay for it.
        Completion batches dispatch onto this node's completion pool
        (``submit``)."""
        d = self._async_dispatcher
        if d is not None:
            return d
        with self._disp_lock:
            if self._async_dispatcher is None:
                if self._stopped.is_set():
                    raise TransportError(f"{self}: stopped")
                from sparkrdma_tpu_torch.transport.dispatcher import Dispatcher

                self._async_dispatcher = Dispatcher(
                    f"{self.address[0]}:{self.address[1]}",
                    self.conf, self.submit,
                    pin_fn=self._pin_worker_thread,
                )
            return self._async_dispatcher

    # -- block stores (registered memory domains) ---------------------------
    def register_block_store(self, mkey: int, store: BlockStore) -> None:
        with self._block_store_lock:
            self._block_stores[mkey] = store

    def unregister_block_store(self, mkey: int) -> None:
        with self._block_store_lock:
            self._block_stores.pop(mkey, None)

    def read_local_block(self, location: BlockLocation) -> bytes:
        """Serve a one-sided read against this node's registered memory."""
        with self._block_store_lock:
            store = self._block_stores.get(location.mkey)
        if store is None:
            # fatal: the shuffle was unregistered (or never registered)
            # here — a retry would just re-ask the same dead question
            raise FatalTransportError(
                f"{self}: no block store registered for mkey={location.mkey}"
            )
        return store.read_block(location)

    def read_local_blocks(self, locations) -> list:
        """Batched one-sided read service: groups by owning store and
        uses its ``read_blocks`` (per-segment batched transfers on the
        arena store; the BlockStore base falls back per block)."""
        by_store: dict = {}
        with self._block_store_lock:
            for i, loc in enumerate(locations):
                store = self._block_stores.get(loc.mkey)
                if store is None:
                    raise FatalTransportError(
                        f"{self}: no block store registered for "
                        f"mkey={loc.mkey}"
                    )
                by_store.setdefault(id(store), (store, []))[1].append(i)
        out: list = [b""] * len(locations)
        for store, idxs in by_store.values():
            blocks = store.read_blocks([locations[i] for i in idxs])
            if len(blocks) != len(idxs):
                raise TransportError(
                    f"{store!r}.read_blocks returned {len(blocks)} "
                    f"blocks for {len(idxs)} locations"
                )
            for i, b in zip(idxs, blocks):
                out[i] = b
        return out

    # -- channel cache ------------------------------------------------------
    def get_channel(
        self,
        peer: Address,
        channel_type: ChannelType,
        connect: Callable[["Node", Address, ChannelType], Channel],
        must_retry: bool = True,
        slot: int = 0,
    ) -> Channel:
        """Get-or-create a channel to ``peer``.

        ``connect`` is the backend's connector.  Mirrors the reference's
        racy-create + retry loop (RdmaNode.java:277-351): concurrent
        callers race benignly, losers close their extra channel; dead
        cached channels are replaced up to ``connectRetries`` attempts
        with jittered exponential backoff (``connectBackoffMs`` base,
        doubling per attempt, capped at 16x).
        ``slot`` distinguishes the parallel data lanes of a striped
        channel group — each slot is its own cached connection.

        The cache is BOUNDED at ``transportMaxCachedChannels`` (0 =
        unbounded): inserting past the cap evicts the idle-coldest
        cached channels, and a key evicted earlier transparently
        reconnects here (counted as a reconnect).  A caller that loses
        the tiny race between receiving a cached channel and posting on
        it sees a synchronous ``TransportError`` and simply calls
        get_channel again — the evicted key is gone from the cache, so
        the retry reconnects (transport/stripe.py and the manager's
        control-plane send helpers do exactly that).
        """
        attempts = 0
        last_err: Optional[BaseException] = None
        max_attempts = self.conf.connect_retries if must_retry else 1
        backoff_s = self.conf.connect_backoff_ms / 1000.0
        key = (peer, channel_type, slot)
        while attempts < max_attempts and not self._stopped.is_set():
            attempts += 1
            if attempts > 1:
                counter("transport_connect_retries_total").inc()
            with self._active_lock:
                ch = self._active.get(key)
                if ch is not None and ch.is_connected():
                    self._touch_locked(key)
                    return ch
            try:
                new_ch = connect(self, peer, channel_type)
            except BaseException as e:
                last_err = e
                # jittered exponential backoff (equal jitter: half
                # fixed, half uniform — lockstep reconnect storms after
                # a shared-fabric blip decorrelate) on the stop event,
                # not time.sleep: node teardown mid-retry interrupts
                # the wait immediately instead of blocking stop()
                base = min(backoff_s * (2.0 ** (attempts - 1)),
                           backoff_s * 16.0)
                delay = base / 2.0 + random.uniform(0.0, base / 2.0)
                if self._stopped.wait(delay):
                    break
                continue
            with self._active_lock:
                cur = self._active.get(key)
                if cur is not None and cur.is_connected():
                    winner, loser = cur, new_ch  # lost the race
                else:
                    self._active[key] = new_ch
                    winner, loser = new_ch, cur
                self._touch_locked(key)
                reconnected = (
                    winner is new_ch and key in self._evicted_keys
                )
                if reconnected:
                    self._evicted_keys.discard(key)
                self._m_cached.set(len(self._active))
            if reconnected:
                self._m_reconnects.inc()
            if loser is not None:
                loser.stop()
            if winner.is_connected():
                if winner is new_ch:
                    self._maybe_evict(keep=key)
                return winner
            with self._active_lock:
                if self._active.get(key) is winner:
                    del self._active[key]
                    self._last_use.pop(key, None)
                self._m_cached.set(len(self._active))
            # stop the dead winner: nothing else references it, and
            # skipping teardown would leak its outstanding listeners
            # and the active-channel gauge increment
            winner.stop()
            last_err = TransportError("channel died immediately after connect")
        counter("transport_connect_exhausted_total").inc()
        # the peer is unreachable: a cached read group must not pin its
        # lane bookkeeping (and gauge) for the node's lifetime
        self.invalidate_read_group(peer)
        raise TransportError(
            f"{self}: could not connect to {peer} ({channel_type.name}) "
            f"after {attempts} attempts"
        ) from last_err

    def _touch_locked(
        self, key: Tuple[Address, ChannelType, int]
    ) -> None:
        """Record a cache use for LRU ordering — caller holds
        ``_active_lock``."""
        self._use_seq += 1  # noqa: CK03 - caller holds _active_lock
        self._last_use[key] = self._use_seq  # noqa: CK03 - caller holds _active_lock

    def _maybe_evict(self, keep=None) -> None:
        """Shrink the channel cache back under the conf cap: victims
        are the idle-coldest cached channels (LRU by last use), never
        one with in-flight ops — the listener/descriptor machinery is
        the refcount (``Channel.in_flight``), checked atomically with
        admission by ``Channel.stop_if_idle`` — and never ``keep``
        (the key whose channel the caller is about to hand out).
        Victims are stopped OUTSIDE the cache lock; a racing user that
        already holds a victim sees a synchronous post error and
        re-resolves through get_channel, which reconnects the evicted
        key."""
        cap = self._max_cached
        if cap <= 0:
            return
        victims: List[Tuple[Tuple[Address, ChannelType, int], Channel]] = []
        with self._active_lock:
            need = len(self._active) - cap
            if need <= 0:
                return
            order = sorted(
                self._active,
                # the lambda runs inside this with-block (sorted is
                # eager) — the analyzer just can't see through it
                key=lambda k: self._last_use.get(k, 0),  # noqa: CK03
            )
            for k in order:
                if need <= 0:
                    break
                if k == keep:
                    continue
                ch = self._active[k]
                if not ch.stop_if_idle():
                    self._m_evict_refusals.inc()
                    continue
                del self._active[k]
                self._last_use.pop(k, None)
                self._evicted_keys.add(k)
                victims.append((k, ch))
                need -= 1
            live_peers = {k[0] for k in self._active}
            self._m_cached.set(len(self._active))
        if not victims:
            return  # everything over cap is busy: tolerate overflow
        self._m_evictions.inc(len(victims))
        for _k, ch in victims:
            try:
                ch.stop()
            except Exception:
                logger.exception("evicted channel stop failed")
        for p in {k[0] for k, _ch in victims} - live_peers:
            # the peer's LAST cached channel left: its read group has
            # nothing to multiplex over until a fetch recreates it
            self.invalidate_read_group(p)

    def on_channel_dead(self, channel: Channel) -> None:
        """Death hook from the engines' channel-teardown paths (tcp
        reader-loop failure, async loop death): drop the dead channel
        from the caches it occupies so a dead peer does not pin cache
        slots, passive-list entries, or a stale read group until node
        teardown.  Idempotent and safe from any thread."""
        if self._stopped.is_set():
            return
        peer: Optional[Address] = None
        with self._active_lock:
            for k, ch in self._active.items():
                if ch is channel:
                    del self._active[k]
                    self._last_use.pop(k, None)
                    peer = k[0]
                    break
            peer_live = peer is not None and any(
                k[0] == peer for k in self._active
            )
            self._m_cached.set(len(self._active))
        with self._passive_lock:
            try:
                self._passive.remove(channel)
            except ValueError:
                pass
        if peer is not None and not peer_live:
            self.invalidate_read_group(peer)

    def get_read_group(self, peer: Address, connect):
        """Get-or-create ``peer``'s striped read group (one small-read
        lane + data lanes BORROWED per read from the node's fixed lane
        pool, over the channel cache) — the bulk-fetch entry point for
        readers.  Invalidated when the peer dies or its last cached
        channel is evicted; the next fetch just recreates it."""
        with self._read_groups_lock:
            group = self._read_groups.get(peer)
            if group is None:
                from sparkrdma_tpu_torch.transport.stripe import ReadGroup

                group = self._read_groups[peer] = ReadGroup(
                    self, peer, connect
                )
                gauge("transport_read_groups").inc()
        return group

    def peer_health(self, peer: Address):
        """``peer``'s recovery state (breaker + stripe health) —
        created on first use, survives read-group invalidation, cleared
        only at node stop."""
        return self._peer_health.get(peer)

    def invalidate_read_group(self, peer: Address) -> None:
        """Drop ``peer``'s cached read group (dead peer / evicted
        lanes): a group object already held by a reader keeps working —
        it re-resolves channels through the cache per read — this only
        stops a dead peer from pinning the cache entry and its gauge
        for the node's lifetime."""
        with self._read_groups_lock:
            group = self._read_groups.pop(peer, None)
        if group is not None:
            gauge("transport_read_groups").dec()
            counter("transport_read_group_invalidations_total").inc()

    def register_passive_channel(self, channel: Channel) -> None:
        if self._stopped.is_set():
            # an acceptor racing node teardown would otherwise hand out
            # a channel nothing ever stops — the peer's reads against
            # it would hang instead of failing fast
            channel.stop()
            return
        with self._passive_lock:
            self._passive.append(channel)

    def active_channels(self) -> List[Channel]:
        with self._active_lock:
            return list(self._active.values())

    # -- teardown -----------------------------------------------------------
    def stop(self) -> None:
        """Parallel teardown of all channels (RdmaNode.java:353-394)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._active_lock:
            actives = list(self._active.values())
            self._active.clear()
            self._last_use.clear()
            self._evicted_keys.clear()
            self._m_cached.set(0)
        with self._passive_lock:
            passives = list(self._passive)
            self._passive.clear()
        channels = actives + passives
        if channels:
            # bounded parallel teardown (reference: stop() waits a
            # teardownListenTimeout window, RdmaNode.java:367-394): a
            # hung channel must not wedge shutdown forever.  Plain
            # DAEMON threads, not a ThreadPoolExecutor: its workers are
            # non-daemon and concurrent.futures' atexit hook joins
            # them, so an abandoned wedged stop would still hang
            # interpreter exit.
            budget = max(
                self.conf.teardown_listen_timeout_ms / 1000.0,
                0.05,
            ) * max(1, len(channels))
            work: "queue.Queue[Channel]" = queue.Queue()
            for c in channels:
                work.put(c)

            def _stop_worker() -> None:
                while True:
                    try:
                        c = work.get_nowait()
                    except queue.Empty:
                        return
                    try:
                        c.stop()
                    except Exception:
                        logger.exception("channel stop failed")
                    finally:
                        work.task_done()

            workers = [
                threading.Thread(
                    target=_stop_worker, daemon=True,
                    name=f"node-stop-{i}",
                )
                for i in range(min(8, len(channels)))
            ]
            for t in workers:
                t.start()
            deadline = time.monotonic() + budget
            for t in workers:
                t.join(max(0.0, deadline - time.monotonic()))
            hung = sum(1 for t in workers if t.is_alive())
            if hung:
                logger.warning(
                    "node %s teardown: %d stop worker(s) still busy "
                    "after %.1fs — abandoning (daemon threads; they "
                    "cannot block process exit)", self.address,
                    hung, budget,
                )
        # the async event loop stops AFTER channels (their _loop_close
        # descriptors must drain) and BEFORE the completion pool (its
        # teardown completion batch still needs an executor)
        with self._disp_lock:
            disp, self._async_dispatcher = self._async_dispatcher, None
        if disp is not None:
            disp.stop()
        self._dispatcher.shutdown(wait=True)
        gauge("transport_threads", role="completion_pool").dec(
            len(getattr(self._dispatcher, "_threads", ()))
        )
        with self._serve_lock:
            serve, self._serve_pool = self._serve_pool, None
        if serve is not None:
            serve.stop()
        with self._read_groups_lock:
            n_groups = len(self._read_groups)
            self._read_groups.clear()
        if n_groups:
            gauge("transport_read_groups").dec(n_groups)
        self._peer_health.clear()
        with self._block_store_lock:
            self._block_stores.clear()

    def __repr__(self) -> str:
        return f"Node({self.address[0]}:{self.address[1]})"
