"""Channel abstraction: two traffic classes, flow control, completions.

TPU-native re-design of the reference's RdmaChannel
(RdmaChannel.java:35-873).  Kept semantics:

- Four channel roles (RdmaChannel.java:41): RPC requestor/responder for
  the driver↔executor control plane, READ requestor/responder for the
  executor↔executor bulk plane.
- Send-budget semaphore + FIFO pending queue so posting more work than
  the queue depth never blocks the caller or drops work
  (RdmaChannel.java:61-71,379-439).
- Async completion listeners; ``on_failure`` must tolerate multiple
  invocations (RdmaCompletionListener.java:25).
- Channel state machine IDLE → CONNECTING → CONNECTED → ERROR/STOPPED,
  with sticky ERROR and ``stop()`` failing all outstanding listeners
  (RdmaChannel.java:103-110,788-869).

Dropped (no analog on TPU): QP/CQ plumbing, recv WR pools, credit
immediates — XLA owns scheduling on the bulk plane; the loopback backend
models completion dispatch with a dispatcher thread instead of a CQ
polling thread.
"""

from __future__ import annotations

import enum
import threading
from collections import deque
from typing import Callable, List, Optional, Sequence

from sparkrdma_tpu_torch.metrics import gauge
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.statemachine import StateMachine
from sparkrdma_tpu_torch.utils.types import BlockLocation


class TransportError(Exception):
    """Raised for channel/node failures (connect, send, read, teardown).

    ``transient`` classifies the failure for the reader's in-task
    retry policy: transient errors (the default — connection drops,
    lane deaths, injected faults) are worth retrying; fatal ones
    (:class:`FatalTransportError` — protocol violations, missing
    block stores) convert straight to ``FetchFailedError``.
    """

    transient = True


class FatalTransportError(TransportError):
    """A transport failure retrying cannot fix (bad frame, unknown
    mkey, wire-version mismatch)."""

    transient = False


def is_transient(err: BaseException) -> bool:
    """Retry classification: only transport errors marked transient
    qualify — anything else (decode bugs, serialization errors) is a
    program error a retry would just repeat."""
    return isinstance(err, TransportError) and err.transient


_FATAL_PREFIX = "FATAL:"


def encode_remote_error(err: BaseException) -> str:
    """Serve-side error -> status-frame reason string.  Fatal errors
    carry a classification prefix so the requester's taxonomy survives
    the wire without a frame change."""
    reason = str(err)
    if not is_transient(err) and isinstance(err, TransportError):
        return _FATAL_PREFIX + reason
    return reason


def decode_remote_error(reason: str) -> TransportError:
    """Status-frame reason string -> classified transport error."""
    if reason.startswith(_FATAL_PREFIX):
        return FatalTransportError(reason[len(_FATAL_PREFIX):])
    return TransportError(reason)


class ChannelType(enum.Enum):
    RPC_REQUESTOR = "rpc_requestor"
    RPC_RESPONDER = "rpc_responder"
    RPC_WRAPPER = "rpc_wrapper"  # bidirectional (driver side of hello-back)
    READ_REQUESTOR = "read_requestor"
    READ_RESPONDER = "read_responder"


class ChannelState(enum.Enum):
    IDLE = 0
    CONNECTING = 1
    CONNECTED = 2
    ERROR = 3
    STOPPED = 4


class CompletionListener:
    """Async completion contract (reference: RdmaCompletionListener.java).

    on_failure may be invoked more than once and must tolerate it.
    """

    def on_success(self, result) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def on_failure(self, error: BaseException) -> None:  # pragma: no cover
        raise NotImplementedError


class FnCompletionListener(CompletionListener):
    def __init__(self, on_success: Callable = None, on_failure: Callable = None):
        self._ok = on_success or (lambda r: None)
        self._err = on_failure or (lambda e: None)

    def on_success(self, result) -> None:
        self._ok(result)

    def on_failure(self, error: BaseException) -> None:
        self._err(error)


class Channel(StateMachine):
    """Base channel: state machine + send budgeting.

    Subclasses implement ``_post_rpc`` and ``_post_read`` which perform
    the actual transfer and MUST call ``_complete(listener, result)`` or
    ``_fail(listener, err)`` exactly once when done (possibly on another
    thread), then ``_release_budget()``.
    """

    MACHINE = "channel.lifecycle"
    STATES = ("idle", "connecting", "connected", "error", "stopped")
    INITIAL = "idle"
    TERMINAL = ("stopped",)
    TRANSITIONS = {
        "idle": ("connecting", "connected", "error", "stopped"),
        "connecting": ("connected", "error", "stopped"),
        "connected": ("error", "stopped"),
        "error": ("stopped",),
    }

    #: whether this channel's ``_post_read`` honors ``dest`` scatter
    #: buffers and ``on_progress`` callbacks (the striped-read group
    #: only stripes across channels that do)
    supports_scatter = False

    def __init__(self, channel_type: ChannelType, send_queue_depth: int = 4096):
        self.channel_type = channel_type
        #: negotiated wire generation — 0 means "unversioned" (in-process
        #: channels, tests), treated as current; the TCP engines stamp
        #: the handshake's accepted/negotiated version here, and senders
        #: suppress v2-only bytes when it reads 1
        self.wire_version = 0
        self._state = ChannelState.IDLE  # state: channel.lifecycle
        self._state_lock = dbg_lock("channel.state", 60)
        # send-WR budget: number of outstanding posted operations
        self._budget = threading.Semaphore(send_queue_depth)
        self._send_queue_depth = send_queue_depth
        # (post_fn, listener) pairs
        self._pending: deque = deque()  # guarded-by: _pending_lock
        self._pending_lock = dbg_lock("channel.pending", 62)
        # listeners awaiting completion
        self._outstanding: set = set()  # guarded-by: _outstanding_lock
        self._outstanding_lock = dbg_lock("channel.outstanding", 64)
        # active-channel gauge handle, held between CONNECTED and stop()
        self._m_active_gauge = None

    # -- state machine ------------------------------------------------------
    @property
    def state(self) -> ChannelState:
        return self._state

    def is_connected(self) -> bool:
        return self._state == ChannelState.CONNECTED

    def _set_state(self, new: ChannelState) -> None:
        with self._state_lock:
            if self._state in (ChannelState.ERROR, ChannelState.STOPPED):
                return  # sticky terminal states
            prev = self._state
            self._transition(new)
        if (new == ChannelState.CONNECTED
                and prev != ChannelState.CONNECTED
                and self._m_active_gauge is None):
            g = gauge("transport_active_channels")
            g.inc()
            self._m_active_gauge = g

    def _check_usable(self) -> None:
        if self._state != ChannelState.CONNECTED:
            raise TransportError(
                f"channel not connected (state={self._state.name})"
            )

    # -- public API ---------------------------------------------------------
    def send_rpc(self, frames: Sequence[bytes], listener: CompletionListener) -> None:
        """Post control-plane frames (reference: rdmaSendInQueue,
        RdmaChannel.java:476-505).  Never blocks: if the send budget is
        exhausted the operation is queued FIFO."""
        self._enqueue(lambda: self._post_rpc(list(frames), listener), listener)

    def read_blocks(
        self,
        locations: Sequence[BlockLocation],
        listener: CompletionListener,
        dest: Optional[Sequence] = None,
        on_progress: Optional[Callable[[int], None]] = None,
        ctx=None,
    ) -> None:
        """Post a scatter read of remote blocks — the one-sided RDMA READ
        analog (reference: rdmaReadInQueue, RdmaChannel.java:441-474).
        Completion delivers a list of bytes-like payloads, one per
        location.

        Channels with ``supports_scatter`` additionally honor:

        - ``dest``: per-location writable uint8 buffers (or None
          entries) the payloads land in DIRECTLY — the striped
          reassembly path; completion then delivers the dest buffers
          themselves in place of fresh payloads.
        - ``on_progress(nbytes)``: fires as each location's payload
          arrives, before completion — stripe-granular in-flight-window
          accounting for the reader.

        ``ctx`` is an optional trace context (obs/) the engine carries
        to the serving node — the v2 read-request tail — so serve-side
        spans join the requester's trace; None costs nothing."""
        if dest is None and on_progress is None and ctx is None:
            self._enqueue(
                lambda: self._post_read(list(locations), listener), listener
            )
        else:
            self._enqueue(
                lambda: self._post_read(
                    list(locations), listener, dest, on_progress, ctx
                ),
                listener,
            )

    def in_flight(self) -> int:
        """Operations posted but not yet completed (outstanding
        listeners + budget-queued posts) — the refcount the node's LRU
        channel cache consults before evicting: a channel with work in
        flight is never torn out from under its listeners.  Both
        engines route every op through the base-class listener
        machinery, so this covers reads and RPC sends alike.  Both sets
        are read under their locks together: a pending op is promoted
        (``_release_budget``) under the same two, so the count never
        reads 0 while an op moves from one set to the other."""
        with self._pending_lock, self._outstanding_lock:
            return len(self._outstanding) + len(self._pending)

    def stop_if_idle(self) -> bool:
        """The channel cache's eviction test, atomic with admission: with
        nothing in flight, move to STOPPED, so that every later post
        raises synchronously in ``_check_usable`` (its caller re-resolves
        through the cache), and return True; the caller then runs
        ``stop()`` for the engine's teardown.  With an op in flight,
        change nothing and return False.  A plain ``in_flight()`` check
        followed by ``stop()`` let a post land between the two and fail
        through its listener instead."""
        with self._state_lock:
            if self.in_flight():
                return False
            if self._state != ChannelState.STOPPED:
                self._transition(ChannelState.STOPPED)
        return True

    def stop(self) -> None:
        """Teardown: fail every outstanding / pending listener
        (reference: RdmaChannel.java:788-869).  Runs its drain after
        ``stop_if_idle`` too, which only moved the state."""
        with self._state_lock:
            if self._state != ChannelState.STOPPED:
                self._transition(ChannelState.STOPPED)
            g, self._m_active_gauge = self._m_active_gauge, None
        if g is not None:
            g.dec()
        err = TransportError("channel stopped")
        with self._pending_lock:
            pending = list(self._pending)
            self._pending.clear()
        for _, listener in pending:
            self._safe_fail(listener, err)
        with self._outstanding_lock:
            outstanding = list(self._outstanding)
            self._outstanding.clear()
        for listener in outstanding:
            self._safe_fail(listener, err)

    # -- budget / pending machinery -----------------------------------------
    def _enqueue(self, post_fn: Callable[[], None], listener: CompletionListener):
        # admission under the state lock: stop() and stop_if_idle()
        # take it too, so an op is either tracked (in flight, and a
        # later stop fails it through its listener) or refused here,
        # synchronously, before its listener is touched
        with self._state_lock:
            self._check_usable()
            if not self._budget.acquire(blocking=False):
                with self._pending_lock:
                    self._pending.append((post_fn, listener))
                return
            self._track(listener)
        self._run_post(post_fn, listener)

    def _run_post(self, post_fn, listener) -> None:
        try:
            post_fn()
        except BaseException as e:  # posting failed synchronously
            self._error(e)
            self._fail(listener, e)
            self._release_budget()

    def _track(self, listener) -> None:
        with self._outstanding_lock:
            self._outstanding.add(listener)

    def _release_budget(self) -> None:
        """Called after each completion; drains one pending op
        (reference: exhaustCq draining pendingSends)."""
        with self._pending_lock:
            nxt = self._pending.popleft() if self._pending else None
            if nxt is not None:
                # tracked before the pending lock drops: in_flight()
                # sees the op in one set or the other, never in neither
                self._track(nxt[1])
        if nxt is None:
            self._budget.release()
            return
        post_fn, listener = nxt
        self._run_post(post_fn, listener)

    # -- completion plumbing ------------------------------------------------
    def _untrack(self, listener) -> None:
        with self._outstanding_lock:
            self._outstanding.discard(listener)

    def _complete(self, listener: CompletionListener, result) -> None:
        self._untrack(listener)
        try:
            listener.on_success(result)
        except BaseException:
            pass

    def _fail(self, listener: CompletionListener, err: BaseException) -> None:
        self._untrack(listener)
        self._safe_fail(listener, err)

    @staticmethod
    def _safe_fail(listener: CompletionListener, err: BaseException) -> None:
        try:
            listener.on_failure(err)
        except BaseException:
            pass

    def _error(self, err: BaseException) -> None:
        """Flip to sticky ERROR (reference: completion-with-error path,
        RdmaChannel.java:611-637)."""
        with self._state_lock:
            if self._state not in (ChannelState.STOPPED,):
                self._transition(ChannelState.ERROR)

    # -- subclass hooks -----------------------------------------------------
    def _post_rpc(self, frames: List[bytes], listener: CompletionListener) -> None:
        raise NotImplementedError

    def _post_read(
        self,
        locations: List[BlockLocation],
        listener: CompletionListener,
        dest=None,
        on_progress=None,
        ctx=None,
    ) -> None:
        raise NotImplementedError


class BlockStore:
    """Registered-memory domain served by a node: resolves a
    BlockLocation's (mkey, address, length) to bytes — what the NIC does
    for a one-sided READ against an lkey/rkey in the reference."""

    def read_block(self, location: BlockLocation) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def read_blocks(self, locations) -> list:
        """Batched read; stores with a cheaper grouped path override
        this (ArenaManager batches per backing segment)."""
        return [self.read_block(loc) for loc in locations]


class BytesBlockStore(BlockStore):
    """Host-memory block store over one contiguous buffer; ``address``
    is the byte offset within it.  Blocks serve as zero-copy chunk
    views of the backing buffer (the transport sends views
    scatter-gather; the view keeps the buffer alive by refcount)."""

    def __init__(self, data: bytes):
        self._view = memoryview(data)

    def read_block(self, location: BlockLocation):
        end = location.address + location.length
        if location.address < 0 or end > len(self._view):
            raise TransportError(
                f"read [{location.address},{end}) outside store of "
                f"{len(self._view)}B"
            )
        return self._view[location.address : end]
