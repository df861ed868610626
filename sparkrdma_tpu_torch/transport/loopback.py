"""In-process loopback transport: the test/fallback backend.

The reference has no fake transport (its only backend is real verbs,
SURVEY.md §4) — this backend is the test harness the rebuild adds: a
process-local "network" of Nodes where

- ``send_rpc`` delivers frames to the peer node's receive dispatcher on
  the peer's dispatcher pool (async, like SEND/RECV + CQ thread), and
- ``read_blocks`` pulls bytes straight out of the peer node's registered
  block stores with *no peer-side handler involved* — faithfully modeling
  the one-sided RDMA READ data plane (the "remote CPU never serves
  reads" property, SURVEY.md §2 backend notes).

Failure injection: ``partition(addr)`` refuses new connects and kills
in-flight ops to that address; ``Channel.inject_error()`` flips a single
channel to sticky ERROR, failing its outstanding ops — exercising the
same failure semantics the reference gets from CQ error completions.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.metrics import counter, histogram
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.transport.channel import (
    Channel,
    ChannelState,
    ChannelType,
    CompletionListener,
    TransportError,
)
from sparkrdma_tpu_torch.transport.node import Address, Node
from sparkrdma_tpu_torch.utils import wiredbg
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock

_PAIRED = {
    ChannelType.RPC_REQUESTOR: ChannelType.RPC_RESPONDER,
    ChannelType.RPC_WRAPPER: ChannelType.RPC_WRAPPER,
    ChannelType.READ_REQUESTOR: ChannelType.READ_RESPONDER,
}


def _land(block, d):
    """Copy one served block into its registered dest buffer (the
    recv_into analog — bit-exact with TcpChannel's scatter path)."""
    arr = d if isinstance(d, np.ndarray) else np.frombuffer(d, np.uint8)
    src = (
        block if isinstance(block, np.ndarray)
        else np.frombuffer(memoryview(block), np.uint8)
    )
    if src.shape[0] != arr.shape[0]:
        raise TransportError(
            f"stripe length mismatch: {src.shape[0]}B payload for "
            f"{arr.shape[0]}B dest buffer"
        )
    arr[:] = src
    return d


class LoopbackChannel(Channel):
    """One direction of an in-process channel pair.

    RPC channels implement receiver-credit software flow control when
    the node's conf enables it (reference: sender consumes one credit
    per SEND, receiver piggybacks credit reports once half the recv
    queue is consumed, RdmaChannel.java:56-59,508-520,690-703)."""

    supports_scatter = True

    def __init__(
        self,
        channel_type: ChannelType,
        local: Node,
        remote: Node,
        network: "LoopbackNetwork",
        send_queue_depth: int,
    ):
        super().__init__(channel_type, send_queue_depth)
        self.local = local
        self.remote = remote
        self.network = network
        self.peer_channel: Optional["LoopbackChannel"] = None
        conf = local.conf
        self._fc_enabled = conf.sw_flow_control and channel_type in (
            ChannelType.RPC_REQUESTOR, ChannelType.RPC_RESPONDER,
            ChannelType.RPC_WRAPPER,
        )
        self._credits = conf.recv_queue_depth  # guarded-by: _credit_lock
        self._credit_lock = dbg_lock("loopback.credits", 66)
        # (frames, listener) blocked on credits
        self._credit_waiting: List = []  # guarded-by: _credit_lock
        self._consumed_since_report = 0  # guarded-by: _credit_lock
        self._report_threshold = max(1, conf.recv_queue_depth // 2)
        self._m_bytes_sent = counter(
            "transport_bytes_sent_total", transport="loopback")
        self._m_bytes_recv = counter(
            "transport_bytes_received_total", transport="loopback")
        self._m_msgs_sent = counter(
            "transport_msgs_sent_total", transport="loopback")
        self._m_read_rtt = histogram(
            "transport_read_rtt_ms", transport="loopback")

    # -- credit machinery (transport-internal, like WRITE_WITH_IMM) ---------
    def _on_credit_report(self, n: int) -> None:
        """Credits became available (peer report or failed-delivery
        restore); drain blocked sends.  Pop-and-take happens atomically
        under _credit_lock so a report racing a failed take can never
        strand a queued send; failed deliveries restore their credits and
        loop so later queued sends still fail promptly."""
        while True:
            drained = []
            with self._credit_lock:
                self._credits += n
                n = 0
                while (
                    self._credit_waiting
                    and self._credits >= len(self._credit_waiting[0][0])
                ):
                    frames, listener = self._credit_waiting.pop(0)
                    self._credits -= len(frames)
                    drained.append((frames, listener))
            if not drained:
                return
            restore = 0
            for frames, listener in drained:
                if not self._deliver_frames(frames, listener):
                    restore += len(frames)
            if restore == 0:
                return
            n = restore

    def _frame_consumed(self) -> None:
        """Receiver side: one recv slot freed after dispatch; report
        credits back in batches."""
        with self._credit_lock:
            self._consumed_since_report += 1
            if self._consumed_since_report < self._report_threshold:
                return
            n, self._consumed_since_report = self._consumed_since_report, 0
        peer = self.peer_channel
        if peer is not None:
            peer._on_credit_report(n)

    # -- posting ------------------------------------------------------------
    def _post_rpc(self, frames: List[bytes], listener: CompletionListener) -> None:
        def deliver():
            # fail fast BEFORE consuming credits: a dead channel must not
            # burn credits it can never get reported back
            err = self._check_deliverable()
            if err is None and FAULTS.enabled:
                try:
                    FAULTS.check("send")
                except TransportError as e:
                    err = e
            if err is not None:
                self._error(err)
                self._fail(listener, err)
                self._release_budget()
                return
            if self._fc_enabled:
                with self._credit_lock:
                    if self._credits >= len(frames):
                        self._credits -= len(frames)
                    else:
                        self._credit_waiting.append((frames, listener))
                        return  # budget held until credits arrive
            if not self._deliver_frames(frames, listener) and self._fc_enabled:
                self._on_credit_report(len(frames))  # restore + re-drain

        self.local.submit(deliver)

    def _check_deliverable(self) -> Optional[TransportError]:
        if self.network.is_partitioned(self.local.address, self.remote.address):
            return TransportError(f"network partition to {self.remote.address}")
        if self.state != ChannelState.CONNECTED:
            return TransportError("channel not connected")
        return None

    def _deliver_frames(
        self, frames: List[bytes], listener: CompletionListener
    ) -> bool:
        """Returns True when the frames were handed to the peer; on False
        the listener has been failed and (for flow-controlled channels)
        the caller must restore the consumed credits."""
        try:
            err = self._check_deliverable()
            if err is not None:
                raise err
            target = self.peer_channel if self.peer_channel is not None else self
            for frame in frames:
                data = bytes(frame)
                if (wiredbg.wire_debug_enabled()
                        and not wiredbg.rpc_frame_ok("loopback", data)):
                    # loopback has no byte framing, so this is the
                    # engine's whole validator: the rejected frame is
                    # dropped (counted + logged) but still frees its
                    # recv slot — the credit must flow back or the
                    # sender leaks it
                    target._frame_consumed()
                    continue
                self.remote.dispatch_frame(
                    target, data, on_consumed=target._frame_consumed
                )
        except BaseException as e:
            self._error(e)
            self._fail(listener, e)
            self._release_budget()
            return False
        else:
            self._m_msgs_sent.inc(len(frames))
            self._m_bytes_sent.inc(sum(len(f) for f in frames))
            self._complete(listener, None)
            self._release_budget()
            return True

    def _post_read(self, locations, listener: CompletionListener,
                   dest=None, on_progress=None, ctx=None) -> None:
        # clock starts at POST time (like TcpChannel stamping t0 in
        # _post_read): the serve-queue wait is part of the RTT, so the
        # tcp/loopback series stay comparable under load
        t0 = time.monotonic()

        def fail(e: BaseException) -> None:
            self._error(e)
            self._fail(listener, e)
            self._release_budget()

        def land(data) -> None:
            # receiver-side completion: the landing copy, progress and
            # completion callbacks run INSIDE the serve (still under
            # its byte credits), so a slow receiver back-pressures the
            # responder exactly like TcpChannel's credit-held sendmsg
            try:
                if dest is not None:
                    # striped-reassembly parity with TcpChannel: each
                    # payload lands in its registered dest buffer and
                    # the dest object IS the completed block
                    data = [
                        _land(data[i], dest[i])
                        if i < len(dest) and dest[i] is not None
                        else data[i]
                        for i in range(len(data))
                    ]
                if on_progress is not None:
                    for b in data:
                        try:
                            on_progress(len(b))
                        except BaseException:
                            pass
            except BaseException as e:
                fail(e)
            else:
                self._m_read_rtt.observe((time.monotonic() - t0) * 1000.0)
                self._m_bytes_recv.inc(sum(len(b) for b in data))
                self._complete(listener, data)
                self._release_budget()

        def serve() -> None:
            # responder side: resolve the blocks from registered memory
            # on the REMOTE node's bounded serve pool — off this node's
            # dispatcher (a multi-MB loopback read must not head-of-
            # line-block control frames), under the same byte-credit
            # flow control the TCP read service carries (TCP parity;
            # the serve holds its block views only while it owns
            # credits)
            try:
                if self.network.is_partitioned(
                    self.local.address, self.remote.address
                ):
                    raise TransportError(
                        f"network partition to {self.remote.address}"
                    )
                if self.state != ChannelState.CONNECTED:
                    raise TransportError("channel not connected")
                if FAULTS.enabled:
                    FAULTS.check("serve_delay")
                    FAULTS.check("serve")
                    # loopback has no response frame to cut, so the
                    # read_resp point fires here on the reply boundary
                    FAULTS.check("read_resp")
                ts = time.monotonic()
                data = self.remote.read_local_blocks(locations)
                if ctx is not None and RECORDER.enabled:
                    # in-process serve: the trace context needs no wire
                    # tail — the closure carries it to the serve side
                    fr_event(
                        "transport", "serve_read",
                        trace_id=ctx[0], span_id=ctx[1],
                        blocks=len(locations),
                        us=int((time.monotonic() - ts) * 1e6),
                    )
            except BaseException as e:
                fail(e)
                return
            land(data)

        try:
            self.remote.submit_serve(
                serve, (), cost=sum(loc.length for loc in locations),
                mkey=locations[0].mkey if locations else None,
            )
        except BaseException as e:
            # remote node stopped (serve pool refused): fail fast like
            # a read against a dead peer, asynchronously so post-read
            # keeps its completion-callback contract
            try:
                self.local.submit(fail, e)
            except BaseException:
                fail(e)

    def _error(self, err: BaseException) -> None:
        # ERROR is sticky (the channel is dead for good): run the same
        # cache/passive/read-group cleanup the TCP engines run on their
        # teardown paths, so a partitioned/stopped loopback peer does
        # not pin cache slots until node teardown (idempotent; no-op
        # while the owning node is itself stopping)
        super()._error(err)
        self.local.on_channel_dead(self)

    def stop(self) -> None:
        # credit-waiting listeners are tracked in _outstanding, which
        # super().stop() fails exactly once — just drop the queue
        with self._credit_lock:
            self._credit_waiting.clear()
        super().stop()

    # -- failure injection --------------------------------------------------
    def inject_error(self) -> None:
        self._error(TransportError("injected channel error"))
        err = TransportError("injected channel error")
        with self._outstanding_lock:
            outstanding = list(self._outstanding)
            self._outstanding.clear()
        for l in outstanding:
            self._safe_fail(l, err)

    def reply_channel(self) -> Channel:
        """Channel on which the receiver of a frame answers.  Frames are
        dispatched tagged with the receiver-owned reverse channel, so the
        reply path is this very channel."""
        return self


class LoopbackNetwork:
    """Registry of in-process nodes + connector, with failure injection."""

    def __init__(self):
        self._nodes: Dict[Address, Node] = {}  # guarded-by: _lock
        self._lock = dbg_lock("loopback.network", 56)
        # frozenset({a, b}) pairs or single addr
        self._partitioned: set = set()  # guarded-by: _lock

    # -- membership ---------------------------------------------------------
    def register(self, node: Node) -> None:
        with self._lock:
            if node.address in self._nodes:
                raise TransportError(f"address already bound: {node.address}")
            self._nodes[node.address] = node

    def unregister(self, node: Node) -> None:
        with self._lock:
            self._nodes.pop(node.address, None)

    def lookup(self, address: Address) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(address)

    # -- failure injection --------------------------------------------------
    def partition(self, address: Address) -> None:
        """Cut an endpoint off (executor loss)."""
        with self._lock:
            self._partitioned.add(address)

    def heal(self, address: Address) -> None:
        with self._lock:
            self._partitioned.discard(address)

    def is_partitioned(self, a: Address, b: Address) -> bool:
        with self._lock:
            return a in self._partitioned or b in self._partitioned

    # -- connector (passed to Node.get_channel) -----------------------------
    def connect(
        self, src: Node, peer: Address, channel_type: ChannelType
    ) -> Channel:
        """CM-handshake analog: create the channel pair, register the
        passive side with the acceptor (RdmaNode CM listener accepting
        CONNECT_REQUEST, RdmaNode.java:114-214)."""
        counter(
            "transport_connect_attempts_total", transport="loopback"
        ).inc()
        if FAULTS.enabled:
            FAULTS.check("connect")
        dst = self.lookup(peer)
        if dst is None:
            counter(
                "transport_connect_failures_total", transport="loopback"
            ).inc()
            raise TransportError(f"connection refused: no node at {peer}")
        if self.is_partitioned(src.address, peer):
            counter(
                "transport_connect_failures_total", transport="loopback"
            ).inc()
            raise TransportError(f"network partition to {peer}")
        depth = src.conf.send_queue_depth
        fwd = LoopbackChannel(channel_type, src, dst, self, depth)
        back_type = _PAIRED.get(channel_type, channel_type)
        bwd = LoopbackChannel(back_type, dst, src, self, depth)
        fwd.peer_channel = bwd
        bwd.peer_channel = fwd
        fwd._set_state(ChannelState.CONNECTED)
        bwd._set_state(ChannelState.CONNECTED)
        dst.register_passive_channel(bwd)
        return fwd
