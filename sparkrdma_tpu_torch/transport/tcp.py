"""TCP transport: the real multi-process control/data plane backend.

Same connector interface as :class:`LoopbackNetwork`, over real sockets,
so driver and executors can live in separate processes or hosts.  On a
TPU pod the BULK shuffle plane rides ICI collectives (the TileExchange);
this backend carries what remains host-side — the control plane (the
five RPC message types) and the block-fetch path for executors outside
the mesh (spill-over, debugging, CPU-only deployments).

Mapping to the reference (RdmaNode.java / RdmaChannel.java):

- connect() plays the RDMA CM handshake: a 9-byte hello carrying the
  channel type and the caller's listening port, acked by the acceptor
  (CONNECT_REQUEST/ESTABLISHED, RdmaNode.java:114-214).
- OP_RPC frames are the two-sided SEND/RECV class; TCP supplies
  ordering and (via its window) flow control, so the software credit
  scheme of the loopback backend is not re-implemented here.
- OP_READ_REQ/RESP is the one-sided READ class: the acceptor serves
  registered-memory reads on the node's dedicated bulk pool — the
  application's receive listener is never involved, preserving the
  "remote CPU does not run app code to serve reads" split (the NIC's
  role in RdmaChannel.java:441-474; here dedicated service threads,
  kept off both the reader loop and the control-plane dispatcher).

Framing: every message is ``1B opcode + 4B LE length + payload``.
Read requests carry ``8B req_id + 4B count + count × (8B address,
4B length, 4B mkey)``; responses carry ``8B req_id + 1B status`` then
either ``count × (4B len + bytes)`` or an error string.

The 9-byte connect hello carries the protocol version
(``WIRE_VERSION``): ``4B magic + 1B channel type + 2B src port +
2B version``.  A version mismatch is rejected STRUCTURALLY — the
acceptor answers ``\\x00`` plus ``<HH`` (its version, the hello's
version) instead of the ``\\x01`` ack, so both sides can name both
versions in the error instead of desyncing mid-stream.
"""

from __future__ import annotations

import errno
import logging
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.faults.injector import FAULTS
from sparkrdma_tpu_torch.metrics import counter, gauge, histogram
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.transport.channel import (
    Channel,
    ChannelState,
    ChannelType,
    CompletionListener,
    TransportError,
    decode_remote_error,
    encode_remote_error,
)
from sparkrdma_tpu_torch.transport.node import Address, Node
from sparkrdma_tpu_torch.utils import wiredbg
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.types import BlockLocation

logger = logging.getLogger(__name__)

_MAGIC = b"STPU"
_HDR = struct.Struct("<BI")          # opcode, payload length
_HELLO = struct.Struct("<4sBHH")     # magic, channel type, src port, version
_HELLO_REJ = struct.Struct("<HH")    # (acceptor's version, hello's version)
_REQ_HDR = struct.Struct("<QI")      # req_id, location count
_LOC = struct.Struct("<QII")         # address, length, mkey
_RESP_HDR = struct.Struct("<QB")     # req_id, status
_LEN = struct.Struct("<I")
_TRACE_CTX = struct.Struct("<QQ")    # optional read-req tail: trace, span id

#: Wire protocol generation carried in the connect hello.  Bump on any
#: incompatible change to framing or message layout.  v2 adds the
#: OPTIONAL trace-context tail to read requests and the trace fields on
#: fetch-status/prefetch RPCs (rpc/messages.py ``since=2`` fields).
#: v3 adds the push-based merged shuffle messages (PushSubBlockMsg /
#: FetchMergeStatusMsg / MergeStatusResponseMsg, types 13-15): push
#: senders gate on the channel's negotiated generation, so pre-v3
#: peers simply never merge and every block rides the pull path.
#: Acceptors take any hello in [MIN_WIRE_VERSION, WIRE_VERSION]; a
#: hello above/below that range is rejected STRUCTURALLY with both
#: versions named (pre-versioning peers sent 0 in this slot, so they
#: reject cleanly too).  The connector, NAKed by an older acceptor
#: whose version it can still speak, re-dials at the acceptor's
#: generation — the negotiated fallback — and records the channel's
#: ``wire_version`` so v2-only bytes stay off that channel.
WIRE_VERSION = 3

#: Oldest wire generation this build still speaks (for both accepting
#: older hellos and downgrading its own).
MIN_WIRE_VERSION = 1

OP_RPC = 1
OP_READ_REQ = 2
OP_READ_RESP = 3

_TYPE_BY_INDEX = list(ChannelType)

# what the acceptor's side of each connection is called
_PAIRED = {
    ChannelType.RPC_REQUESTOR: ChannelType.RPC_RESPONDER,
    ChannelType.RPC_WRAPPER: ChannelType.RPC_WRAPPER,
    ChannelType.READ_REQUESTOR: ChannelType.READ_RESPONDER,
}

_MAX_FRAME = 1 << 30

# iovec batch per sendmsg call (IOV_MAX is ≥1024 on Linux; stay well
# under it — grouped fetches of many blocks produce many segments)
_IOV_MAX = 256


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed by peer")
        buf += chunk
    return bytes(buf)


def _discard_exact(sock: socket.socket, n: int) -> None:
    """Consume and drop n payload bytes (a response whose request raced
    teardown) without materializing the frame."""
    while n:
        chunk = sock.recv(min(n, 1 << 16))
        if not chunk:
            raise TransportError("connection closed by peer")
        n -= len(chunk)


def _as_view(buf) -> memoryview:
    """Flat byte view over any contiguous buffer (bytes, bytearray,
    uint8 ndarray, memoryview) — what sendmsg/recv_into consume."""
    v = buf if isinstance(buf, memoryview) else memoryview(buf)
    if v.format != "B" or v.ndim != 1:
        v = v.cast("B")
    return v


def build_read_response_parts(node, payload: bytes, peer) -> Optional[List]:
    """Resolve one OP_READ_REQ into the scatter-gather response parts
    (header + length prefixes + the resolved block VIEWS — registered
    memory is never copied into an intermediate buffer), or the scoped
    error reply.  Returns None when not even a req_id is parseable
    (logged; the channel stays healthy).  Shared by the threaded serve
    path and the async dispatcher's completion-driven one."""
    try:
        req_id, count = _REQ_HDR.unpack_from(payload, 0)
    except Exception:
        logger.warning(
            "malformed read request from %s (%dB)", peer, len(payload),
        )
        return None
    try:
        # the count must agree byte-for-byte with the payload BEFORE it
        # sizes the location loop — a lying count becomes a scoped
        # error reply, not a struct.error mid-parse.  v2 requests may
        # carry the optional trace-context tail after the locations.
        base = _REQ_HDR.size + count * _LOC.size
        if count < 0 or len(payload) not in (base, base + _TRACE_CTX.size):
            raise ValueError(
                f"read request count {count} disagrees with payload "
                f"{len(payload)}B"
            )
        locs = []
        off = _REQ_HDR.size
        for _ in range(count):
            addr, length, mkey = _LOC.unpack_from(payload, off)
            off += _LOC.size
            locs.append(BlockLocation(addr, length, mkey))
        if FAULTS.enabled:
            FAULTS.check("serve_delay")
            FAULTS.check("serve")
        t0 = time.monotonic()
        blocks = node.read_local_blocks(locs)
        if RECORDER.enabled:
            ctx = _req_trace(payload)
            fr_event(
                "transport", "serve_read",
                trace_id=ctx[0] if ctx else 0,
                span_id=ctx[1] if ctx else 0,
                blocks=len(locs),
                us=int((time.monotonic() - t0) * 1e6),
            )
        parts: List = [_RESP_HDR.pack(req_id, 0)]
        for b in blocks:
            v = _as_view(b)
            parts.append(_LEN.pack(v.nbytes))
            parts.append(v)
    except BaseException as e:
        parts = [
            _RESP_HDR.pack(req_id, 1),
            encode_remote_error(e).encode("utf-8", "replace"),
        ]
    return parts


def _req_cost(payload: bytes) -> int:
    """Total requested bytes of one OP_READ_REQ — the serve pool's
    admission cost (credits bound resident serve memory).  Runs on the
    channel reader thread, so a malformed request must cost 0, not
    kill the channel — the serve path answers it with a scoped error
    reply (or logs, when even the req_id is unparseable)."""
    try:
        _req_id, count = _REQ_HDR.unpack_from(payload, 0)
        off = _REQ_HDR.size
        total = 0
        for _ in range(count):
            total += _LOC.unpack_from(payload, off)[1]
            off += _LOC.size
        return total
    except Exception:
        return 0


def _req_trace(payload: bytes) -> Optional[Tuple[int, int]]:
    """The (trace_id, span_id) tail of one OP_READ_REQ, or None — v1
    frames, trace-off requesters, and malformed payloads all land on
    None (the tail is strictly optional on the wire)."""
    try:
        _req_id, count = _REQ_HDR.unpack_from(payload, 0)
        base = _REQ_HDR.size + count * _LOC.size
        if count < 0 or len(payload) != base + _TRACE_CTX.size:
            return None
        tid, sid = _TRACE_CTX.unpack_from(payload, base)
        return (tid, sid) if tid else None
    except Exception:
        return None


def _req_mkey(payload: bytes):
    """First target mkey of one OP_READ_REQ — the serve pool resolves
    the owning QoS tenant from it (every location of one grouped read
    belongs to one shuffle's output, so the first is representative).
    None for malformed/empty requests."""
    try:
        _req_id, count = _REQ_HDR.unpack_from(payload, 0)
        if count <= 0:
            return None
        return _LOC.unpack_from(payload, _REQ_HDR.size)[2]
    except Exception:
        return None


class TcpChannel(Channel):
    """One TCP connection; either endpoint can carry RPC frames, the
    acceptor side additionally serves block reads."""

    supports_scatter = True

    def __init__(self, channel_type: ChannelType, node: Node,
                 peer: Address, sock: socket.socket):
        super().__init__(channel_type, node.conf.send_queue_depth)
        self.node = node
        self.peer = peer
        # resource: tcp.fds (one socket fd per live channel)
        self._sock = sock
        # owns: tcp.fds -> _close_sock
        self._fd_tkt = ledger_acquire("tcp.fds")  # acquires: tcp.fds
        self._sg = (
            node.conf.transport_scatter_gather
            and hasattr(sock, "sendmsg")
        )
        self._send_lock = dbg_lock("tcp.send", 70)
        self._next_req = 1  # guarded-by: _reads_lock
        # req_id -> (count, listener, post time, dest, on_progress)
        self._reads: Dict[int, Tuple] = {}  # guarded-by: _reads_lock
        self._reads_lock = dbg_lock("tcp.reads", 68)
        self._reader: Optional[threading.Thread] = None
        self._m_bytes_sent = counter(
            "transport_bytes_sent_total", transport="tcp")
        self._m_bytes_recv = counter(
            "transport_bytes_received_total", transport="tcp")
        self._m_msgs_sent = counter(
            "transport_msgs_sent_total", transport="tcp")
        self._m_msgs_recv = counter(
            "transport_msgs_received_total", transport="tcp")
        self._m_read_rtt = histogram(
            "transport_read_rtt_ms", transport="tcp")
        self._m_fail_outstanding = counter(
            "transport_fail_outstanding_total", transport="tcp")
        self._m_sendmsg_bytes = counter(
            "transport_sendmsg_bytes_total", transport="tcp")
        self._m_sendall_bytes = counter(
            "transport_sendall_bytes_total", transport="tcp")

    # -- lifecycle ----------------------------------------------------------
    def start_reader(self) -> None:
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"tcp-{self.peer[0]}:{self.peer[1]}",
        )
        self._reader.start()

    def _close_sock(self) -> None:
        """Settle this channel's fd exactly once — ``stop()`` and the
        reader loop's peer-close path can both get here (the socket
        object makes the second ``close()`` harmless; the ledger ticket
        must still settle once, under the reads lock)."""
        with self._reads_lock:
            tkt, self._fd_tkt = self._fd_tkt, NOOP_TICKET
        tkt.release()  # releases: tcp.fds  # one-shot
        try:
            self._sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._close_sock()
        err = TransportError("channel stopped")
        with self._reads_lock:
            reads = list(self._reads.values())
            self._reads.clear()
        for entry in reads:
            self._safe_fail(entry[1], err)
        super().stop()

    # -- sending ------------------------------------------------------------
    def _send_msg(self, opcode: int, parts) -> None:
        """Send one frame as a scatter-gather iovec — header, length
        prefixes and block views go to the socket WITHOUT being
        concatenated into an intermediate buffer (``parts`` is a
        sequence of buffer-likes).  ``transportScatterGather=off``
        falls back to the legacy concat+sendall wire path."""
        if FAULTS.enabled:
            FAULTS.check("send")
        views = [v for v in map(_as_view, parts) if v.nbytes]
        length = sum(v.nbytes for v in views)
        hdr = _HDR.pack(opcode, length)
        # blocking socket writes under _send_lock are THE POINT here:
        # this per-channel mutex serializes whole frames onto the wire
        # (interleaved sendmsg calls would shear frames).  It ranks
        # last among the TRANSPORT locks (70) so no transport lock can
        # be requested while a send is in flight (the 80+ ranks above
        # it are memory/metrics leaves).
        with self._send_lock:
            if self._sg:
                self._sendmsg_all([memoryview(hdr)] + views)  # noqa: CK02
            else:
                self._send_concat(hdr, views)  # noqa: CK02
        self._m_msgs_sent.inc()
        self._m_bytes_sent.inc(_HDR.size + length)

    def _sendmsg_all(self, views: List[memoryview]) -> None:
        """writev the iovec list, advancing across partial sends."""
        i = 0
        while i < len(views):
            n = self._sock.sendmsg(views[i:i + _IOV_MAX])
            if n <= 0:
                raise TransportError("sendmsg made no progress")
            self._m_sendmsg_bytes.inc(n)
            while n and i < len(views):
                v = views[i]
                if n >= v.nbytes:
                    n -= v.nbytes
                    i += 1
                else:
                    views[i] = v[n:]
                    n = 0

    def _send_concat(self, hdr: bytes, views: List[memoryview]) -> None:
        # pre-scatter-gather wire path (one concatenation copy +
        # sendall), kept behind transportScatterGather=off for A/B
        # measurement and exotic sockets without sendmsg
        payload = bytearray(hdr)
        for v in views:
            payload += v
        self._sock.sendall(payload)
        self._m_sendall_bytes.inc(len(payload))

    def _post_rpc(self, frames: List[bytes], listener: CompletionListener) -> None:
        def run():
            try:
                for frame in frames:
                    self._send_msg(OP_RPC, (frame,))
            except BaseException as e:
                self._error(e)
                self._fail(listener, e)
            else:
                self._complete(listener, None)
            finally:
                self._release_budget()

        self.node.submit(run)

    def _post_read(self, locations: List[BlockLocation],
                   listener: CompletionListener,
                   dest=None, on_progress=None, ctx=None) -> None:
        with self._reads_lock:
            req_id = self._next_req
            self._next_req += 1
            self._reads[req_id] = (
                len(locations), listener, time.monotonic(), dest,
                on_progress,
            )
        payload = bytearray(_REQ_HDR.pack(req_id, len(locations)))
        for loc in locations:
            payload += _LOC.pack(loc.address, loc.length, loc.mkey)
        if ctx is not None and self.wire_version != 1:
            # optional v2 tail; suppressed on channels negotiated down
            payload += _TRACE_CTX.pack(ctx[0], ctx[1])

        def run():
            try:
                self._send_msg(OP_READ_REQ, (payload,))
                if ctx is not None and RECORDER.enabled:
                    fr_event(
                        "transport", "wire_send",
                        trace_id=ctx[0], span_id=ctx[1],
                        locs=len(locations),
                    )
            except BaseException as e:
                with self._reads_lock:
                    self._reads.pop(req_id, None)
                self._error(e)
                self._fail(listener, e)
                self._release_budget()
            # budget released when the response (or teardown) arrives

        self.node.submit(run)

    # -- receiving ----------------------------------------------------------
    def _read_loop(self) -> None:
        g = gauge("transport_threads", role="tcp_reader")
        g.inc()
        try:
            while True:
                opcode, length = _HDR.unpack(_recv_exact(self._sock, _HDR.size))
                if FAULTS.enabled:
                    # a recv fault models a desynced/cut stream: the
                    # channel dies, outstanding reads fail structured
                    FAULTS.check("recv")
                if length > _MAX_FRAME:
                    raise TransportError(f"oversized frame: {length}B")
                if wiredbg.wire_debug_enabled():
                    herr = wiredbg.header_error("tcp", opcode, length)
                    if herr is not None:
                        raise TransportError(f"wireDebug: {herr}")
                self._m_msgs_recv.inc()
                self._m_bytes_recv.inc(_HDR.size + length)
                if opcode == OP_READ_RESP:
                    # structured scatter receive: the frame is never
                    # materialized whole — blocks land in registered
                    # dest buffers (striped reassembly) or ONE pooled
                    # buffer (BufferReleasingInputStream analog via
                    # alloc_gc)
                    self._recv_read_resp(length)
                    continue
                payload = _recv_exact(self._sock, length) if length else b""
                if opcode == OP_RPC:
                    if (wiredbg.wire_debug_enabled()
                            and not wiredbg.rpc_frame_ok("tcp", payload)):
                        continue  # counted + logged; ONE frame dropped
                    self.node.dispatch_frame(self, payload)
                elif opcode == OP_READ_REQ:
                    # serve OFF the reader thread: one large read must
                    # not head-of-line-block further frames on this
                    # channel (the reference's CQ model has no such
                    # serialization — the NIC serves reads).  The serve
                    # pool, not the dispatcher: multi-MB serves must
                    # never starve heartbeat/RPC dispatch, and its
                    # byte credits bound resident serve memory
                    self.node.submit_serve(
                        self._serve_read, (payload, time.monotonic()),
                        _req_cost(payload), mkey=_req_mkey(payload),
                    )
                else:
                    # an unknown opcode means the byte stream is
                    # desynced — the CHANNEL must die (there is no way
                    # to find the next frame boundary), but it is
                    # counted and scoped: outstanding reads fail with
                    # a structured error and the node stays up
                    counter(
                        "wire_unknown_frames_total",
                        engine="tcp", kind="opcode",
                    ).inc()
                    raise TransportError(f"unknown opcode {opcode}")
        except BaseException as e:
            if self.state not in (ChannelState.STOPPED,):
                self._error(e)
                self._fail_outstanding(e)
                # a peer-initiated close (e.g. the requester evicting
                # its end) must not leak THIS end's fd until node
                # teardown: the reader thread is the socket's only
                # consumer, so it owns the close on its way out
                self._close_sock()
            # and a dead channel must not pin cache slots, the passive
            # list, or a stale read group for the node's lifetime
            self.node.on_channel_dead(self)
        finally:
            g.dec()

    def _recv_read_resp(self, length: int) -> None:
        """Receive one read response.  Striped reads (``dest`` buffers
        registered at post time) scatter straight into their
        destination row via ``recv_into`` — reassembly happens in the
        kernel copy, with no intermediate frame buffer; plain reads
        land in one pooled buffer and complete as zero-copy slices."""
        if FAULTS.enabled:
            FAULTS.check("read_resp")
        if length < _RESP_HDR.size:
            raise TransportError(f"short read response: {length}B")
        req_id, status = _RESP_HDR.unpack(
            _recv_exact(self._sock, _RESP_HDR.size)
        )
        body = length - _RESP_HDR.size
        with self._reads_lock:
            entry = self._reads.pop(req_id, None)
        if entry is None:
            _discard_exact(self._sock, body)  # raced with teardown
            return
        count, listener, t0, dest, on_progress = entry
        # the entry left _reads above, so _fail_outstanding no longer
        # covers it: ANY failure while the body is still on the wire
        # must fail this listener HERE, then re-raise so the read loop
        # tears the (now desynced) channel down
        try:
            if status != 0:
                reason = _recv_exact(self._sock, body).decode(
                    "utf-8", "replace"
                )
                err: BaseException = decode_remote_error(reason)
            elif dest is None:
                payload = self._recv_payload(body)
                blocks, off, err = [], 0, None
                for _ in range(count):
                    (n,) = _LEN.unpack_from(payload, off)
                    off += _LEN.size
                    if n > len(payload) - off:
                        # a lying length prefix must fail loudly, not
                        # silently truncate the block (bounds
                        # discipline: every wire length is checked
                        # against the bytes actually received)
                        raise TransportError(
                            f"block length {n}B exceeds response "
                            f"remainder {len(payload) - off}B"
                        )
                    blocks.append(payload[off: off + n])
                    off += n
                    if on_progress is not None:
                        self._safe_progress(on_progress, n)
            else:
                blocks, err, remaining = [], None, body
                for i in range(count):
                    if remaining < _LEN.size:
                        raise TransportError(
                            f"short read response: {remaining}B left "
                            f"before block {i} of {count}"
                        )
                    (n,) = _LEN.unpack(_recv_exact(self._sock, _LEN.size))
                    remaining -= _LEN.size
                    if n > remaining:
                        # without this check a lying prefix would read
                        # INTO the next frame's bytes (or hang waiting
                        # for bytes that never come) — the frame's
                        # declared length is the hard bound
                        raise TransportError(
                            f"block length {n}B exceeds response "
                            f"remainder {remaining}B"
                        )
                    remaining -= n
                    d = dest[i] if i < len(dest) else None
                    if d is None:
                        blocks.append(self._recv_payload(n))
                    else:
                        view = _as_view(d)
                        if view.nbytes != n:
                            raise TransportError(
                                f"stripe length mismatch: {n}B payload "
                                f"for {view.nbytes}B dest buffer"
                            )
                        self._recv_into(view)
                        blocks.append(d)
                    if on_progress is not None:
                        self._safe_progress(on_progress, n)
        except BaseException as e:
            self._fail(listener, e)
            self._release_budget()
            raise
        # RTT covers the WHOLE transfer including the body (the
        # loopback series measures through data landing — keep the
        # tcp/loopback series comparable)
        self._m_read_rtt.observe((time.monotonic() - t0) * 1000.0)
        if err is not None:
            self._fail(listener, err)
        else:
            self._complete(listener, blocks)
        self._release_budget()

    @staticmethod
    def _safe_progress(on_progress, n: int) -> None:
        try:
            on_progress(n)
        except BaseException:
            logger.exception("read progress callback raised")

    def _recv_into(self, view: memoryview) -> None:
        got, n = 0, view.nbytes
        while got < n:
            r = self._sock.recv_into(view[got:], n - got)
            if r == 0:
                raise TransportError("connection closed by peer")
            got += r

    def _recv_payload(self, length: int):
        """Receive a bulk payload, preferring a pooled staging buffer
        (zero-copy slices for the consumer, pool reuse on release)."""
        pool = getattr(self.node, "staging_pool", None)
        if pool is not None and length > 0:
            try:
                arr = pool.alloc_gc(length)
            except MemoryError:
                arr = None
            if arr is not None:
                self._recv_into(memoryview(arr)[:length])
                out = arr[:length]
                out.flags.writeable = False
                return out
        return _recv_exact(self._sock, length) if length else b""

    def _fail_outstanding(self, err: BaseException) -> None:
        with self._reads_lock:
            reads = list(self._reads.values())
            self._reads.clear()
        self._m_fail_outstanding.inc()
        for entry in reads:
            self._fail(entry[1], err)
            self._release_budget()

    def _serve_read(self, payload: bytes, t_enq=None) -> None:
        """The one-sided READ service: runs on the node's bounded serve
        pool (posted by the reader loop) against the registered block
        stores — never via the application receive listener, and never
        on the reader thread itself (a large serve must not
        head-of-line-block the channel).  The response goes out as one
        scatter-gather frame of header + length prefixes + the
        resolved block VIEWS — registered memory is never copied into
        an intermediate response buffer."""
        ctx = None
        if RECORDER.enabled:
            # t_enq → now spans the serve queue AND credit wait (the
            # pool admits, then runs this on a worker)
            ctx = _req_trace(payload)
            fr_event(
                "transport", "serve_admit",
                trace_id=ctx[0] if ctx else 0,
                span_id=ctx[1] if ctx else 0,
                wait_us=0 if t_enq is None
                else int((time.monotonic() - t_enq) * 1e6),
                bytes=_req_cost(payload),
            )
        parts = build_read_response_parts(self.node, payload, self.peer)
        if parts is None:
            # not even a req_id to scope an error reply to — dropped
            # (logged); the channel itself stays healthy
            return
        try:
            t0 = time.monotonic()
            self._send_msg(OP_READ_RESP, parts)
            if ctx is not None and RECORDER.enabled:
                fr_event(
                    "transport", "serve_send",
                    trace_id=ctx[0], span_id=ctx[1],
                    us=int((time.monotonic() - t0) * 1e6),
                )
        except BaseException:
            # a response the requester will never see — and possibly a
            # half-written frame desyncing the byte stream.  The
            # channel must die (the wire blast-radius contract): the
            # peer's read loop sees the cut and fails its outstanding
            # reads promptly, which is exactly the signal the in-task
            # retry plane recovers from.  Swallowing this would strand
            # the requester's fetch forever on a healthy-looking
            # socket.
            logger.warning(
                "read response to %s failed — closing channel", self.peer
            )
            self.stop()

    def reply_channel(self) -> Channel:
        """Replies ride the same socket."""
        return self


class TcpNetwork:
    """Listener + connector over real sockets (one instance per process).

    ``transportAsyncDispatcher`` (per NODE, default on) decides which
    engine a node's sockets run on: the completion-driven selector loop
    (transport/dispatcher.py — the listener and every channel ride one
    event-loop thread) or the legacy thread-per-channel blocking path.
    The wire format is identical, so mixed-mode deployments
    interoperate."""

    def __init__(self, listen_backlog: int = 128):
        self.listen_backlog = listen_backlog
        # addr -> (server socket, accept thread | Acceptor | None, node)
        self._listeners: Dict[
            Address, Tuple[socket.socket, object, Node]
        ] = {}  # guarded-by: _lock
        self._lock = dbg_lock("tcp.network", 57)

    # -- membership ---------------------------------------------------------
    def register(self, node: Node) -> None:
        host, port = node.address
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host, port))
        except OSError as e:
            srv.close()
            raise TransportError(f"bind failed at {host}:{port}: {e}") from e
        srv.listen(self.listen_backlog)
        if node.conf.transport_async_dispatcher:
            # the listener rides the node's event loop — no accept thread
            from sparkrdma_tpu_torch.transport.dispatcher import Acceptor

            srv.setblocking(False)
            try:
                disp = node.get_dispatcher()
                acc = Acceptor(disp, node, srv)
                disp.post(acc.loop_register)
            except TransportError:
                srv.close()
                raise
            with self._lock:
                self._listeners[node.address] = (srv, acc, node)
            return
        t = threading.Thread(
            target=self._accept_loop, args=(srv, node), daemon=True,
            name=f"tcp-accept-{host}:{port}",
        )
        with self._lock:
            self._listeners[node.address] = (srv, t, node)
        t.start()

    def unregister(self, node: Node) -> None:
        with self._lock:
            entry = self._listeners.pop(node.address, None)
        if entry is not None:
            srv, owner, _n = entry
            close_fn = getattr(owner, "request_close", None)
            if close_fn is not None:
                # async acceptor: the LOOP must unregister before the
                # fd closes (a direct close here could let a reused fd
                # number collide with the stale selector key)
                close_fn()
                return
            try:
                # wake the accept thread first: a close() alone leaves
                # the socket listening (the port bound) for as long as
                # that thread sits in accept()
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass

    # -- acceptor (the CM listener thread analog; threaded mode only) -------
    def _accept_loop(self, srv: socket.socket, node: Node) -> None:
        g = gauge("transport_threads", role="accept")
        g.inc()
        try:
            self._accept_forever(srv, node)
        finally:
            g.dec()

    def _accept_forever(self, srv: socket.socket, node: Node) -> None:
        while True:
            try:
                sock, addr = srv.accept()
            except OSError as e:
                if srv.fileno() == -1 or e.errno in (
                    errno.EBADF, errno.EINVAL, errno.ENOTSOCK
                ):
                    return  # listener closed
                # transient: ECONNABORTED (peer reset before accept)
                # or fd/buffer pressure — exiting here would orphan
                # the still-open listener and strand every future
                # connect in its backlog.  Back off briefly so fd
                # exhaustion does not become a hot spin.
                counter("transport_accept_transient_errors_total").inc()
                time.sleep(0.01)
                continue
            try:
                magic, type_idx, src_port, version = _HELLO.unpack(
                    _recv_exact(sock, _HELLO.size)
                )
                if magic != _MAGIC or type_idx >= len(_TYPE_BY_INDEX):
                    raise TransportError(f"bad hello from {addr}")
                if not (MIN_WIRE_VERSION <= version <= WIRE_VERSION):
                    # structured rejection: NAK byte + both versions,
                    # so the connector's error can name them (old
                    # pre-versioning hellos carry 0 here)
                    sock.sendall(  # noqa: PY10 - 5B one-shot handshake NAK
                        b"\x00" + _HELLO_REJ.pack(WIRE_VERSION, version)
                    )
                    counter("wire_version_rejects_total").inc()
                    raise TransportError(
                        f"protocol version mismatch from {addr}: hello "
                        f"spoke wire version {version}, this node "
                        f"accepts {MIN_WIRE_VERSION}..{WIRE_VERSION}"
                    )
                req_type = _TYPE_BY_INDEX[type_idx]
                sock.sendall(b"\x01")  # ack (ESTABLISHED)
            except BaseException:
                logger.warning("handshake with %s failed", addr, exc_info=True)
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = (addr[0], src_port)
            ch = TcpChannel(_PAIRED.get(req_type, req_type), node, peer, sock)
            ch.wire_version = version  # the hello's (accepted) generation
            ch._set_state(ChannelState.CONNECTED)
            node.register_passive_channel(ch)
            ch.start_reader()

    # -- connector (passed to Node.get_channel) -----------------------------
    def connect(self, src: Node, peer: Address,
                channel_type: ChannelType) -> Channel:
        timeout_s = src.conf.connect_timeout_ms / 1000.0
        counter("transport_connect_attempts_total", transport="tcp").inc()
        if FAULTS.enabled:
            FAULTS.check("connect")
        ver = WIRE_VERSION
        try:
            while True:
                sock = socket.create_connection(peer, timeout=timeout_s)
                sock.settimeout(timeout_s)
                if FAULTS.enabled and FAULTS.fires("hello"):
                    # a handshake fault dies between socket and ack —
                    # the half-open socket closes via the OSError path
                    sock.close()
                    raise OSError("injected fault at point 'hello'")
                sock.sendall(_HELLO.pack(
                    _MAGIC, _TYPE_BY_INDEX.index(channel_type),
                    src.address[1], ver,
                ))
                ack = _recv_exact(sock, 1)
                if ack == b"\x01":
                    break
                detail = ""
                if ack == b"\x00":
                    # structured version rejection carries both sides
                    try:
                        srv_ver, cli_ver = _HELLO_REJ.unpack(
                            _recv_exact(sock, _HELLO_REJ.size)
                        )
                    except TransportError:
                        srv_ver = None
                    else:
                        detail = (
                            f": peer requires wire version {srv_ver}, "
                            f"this hello spoke {cli_ver}"
                        )
                    if (srv_ver is not None
                            and MIN_WIRE_VERSION <= srv_ver < ver):
                        # negotiated fallback: the acceptor closed its
                        # end after the NAK, so re-dial speaking ITS
                        # generation; the channel remembers it so
                        # v2-only bytes (trace tails/fields) stay off
                        # this connection
                        try:
                            sock.close()
                        except OSError:
                            pass
                        ver = srv_ver
                        counter(
                            "wire_version_downgrades_total",
                            transport="tcp",
                        ).inc()
                        fr_event(
                            "transport", "version_downgrade",
                            peer=f"{peer[0]}:{peer[1]}", to=ver,
                        )
                        continue
                raise TransportError(
                    f"handshake rejected by {peer}{detail}"
                )
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except socket.timeout as e:
            counter(
                "transport_connect_timeouts_total", transport="tcp"
            ).inc()
            raise TransportError(f"connect to {peer} timed out: {e}") from e
        except OSError as e:
            counter(
                "transport_connect_failures_total", transport="tcp"
            ).inc()
            raise TransportError(f"connect to {peer} failed: {e}") from e
        if src.conf.transport_async_dispatcher:
            from sparkrdma_tpu_torch.transport.dispatcher import AsyncTcpChannel

            ch = AsyncTcpChannel.attach(channel_type, src, peer, sock)
            ch.wire_version = ver
            return ch
        ch = TcpChannel(channel_type, src, peer, sock)
        ch.wire_version = ver
        ch._set_state(ChannelState.CONNECTED)
        ch.start_reader()
        return ch
