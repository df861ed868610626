"""Async completion-driven transport core: one selector loop per node.

The thread-per-lane TCP plane (transport/tcp.py) costs one blocking
reader thread per channel — O(peers × stripes) threads per node at
production fan-out, plus the accept thread.  This module replaces that
with the submission-queue / completion-queue idiom of fabric-lib and
RAMC (PAPERS.md): post work as descriptors, reap batched completions
from a single progress engine.

- :class:`Dispatcher` — ONE event-loop thread per node owning every
  transport socket in non-blocking mode via ``selectors``.  Work
  arrives on a **submission queue** (descriptors posted from any
  thread; a wakeup pipe interrupts ``select``), progress happens as
  partial ``sendmsg``/``recv_into`` continuations, and results leave
  through a **completion queue**: per-iteration batches of completion
  events handed to the node's completion executor — the CQ-poller →
  RdmaThread split of the reference, with the loop playing the NIC/CQ
  and the executor playing the completion-listener threads.
- :class:`AsyncTcpChannel` — ``TcpChannel``'s send/recv state machines
  ported onto the loop: frames go out as iovec descriptors with
  per-channel write backpressure (a channel whose response backlog
  exceeds ``transportSendBacklogBytes`` stops being READ until it
  drains), and read responses scatter into their registered
  destination buffers exactly like the threaded path — striped
  reassembly (``on_progress``) and the decode-pool submissions feed
  straight off completion events.
- :class:`Acceptor` / :class:`_Handshake` — the listening socket rides
  the same loop (no accept thread); the 9-byte hello is parsed as a
  non-blocking continuation.

Wire format is byte-identical to transport/tcp.py — an async client
interoperates with a threaded server and vice versa; the threaded path
stays available behind ``transportAsyncDispatcher=off`` for A/B and
bit-exactness.

Two mechanisms adapt the engine to load.  LANE STREAMING
(``transportStreamOffloadBytes``, see ``_rx_maybe_offload``): a bulk
channel with enough response bytes outstanding hands its whole recv
machine to a completion-pool worker doing blocking ``recv`` with
inline completion delivery — the threaded reader's exact
syscall-and-delivery shape, paid only while the lane is busy (one
handoff per burst; a bounded number of lanes at a time).  The
SPIN-POLL (``transportPollSpinUs``): after an iteration that did real
work the loop can busy-poll the selector before re-arming the
blocking ``select``, reaping back-to-back completions at syscall cost
(the CQ busy-poll of the reference designs — a multi-core luxury,
default off on single-core hosts where the spin steals the core the
peer needs).  One-sided READ serving keeps the bounded serve pool
(node.py): block resolution may fault on mapped files, which must
never stall the loop.
A serve worker resolves the blocks, posts the response descriptor, and
returns — its byte credits are released by the send-completion event,
not by a worker blocking in ``sendall`` (``_ServePool`` deferred
release), so credits still bound resident serve memory while workers
stay free.

Discipline: methods marked ``# on-loop`` run on the event-loop thread
and must never block — tools/concheck.py CK05 enforces it (the CK02
blocking-call analysis re-aimed at the loop's callback plane).
"""

from __future__ import annotations

import errno
import logging
import os
import select
import selectors
import socket
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

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
)
from sparkrdma_tpu_torch.transport import tcp as wire
from sparkrdma_tpu_torch.utils import wiredbg
from sparkrdma_tpu_torch.utils.dbglock import dbg_lock
from sparkrdma_tpu_torch.utils.ledger import NOOP_TICKET, ledger_acquire
from sparkrdma_tpu_torch.utils.statemachine import (
    GLOBAL_STATE_DEBUG,
    StateMachine,
    check_named,
)
from sparkrdma_tpu_torch.utils.types import BlockLocation

logger = logging.getLogger(__name__)

#: iovec batch per sendmsg call (mirrors transport/tcp.py)
_IOV_MAX = wire._IOV_MAX

_SCRATCH = 1 << 16  # discard-path receive chunk

# fairness budget: max bytes one channel may move per readiness
# callback before yielding the loop back to the selector — bounds the
# worst-case iteration so no handler monopolizes the loop (the
# selector is level-triggered, so the remainder re-reports
# immediately).
_FAIR_BUDGET = 2 << 20

# priority-poll cadence: bulk-class channels re-poll the selector for
# LATENCY-class events (RPC channels, accepts, handshakes) after this
# many bytes of recv/send work, servicing them inline — the loop's
# analog of the dedicated small-read lane: a multi-MiB stream in
# flight adds at most ~this many bytes of latency to an RPC pong,
# instead of a whole transfer: a balance between per-chunk Python
# overhead and pong queueing.
_POLL_BYTES = 256 << 10

# lane streaming (conf transportStreamOffloadBytes): a bulk channel
# with at least that many response bytes outstanding streams its recv
# machine on a completion-pool worker (blocking recv + inline
# delivery) until idle — at most _OFFLOAD_WORKERS lanes at a time so
# completion delivery can never starve; further busy lanes land
# on-loop.  Per-BODY offloading was A/B'd first and lost ~8% striped
# throughput to its per-body round trips (unregister, pool handoff,
# resume post); per-BURST streaming amortizes the handoff to noise.
# 3 of the completion pool's 4 threads may hold streams at once — one
# slot always stays free for loop-side completion batches (a typical
# client needs 3: two data lanes + one hot RPC channel)
_OFFLOAD_WORKERS = 3
_OFFLOAD_TIMEOUT = 0.2  # blocking-recv tick; worker rechecks _closed
# idle-exit grace: a streaming worker with nothing outstanding and
# nothing sending waits this long for a follow-on frame before handing
# the fd back to the loop — request bursts have sub-ms gaps, and a
# handoff round trip costs more than the wait
_STREAM_GRACE = 0.002
# hot-channel trigger: two frames closer together than this = a
# conversation in progress (an RPC ping stream, a request burst) —
# stream the channel so every later frame lands on a blocked reader
# at kernel-wake cost instead of epoll + loop machinery
_HOT_FRAME_S = 0.001

#: channel roles whose traffic is latency-class (control plane)
_LATENCY_TYPES = frozenset((
    ChannelType.RPC_REQUESTOR,
    ChannelType.RPC_RESPONDER,
    ChannelType.RPC_WRAPPER,
))


_RMEM_MAX_FALLBACK = 6 << 20  # Linux tcp_rmem[2] default ballpark


def _rmem_max() -> int:
    """Autotune growth ceiling of the TCP receive buffer — the bound
    for RCVLOWAT watermarks on autotuned sockets."""
    try:
        with open("/proc/sys/net/ipv4/tcp_rmem") as f:
            return int(f.read().split()[2])
    except (OSError, ValueError, IndexError):
        return _RMEM_MAX_FALLBACK


def _safe(fn, *args) -> None:
    """Run one completion callback, never letting it kill the batch."""
    try:
        fn(*args)
    except BaseException:
        logger.exception("completion callback raised")


def _run_batch(batch: List[Tuple]) -> None:
    """Drain one completion batch in order on the completion executor."""
    for fn, args in batch:
        _safe(fn, *args)


class _SendOp(StateMachine):
    """One outbound frame descriptor: iovec views + a cursor advanced
    across partial sends, completed (on the completion queue) when the
    whole frame has been handed to the kernel.  Lifecycle: ``new`` until
    it enters a channel's tx queue, then ``sent`` (fully written) or
    ``failed`` (queue swept by teardown / rejected by a closed
    channel)."""

    __slots__ = ("views", "i", "total", "frames", "on_done", "tkt",
                 "_state")

    MACHINE = "dispatcher.sendop"
    STATES = ("new", "queued", "sent", "failed")
    INITIAL = "new"
    TERMINAL = ("sent", "failed")
    TRANSITIONS = {
        "new": ("queued", "failed"),
        "queued": ("sent", "failed"),
    }

    def __init__(self, views: List[memoryview], total: int, frames: int,
                 on_done=None):
        self.views = views
        self.i = 0
        self.total = total          # wire bytes incl. headers
        self.frames = frames        # logical frames in this descriptor
        self.on_done = on_done      # callable(err-or-None) | None
        self.tkt = NOOP_TICKET      # ledger ticket, set when queued
        self._state = "new"  # state: dispatcher.sendop guarded-by: AsyncTcpChannel._tx_lock  # noqa: PY02

    def advance(self, n: int) -> None:
        while n and self.i < len(self.views):
            v = self.views[self.i]
            if n >= v.nbytes:
                n -= v.nbytes
                self.i += 1
            else:
                self.views[self.i] = v[n:]
                n = 0

    @property
    def done(self) -> bool:
        return self.i >= len(self.views)


class Dispatcher:
    """One event-loop thread per node: selector + submission queue +
    completion queue (the progress engine)."""

    def __init__(self, name: str, conf, exec_submit, pin_fn=None):
        self.name = name
        self.conf = conf
        self._exec_submit = exec_submit  # node.submit — completion executor
        self._pin_fn = pin_fn
        self._sel = selectors.DefaultSelector()
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        self._wake_r, self._wake_w = r, w
        self._sel.register(r, selectors.EVENT_READ, None)
        self._subs: Deque[Tuple] = deque()  # guarded-by: _subs_lock
        self._stopping = False  # guarded-by: _subs_lock
        # True from just before the submission drain until select
        # returns: a post() in that window MUST write the wakeup pipe
        # (the loop may be blocked in select); outside it the loop is
        # busy and will drain at the top of its next iteration — the
        # pipe syscalls are skipped (hot-path posts get cheap)
        self._armed = False  # guarded-by: _subs_lock
        self._subs_lock = dbg_lock("disp.subs", 72)
        self._comp_batch: List[Tuple] = []  # loop-thread only
        self._polling = False  # loop-thread only (nested-poll guard)
        # registered latency-class handlers (RPC channels, acceptors,
        # handshakes).  While zero, bulk channels skip the poll cadence
        # and run full-size GIL-free recv calls — chunking only costs
        # when there is actually control traffic to protect
        self._latency_handlers = 0  # loop-thread only
        # bounds concurrent big-body landing offloads onto the node's
        # completion pool (semaphore: no rank — never held across a
        # blocking call; try-acquire on the loop, released by workers)
        self.offload_sem = threading.Semaphore(_OFFLOAD_WORKERS)
        # adaptive busy-poll (the poll-mode progress engine): after an
        # iteration that did real work the loop re-polls the selector
        # non-blocking for this long before re-arming the blocking
        # select — back-to-back events (an RPC pong chased by the next
        # ping, successive bulk chunks draining a stripe) are serviced
        # at syscall cost with no sleep/wake transition on either side
        self._spin_s = conf.transport_poll_spin_us / 1e6
        self._m_loop_us = histogram("transport_dispatcher_loop_us")
        self._m_polls = counter("transport_dispatcher_latency_polls_total")
        self._m_sub_depth = gauge("transport_dispatcher_submission_depth")
        self._m_comp_depth = gauge("transport_dispatcher_completion_depth")
        self._m_submissions = counter(
            "transport_dispatcher_submissions_total")
        self._m_completions = counter(
            "transport_dispatcher_completions_total")
        self._m_batches = counter(
            "transport_dispatcher_completion_batches_total")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"disp-{name}",
        )
        self._thread.start()

    # -- submission side (any thread) ---------------------------------------
    def post(self, fn, *args) -> None:
        """Post one descriptor/action to the loop.  Never blocks; raises
        TransportError once the dispatcher is stopping."""
        with self._subs_lock:
            if self._stopping:
                raise TransportError(f"dispatcher {self.name} stopped")
            self._subs.append((fn, args))
            depth = len(self._subs)
            need_wake = self._armed
        self._m_submissions.inc()
        self._m_sub_depth.set(depth)
        if need_wake:
            self._wake()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except (BlockingIOError, InterruptedError):
            pass  # pipe full — a wakeup is already pending
        except OSError:
            pass  # torn down under us

    def stop(self) -> None:
        """Stop the loop: every registered handler is closed and every
        queued descriptor fails.  Idempotent; joins the loop thread."""
        with self._subs_lock:
            self._stopping = True
        self._wake()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    # -- completion side (loop thread) --------------------------------------
    def complete(self, fn, *args) -> None:  # on-loop
        """Queue one completion event; the batch is dispatched to the
        completion executor at the end of the loop iteration."""
        self._comp_batch.append((fn, args))

    def _flush_completions(self) -> None:  # on-loop
        batch, self._comp_batch = self._comp_batch, []
        if not batch:
            return
        self._m_completions.inc(len(batch))
        self._m_batches.inc()
        self._m_comp_depth.set(len(batch))
        try:
            self._exec_submit(_run_batch, batch)
        except BaseException:
            # completion executor gone (node teardown): deliver inline
            # so failure listeners still fire
            _run_batch(batch)

    def poll_latency(self) -> None:  # on-loop
        """Priority poll, called by BULK-class handlers between I/O
        chunks: drain pending submissions and service LATENCY-class
        socket events (RPC frames, accepts, handshakes) inline, then
        flush their completions — so control traffic preempts a
        multi-MiB transfer mid-stream instead of queueing behind it
        (the channel-specialization split, enforced inside the loop)."""
        if self._polling:
            return  # no recursive nesting
        self._polling = True
        self._m_polls.inc()
        try:
            self._drain_submissions()
            for key, mask in self._sel.select(0):
                handler = key.data
                if handler is None or not getattr(
                        handler, "latency_class", False):
                    continue
                try:
                    if mask & selectors.EVENT_READ:
                        handler.on_readable()
                    if mask & selectors.EVENT_WRITE:
                        handler.on_writable()
                except BaseException:
                    logger.exception("transport handler raised")
                    _safe(handler.loop_close,
                          TransportError("handler raised"))
            self._flush_completions()
        finally:
            self._polling = False

    def latency_active(self) -> bool:  # on-loop
        return self._latency_handlers > 0

    # -- selector plumbing (loop thread) ------------------------------------
    @staticmethod
    def _is_latency(handler) -> bool:
        # only RPC CHANNELS force the bulk planes into chunk+poll mode
        # — acceptors/handshakes are still SERVICED by polls, but a
        # mere listener must not tax bulk throughput on an idle node
        return bool(getattr(handler, "latency_counts", False))

    def sel_register(self, sock, events: int, handler) -> None:  # on-loop
        self._sel.register(sock, events, handler)
        if self._is_latency(handler):
            self._latency_handlers += 1

    def sel_modify(self, sock, events: int, handler) -> None:  # on-loop
        try:
            old = self._sel.get_key(sock).data
        except (KeyError, ValueError):
            old = None
        self._sel.modify(sock, events, handler)
        if old is not handler:
            if self._is_latency(old):
                self._latency_handlers -= 1
            if self._is_latency(handler):
                self._latency_handlers += 1

    def sel_unregister(self, sock) -> None:  # on-loop
        try:
            key = self._sel.get_key(sock)
        except (KeyError, ValueError, OSError):
            return
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            return
        if self._is_latency(key.data):
            self._latency_handlers -= 1

    # -- the loop ------------------------------------------------------------
    def _drain_wake(self) -> None:  # on-loop
        try:
            while os.read(self._wake_r, 4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _drain_submissions(self) -> bool:  # on-loop
        # lock-free empty peek: a post racing past it is drained at the
        # top of the next iteration (same guarantee as the armed-pipe
        # contract), and the hot no-work path pays no lock
        if not self._subs and not self._stopping:  # noqa: CK03 - racy peek
            return False
        with self._subs_lock:
            subs, stop = None, self._stopping
            if self._subs:
                subs = list(self._subs)
                self._subs.clear()
        if subs:
            self._m_sub_depth.set(0)
            for fn, args in subs:
                try:
                    fn(*args)
                except BaseException:
                    logger.exception("submission raised on dispatcher loop")
        return stop

    def _run(self) -> None:
        if self._pin_fn is not None:
            self._pin_fn()
        g = gauge("transport_threads", role="dispatcher_loop")
        g.inc()
        spin_deadline = 0.0
        try:
            while True:
                with self._subs_lock:
                    pending = bool(self._subs) or self._stopping
                    # posts landed while we were busy (no wakeup
                    # written) poll instead of blocking so they drain
                    # immediately; inside the spin window we also poll
                    # (busy-wait for the next completion, no sleep) —
                    # in both cases posters may skip the wakeup pipe
                    poll = pending or (
                        self._spin_s > 0.0
                        and time.monotonic() < spin_deadline
                    )
                    self._armed = not poll
                events = self._sel.select(0 if poll else None)
                # disarm + drain in ONE lock round trip (the wake path
                # is latency-critical: every saved acquisition is RTT)
                with self._subs_lock:
                    self._armed = False
                    stop = self._stopping
                    subs = None
                    if self._subs:
                        subs = list(self._subs)
                        self._subs.clear()
                if poll and not pending and not events and not subs \
                        and not stop:
                    continue  # empty spin poll: burn-and-retry
                t0 = time.monotonic()
                if subs:
                    self._m_sub_depth.set(0)
                    for fn, args in subs:
                        try:
                            fn(*args)
                        except BaseException:
                            logger.exception(
                                "submission raised on dispatcher loop")
                self._flush_completions()
                if len(events) > 1:
                    # interactive-before-bulk within one event batch
                    # (the qos/ scheduling-edge contract): RPC lanes,
                    # accepts and handshakes service ahead of bulk
                    # channels — stable sort, so per-class arrival
                    # order (and per-channel frame order) is untouched
                    events.sort(
                        key=lambda km: not getattr(
                            km[0].data, "latency_class", False
                        )
                    )
                for key, mask in events:
                    handler = key.data
                    if handler is None:
                        self._drain_wake()
                        continue
                    try:
                        if mask & selectors.EVENT_READ:
                            handler.on_readable()
                        if mask & selectors.EVENT_WRITE:
                            handler.on_writable()
                    except BaseException:
                        logger.exception("transport handler raised")
                        _safe(handler.loop_close,
                              TransportError("handler raised"))
                    # flush per handler, not per iteration: a completed
                    # read's callbacks reach the completion executor
                    # before the next handler's I/O, not after
                    self._flush_completions()
                now = time.monotonic()
                self._m_loop_us.observe((now - t0) * 1e6)
                spin_deadline = now + self._spin_s
                if stop:
                    break
        finally:
            self._teardown()
            g.dec()

    def _teardown(self) -> None:  # on-loop
        err = TransportError(f"dispatcher {self.name} stopped")
        for key in list(self._sel.get_map().values()):
            if key.data is not None:
                _safe(key.data.loop_close, err)
        self._flush_completions()
        try:
            self._sel.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass


# accept() errnos that mean the LISTENING socket itself is gone —
# anything else (ECONNABORTED, EMFILE, ENFILE, ENOBUFS, ...) is a
# per-connection or transient-pressure failure the listener survives
_FATAL_ACCEPT_ERRNOS = frozenset(
    (errno.EBADF, errno.EINVAL, errno.ENOTSOCK)
)


class Acceptor:
    """The listening socket on the loop — the CM listener with no
    thread.  Fresh connections enter a :class:`_Handshake` continuation;
    completed handshakes become :class:`AsyncTcpChannel`s on the same
    selector."""

    latency_class = True   # serviced by priority polls
    latency_counts = False  # but does not force bulk chunking

    def __init__(self, dispatcher: Dispatcher, node, sock: socket.socket):
        self._disp = dispatcher
        self._node = node
        self._sock = sock
        self._closed = False  # loop-thread only after registration

    def loop_register(self) -> None:  # on-loop
        self._disp.sel_register(self._sock, selectors.EVENT_READ, self)

    def on_readable(self) -> None:  # on-loop
        while True:
            try:
                sock, addr = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if self._closed or e.errno in _FATAL_ACCEPT_ERRNOS:
                    self.loop_close(None)
                    return
                # transient: ECONNABORTED (the peer reset before we
                # accepted — routine when a connect attempt dies
                # mid-handshake) or fd/buffer pressure.  The LISTENER
                # is still healthy; closing it here would refuse every
                # future peer on this node forever.  Level-triggered
                # readiness re-fires for anything still queued.
                counter("transport_accept_transient_errors_total").inc()
                return
            try:
                sock.setblocking(False)
            except OSError:
                sock.close()
                continue
            hs = _Handshake(self._disp, self._node, sock, addr)
            self._disp.sel_register(sock, selectors.EVENT_READ, hs)

    def on_writable(self) -> None:  # on-loop
        pass

    def loop_close(self, _err) -> None:  # on-loop
        if self._closed:
            return
        self._closed = True
        self._disp.sel_unregister(self._sock)
        try:
            self._sock.close()
        except OSError:
            pass

    def request_close(self) -> None:
        """Close from any thread (network unregister): route through
        the loop; fall back to a direct close when it is already gone."""
        try:
            self._disp.post(self.loop_close, None)
        except TransportError:
            try:
                self._sock.close()
            except OSError:
                pass


class _Handshake:
    """Non-blocking hello continuation for one accepted socket
    (the CONNECT_REQUEST/ESTABLISHED exchange, RdmaNode.java:114-214)."""

    latency_class = True   # 9 bytes; never worth queueing behind bulk
    latency_counts = False

    def __init__(self, dispatcher: Dispatcher, node, sock, addr):
        self._disp = dispatcher
        self._node = node
        self._sock = sock
        self._addr = addr
        self._buf = bytearray(wire._HELLO.size)
        self._got = 0
        # once the socket is handed to its channel (or closed), a
        # STALE readiness event from the outer loop — this handshake
        # may have completed inside a nested priority poll — must not
        # touch the socket again (it would eat the first frame's bytes)
        self._done = False

    def on_readable(self) -> None:  # on-loop
        if self._done:
            return
        try:
            n = self._sock.recv_into(
                memoryview(self._buf)[self._got:],
                wire._HELLO.size - self._got,
            )
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self.loop_close(None)
            return
        if n == 0:
            self.loop_close(None)
            return
        self._got += n
        if self._got < wire._HELLO.size:
            return
        try:
            magic, type_idx, src_port, version = wire._HELLO.unpack(
                bytes(self._buf)
            )
            if magic != wire._MAGIC \
                    or type_idx >= len(wire._TYPE_BY_INDEX):
                raise TransportError(f"bad hello from {self._addr}")
            if not (wire.MIN_WIRE_VERSION <= version
                    <= wire.WIRE_VERSION):
                # structured rejection (NAK + both versions) — the 5
                # bytes always fit a fresh socket's send buffer; the
                # connector's error names both sides
                self._sock.send(
                    b"\x00"
                    + wire._HELLO_REJ.pack(wire.WIRE_VERSION, version)
                )
                counter("wire_version_rejects_total").inc()
                raise TransportError(
                    f"protocol version mismatch from {self._addr}: "
                    f"hello spoke wire version {version}, this node "
                    f"accepts {wire.MIN_WIRE_VERSION}.."
                    f"{wire.WIRE_VERSION}"
                )
            # the 1-byte ack always fits a fresh socket's send buffer
            self._sock.send(b"\x01")
            self._sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        except (BlockingIOError, InterruptedError, OSError,
                TransportError):
            logger.warning("handshake with %s failed", self._addr)
            self.loop_close(None)
            return
        req_type = wire._TYPE_BY_INDEX[type_idx]
        peer = (self._addr[0], src_port)
        ch = AsyncTcpChannel(
            wire._PAIRED.get(req_type, req_type), self._node, peer,
            self._sock, self._disp,
        )
        ch.wire_version = version  # the hello's (accepted) generation
        ch._set_state(ChannelState.CONNECTED)
        # swap this socket's handler from the handshake to the channel
        self._done = True
        self._disp.sel_modify(self._sock, selectors.EVENT_READ, ch)
        ch._mark_registered()
        self._node.register_passive_channel(ch)

    def on_writable(self) -> None:  # on-loop
        pass

    def loop_close(self, _err) -> None:  # on-loop
        if self._done:
            return
        self._done = True
        self._disp.sel_unregister(self._sock)
        try:
            self._sock.close()
        except OSError:
            pass


class AsyncTcpChannel(Channel):
    """One TCP connection driven entirely by the node's dispatcher
    loop: sends are posted as descriptors and written as partial
    ``sendmsg`` continuations; receives run the same framed state
    machine as ``TcpChannel`` but re-entrantly, landing striped read
    responses straight into their registered dest buffers.  Wire format
    identical to ``TcpChannel`` — the two interoperate."""

    supports_scatter = True

    #: recv-machine states
    _HDR, _RPC, _REQ, _RESP_HDR, _RESP_WHOLE, _RESP_LEN, _RESP_BLOCK, \
        _RESP_ERR, _DISCARD = (
            "hdr", "rpc", "req", "resp_hdr", "resp_whole", "resp_len",
            "resp_block", "resp_err", "discard",
        )

    #: the recv machine rides NEXT TO the inherited channel.lifecycle
    #: machine, so its table lives under the RX_ prefix (``table: RX``)
    RX_STATES = _HDR, _RPC, _REQ, _RESP_HDR, _RESP_WHOLE, _RESP_LEN, \
        _RESP_BLOCK, _RESP_ERR, _DISCARD
    RX_INITIAL = "hdr"
    RX_TERMINAL = ()
    RX_TRANSITIONS = {
        "hdr": ("rpc", "req", "resp_hdr"),
        "rpc": ("hdr",),
        "req": ("hdr",),
        # resp_hdr fans out: empty/error bodies settle straight back to
        # hdr, torn-down reads drain via discard, scatter reads walk
        # the len/block loop, whole-frame landings take resp_whole
        "resp_hdr": ("hdr", "discard", "resp_err", "resp_whole",
                     "resp_len"),
        "resp_whole": ("hdr",),
        "resp_len": ("resp_block", "hdr"),
        "resp_block": ("resp_len", "hdr"),
        "resp_err": ("hdr",),
        "discard": ("hdr",),
    }

    def __init__(self, channel_type: ChannelType, node, peer, sock,
                 dispatcher: Dispatcher):
        super().__init__(channel_type, node.conf.send_queue_depth)
        self.node = node
        self.peer = peer
        self._sock = sock
        self._disp = dispatcher
        self._sg = (
            node.conf.transport_scatter_gather
            and hasattr(sock, "sendmsg")
        )
        # latency-class channels (RPC) are serviced by bulk channels'
        # priority polls; bulk channels chunk their I/O at _POLL_BYTES
        # and poll between chunks
        self.latency_class = channel_type in _LATENCY_TYPES
        self.latency_counts = self.latency_class
        self._bulk = not self.latency_class
        self._backlog_hi = node.conf.transport_send_backlog_bytes
        # pinned socket buffers (the QP ring-size analog): a whole
        # stripe parks in the kernel between loop visits instead of
        # trickling through autotune growth; kernel doubles + caps at
        # net.core.{w,r}mem_max
        bufs = node.conf.transport_socket_buffer_bytes
        if bufs:
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, bufs)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufs)
            except OSError:
                pass
        # receive-wakeup coalescing (interrupt moderation): mid-body,
        # SO_RCVLOWAT batches epoll wakeups to ~_coalesce bytes; EOF
        # and socket errors always wake regardless, so dead peers are
        # still detected promptly.  Bulk lanes only — RPC must wake on
        # the first byte
        self._coalesce = (
            node.conf.transport_recv_coalesce_bytes if self._bulk else 0
        )
        if self._coalesce:
            # clamp the watermark under what the receive buffer can
            # actually hold: select/epoll honor RCVLOWAT, so a
            # watermark the buffer can never reach would simply never
            # report readable — a silent permanent stall on the
            # on-loop landing path.  Pinned buffers bound at the
            # pinned size (the kernel doubles the request); autotuned
            # ones at half the tcp_rmem growth ceiling.
            cap = bufs if bufs else _rmem_max() // 2
            self._coalesce = max(1, min(self._coalesce, cap))
        # big-body landing offload threshold; 0 (the default) keeps
        # every landing on-loop — see the _OFFLOAD_WORKERS note
        self._offload_min = node.conf.transport_stream_offload_bytes
        self._lowat = 1  # loop-thread only
        self._next_req = 1  # guarded-by: _reads_lock
        # req_id -> (count, listener, post time, dest, on_progress,
        #            total bytes)
        self._reads = {}  # guarded-by: _reads_lock
        # response bytes posted but not yet settled — the lane-stream
        # trigger (read racily off-loop: a stale value only delays or
        # double-checks a stream handoff, never corrupts state)
        self._rx_outstanding = 0  # guarded-by: _reads_lock
        self._reads_lock = dbg_lock("adisp.reads", 68)
        # ---- send side: shared between posting threads and the loop.
        # INLINE SENDS (the fabric-lib small-message idiom): a posting
        # thread whose channel has no queued tx writes the descriptor
        # straight to the non-blocking socket under _tx_lock — serve
        # workers push response bytes in big GIL-free sendmsg calls
        # (exactly the threaded path's send behavior) and RPC pings
        # reach the wire without a loop hop; only the EAGAIN remainder
        # is left for the loop to drain on EVENT_WRITE.  The lock also
        # serializes the fd's close against in-flight writes.
        # resource: dispatcher.send_ops (queued outbound descriptors)
        self._tx: Deque[_SendOp] = deque()  # guarded-by: _tx_lock
        self._tx_bytes = 0  # guarded-by: _tx_lock
        # True while a serve worker synchronously drains the tx queue
        # (_drain_tx_blocking) — at most one drainer per channel; the
        # loop and other posters leave the queue to it
        self._tx_draining = False  # guarded-by: _tx_lock
        self._closed = False  # written under _tx_lock (read racily)
        # single-owner fd close: with the recv machine streamable onto
        # workers and a teardown fallback on the stop() path, more than
        # one thread can reach "I should close this fd" — the flag
        # makes exactly ONE of them win, so a recycled fd number can
        # never be closed out from under an unrelated socket
        self._fd_closed = False  # guarded-by: _tx_lock
        self._tx_lock = dbg_lock("adisp.tx", 71)
        # owns: tcp.fds -> _close_fd_locked
        self._fd_tkt = ledger_acquire("tcp.fds")  # acquires: tcp.fds
        # ---- loop-thread-only state (never touched off-loop) ----
        self._events = 0
        self._registered = False
        self._read_paused = False
        self._rx_state = self._HDR  # state: channel.recv table: RX
        self._rx_view: Optional[memoryview] = None  # current fill target
        self._rx_got = 0
        self._rx_store = None       # backing object of _rx_view
        self._rx_frame_len = 0
        self._rx_entry = None       # (count, listener, t0, dest, on_progress)
        self._rx_idx = 0
        self._rx_blocks: List = []
        self._rx_block = None       # object delivered for current block
        self._rx_discard = 0
        self._rx_scratch = bytearray(_SCRATCH)
        # True while a completion worker owns the socket's recv side
        # (lane streaming); loop-thread written, the worker reads
        # _closed under _tx_lock for the fd-close handoff.  _on_worker
        # is the delivery-context flag: while the WORKER runs the recv
        # machine, completions deliver inline on it (the threaded
        # reader's shape) instead of hopping through the loop's
        # completion batches
        self._rx_offloaded = False
        self._on_worker = False  # touched only by the machine's owner
        # last completed-frame instant — the hot-conversation trigger
        # (machine-owner only, like the rest of the rx state)
        self._last_frame_t = 0.0
        self._arm_fixed(self._HDR, wire._HDR.size)
        # same metric series as the threaded path — it IS tcp wire
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
        self._m_backlog = gauge("transport_send_backlog_bytes")
        self._m_offloads = counter(
            "transport_dispatcher_lane_streams_total", transport="tcp")

    # -- attach (connector side) --------------------------------------------
    @classmethod
    def attach(cls, channel_type: ChannelType, node, peer,
               sock: socket.socket) -> "AsyncTcpChannel":
        """Wrap a freshly handshaken socket and hand it to the node's
        dispatcher (the connector-side entry; the acceptor side attaches
        on the loop itself)."""
        disp = node.get_dispatcher()
        sock.setblocking(False)
        ch = cls(channel_type, node, peer, sock, disp)
        ch._set_state(ChannelState.CONNECTED)
        try:
            disp.post(ch._loop_register)
        except TransportError:
            # settle through the single-owner close so the channel's
            # fd accounting closes with the socket
            ch._close_fd()
            raise
        return ch

    def _mark_registered(self) -> None:  # on-loop
        self._registered = True
        self._events = selectors.EVENT_READ

    def _loop_register(self) -> None:  # on-loop
        if self._closed:
            return
        self._events = selectors.EVENT_READ
        self._disp.sel_register(self._sock, self._events, self)
        self._registered = True

    # -- posting (any thread) ------------------------------------------------
    def _frame_op(self, opcode: int, parts, frames: int,
                  on_done=None) -> _SendOp:
        views = [v for v in map(wire._as_view, parts) if v.nbytes]
        length = sum(v.nbytes for v in views)
        hdr = wire._HDR.pack(opcode, length)
        if not self._sg:
            # legacy concat wire path (A/B parity with
            # transportScatterGather=off): one copy, one buffer
            buf = bytearray(hdr)
            for v in views:
                buf += v
            views = [memoryview(buf)]
        else:
            views = [memoryview(hdr)] + views
        return _SendOp(views, wire._HDR.size + length, frames, on_done)

    def _post_op(self, op: _SendOp, drain: bool = False) -> None:
        """Submit one send descriptor; a dead dispatcher fails it on
        the caller thread (the threaded path's synchronous-post-failure
        analog).

        Inline-send fast path: when the channel's tx queue is empty,
        THIS thread writes the descriptor to the non-blocking socket
        immediately under ``_tx_lock`` — big serve responses leave on
        the serve worker in GIL-free ``sendmsg`` calls and small RPC
        frames hit the wire with no loop hop; whatever the kernel
        refuses (EAGAIN) stays queued and the loop is kicked to drain
        it on EVENT_WRITE.

        ``drain=True`` (serve workers, which may block) goes one step
        further: instead of handing the EAGAIN remainder to the loop,
        THIS thread finishes the drain itself in ``_drain_tx_blocking``
        — writability waits + GIL-free sendmsg, the threaded serve
        path's blocking-``sendall`` shape without loop round trips.
        One drainer per channel; concurrent posters just append."""
        done_ops: List[_SendOp] = []
        err = None
        queued = False
        drained_here = False
        rejected = None  # op refused by an already-closed channel
        with self._tx_lock:
            if self._closed:
                err = TransportError("channel stopped")
                rejected = op
            else:
                # a queued descriptor leaves the tx queue exactly once:
                # fully written (_write_locked pops it) or swept by a
                # teardown path that fails the queue
                # owns: dispatcher.send_ops -> _write_locked
                # owns: dispatcher.send_ops -> _fail_tx
                # owns: dispatcher.send_ops -> _loop_fail
                op.tkt = ledger_acquire(
                    "dispatcher.send_ops"
                )  # acquires: dispatcher.send_ops
                op._transition("queued", frm="new")
                self._tx.append(op)
                self._tx_bytes += op.total
                self._m_backlog.inc(op.total)
                if len(self._tx) == 1 or self._tx_draining:
                    # inline send: socket is NON-blocking (see
                    # _write_locked's contract) — not a blocking call
                    # under _tx_lock.  With a drainer active, skip —
                    # it owns the queue.
                    if not self._tx_draining:
                        err = self._write_locked(done_ops)  # noqa: CK02
                queued = bool(self._tx) and err is None
                if queued and drain and not self._tx_draining:
                    self._tx_draining = True
                    drained_here = True
                # decided under the lock: a drainer active HERE is
                # guaranteed to see our op (it re-checks _tx under
                # _tx_lock before retiring)
                covered = drained_here or self._tx_draining
        if err is None:
            for d in done_ops:
                if d.on_done is not None:
                    _safe(d.on_done, None)
            if drained_here:
                self._drain_tx_blocking()
            elif queued and not covered:
                try:
                    self._disp.post(self._loop_kick)
                except TransportError as e:
                    self._fail_tx(e)
            return
        # write failed (or channel already stopped): completed ops
        # still succeeded; everything queued — including op — fails,
        # and (on a write failure) the loop is asked to tear the
        # socket down
        for d in done_ops:
            if d.on_done is not None:
                _safe(d.on_done, None)
        if rejected is not None:
            # closed before the post: the op was never queued and the
            # teardown already ran — fail JUST this descriptor
            rejected._transition("failed", frm="new")
            if rejected.on_done is not None:
                _safe(rejected.on_done, err)
            return
        self._error(err)
        self._fail_tx(err)
        try:
            self._disp.post(self._loop_close)
        except TransportError:
            pass

    def _write_locked(self, done_ops: List[_SendOp]):
        """Drain the tx queue onto the socket until EAGAIN or empty —
        caller holds ``_tx_lock``.  Completed ops are appended to
        ``done_ops`` (their callbacks run after the lock drops); a
        socket error is RETURNED, and the tx queue is failed by the
        caller.  The socket is non-blocking, so the ``sendmsg`` here
        returns immediately (the GIL is dropped only for the kernel
        copy) — not a blocking send under a lock."""
        while self._tx:  # noqa: CK03 - caller holds _tx_lock
            op = self._tx[0]  # noqa: CK03 - caller holds _tx_lock
            try:
                if self._sg:
                    n = self._sock.sendmsg(  # noqa: CK02
                        op.views[op.i:op.i + _IOV_MAX])
                else:
                    n = self._sock.send(op.views[op.i])
            except (BlockingIOError, InterruptedError):
                return None
            except OSError as e:
                return TransportError(f"send failed: {e}")
            if n <= 0:
                return None
            self._m_sendmsg_bytes.inc(n)
            op.advance(n)
            if op.done:
                self._tx.popleft()  # noqa: CK03 - caller holds _tx_lock
                self._tx_bytes -= op.total  # noqa: CK03 - caller holds _tx_lock
                self._m_backlog.dec(op.total)
                self._m_msgs_sent.inc(op.frames)
                self._m_bytes_sent.inc(op.total)
                op.tkt.release()  # releases: dispatcher.send_ops
                op._transition("sent", frm="queued")
                done_ops.append(op)
        return None

    def _drain_tx_blocking(self) -> None:
        """Finish the tx queue on THIS (serve-worker) thread: repeated
        non-blocking ``_write_locked`` bursts with short writability
        waits in between — the threaded serve path's blocking
        ``sendall`` shape, minus any loop involvement.  Caller set
        ``_tx_draining`` under ``_tx_lock``.  The wait runs WITHOUT the
        lock and with a bounded tick: if the channel closes (and the fd
        number is even reused) under us, the next burst re-checks
        ``_closed`` under the lock and retires; a stale-fd ``select``
        can at worst idle one tick."""
        while True:
            done_ops: List[_SendOp] = []
            fd = -1
            with self._tx_lock:
                if self._closed or not self._tx:
                    self._tx_draining = False
                    err, pending = None, False
                else:
                    # non-blocking socket (see _write_locked) — not CK02
                    err = self._write_locked(done_ops)  # noqa: CK02
                    pending = bool(self._tx) and err is None
                    if not pending:
                        self._tx_draining = False
                if pending:
                    try:
                        fd = self._sock.fileno()
                    except OSError:
                        fd = -1
            for d in done_ops:
                if d.on_done is not None:
                    _safe(d.on_done, None)
            if err is not None:
                with self._tx_lock:
                    self._tx_draining = False
                self._error(err)
                self._fail_tx(err)
                try:
                    self._disp.post(self._loop_close)
                except TransportError:
                    pass
                return
            if not pending:
                return
            if fd >= 0:
                try:
                    select.select([], [fd], [fd], _OFFLOAD_TIMEOUT)
                except (OSError, ValueError):
                    pass  # fd torn down under us; loop re-checks _closed

    def _close_fd_locked(self) -> None:
        """Close the fd exactly once — caller holds ``_tx_lock``."""
        if not self._fd_closed:  # noqa: CK03 - caller holds _tx_lock
            self._fd_closed = True  # noqa: CK03 - caller holds _tx_lock
            tkt, self._fd_tkt = self._fd_tkt, NOOP_TICKET
            tkt.release()  # releases: tcp.fds  # one-shot
            try:
                self._sock.close()
            except OSError:
                pass

    def _close_fd(self) -> None:
        with self._tx_lock:
            self._close_fd_locked()

    def _stream_drain_tx(self):
        """Drain queued tx from the STREAMING worker: while a lane is
        streamed its socket is off the selector, so EVENT_WRITE can
        never re-arm — a frame the inline send EAGAIN'd would strand
        until the next post.  The worker's select watches writability
        whenever tx is pending and drains here.  Returns a
        TransportError on socket failure (the worker turns it into the
        stream error), None otherwise."""
        done_ops: List[_SendOp] = []
        with self._tx_lock:
            if self._closed:
                return None
            if self._tx_draining:
                return None  # a serve-worker drainer owns the queue
            # non-blocking socket (see _write_locked) — not CK02
            err = self._write_locked(done_ops)  # noqa: CK02
        for d in done_ops:
            if d.on_done is not None:
                _safe(d.on_done, None)
        return err

    def _fail_tx(self, err: BaseException) -> None:
        """Fail every queued descriptor (any thread)."""
        with self._tx_lock:
            tx, self._tx = list(self._tx), deque()
            if self._tx_bytes:
                self._m_backlog.dec(self._tx_bytes)
            self._tx_bytes = 0
        for op in tx:
            op.tkt.release()  # releases: dispatcher.send_ops
            op._transition("failed")
            if op.on_done is not None:
                _safe(op.on_done, err)

    def _send_msg(self, opcode: int, parts) -> None:
        """Post one raw frame (fire-and-forget) — the threaded path's
        ``_send_msg`` sibling, used by chaos/fault tests to inject
        hand-crafted frames.  Delivery is asynchronous."""
        self._post_op(self._frame_op(opcode, parts, 1))

    def _post_rpc(self, frames, listener: CompletionListener) -> None:
        parts: List = []
        for f in frames:
            v = wire._as_view(f)
            parts.append(wire._HDR.pack(wire.OP_RPC, v.nbytes))
            parts.append(v)
        views = [memoryview(wire._as_view(p)) for p in parts if len(p)]
        total = sum(v.nbytes for v in views)
        if not self._sg:
            buf = bytearray()
            for v in views:
                buf += v
            views = [memoryview(bytes(buf))]

        def done(err):
            if err is not None:
                self._error(err)
                self._fail(listener, err)
            else:
                self._complete(listener, None)
            self._release_budget()

        if FAULTS.enabled:
            try:
                FAULTS.check("send")
            except TransportError as e:
                done(e)
                return
        self._post_op(_SendOp(views, total, len(frames), done))

    def _post_read(self, locations: List[BlockLocation],
                   listener: CompletionListener,
                   dest=None, on_progress=None, ctx=None) -> None:
        total = sum(loc.length for loc in locations)
        with self._reads_lock:
            req_id = self._next_req
            self._next_req += 1
            self._reads[req_id] = (
                len(locations), listener, time.monotonic(), dest,
                on_progress, total,
            )
            self._rx_outstanding += total
        payload = bytearray(wire._REQ_HDR.pack(req_id, len(locations)))
        for loc in locations:
            payload += wire._LOC.pack(loc.address, loc.length, loc.mkey)
        if ctx is not None and self.wire_version != 1:
            # optional v2 tail; suppressed on channels negotiated down
            payload += wire._TRACE_CTX.pack(ctx[0], ctx[1])
            if RECORDER.enabled:
                fr_event(
                    "transport", "wire_send",
                    trace_id=ctx[0], span_id=ctx[1],
                    locs=len(locations),
                )

        def done(err):
            if err is not None:
                with self._reads_lock:
                    entry = self._reads.pop(req_id, None)
                    if entry is not None:
                        self._rx_outstanding -= entry[5]
                self._error(err)
                self._fail(listener, err)
                self._release_budget()
            # success: budget released when the response arrives

        if FAULTS.enabled:
            try:
                FAULTS.check("send")
            except TransportError as e:
                done(e)
                return
        self._post_op(self._frame_op(wire.OP_READ_REQ, (payload,), 1, done))

    # -- send machine (loop side) -------------------------------------------
    def _loop_kick(self) -> None:  # on-loop
        """Arm/drain the tx remainder an inline send left behind."""
        if not self._closed:
            self._flush_tx()

    def on_writable(self) -> None:  # on-loop
        self._flush_tx()

    def _flush_tx(self) -> None:  # on-loop
        done_ops: List[_SendOp] = []
        with self._tx_lock:
            # non-blocking socket (see _write_locked) — not CK02
            err = None if self._closed \
                else self._write_locked(done_ops)  # noqa: CK02
        for d in done_ops:
            if d.on_done is not None:
                self._disp.complete(d.on_done, None)
        if err is not None:
            self._loop_fail(err)
            return
        self._update_interest()

    def _update_interest(self) -> None:  # on-loop
        if self._closed or not self._registered:
            return
        with self._tx_lock:
            pending = bool(self._tx)
            backlog = self._tx_bytes
        # per-channel write backpressure: a peer that stops draining
        # its responses gets its READ interest parked until the backlog
        # halves — new requests stay in the kernel / its TCP window
        if self._read_paused:
            if backlog <= self._backlog_hi // 2:
                self._read_paused = False
        elif backlog > self._backlog_hi:
            self._read_paused = True
        want = 0 if self._read_paused else selectors.EVENT_READ
        if pending:
            want |= selectors.EVENT_WRITE
        if not want:
            want = selectors.EVENT_WRITE  # paused + drained: impossible,
            # but the selector needs a non-empty interest set
        if want != self._events:
            self._events = want
            self._disp.sel_modify(self._sock, want, self)

    # -- recv machine (loop thread) -----------------------------------------
    def _transition_rx(self, state: str) -> None:  # on-loop
        if GLOBAL_STATE_DEBUG.enabled:
            check_named(self, state, name="channel.recv", field="_rx_state",
                        transitions=self.RX_TRANSITIONS)
        self._rx_state = state

    def _arm_fixed(self, state: str, n: int) -> None:  # on-loop
        self._transition_rx(state)
        self._rx_store = bytearray(n)
        self._rx_view = memoryview(self._rx_store)
        self._rx_got = 0

    def _arm_into(self, state: str, store, view: memoryview) -> None:  # on-loop
        self._transition_rx(state)
        self._rx_store = store
        self._rx_view = view
        self._rx_got = 0

    def _recv_buffer(self, length: int):
        """Pooled receive buffer (zero-copy slices for the consumer)
        with a plain bytearray fallback — the threaded ``_recv_payload``
        allocation policy."""
        if length == 0:
            return b""
        pool = getattr(self.node, "staging_pool", None)
        if pool is not None:
            try:
                arr = pool.alloc_gc(length)
            except MemoryError:
                arr = None
            if arr is not None:
                return arr
        return bytearray(length)

    def on_readable(self) -> None:  # on-loop
        self._rx_pump()
        if not self._closed and not self._rx_offloaded and self._coalesce:
            self._tune_lowat()

    def _tune_lowat(self) -> None:  # on-loop
        """Set the receive low-watermark for the CURRENT arm target:
        ``_coalesce`` while ≥ that many body bytes are still expected
        (one wakeup per ~watermark of queued bytes), 1 for headers and
        body tails — a tail below the watermark would otherwise never
        wake the loop (rcvbuf autotuning stalls when the app stops
        reading)."""
        if self._rx_state == self._DISCARD:
            rem = self._rx_discard
        elif self._rx_view is not None:
            rem = self._rx_view.nbytes - self._rx_got
        else:
            rem = 0
        want = self._coalesce if rem >= self._coalesce else 1
        if want != self._lowat:
            try:
                self._sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_RCVLOWAT, want
                )
                self._lowat = want
            except OSError:
                self._coalesce = 0  # platform without RCVLOWAT

    def _rx_pump(self) -> None:  # on-loop
        budget = _FAIR_BUDGET
        polled = 0
        frames = 0
        # chunk + priority-poll only while the loop actually hosts
        # latency-class traffic; otherwise bulk runs full-size
        # GIL-free recv calls (the threaded reader's syscall shape)
        chunked = self._bulk and self._disp.latency_active()
        while not self._closed:
            if budget <= 0:
                # fairness: yield the loop; the level-triggered
                # selector re-reports the remainder immediately
                return
            if self._rx_state == self._DISCARD:
                got = self._rx_run_discard()
                if not got:
                    return
                budget -= got
                continue
            # ≥2 full frames in ONE readiness callback = an inbound
            # burst (a windowed requester fires its whole window
            # back-to-back) — stream the responder side too, not just
            # lanes with outstanding READS of our own
            if self._rx_maybe_offload(force=frames >= 2):
                return
            want = self._rx_view.nbytes - self._rx_got
            if chunked and want > _POLL_BYTES:
                # chunk bulk receives at the poll cadence so RPC
                # events preempt mid-stream
                want = _POLL_BYTES
            try:
                n = self._sock.recv_into(
                    self._rx_view[self._rx_got:], want,
                )
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._loop_fail(TransportError(f"recv failed: {e}"))
                return
            if n == 0:
                self._loop_fail(
                    TransportError("connection closed by peer")
                )
                return
            budget -= n
            self._rx_got += n
            if chunked:
                polled += n
                if polled >= _POLL_BYTES:
                    polled = 0
                    self._disp.poll_latency()
                    if self._closed:
                        return
            if self._rx_got < self._rx_view.nbytes:
                if n < want:
                    return  # kernel buffer drained; wait for the event
                continue
            try:
                self._rx_dispatch()
            except TransportError as e:
                self._loop_fail(e)
                return
            except BaseException as e:
                logger.exception("recv state machine failed")
                self._loop_fail(TransportError(f"recv failed: {e}"))
                return
            if self._rx_state == self._HDR:
                # a LOGICAL frame completed (not a mid-response state
                # hop, which arms something else)
                frames += 1
                t = time.monotonic()
                hot = t - self._last_frame_t < _HOT_FRAME_S
                self._last_frame_t = t
                if hot and self._rx_maybe_offload(force=True):
                    return

    def _rx_run_discard(self) -> int:  # on-loop
        """Consume discard-path bytes; returns how many were read
        (0 = would-block or channel failed)."""
        want = min(self._rx_discard, _SCRATCH)
        try:
            n = self._sock.recv_into(
                memoryview(self._rx_scratch)[:want], want
            )
        except (BlockingIOError, InterruptedError):
            return 0
        except OSError as e:
            self._loop_fail(TransportError(f"recv failed: {e}"))
            return 0
        if n == 0:
            self._loop_fail(TransportError("connection closed by peer"))
            return 0
        self._rx_discard -= n
        if self._rx_discard == 0:
            self._arm_fixed(self._HDR, wire._HDR.size)
        return n

    def _rx_dispatch(self) -> None:  # on-loop
        """One completed fixed-size read: advance the frame state
        machine (the re-entrant ``_read_loop``)."""
        state = self._rx_state
        if state == self._HDR:
            opcode, length = wire._HDR.unpack(bytes(self._rx_store))
            if FAULTS.enabled:
                # raising here rides the _rx_pump failure path: the
                # channel dies and outstanding reads fail structured
                FAULTS.check("recv")
            if length > wire._MAX_FRAME:
                raise TransportError(f"oversized frame: {length}B")
            if wiredbg.wire_debug_enabled():
                herr = wiredbg.header_error("dispatcher", opcode, length)
                if herr is not None:
                    raise TransportError(f"wireDebug: {herr}")
            self._m_msgs_recv.inc()
            self._m_bytes_recv.inc(wire._HDR.size + length)
            if opcode == wire.OP_RPC:
                if length == 0:
                    self._rx_rpc_frame(b"")
                    self._arm_fixed(self._HDR, wire._HDR.size)
                else:
                    self._arm_fixed(self._RPC, length)
            elif opcode == wire.OP_READ_REQ:
                if length == 0:
                    self._arm_fixed(self._HDR, wire._HDR.size)
                    self.node.submit_serve(
                        self._serve_read_async, (b"", time.monotonic()),
                        0, deferred=True,
                    )
                else:
                    self._arm_fixed(self._REQ, length)
            elif opcode == wire.OP_READ_RESP:
                if FAULTS.enabled:
                    FAULTS.check("read_resp")
                if length < wire._RESP_HDR.size:
                    raise TransportError(f"short read response: {length}B")
                self._rx_frame_len = length
                self._arm_fixed(self._RESP_HDR, wire._RESP_HDR.size)
            else:
                # desynced byte stream: the channel must die, but
                # counted and scoped (outstanding reads fail with a
                # structured error; the node stays up)
                counter(
                    "wire_unknown_frames_total",
                    engine="dispatcher", kind="opcode",
                ).inc()
                raise TransportError(f"unknown opcode {opcode}")
        elif state == self._RPC:
            frame = bytes(self._rx_store)
            self._arm_fixed(self._HDR, wire._HDR.size)
            self._rx_rpc_frame(frame)
        elif state == self._REQ:
            payload = bytes(self._rx_store)
            self._arm_fixed(self._HDR, wire._HDR.size)
            # resolution runs on the bounded serve pool (mapped-file
            # reads may fault — never on the loop); its byte credits
            # are released by the response's send-completion event
            self.node.submit_serve(
                self._serve_read_async, (payload, time.monotonic()),
                wire._req_cost(payload), deferred=True,
                mkey=wire._req_mkey(payload),
            )
        elif state == self._RESP_HDR:
            self._rx_resp_hdr()
        elif state == self._RESP_WHOLE:
            self._rx_resp_whole()
        elif state == self._RESP_LEN:
            self._rx_resp_len()
        elif state == self._RESP_BLOCK:
            self._rx_block_done(self._rx_block, self._rx_view.nbytes)
        elif state == self._RESP_ERR:
            reason = bytes(self._rx_store).decode("utf-8", "replace")
            self._rx_settle(None, decode_remote_error(reason))
        else:  # pragma: no cover - state machine exhaustive
            raise TransportError(f"bad recv state {state}")

    def _rx_rpc_frame(self, frame: bytes) -> None:  # on-loop
        """Hand one RPC frame to the application dispatch plane —
        schema-validated first under wireDebug (a rejected frame is
        counted, hexdump-logged, and dropped: one-frame blast
        radius)."""
        if (wiredbg.wire_debug_enabled()
                and not wiredbg.rpc_frame_ok("dispatcher", frame)):
            return
        self.node.dispatch_frame(self, frame)

    def _rx_resp_hdr(self) -> None:  # on-loop
        req_id, status = wire._RESP_HDR.unpack(bytes(self._rx_store))
        body = self._rx_frame_len - wire._RESP_HDR.size
        # bytes of this frame's body not yet consumed — the hard bound
        # every block-length prefix is validated against (a lying
        # prefix must never read into the next frame or size an
        # allocation)
        self._rx_resp_left = body
        with self._reads_lock:
            entry = self._reads.pop(req_id, None)
        if entry is None:
            # raced with teardown: drop the body without materializing
            if body == 0:
                self._arm_fixed(self._HDR, wire._HDR.size)
            else:
                self._rx_discard = body
                self._transition_rx(self._DISCARD)
            return
        self._rx_entry = entry
        self._rx_idx = 0
        self._rx_blocks = []
        count, _listener, _t0, dest, _prog, _total = entry
        if status != 0:
            if body == 0:
                self._rx_settle(None, TransportError("read failed"))
            else:
                self._arm_fixed(self._RESP_ERR, body)
        elif dest is None:
            # whole-frame landing in ONE pooled buffer, blocks served
            # as zero-copy slices (threaded _recv_payload parity)
            store = self._recv_buffer(body)
            if body == 0:
                self._rx_store = store
                self._rx_resp_whole()
            else:
                self._arm_into(
                    self._RESP_WHOLE, store,
                    wire._as_view(store)[:body],
                )
        elif count == 0:
            self._rx_settle([], None)
        else:
            self._rx_next_block()

    def _rx_resp_whole(self) -> None:  # on-loop
        count, _listener, _t0, _dest, on_progress, _total = self._rx_entry
        store = self._rx_store
        if isinstance(store, np.ndarray):
            store.flags.writeable = False
        payload = store if isinstance(store, np.ndarray) else bytes(store)
        blocks, off = [], 0
        for _ in range(count):
            (n,) = wire._LEN.unpack_from(payload, off)
            off += wire._LEN.size
            if n > len(payload) - off:
                # lying length prefix: fail the read, then tear the
                # (desynced) channel down — never silently truncate
                self._rx_settle(None, TransportError(
                    f"block length {n}B exceeds response remainder "
                    f"{len(payload) - off}B"
                ))
                raise TransportError("block length exceeds frame")
            blocks.append(payload[off: off + n])
            off += n
            if on_progress is not None:
                if self._on_worker:
                    _safe(on_progress, n)
                else:
                    self._disp.complete(_safe, on_progress, n)
        self._rx_settle(blocks, None)

    def _rx_next_block(self) -> None:  # on-loop
        if self._rx_resp_left < wire._LEN.size:
            self._rx_settle(None, TransportError(
                f"short read response: {self._rx_resp_left}B left "
                f"before next block prefix"
            ))
            raise TransportError("short read response body")
        self._arm_fixed(self._RESP_LEN, wire._LEN.size)

    def _rx_resp_len(self) -> None:  # on-loop
        (n,) = wire._LEN.unpack(bytes(self._rx_store))
        self._rx_resp_left -= wire._LEN.size
        count, listener, _t0, dest, _prog, _total = self._rx_entry
        if n > self._rx_resp_left:
            # without this bound a lying prefix would read INTO the
            # next frame's bytes (or hang waiting for bytes that never
            # come) and size an attacker-controlled allocation
            self._rx_settle(None, TransportError(
                f"block length {n}B exceeds response remainder "
                f"{self._rx_resp_left}B"
            ))
            raise TransportError("block length exceeds frame")
        self._rx_resp_left -= n
        d = dest[self._rx_idx] if self._rx_idx < len(dest) else None
        if d is None:
            store = self._recv_buffer(n)
            block = store
            view = wire._as_view(store)[:n]
        else:
            view = wire._as_view(d)
            if view.nbytes != n:
                # protocol desync: fail this read, then tear the
                # channel down (the threaded path raises out of the
                # reader loop here)
                self._rx_settle(None, TransportError(
                    f"stripe length mismatch: {n}B payload for "
                    f"{view.nbytes}B dest buffer"
                ))
                raise TransportError("stripe length mismatch")
            store, block = d, d
        if n == 0:
            self._rx_block_done(block, 0)
        else:
            self._rx_block = block
            self._arm_into(self._RESP_BLOCK, store, view)

    def _rx_block_done(self, block, n: int) -> None:  # on-loop
        count, _listener, _t0, dest, on_progress, _total = self._rx_entry
        if (dest is None or self._rx_idx >= len(dest)
                or dest[self._rx_idx] is None):
            if isinstance(block, np.ndarray):
                block.flags.writeable = False
        self._rx_blocks.append(block)
        if on_progress is not None:
            if self._on_worker:
                _safe(on_progress, n)
            else:
                self._disp.complete(_safe, on_progress, n)
        self._rx_idx += 1
        if self._rx_idx >= count:
            self._rx_settle(self._rx_blocks, None)
        else:
            self._rx_next_block()

    def _rx_settle(self, blocks, err) -> None:  # on-loop
        """One read response fully received (or failed): queue the
        completion event and re-arm for the next frame header.  On a
        streaming worker the completion delivers INLINE — the worker
        IS completion-executor context (the threaded reader's delivery
        shape), so the loop round trip is skipped."""
        entry, self._rx_entry = self._rx_entry, None
        self._rx_blocks = []
        self._rx_block = None
        _count, listener, t0, _dest, _prog, total = entry
        with self._reads_lock:
            self._rx_outstanding -= total
        if self._on_worker:
            self._deliver(listener, blocks, err, t0)
        else:
            self._disp.complete(self._deliver, listener, blocks, err, t0)
        self._arm_fixed(self._HDR, wire._HDR.size)

    def _deliver(self, listener, blocks, err, t0) -> None:
        """Completion-executor side of one read: RTT covers the whole
        transfer through completion-queue dispatch (comparable with the
        threaded/loopback series)."""
        self._m_read_rtt.observe((time.monotonic() - t0) * 1000.0)
        if err is not None:
            self._fail(listener, err)
        else:
            self._complete(listener, blocks)
        self._release_budget()

    # -- lane streaming (completion-worker recv) ----------------------------
    def _rx_maybe_offload(self, force: bool = False) -> bool:  # on-loop
        """Hand a BUSY lane's whole recv machine to a completion worker
        doing BLOCKING recv (the completion-worker half of the CQ
        split): when at least ``transportStreamOffloadBytes`` of
        response bytes are outstanding on this channel, the socket
        leaves the selector and the worker runs the frame state machine
        with kernel-coalesced blocking reads and INLINE completion
        delivery — the threaded reader's exact syscall-and-delivery
        shape, paid only while the lane is actually busy — until the
        lane goes idle, then ``_offload_done`` hands the fd back to the
        loop.  One handoff per burst, not per body.  Bulk channels
        only, at most ``_OFFLOAD_WORKERS`` lanes at a time — when the
        semaphore is exhausted further lanes land on-loop as usual.

        ``force`` streams regardless of OUR outstanding reads (and
        also covers HOT latency channels) — the burst/conversation
        triggers detected by the pump."""
        if not self._offload_min:
            return False
        # racy read of _outstanding: a stale value only delays the
        # handoff one pump or streams a lane that just went idle (the
        # worker exits after its grace tick) — never corrupts state
        if not force and (
                not self._bulk
                or self._rx_outstanding < self._offload_min):  # noqa: CK03
            return False
        if not self._disp.offload_sem.acquire(blocking=False):
            return False
        self._rx_offloaded = True
        self._on_worker = True
        if self._registered:
            self._disp.sel_unregister(self._sock)
            self._registered = False
        self._m_offloads.inc()
        try:
            self.node.submit(self._stream_recv)
        except BaseException:
            # completion pool gone (teardown): land on-loop after all
            self._disp.offload_sem.release()
            self._rx_offloaded = False
            self._on_worker = False
            self._loop_register()
            return False
        return True

    def _stream_recv(self) -> None:
        """Dedicated recv loop of one streamed lane — runs on a
        completion-pool worker, NOT on the loop (a sleeping per-fd
        reader gets RCVLOWAT-coalesced wakeups where the shared epoll
        pays loop machinery per event, and inline delivery skips the
        loop completion round trip).  The fd stays NON-blocking — the
        worker waits in its own ``select`` — because the send side of
        the same socket keeps running concurrently (see the comment at
        the recv call).  The loop does not touch this channel's recv
        state or the socket until ``_offload_done`` is posted back;
        ``stop``/``_loop_fail`` shutdown() the socket to wake this
        worker, which then owns the final close (fd-reuse safety)."""
        err = None
        # readahead carve buffer: one recv per wakeup pulls everything
        # queued (up to _SCRATCH); headers / prefixes / small frames
        # are carved out of ra[lo:hi] with no further syscalls, and
        # armed targets with ≥ _SCRATCH still to fill recv DIRECTLY
        # into their view (zero copy for the body bulk)
        ra = memoryview(self._rx_scratch)
        lo = hi = 0
        try:
            while err is None and not self._closed:
                state = self._rx_state
                if state == self._DISCARD:
                    if hi > lo:
                        take = min(hi - lo, self._rx_discard)
                        lo += take
                        self._rx_discard -= take
                    else:
                        # ra is free when the spill is empty — reuse it
                        want = min(self._rx_discard, _SCRATCH)
                        try:
                            n = self._sock.recv_into(ra[:want], want)
                        except (BlockingIOError, InterruptedError):
                            try:
                                fd = self._sock.fileno()
                                wl = (
                                    [fd] if self._tx_bytes  # noqa: CK03
                                    and not self._tx_draining  # noqa: CK03
                                    else [])
                                _r, w, _x = select.select(
                                    [fd], wl, [fd], _OFFLOAD_TIMEOUT)
                            except (OSError, ValueError):
                                err = TransportError("socket gone")
                                break
                            if w:
                                err = self._stream_drain_tx()
                                if err is not None:
                                    break
                            continue
                        except OSError as e:
                            err = TransportError(f"recv failed: {e}")
                            break
                        if n == 0:
                            err = TransportError(
                                "connection closed by peer")
                            break
                        self._rx_discard -= n
                    if self._rx_discard == 0:
                        self._arm_fixed(self._HDR, wire._HDR.size)
                    continue
                view = self._rx_view
                want = view.nbytes - self._rx_got
                if hi > lo:
                    take = hi - lo if hi - lo < want else want
                    view[self._rx_got:self._rx_got + take] = \
                        ra[lo:lo + take]
                    lo += take
                    self._rx_got += take
                else:
                    grace = False
                    if state == self._HDR and self._rx_got == 0:
                        # between frames with nothing buffered, nothing
                        # outstanding and nothing being sent: the burst
                        # is probably over — wait one short grace tick
                        # for a follow-on frame (request bursts have
                        # sub-ms gaps), then hand the fd back.  While
                        # the conversation is HOT the lock checks are
                        # skipped entirely — the previous frame just
                        # landed, another is coming
                        if (time.monotonic() - self._last_frame_t
                                >= _HOT_FRAME_S):
                            with self._reads_lock:
                                idle = self._rx_outstanding == 0
                            if idle:
                                with self._tx_lock:
                                    idle = not self._tx_bytes
                            grace = idle
                        # select FIRST at a frame boundary: the lane is
                        # usually between frames here, and probing with
                        # a guaranteed-EAGAIN recv pays a syscall plus
                        # an exception per frame; when bytes are
                        # already queued the select returns immediately.
                        # The watermark MUST drop to the header size
                        # first — select honors RCVLOWAT, and a stale
                        # mid-body watermark would never report a lone
                        # header readable
                        if self._coalesce and self._lowat != want:
                            try:
                                self._sock.setsockopt(
                                    socket.SOL_SOCKET, socket.SO_RCVLOWAT,
                                    want,
                                )
                                self._lowat = want
                            except OSError:
                                self._coalesce = 0
                        try:
                            fd = self._sock.fileno()
                            wl = (
                                [fd] if self._tx_bytes  # noqa: CK03
                                and not self._tx_draining  # noqa: CK03
                                else [])
                            r, w, x = select.select(
                                [fd], wl, [fd],
                                _STREAM_GRACE if grace
                                else _OFFLOAD_TIMEOUT,
                            )
                        except (OSError, ValueError):
                            err = TransportError("socket gone")
                            break
                        if w:
                            err = self._stream_drain_tx()
                            if err is not None:
                                break
                        if not r and not x:
                            if grace and not w:
                                break  # idle through grace: hand back
                            continue  # periodic _closed recheck
                    direct = want >= _SCRATCH
                    if self._coalesce:
                        # wake per ~coalesce bytes mid-body, exact-fill
                        # for headers/tails (RCVLOWAT gates select
                        # readability, so it must never exceed the
                        # bytes the machine still needs)
                        lw = (want if want < self._coalesce
                              else self._coalesce)
                        if lw != self._lowat:
                            try:
                                self._sock.setsockopt(
                                    socket.SOL_SOCKET, socket.SO_RCVLOWAT,
                                    lw,
                                )
                                self._lowat = lw
                            except OSError:
                                self._coalesce = 0
                    # The socket MUST stay non-blocking: settimeout()
                    # would flip the whole fd into Python's timeout
                    # mode and make concurrent inline sendmsg on the
                    # SAME socket (_write_locked under _tx_lock)
                    # wait-then-raise socket.timeout — dropping a
                    # half-sent frame and desyncing the wire.  So the
                    # worker waits in select() and recvs non-blocking:
                    # the RCVLOWAT watermark still coalesces select
                    # wakeups exactly like a blocking reader's.
                    try:
                        if direct:
                            n = self._sock.recv_into(
                                view[self._rx_got:], want)
                        else:
                            n = self._sock.recv_into(ra, _SCRATCH)
                    except (BlockingIOError, InterruptedError):
                        try:
                            fd = self._sock.fileno()
                            wl = (
                                [fd] if self._tx_bytes  # noqa: CK03
                                and not self._tx_draining  # noqa: CK03
                                else [])
                            r, w, x = select.select(
                                [fd], wl, [fd],
                                _STREAM_GRACE if grace
                                else _OFFLOAD_TIMEOUT,
                            )
                        except (OSError, ValueError):
                            err = TransportError("socket gone")
                            break
                        if w:
                            err = self._stream_drain_tx()
                            if err is not None:
                                break
                        if grace and not r and not x and not w:
                            break  # idle through the grace: hand back
                        continue  # data/EOF ready, or periodic recheck
                    except OSError as e:
                        err = TransportError(f"recv failed: {e}")
                        break
                    if n == 0:
                        err = TransportError("connection closed by peer")
                        break
                    if direct:
                        self._rx_got += n
                    else:
                        lo, hi = 0, n
                        continue  # carve on the next iteration
                if self._rx_got < view.nbytes:
                    continue
                try:
                    self._rx_dispatch()
                except TransportError as e:
                    err = e
                    break
                except BaseException as e:
                    logger.exception("recv state machine failed")
                    err = TransportError(f"recv failed: {e}")
                    break
                if self._rx_state == self._HDR:
                    # logical frame completed on the worker: feed the
                    # hot-conversation clock (grace skip above)
                    self._last_frame_t = time.monotonic()
        finally:
            self._disp.offload_sem.release()
        with self._tx_lock:
            closed = self._closed
            if closed:
                # the channel died while we owned the fd — the closer
                # skipped the close (fd-reuse safety); finish it here
                self._close_fd_locked()
        if closed:
            self._stream_fail_entry(err)
            return
        try:
            self._disp.post(self._offload_done, err)
        except TransportError:
            # dispatcher stopped while we owned the fd: nobody will
            # take the machine back — close it here (single-owner flag
            # arbitrates against the stop() fallback)
            self._close_fd()
            self._stream_fail_entry(err)

    def _stream_fail_entry(self, err) -> None:
        """Worker-side cleanup of a read mid-body when the channel died
        under a streamed lane: _loop_fail deferred the entry to us (we
        own the recv machine), and _fail_outstanding no longer covers
        it (it left _reads at RESP_HDR) — fail it exactly once here."""
        entry, self._rx_entry = self._rx_entry, None
        if entry is not None:
            with self._reads_lock:
                self._rx_outstanding -= entry[5]
            self._deliver(
                entry[1], None,
                err if err is not None
                else TransportError("channel stopped"),
                entry[2],
            )

    def _offload_done(self, err) -> None:  # on-loop
        """Streaming worker finished (lane idle) or failed: take the
        recv machine back, re-register the socket and drain whatever
        already queued."""
        self._rx_offloaded = False
        self._on_worker = False
        if self._closed:
            # closed between the worker's post and this running:
            # _loop_fail deferred the mid-body entry while the worker
            # owned the machine — it is ours to fail now
            self._close_fd()
            self._stream_fail_entry(err)
            return
        if err is not None:
            self._loop_fail(err)
            return
        self._loop_register()
        self._rx_pump()  # drain whatever else is already queued
        if self._closed or self._rx_offloaded:
            return
        if self._coalesce:
            self._tune_lowat()
        self._update_interest()

    # -- serving (serve-pool worker thread) ---------------------------------
    def _serve_read_async(self, payload: bytes, t_enq, release) -> None:
        """One-sided READ service, completion-driven: resolve the
        blocks here on the serve worker, post the response descriptor,
        return.  The serve's byte credits are released by the
        send-completion event — not by a worker blocked in sendall —
        so the credit budget still bounds resident serve memory while
        the worker moves on."""
        ctx = None
        if RECORDER.enabled:
            # t_enq → now spans the serve queue AND credit wait
            ctx = wire._req_trace(payload)
            fr_event(
                "transport", "serve_admit",
                trace_id=ctx[0] if ctx else 0,
                span_id=ctx[1] if ctx else 0,
                wait_us=0 if t_enq is None
                else int((time.monotonic() - t_enq) * 1e6),
                bytes=wire._req_cost(payload),
            )
        parts = wire.build_read_response_parts(
            self.node, payload, self.peer
        )
        if parts is None:
            release()
            return
        t0 = time.monotonic()

        def sent(err):
            release()
            if err is not None:
                logger.warning("read response to %s failed", self.peer)
            elif ctx is not None and RECORDER.enabled:
                fr_event(
                    "transport", "serve_send",
                    trace_id=ctx[0], span_id=ctx[1],
                    us=int((time.monotonic() - t0) * 1e6),
                )

        # drain=True: this serve worker finishes the send itself
        # (blocking-sendall shape, no loop round trips) and the credits
        # release right when the last byte reaches the kernel
        self._post_op(
            self._frame_op(wire.OP_READ_RESP, parts, 1, sent), drain=True,
        )

    # -- teardown ------------------------------------------------------------
    def _fail_outstanding(self, err: BaseException) -> None:
        with self._reads_lock:
            reads = list(self._reads.values())
            self._reads.clear()
            self._rx_outstanding = 0
        if reads:
            self._m_fail_outstanding.inc()
        for entry in reads:
            self._fail(entry[1], err)
            self._release_budget()

    def _on_loop_dead(self, err: BaseException) -> None:
        if self.state not in (ChannelState.STOPPED,):
            self._error(err)
        self._fail_outstanding(err)
        # cache/passive/read-group cleanup, exactly like the threaded
        # reader loop's exit path — a dead peer must not pin its cache
        # slots until node teardown
        self.node.on_channel_dead(self)

    def _loop_fail(self, err: BaseException) -> None:  # on-loop
        if self._closed:
            return
        with self._tx_lock:
            if self._closed:
                return
            self._closed = True
            tx, self._tx = list(self._tx), deque()
            if self._tx_bytes:
                self._m_backlog.dec(self._tx_bytes)
            self._tx_bytes = 0
            if self._registered:
                self._disp.sel_unregister(self._sock)
                self._registered = False
            # shutdown wakes a completion worker blocked in an
            # offloaded recv; close INSIDE the lock: an inline sender
            # mid-sendmsg holds it, so the fd can never be reused
            # under a write in flight.  While a worker owns the recv
            # side the close is DEFERRED to it (same fd-reuse safety).
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            if not self._rx_offloaded:
                self._close_fd_locked()
        # a read mid-body when the channel died: its entry already left
        # _reads, so _fail_outstanding no longer covers it — fail it
        # here.  NOT while a streaming worker owns the recv machine
        # (_rx_entry/_rx_outstanding are the machine owner's state):
        # the shutdown above wakes the worker, which either fails the
        # entry itself (channel seen closed) or posts _offload_done,
        # whose _loop_fail re-runs this block with ownership back
        if not self._rx_offloaded:
            entry, self._rx_entry = self._rx_entry, None
            if entry is not None:
                with self._reads_lock:
                    self._rx_outstanding -= entry[5]
                self._disp.complete(self._deliver, entry[1], None, err,
                                    entry[2])
        for op in tx:
            op.tkt.release()  # releases: dispatcher.send_ops
            op._transition("failed")
            if op.on_done is not None:
                self._disp.complete(op.on_done, err)
        self._disp.complete(self._on_loop_dead, err)

    def _loop_close(self) -> None:  # on-loop
        self._loop_fail(TransportError("channel stopped"))

    def loop_close(self, err) -> None:  # on-loop
        """Dispatcher-teardown/handler-failure entry (the generic
        handler close contract shared with Acceptor/_Handshake)."""
        self._loop_fail(err if err is not None
                        else TransportError("channel stopped"))

    def stop(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        err = TransportError("channel stopped")
        with self._reads_lock:
            reads = list(self._reads.values())
            self._reads.clear()
        for entry in reads:
            self._safe_fail(entry[1], err)
        super().stop()
        try:
            self._disp.post(self._loop_close)
        except TransportError:
            # loop already gone: it cannot close the fd for us
            self._fail_tx(err)
            with self._tx_lock:
                self._closed = True
                # a streaming worker may still own the fd: shutdown()
                # above wakes it and IT closes via _close_fd_locked —
                # never close out from under it here
                if not self._rx_offloaded:
                    self._close_fd_locked()

    def reply_channel(self) -> Channel:
        """Replies ride the same socket."""
        return self


__all__ = ["Dispatcher", "Acceptor", "AsyncTcpChannel"]
