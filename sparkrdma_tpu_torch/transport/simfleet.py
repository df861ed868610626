"""Dry-run peer fleet: N wire-protocol peers on ONE selector thread.  The
port of ``sparkrdma_tpu/transport/simfleet.py``; its
:class:`ProcessCluster` places every manager on a device (see there).

Scale tests and the fabric-scale bench need hundreds of fetchable peers
without paying hundreds of real :class:`~sparkrdma_tpu_torch.transport.node.Node`
instances (each with its own dispatcher loop and pools — the very cost
the bounded fabric exists to avoid paying per peer).  A
:class:`SimPeerFleet` listens on ``n_peers`` consecutive ports and
speaks just enough of the TCP wire protocol (transport/tcp.py framing)
to serve the fetch path:

- the 9-byte connect hello is acked (any channel type),
- ``OP_READ_REQ`` frames are answered with ``OP_READ_RESP`` served
  from one shared pattern buffer (``BlockLocation.address`` indexes
  into it; ``mkey`` is ignored), so striped sub-range reads reassemble
  bit-exactly,
- ``OP_RPC`` frames are swallowed.

Everything — all listeners and every accepted connection — runs on a
single daemon thread with non-blocking sockets, so a 256-peer fleet
costs one thread plus its sockets.  The node under test connects to
``fleet.addresses[i]`` through the REAL engines (threaded or async);
only the far side is simulated.
"""

from __future__ import annotations

import logging
import selectors
import socket
import threading
import time
from typing import List, Tuple

from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.transport import tcp as wire
from sparkrdma_tpu_torch.utils.statemachine import StateMachine

logger = logging.getLogger(__name__)

_MAX_RX = 1 << 20


class _Conn:
    __slots__ = ("sock", "rx", "tx", "hello_done")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rx = bytearray()
        self.tx = bytearray()
        self.hello_done = False


class SimPeerFleet:
    """``n_peers`` fake wire-protocol peers on one selector thread."""

    def __init__(self, n_peers: int, base_port: int, pattern,
                 host: str = "127.0.0.1"):
        self._pattern = memoryview(pattern).cast("B")
        self.addresses: List[Tuple[str, int]] = []
        self._sel = selectors.DefaultSelector()
        self._listeners: List[socket.socket] = []
        self._conns: dict = {}
        self._stop = threading.Event()
        # wake pipe so stop() interrupts a parked select
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        for i in range(n_peers):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                srv.bind((host, base_port + i))
                srv.listen(64)
            except OSError:
                srv.close()
                self.close()
                raise
            srv.setblocking(False)
            self._sel.register(srv, selectors.EVENT_READ, "accept")
            self._listeners.append(srv)
            self.addresses.append((host, base_port + i))
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="simfleet",
        )
        self._thread.start()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        for srv in self._listeners:
            try:
                srv.close()
            except OSError:
                pass
        for conn in list(self._conns.values()):
            try:
                conn.sock.close()
            except OSError:
                pass
        self._conns.clear()
        try:
            self._sel.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()

    # -- event loop ----------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            for key, events in self._sel.select(timeout=1.0):
                if self._stop.is_set():
                    return
                if key.data == "wake":
                    return
                if key.data == "accept":
                    self._accept(key.fileobj)
                    continue
                conn = key.data
                try:
                    if events & selectors.EVENT_READ:
                        self._readable(conn)
                    if (conn.sock in self._conns
                            and events & selectors.EVENT_WRITE):
                        self._flush(conn)
                except Exception:
                    logger.exception("simfleet connection failed")
                    self._drop(conn)

    def _accept(self, srv) -> None:
        try:
            sock, _addr = srv.accept()
        except OSError:
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        del self._conns[conn.sock]
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        conn.rx += chunk
        self._process(conn)

    def _process(self, conn: _Conn) -> None:
        rx = conn.rx
        if not conn.hello_done:
            if len(rx) < wire._HELLO.size:
                return
            magic, _ct, _port, version = wire._HELLO.unpack_from(rx, 0)
            del rx[:wire._HELLO.size]
            if magic != wire._MAGIC:
                self._drop(conn)
                return
            if not (wire.MIN_WIRE_VERSION <= version <= wire.WIRE_VERSION):
                # same structured rejection real acceptors send: the
                # dialing engine surfaces both versions in its error
                self._send(conn, b"\x00" + wire._HELLO_REJ.pack(
                    wire.WIRE_VERSION, version))
                self._drop(conn)
                return
            conn.hello_done = True
            self._send(conn, b"\x01")
        while len(rx) >= wire._HDR.size:
            opcode, length = wire._HDR.unpack_from(rx, 0)
            if len(rx) < wire._HDR.size + length:
                if len(rx) > _MAX_RX + wire._HDR.size + length:
                    self._drop(conn)
                return
            payload = bytes(rx[wire._HDR.size:wire._HDR.size + length])
            del rx[:wire._HDR.size + length]
            if opcode == wire.OP_READ_REQ:
                self._serve_read(conn, payload)
            # OP_RPC frames are swallowed: the fleet has no control plane

    def _serve_read(self, conn: _Conn, payload: bytes) -> None:
        req_id, count = wire._REQ_HDR.unpack_from(payload, 0)
        if RECORDER.enabled:
            # the requester's trace context rides the request's v2
            # tail — the fleet's serve events join its trace exactly
            # like a real peer's would
            ctx = wire._req_trace(payload)
            t0 = time.monotonic()
        parts = [wire._RESP_HDR.pack(req_id, 0)]
        off = wire._REQ_HDR.size
        try:
            for _ in range(count):
                addr, length, _mkey = wire._LOC.unpack_from(payload, off)
                off += wire._LOC.size
                if addr < 0 or addr + length > self._pattern.nbytes:
                    raise ValueError(
                        f"read [{addr},{addr + length}) outside the "
                        f"{self._pattern.nbytes}B pattern"
                    )
                parts.append(wire._LEN.pack(length))
                parts.append(self._pattern[addr:addr + length])
        except Exception as e:
            parts = [
                wire._RESP_HDR.pack(req_id, 1),
                str(e).encode("utf-8", "replace"),
            ]
        body = b"".join(bytes(p) for p in parts)
        if RECORDER.enabled:
            fr_event(
                "transport", "serve_read",
                trace_id=ctx[0] if ctx else 0,
                span_id=ctx[1] if ctx else 0,
                blocks=count,
                us=int((time.monotonic() - t0) * 1e6),
            )
        self._send(
            conn, wire._HDR.pack(wire.OP_READ_RESP, len(body)) + body
        )

    def _send(self, conn: _Conn, data: bytes) -> None:
        conn.tx += data
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        while conn.tx:
            try:
                n = conn.sock.send(conn.tx)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop(conn)
                return
            del conn.tx[:n]
        events = selectors.EVENT_READ
        if conn.tx:
            events |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass


def _fleet_proc_main(n_peers, base_port, pattern, dump_path, host,
                     ready, stop) -> None:
    """Entry point of the spawned fleet process: serve until ``stop``,
    then leave a flight-recorder dump at ``dump_path`` so the parent
    can merge this process's serve spans with its own trace
    (obs/collect.py)."""
    RECORDER.retain()
    try:
        fleet = SimPeerFleet(n_peers, base_port, pattern, host=host)
    except OSError as e:
        ready.put(("err", str(e)))
        return
    ready.put(("ok", fleet.addresses))
    stop.wait()
    fleet.close()
    if dump_path:
        RECORDER.dump("fleet_stop", path=dump_path)
    RECORDER.release()


class SimPeerFleetProc:
    """A :class:`SimPeerFleet` in its OWN process (multiprocessing
    spawn — the module chain stays free of the device stack, so spawn is
    cheap).

    The point is cross-process observability: the child retains the
    flight recorder, its ``serve_read`` events carry the requester's
    trace context off the wire, and ``close()`` leaves a dump at
    ``dump_path`` for the parent to merge — a 2-process run then
    yields ONE trace spanning requester and server spans."""

    def __init__(self, n_peers: int, base_port: int, pattern,
                 dump_path: str = "", host: str = "127.0.0.1",
                 start_timeout: float = 30.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._stop = ctx.Event()
        ready = ctx.Queue()
        self.dump_path = dump_path
        self._proc = ctx.Process(
            target=_fleet_proc_main,
            args=(n_peers, base_port, bytes(pattern), dump_path, host,
                  ready, self._stop),
            daemon=True,
        )
        self._proc.start()
        try:
            status, detail = ready.get(timeout=start_timeout)
        except Exception:
            self._proc.terminate()
            raise RuntimeError("simfleet subprocess did not come up")
        if status != "ok":
            self._proc.join(timeout=5)
            raise OSError(f"simfleet subprocess bind failed: {detail}")
        self.addresses: List[Tuple[str, int]] = detail

    def close(self) -> None:
        self._stop.set()
        self._proc.join(timeout=15)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)


# ---------------------------------------------------------------------------
# ProcessCluster: driver + N executor TpuShuffleManager PROCESSES
# ---------------------------------------------------------------------------
#
# Where SimPeerFleet fakes the far side of the wire, ProcessCluster is
# the real thing: every executor is a full TpuShuffleManager in its own
# spawned interpreter with its own TcpNetwork, decode pool, and serve
# threads — processes sidestep the GIL, so the overlap planes finally
# run concurrently on multi-core hosts.  The parent holds the driver
# manager; each child gets the driver's BOUND port written into its
# conf (bound-port broadcast), says hello over real sockets, and then
# serves a small picklable command protocol over a duplex pipe:
#
#   register   declarative shuffle spec (partitioner/aggregator KINDS,
#              not objects — Aggregator holds lambdas and can't pickle)
#   write      explicit records, or a named deterministic generator so
#              benchmark data is made in-child and never rides the pipe
#   read       records back, or an order-independent digest (count /
#              sum / xor of per-record CRCs via the native crc kernel)
#   metrics    registry snapshot + process census (cpu, fds, threads)
#   stop       manager.stop() — writes metrics JSON + flight-recorder
#              dump (conf paths), then the child exits
#
# Lifecycle: start → ready barrier (pipe acks AND driver.executors
# census) → commands → stop/kill → collect() merges per-process
# flight-recorder dumps through obs/collect.merge_dumps.

_PORT_SPACING = 40  # > portMaxRetries so per-child bind hunts don't collide


def _process_census() -> dict:
    """CPU/fd/thread census of THIS process (parent and children both
    report through it, so bench_cluster can sum a fleet)."""
    import os

    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = -1
    t = os.times()
    return {
        "pid": os.getpid(),
        "cpu_user_s": t.user,
        "cpu_sys_s": t.system,
        "fds": fds,
        "threads": threading.active_count(),
    }


def _build_partitioner(spec):
    """('hash', n) | ('range', n, sample) → a Partitioner, in-child."""
    from sparkrdma_tpu_torch.shuffle.partitioner import (
        HashPartitioner,
        RangePartitioner,
    )

    kind = spec[0]
    if kind == "hash":
        return HashPartitioner(int(spec[1]))
    if kind == "range":
        return RangePartitioner(int(spec[1]), list(spec[2]))
    raise ValueError(f"unknown partitioner spec {spec!r}")


def _build_aggregator(kind):
    """None | 'group' | 'sum' | 'min' | 'max' → an Aggregator, in-child
    (lambdas live here; only the KIND crosses the pipe)."""
    if not kind:
        return None
    from sparkrdma_tpu_torch.shuffle.manager import ColumnarAggregator

    if kind == "group":
        return ColumnarAggregator.group()
    return ColumnarAggregator.reduce(kind)


def _gen_records(gen: dict, map_id: int):
    """Named deterministic record generators — data is born in the
    executor process so benchmark payloads never cross the pipe."""
    import random

    kind = gen["kind"]
    n = int(gen.get("records", 1000))
    seed = int(gen.get("seed", 0x5eed)) + map_id * 7919
    rng = random.Random(seed)
    if kind == "terasort":
        vlen = int(gen.get("value_len", 90))
        return [
            (rng.getrandbits(80).to_bytes(10, "big"),
             bytes([(seed + i) & 0xFF]) * vlen)
            for i in range(n)
        ]
    if kind == "wordcount":
        vocab = [f"word{j:04d}" for j in range(int(gen.get("vocab", 97)))]
        return [(vocab[rng.randrange(len(vocab))], 1) for _ in range(n)]
    raise ValueError(f"unknown generator {kind!r}")


def records_digest(records) -> dict:
    """Order-independent digest of a record set: per-record pickle
    CRCs combined by count/sum/xor, so two readers agree no matter the
    arrival order.  The CRC batch rides the native ``crc32_spans``
    kernel when built, with the zlib loop as the pure-Python path."""
    import pickle
    import zlib

    import numpy as np

    from sparkrdma_tpu_torch.memory.staging import native_crc32_spans

    parts = [pickle.dumps(r, 4) for r in records]
    crcs = None
    if parts:
        # span table built as an int64 array (not tuple pairs): the
        # native call then starts without a list→ndarray conversion
        lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
        spans = np.empty((len(parts), 2), np.int64)
        np.cumsum(lens, out=spans[:, 1])
        np.subtract(spans[:, 1], lens, out=spans[:, 0])
        crcs = native_crc32_spans(bytearray().join(parts), spans)
    if crcs is None:
        crcs = [zlib.crc32(p) for p in parts]
    acc_sum = 0
    acc_xor = 0
    for c in crcs:
        acc_sum = (acc_sum + int(c)) & 0xFFFFFFFFFFFFFFFF
        acc_xor ^= int(c)
    return {"count": len(parts), "sum": acc_sum, "xor": acc_xor}


def _cmd_register(mgr, handles, *, shuffle_id, num_maps, partitioner,
                  aggregator=None, map_side_combine=False,
                  key_ordering=False):
    handles[shuffle_id] = mgr.register_shuffle(
        int(shuffle_id), int(num_maps), _build_partitioner(partitioner),
        _build_aggregator(aggregator), map_side_combine=map_side_combine,
        key_ordering=key_ordering,
    )
    return {"shuffle_id": shuffle_id}


def _cmd_write(mgr, handles, *, shuffle_id, map_id, records=None,
               gen=None):
    if records is None:
        records = _gen_records(gen, int(map_id))
    writer = mgr.get_writer(handles[shuffle_id], int(map_id))
    writer.write(iter(records))
    writer.stop(True)
    return {"map_id": map_id, "records": len(records)}


def _cmd_read(mgr, handles, *, shuffle_id, start, end, maps_by_host,
              digest=False):
    reader = mgr.get_reader(
        handles[shuffle_id], int(start), int(end), maps_by_host,
    )
    records = list(reader.read())
    out = {"records": len(records)}
    if digest:
        out["digest"] = records_digest(records)
    else:
        out["data"] = records
    return out


def _cmd_metrics(mgr, handles):
    from sparkrdma_tpu_torch.metrics import get_registry

    reg = get_registry()
    return {
        "executor_id": mgr.executor_id,
        "census": _process_census(),
        "metrics": reg.snapshot() if reg.enabled else {},
    }


_EXEC_COMMANDS = {
    "register": _cmd_register,
    "write": _cmd_write,
    "read": _cmd_read,
    "metrics": _cmd_metrics,
}


def _executor_proc_main(idx, conf_map, host, port_base, log_path,
                        conn, device="cpu") -> None:
    """Spawned executor entry: set this process's device (``device``, a
    string: ``"cpu"`` or ``"cuda:<k>"``, selected before anything else
    touches CUDA), build a full TpuShuffleManager on it (its __init__
    says hello to the driver over the real socket), ack readiness on the
    pipe, then serve commands until stop/EOF."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    if log_path:
        logging.basicConfig(
            filename=log_path, level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    from sparkrdma_tpu_torch.conf import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.transport.tcp import TcpNetwork

    try:
        mgr = TpuShuffleManager(
            TpuShuffleConf(conf_map), is_driver=False,
            network=TcpNetwork(), host=host, port=port_base,
            executor_id=str(idx), stage_to_device=False, device=device,
        )
    except Exception as e:  # bind/hello failure → structured nack
        try:
            conn.send(("err", type(e).__name__, str(e), ""))
        except OSError:
            pass
        return
    import os

    conn.send(("ready", {
        "pid": os.getpid(),
        "smid": mgr.local_smid,
        "address": mgr.node.address,
    }))
    handles: dict = {}
    try:
        while True:
            try:
                cmd, kwargs = conn.recv()
            except (EOFError, OSError):
                break  # parent died — fall through to manager teardown
            if cmd == "stop":
                break
            fn = _EXEC_COMMANDS.get(cmd)
            try:
                if fn is None:
                    raise ValueError(f"unknown cluster command {cmd!r}")
                result = fn(mgr, handles, **kwargs)
                conn.send(("ok", result))
            except Exception as e:
                import traceback

                try:
                    conn.send(("err", type(e).__name__, str(e),
                               traceback.format_exc()))
                except OSError:
                    break
    finally:
        # stop() writes the metrics JSON and flight-recorder dump the
        # parent's collect() merges (conf metricsJsonPath /
        # flightRecorderDumpPath, both suffixed/tagged per process)
        try:
            mgr.stop()
        except Exception:
            logger.exception("executor %s stop failed", idx)
        try:
            conn.send(("ok", {"stopped": True}))
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass


class ExecutorDiedError(RuntimeError):
    """The executor process went away mid-command (crash/kill)."""


class ExecutorCommandError(RuntimeError):
    """A command raised in the executor; carries the remote type name."""

    def __init__(self, kind: str, message: str, tb: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.remote_traceback = tb


class ExecutorProcess:
    """One spawned executor: process + command pipe.  ``send``/``recv``
    are split so callers can overlap commands across the fleet (and so
    the crash test can park a read while killing a sibling)."""

    def __init__(self, idx: int, conf_map: dict, host: str,
                 port_base: int, log_path: str = "", device: str = "cpu"):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.idx = idx
        self.log_path = log_path
        self.info: dict = {}
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_executor_proc_main,
            args=(idx, conf_map, host, port_base, log_path, child_conn,
                  device),
            daemon=True, name=f"cluster-exec-{idx}",
        )
        self._proc.start()
        child_conn.close()

    @property
    def alive(self) -> bool:
        return self._proc.is_alive()

    @property
    def pid(self):
        return self._proc.pid

    def wait_ready(self, timeout: float) -> dict:
        if not self._conn.poll(timeout):
            raise ExecutorDiedError(
                f"executor {self.idx}: not ready within {timeout:.0f}s"
            )
        try:
            msg = self._conn.recv()
        except (EOFError, OSError) as e:
            raise ExecutorDiedError(
                f"executor {self.idx}: died during startup ({e})"
            ) from e
        if msg[0] != "ready":
            raise ExecutorDiedError(
                f"executor {self.idx} failed to start: {msg[1:]}"
            )
        self.info = msg[1]
        return self.info

    def send(self, cmd: str, **kwargs) -> None:
        try:
            self._conn.send((cmd, kwargs))
        except (OSError, BrokenPipeError) as e:
            raise ExecutorDiedError(
                f"executor {self.idx}: pipe closed ({e})"
            ) from e

    def recv(self, timeout: float = 120.0):
        try:
            if not self._conn.poll(timeout):
                raise TimeoutError(
                    f"executor {self.idx}: no reply within {timeout:.0f}s"
                )
            msg = self._conn.recv()
        except (EOFError, OSError) as e:
            raise ExecutorDiedError(
                f"executor {self.idx}: died mid-command ({e})"
            ) from e
        if msg[0] == "ok":
            return msg[1]
        raise ExecutorCommandError(msg[1], msg[2],
                                   msg[3] if len(msg) > 3 else "")

    def call(self, cmd: str, timeout: float = 120.0, **kwargs):
        self.send(cmd, **kwargs)
        return self.recv(timeout)

    def kill(self) -> None:
        """SIGKILL — the crash-mid-stage path.  No goodbye, no dump."""
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join(timeout=10)

    def stop(self, timeout: float = 30.0) -> bool:
        """Graceful stop; True when the child acked its teardown."""
        acked = False
        try:
            self.send("stop")
            acked = bool(self.recv(timeout))
        except (ExecutorDiedError, ExecutorCommandError, TimeoutError):
            pass
        self._proc.join(timeout=timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        try:
            self._conn.close()
        except OSError:
            pass
        return acked


class ProcessCluster(StateMachine):
    """Driver in THIS process + ``n_executors`` full shuffle-manager
    processes over real TCP sockets.

    Keep ``base_port`` below the kernel ephemeral range (use 2xxxx
    bases); the driver binds at ``base_port`` (with the manager's own
    retry hunt), each executor at ``base_port + 100 + idx * 40``.
    ``workdir`` receives per-process logs, metrics JSONs, and
    flight-recorder dumps; ``collect()`` folds the dumps into one
    merged trace document via obs/collect.merge_dumps.

    ``device`` places the managers: CUDA by default (an error without
    it), where the driver runs on the current card and executor ``i``
    on card ``i % torch.cuda.device_count()`` (each spawned process
    selects its card before it touches CUDA, so they do not all land on
    card 0); an explicit ``"cuda:<k>"`` puts every executor on card k,
    and ``"cpu"`` (the tests) keeps every manager on the CPU."""

    MACHINE = "cluster.proc"
    STATES = ("running", "stopping", "stopped")
    INITIAL = "running"
    TERMINAL = ("stopped",)
    TRANSITIONS = {
        "running": ("stopping",),
        "stopping": ("stopped",),
    }

    def __init__(self, n_executors: int, base_port: int,
                 conf: dict = None, host: str = "127.0.0.1",
                 workdir: str = "", start_timeout: float = 180.0,
                 device=None):
        import os
        import tempfile

        import torch

        from sparkrdma_tpu_torch.conf import TpuShuffleConf
        from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
        from sparkrdma_tpu_torch.transport.tcp import TcpNetwork

        self.n_executors = n_executors
        self.host = host
        self._own_workdir = not workdir
        self.workdir = workdir or tempfile.mkdtemp(prefix="tpucluster-")
        os.makedirs(self.workdir, exist_ok=True)
        base = dict(conf or {})
        pfx = TpuShuffleConf.PREFIX
        base.setdefault(pfx + "metricsJsonPath",
                        os.path.join(self.workdir, "metrics.json"))
        base.setdefault(pfx + "flightRecorderDumpPath", self.workdir)
        self.driver = TpuShuffleManager(
            TpuShuffleConf(dict(base)), is_driver=True,
            network=TcpNetwork(), host=host, port=base_port,
            stage_to_device=False, device=device,
        )
        dev = self.driver.device
        spread = dev.type == "cuda" and (
            device is None or torch.device(device).index is None)
        self.executor_devices = [
            f"cuda:{i % torch.cuda.device_count()}" if spread else str(dev)
            for i in range(n_executors)
        ]
        self.executors: List[ExecutorProcess] = []
        self._state = "running"  # state: cluster.proc
        try:
            # bound-port broadcast: children dial the port the driver
            # ACTUALLY bound, not the one we asked for
            child_base = dict(base)
            child_base[pfx + "driverHost"] = host
            child_base[pfx + "driverPort"] = self.driver.node.address[1]
            for i in range(n_executors):
                self.executors.append(ExecutorProcess(
                    i, dict(child_base), host,
                    base_port + 100 + i * _PORT_SPACING,
                    log_path=os.path.join(self.workdir, f"executor-{i}.log"),
                    device=self.executor_devices[i],
                ))
            deadline = time.monotonic() + start_timeout
            for ex in self.executors:
                ex.wait_ready(max(1.0, deadline - time.monotonic()))
            # second half of the barrier: the driver's own census —
            # every hello landed, so maps_by_host routing is live
            while len(self.driver.executors) < n_executors:
                if time.monotonic() > deadline:
                    raise ExecutorDiedError(
                        f"driver saw {len(self.driver.executors)}/"
                        f"{n_executors} hellos within {start_timeout:.0f}s"
                    )
                time.sleep(0.02)
        except Exception:
            self.stop(graceful=False)
            raise

    # -- command fan-out -----------------------------------------------------
    def call(self, idx: int, cmd: str, timeout: float = 120.0, **kwargs):
        return self.executors[idx].call(cmd, timeout=timeout, **kwargs)

    def broadcast(self, cmd: str, timeout: float = 120.0, **kwargs):
        """Send to every executor, THEN collect — commands overlap
        across the fleet instead of serializing through one pipe."""
        for ex in self.executors:
            ex.send(cmd, **kwargs)
        return [ex.recv(timeout) for ex in self.executors]

    def register(self, shuffle_id: int, num_maps: int, partitioner,
                 aggregator=None, **kwargs):
        return self.broadcast(
            "register", shuffle_id=shuffle_id, num_maps=num_maps,
            partitioner=partitioner, aggregator=aggregator, **kwargs,
        )

    def maps_by_host(self, shuffle_id: int):
        return self.driver.maps_by_host(shuffle_id)

    def wait_published(self, shuffle_id: int, num_maps: int,
                       timeout: float = 60.0):
        """Block until the driver has seen ``num_maps`` map outputs."""
        deadline = time.monotonic() + timeout
        while True:
            mbh = self.driver.maps_by_host(shuffle_id)
            if sum(len(v) for v in mbh.values()) >= num_maps:
                return mbh
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shuffle {shuffle_id}: {mbh} after {timeout:.0f}s"
                )
            time.sleep(0.02)

    def read(self, idx: int, shuffle_id: int, start: int, end: int,
             digest: bool = False, timeout: float = 120.0):
        return self.call(
            idx, "read", timeout=timeout, shuffle_id=shuffle_id,
            start=start, end=end,
            maps_by_host=self.driver.maps_by_host(shuffle_id),
            digest=digest,
        )

    def census(self) -> dict:
        """Fleet-wide process census: driver + every live executor."""
        out = {"driver": _process_census(), "executors": {}}
        for ex in self.executors:
            if not ex.alive:
                continue
            try:
                out["executors"][ex.idx] = ex.call("metrics", timeout=30.0)
            except (ExecutorDiedError, TimeoutError):
                pass
        return out

    # -- lifecycle -----------------------------------------------------------
    def kill(self, idx: int) -> None:
        self.executors[idx].kill()

    def stop(self, graceful: bool = True) -> None:
        if self._state != "running":
            return
        self._transition("stopping", frm="running")
        # deliberate shutdown must not race the heartbeat monitor into
        # declaring executor deaths (manager.quiesce contract)
        try:
            self.driver.quiesce()
        except Exception:
            pass
        for ex in self.executors:
            if graceful and ex.alive:
                ex.stop()
            else:
                ex.kill()
        try:
            self.driver.stop()
        except Exception:
            logger.exception("cluster driver stop failed")
        self._transition("stopped", frm="stopping")

    def collect(self) -> dict:
        """Merge every per-process flight-recorder dump in ``workdir``
        into one trace document (obs/collect merge path); also lists
        the metrics JSONs and logs the run left behind."""
        import glob
        import os

        from sparkrdma_tpu_torch.obs.collect import merge_dumps

        dumps = sorted(
            glob.glob(os.path.join(self.workdir, "flightrec-*.json")))
        merged = merge_dumps(dumps) if dumps else {"merged": True,
                                                  "processes": []}
        merged["dump_paths"] = dumps
        merged["metrics_paths"] = sorted(
            glob.glob(os.path.join(self.workdir, "metrics.json*")))
        merged["log_paths"] = sorted(
            glob.glob(os.path.join(self.workdir, "executor-*.log")))
        return merged

    def close(self) -> None:
        """stop() + scrub the workdir when the cluster owns it."""
        self.stop()
        if self._own_workdir:
            import shutil

            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self) -> "ProcessCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = [
    "ExecutorCommandError",
    "ExecutorDiedError",
    "ExecutorProcess",
    "ProcessCluster",
    "SimPeerFleet",
    "SimPeerFleetProc",
    "records_digest",
]
