"""Tile-round byte exchange over the exchange group: the port of
``sparkrdma_tpu/parallel/exchange.py``.

This is the data-plane inversion at the core of the design (SURVEY.md
§7 "Hard parts"): the reference's reducers *pull* exactly the bytes
they want with one-sided RDMA READs (RdmaChannel.java:441-474); SPMD
collectives instead need every rank participating in lockstep with
static shapes.  The resolution:

- The control plane still resolves exact block locations (unchanged).
- The data plane buckets each (src -> dst) byte stream into fixed-size
  padded *tiles* and runs synchronised ``all_to_all`` rounds over the
  group; the host-side :class:`ExchangePlan` knows exactly which slice
  of which stream rides in which round, so no in-band framing is
  needed.
- Round count is the global max over pairs (lockstep), tile size is the
  ``shuffle_read_block_size`` analog (``conf.exchange_tile_bytes``), and
  the bounded number of rounds in flight is the ``maxBytesInFlight``
  window (RdmaShuffleFetcherIterator.scala:241-251).

The JAX ``TileExchange`` is single-controller: one process drives a
mesh of D devices.  The port runs one process per GPU
(``parallel/group.py``), so every method runs rank-locally, as the JAX
package's multi-process contract reads: every rank passes the same
``lengths [D, D]`` and only its own source row, and gets back a
:class:`HostLocalStreams` in which only row ``rank`` is addressable (at
D = 1, every row).

Where the bytes go on a card.  The analog of SparkRDMA's registered
memory is pinned host memory: every host buffer a copy reads or writes
asynchronously is pinned, and the host reads a received buffer only
after the CUDA event of its copy has completed.

- Host-staged tile rounds (:meth:`TileExchange.exchange_bytes`,
  :meth:`TileExchange.exchange_into`): the rank fills its ``[D, tile]``
  row of round r into a pinned buffer (pad spans are written as zeros,
  never left stale), copies it to the card, runs ``all_to_all`` over
  the group, and copies the received ``[S, tile]`` back into pinned
  memory on a copy stream; at most ``max_rounds_in_flight`` rounds are
  in flight.
- :meth:`TileExchange.exchange_padded`: the rank's
  :class:`PaddedSourceRow` goes to the card in one copy.  Full shot:
  one ``all_to_all`` of its ``[D, C]`` row and one copy of the received
  ``[S, C]`` into a pinned matrix that the views keep alive.  Windowed:
  round r's tile is a slice of the one resident row on the card, its
  collective runs on the current stream and its copy back on a copy
  stream ordered by events, so that it overlaps round r + 1's
  collective; ``on_round`` fires once round r's event has completed.
- :meth:`TileExchange.a2a`: a ``[D, C]`` tensor already on the card.

4-byte words ride the collective as an int32 view (bit-identical),
other buffers as uint8; the ranks agree on the choice
(``ExchangeGroup.agree_max``), so the collective's shape never differs
between them.  On a CUDA group every collective is NCCL on CUDA
tensors, and a failed copy or collective raises; on the CPU (the tests'
gloo groups) the same code runs with plain host memory and synchronous
copies.
"""

from __future__ import annotations

import math
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.memory.device_arena import (
    DeviceStagingBridge,
    host_bytes,
)
from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.parallel.device import DeviceLike
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup
from sparkrdma_tpu_torch.transport.channel import TransportError


class ExchangeIntegrityError(TransportError):
    """A received stream failed its end-to-end checksum.

    The collective analog of a CQ completion with error status
    (RdmaChannel.java:611-615): a device or link fault inside a
    collective corrupts silently instead of failing a channel.
    Subclasses :class:`TransportError` so any layer that converts
    transport failures to stage-retryable fetch failures handles
    corruption the same way.  Opt in via the ``verify_integrity``
    constructor flag, or ``spark.shuffle.tpu.verifyExchangeIntegrity``
    through :meth:`TileExchange.from_conf` — the comparison costs
    O(payload) host time."""

    def __init__(self, src: int, dst: int, expected: int, got: int):
        super().__init__(
            f"stream {src}->{dst} corrupt: crc32 {got:#010x} != "
            f"expected {expected:#010x}"
        )
        self.src = src
        self.dst = dst
        self.expected = expected
        self.got = got


# tiles are padded to lane multiples so uint8 rows lay out cleanly (and
# always split into 4-byte words)
TILE_ALIGN = 128
WORD = DeviceStagingBridge.WORD  # int32 words over uint8 lanes


def row_offsets(lengths_1d) -> np.ndarray:
    """Exclusive prefix sums of one lengths row/column: stream ``i`` of
    a contiguous exchange row occupies ``[offs[i], offs[i + 1])``.
    Returns int64 ``[D + 1]``."""
    lengths_1d = np.asarray(lengths_1d, np.int64)
    offs = np.zeros(len(lengths_1d) + 1, np.int64)
    np.cumsum(lengths_1d, out=offs[1:])
    return offs


class DestRowView:
    """One destination's received streams as ZERO-COPY slices of one
    contiguous row buffer: ``row[s]`` is the uint8 view of the stream
    from source ``s``."""

    __slots__ = ("buf", "offsets")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray):
        self.buf = buf
        self.offsets = offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, s: int) -> np.ndarray:
        return self.buf[int(self.offsets[s]):int(self.offsets[s + 1])]

    @property
    def nbytes(self) -> int:
        return int(self.offsets[-1])


class PaddedSourceRow:
    """One source's exchange payload in the DEVICE framing: a flat
    uint8 buffer of ``D * cols`` bytes where the stream to destination
    ``d`` occupies ``[d * cols, d * cols + lengths[s, d])`` and the
    tail of each span is zero padding.  ``stream(d, n)`` recovers the
    compact view a host-staged consumer expects."""

    __slots__ = ("buf", "cols")

    def __init__(self, buf: np.ndarray, cols: int):
        self.buf = buf
        self.cols = int(cols)

    def stream(self, d: int, n: int) -> np.ndarray:
        """Zero-copy view of the payload bytes headed to destination
        ``d`` (``n`` = that stream's true length, excluding padding)."""
        o = d * self.cols
        return self.buf[o : o + n]

    @property
    def nbytes(self) -> int:
        return int(self.buf.nbytes)


class PaddedDestRowView:
    """One destination's received streams as rows of one padded
    ``[S, cols]`` matrix: ``row[s]`` is the uint8 view of the first
    ``lengths[s]`` bytes of source ``s``'s row — the device-plane
    sibling of :class:`DestRowView`.

    ``keepalive`` holds whatever owns the matrix memory (the pinned
    host tensor the full-shot path copies the collective's output into)
    for the life of the views handed out."""

    __slots__ = ("mat", "lengths", "keepalive")

    def __init__(self, mat: np.ndarray, lengths: np.ndarray,
                 keepalive=None):
        self.mat = mat
        self.lengths = np.asarray(lengths, np.int64)
        self.keepalive = keepalive

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, s: int) -> np.ndarray:
        return self.mat[s, : int(self.lengths[s])]

    @property
    def nbytes(self) -> int:
        return int(self.lengths.sum())


class NonAddressableStreamError(TransportError):
    """A caller touched a destination row that another rank owns.

    Exchange results are rank-local by construction (each rank receives
    only its own destination row): silently returning empty streams for
    the other destinations would make the API *look* total while
    dropping data, so those rows fail loudly on access."""

    def __init__(self, dst: int, rank: int = 0):
        super().__init__(
            f"destination {dst} is not addressable from group rank "
            f"{rank}: exchange results are rank-local; read this row on "
            f"the rank that owns destination {dst}"
        )
        self.dst = dst


class HostLocalStreams:
    """Result of a rank-local ``exchange_bytes`` (rows are per-source
    ``bytes`` lists) or any ``exchange_into`` / ``exchange_padded``
    (rows are views): list-like [D][S] with only this rank's
    destination rows present.  Indexing another destination raises
    :class:`NonAddressableStreamError`; ``addressable`` lists the valid
    rows.

    There is deliberately no ``__iter__``: plain iteration falls back to
    ``__getitem__(0..)`` and raises the moment it touches another rank's
    row.  Rank-local code iterates ``items()`` explicitly."""

    def __init__(self, rows: List, filled: frozenset, rank: int = 0):
        self._rows = rows
        self.addressable = frozenset(filled)
        self.rank = rank

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, d: int):
        if d not in self.addressable:
            raise NonAddressableStreamError(d, self.rank)
        return self._rows[d]

    def items(self):
        """(destination, row) pairs for this rank's rows."""
        for d in sorted(self.addressable):
            yield d, self._rows[d]


class ExchangePlan:
    """Static plan for one exchange of per-pair streams of known length.

    lengths[s, d] = bytes queued from source s to destination d.
    """

    def __init__(self, lengths: np.ndarray, tile_bytes: int):
        lengths = np.asarray(lengths, dtype=np.int64)
        if lengths.ndim != 2 or lengths.shape[0] != lengths.shape[1]:
            raise ValueError(f"lengths must be [D, D], got {lengths.shape}")
        if (lengths < 0).any():
            raise ValueError("negative stream length")
        self.lengths = lengths
        self.n_devices = lengths.shape[0]
        max_len = int(lengths.max()) if lengths.size else 0
        if max_len == 0:
            self.tile_bytes = 0
            self.rounds = 0
            self.total_cols = 0
            return
        # tile: lane-aligned, no larger than needed for a single round,
        # QUANTIZED to a power-of-two ladder of TILE_ALIGN units below
        # the configured tile, so the distinct collective shapes (and
        # the pinned staging buffers sized by them) stay ~log2(tile /
        # 128) for <= 2x padding on sub-tile exchanges
        cap = max(
            TILE_ALIGN,
            (int(tile_bytes) + TILE_ALIGN - 1) // TILE_ALIGN * TILE_ALIGN,
        )
        if max_len >= cap:
            tile = cap
        else:
            units = (max_len + TILE_ALIGN - 1) // TILE_ALIGN
            tile = min(cap, TILE_ALIGN * (1 << (units - 1).bit_length()))
        self.tile_bytes = tile
        self.rounds = math.ceil(max_len / tile)
        self.total_cols = self.rounds * tile

    @property
    def payload_bytes(self) -> int:
        return int(self.lengths.sum())

    @property
    def moved_bytes(self) -> int:
        """Bytes actually moved per full exchange incl. padding."""
        return self.n_devices * self.n_devices * self.total_cols

    def round_slice(self, r: int) -> Tuple[int, int]:
        """[start, end) byte range of round r within each pair stream."""
        return r * self.tile_bytes, (r + 1) * self.tile_bytes


def _make_row_collect(plan: "ExchangePlan", lengths: np.ndarray,
                      col_offs, get_dst):
    """The ONE per-round destination scatter both byte paths share:
    received tile slices land at their final offsets inside the
    per-destination contiguous rows."""
    D = lengths.shape[0]

    def collect(r: int, d: int, local: np.ndarray) -> None:
        lo, hi = plan.round_slice(r)
        buf = get_dst(d)
        offs = col_offs[d]
        for s in range(D):
            take = min(hi, int(lengths[s, d])) - lo
            if take > 0:
                o = int(offs[s]) + lo
                buf[o : o + take] = local[s, :take]

    return collect


class _Link:
    """The copies of one exchange between host buffers (``host_bytes``:
    pinned on a card) and ``device``: ``non_blocking`` copies and a CUDA
    event per copy back on a card; synchronous copies on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` on the device, on the current stream: an
        asynchronous copy from pinned memory (the caller reuses ``host``
        only after a later event of the same stream), the tensor itself
        on the CPU."""
        if not self.cuda:
            return host
        return host.to(self.device, non_blocking=True)

    def to_host(self, dst: torch.Tensor, src: torch.Tensor):
        """Copy device ``src`` into host ``dst`` on the copy stream,
        after the work queued so far on the current stream.  Returns the
        event the host waits for before it reads ``dst`` (None on the
        CPU, where the copy is done on return)."""
        if not self.cuda:
            dst.copy_(src)
            return None
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        src.record_stream(self.stream)  # its memory outlives the copy
        return done

    @staticmethod
    def wait(done) -> None:
        if done is not None:
            done.synchronize()


class TileExchange:
    """The exchange engine: pack -> all_to_all rounds -> unpack, over an
    exchange group, rank-locally.

    ``exchange_bytes(streams)`` moves ``streams[rank][d]`` (bytes from
    this rank to destination d) and returns row ``rank`` of
    ``out[d][s]``.  Large exchanges run as multiple rounds with at most
    ``max_rounds_in_flight`` rounds in flight.

    ``group`` is an :class:`ExchangeGroup`, a ``torch.distributed``
    process group (wrapped on ``device``), or None: a world of one on
    ``device`` (CUDA unless the caller passes ``device="cpu"``; without
    CUDA it raises).
    """

    def __init__(
        self,
        group=None,
        device: DeviceLike = None,
        tile_bytes: int = 4 << 20,
        max_rounds_in_flight: int = 2,
        verify_integrity: bool = False,
    ):
        self.group = group if isinstance(group, ExchangeGroup) \
            else ExchangeGroup(group, device=device)
        self.device = self.group.device
        self.rank = self.group.rank
        self.n_devices = self.group.size
        self.tile_bytes = int(tile_bytes)
        self.max_rounds_in_flight = max(1, int(max_rounds_in_flight))
        self.verify_integrity = verify_integrity
        # stats (reader-stats analog for the collective plane); payload
        # and padded bytes count the whole exchange, as the JAX
        # package's single controller counts them
        self.rounds_executed = 0
        self.payload_bytes_moved = 0
        self.padded_bytes_moved = 0
        self.integrity_failures = 0
        self.device_exchanges = 0

    @classmethod
    def from_conf(cls, conf, group=None) -> "TileExchange":
        """Build from a conf object (``TpuShuffleConf``, duck-typed):
        wires ``exchange_tile_bytes``, ``exchange_max_rounds_in_flight``
        and ``verify_exchange_integrity``."""
        return cls(
            group,
            tile_bytes=conf.exchange_tile_bytes,
            max_rounds_in_flight=conf.exchange_max_rounds_in_flight,
            verify_integrity=conf.verify_exchange_integrity,
        )

    # -- planning -----------------------------------------------------------
    def plan(self, lengths: np.ndarray) -> ExchangePlan:
        return ExchangePlan(lengths, self.tile_bytes)

    def _check_lengths(self, lengths) -> np.ndarray:
        D = self.n_devices
        lengths = np.asarray(lengths, dtype=np.int64)
        if lengths.shape != (D, D):
            raise ValueError(
                f"lengths must be [{D}, {D}], got {lengths.shape}"
            )
        if (lengths < 0).any():
            raise ValueError("negative stream length")
        return lengths

    def _result(self, rows, filled) -> HostLocalStreams:
        return HostLocalStreams(rows, frozenset(filled), self.rank)

    # -- host-driven byte exchange ------------------------------------------
    def exchange_bytes(
        self, streams: Sequence[Sequence[bytes]],
        lengths: Optional[np.ndarray] = None,
        local_sources: Optional[frozenset] = None,
    ):
        """Move ``streams[rank][d]`` -> ``out[d][rank]``.  At D = 1 the
        return is the plain ``[D][S]`` list; at D > 1 a
        :class:`HostLocalStreams` whose only addressable row is this
        rank's.

        Every rank passes ``streams`` as ``[D][D]``, with real data in
        its own row ``rank`` (other rows may be empty; they are never
        read).  ``lengths`` is the whole ``[D, D]`` matrix, the same on
        every rank (the plan's tile and round shapes derive from it, and
        divergent shapes would hang the collective); without it each
        rank's own row is measured from ``streams`` and the matrix is
        gathered from the ranks (one ``all_gather``).  ``local_sources``
        names the source rows this caller vouches for (default: this
        rank): a vouched-for empty row with a nonzero length is a caller
        bug."""
        D = self.n_devices
        if len(streams) != D or any(len(row) != D for row in streams):
            raise ValueError(
                f"streams must be [{D}][{D}], got "
                f"[{len(streams)}][{[len(r) for r in streams]}]"
            )
        if lengths is None:
            own = torch.tensor([len(row) for row in streams[self.rank]],
                               dtype=torch.int64, device=self.device)
            lengths = self.group.all_gather(own).cpu().numpy().reshape(D, D)
        else:
            lengths = np.asarray(lengths, dtype=np.int64)
            if lengths.shape != (D, D):
                raise ValueError(
                    f"lengths must be [{D}, {D}], got {lengths.shape}"
                )
            if local_sources is None:
                local_sources = frozenset({self.rank})
            for s in range(D):
                for d in range(D):
                    n = len(streams[s][d])
                    if (n or s in local_sources) and n != int(lengths[s, d]):
                        raise ValueError(
                            f"stream [{s}][{d}] is {n}B but lengths says "
                            f"{int(lengths[s, d])}B (only rows outside "
                            f"local_sources may be empty)"
                        )
        plan = self.plan(lengths)
        if plan.rounds == 0:
            return [[b""] * D for _ in range(D)]

        col_offs = [row_offsets(lengths[:, d]) for d in range(D)]
        dst_rows: Dict[int, np.ndarray] = {}

        def get_dst(d: int) -> np.ndarray:
            buf = dst_rows.get(d)
            if buf is None:
                buf = dst_rows[d] = host_bytes(
                    self.device, int(lengths[:, d].sum())).numpy()
            return buf

        own_row = streams[self.rank]
        own_len = lengths[self.rank]

        def fill(r: int, mat: np.ndarray) -> None:
            lo, hi = plan.round_slice(r)
            for d in range(D):
                n = 0
                take = min(hi, int(own_len[d])) - lo
                if take > 0:
                    # a view, not a copy, of the caller's stream
                    chunk = memoryview(own_row[d])[lo : lo + take]
                    n = len(chunk)
                    if n:
                        mat[d, :n] = np.frombuffer(chunk, np.uint8)
                # pad spans and an omitted row ship zeros, never stale
                # memory of the reused staging buffer
                mat[d, n:] = 0

        collect = _make_row_collect(plan, lengths, col_offs, get_dst)
        filled_dsts = self._run_tile_rounds(plan, fill, collect)
        result = [
            [
                bytes(memoryview(
                    dst_rows[d][col_offs[d][s]:col_offs[d][s + 1]]
                )) if d in filled_dsts else b""
                for s in range(D)
            ]
            for d in range(D)
        ]
        if self.verify_integrity:
            self._verify(streams, result, filled_dsts, local_sources)
        if len(filled_dsts) < D:
            return self._result(result, filled_dsts)
        return result

    def exchange_into(
        self,
        lengths: np.ndarray,
        src_rows,
        local_sources: Optional[frozenset] = None,
        out_alloc=None,
    ) -> HostLocalStreams:
        """Zero-copy exchange over preallocated contiguous rows.

        ``src_rows`` maps source index -> one contiguous uint8 buffer
        laid out per ``lengths[s]``: the stream to destination ``d``
        occupies ``[row_offsets(lengths[s])[d],
        row_offsets(lengths[s])[d + 1])``.  Each rank passes its own row
        (``local_sources`` defaults to this rank; every vouched row must
        be present and exactly sized, and only this rank's row ships).

        Returns a :class:`HostLocalStreams` whose addressable row is a
        :class:`DestRowView` — ``result[rank][s]`` is a uint8 VIEW of
        the received stream from source ``s``, sliced out of one buffer
        that ``out_alloc(nbytes)`` provides (default: pinned host memory
        on a card, ``np.empty`` on the CPU)."""
        D = self.n_devices
        lengths = self._check_lengths(lengths)
        if local_sources is None:
            local_sources = frozenset({self.rank})
        src: Dict[int, np.ndarray] = {}
        src_offs: Dict[int, np.ndarray] = {}
        for s in sorted(local_sources):
            row = src_rows[s] if not hasattr(src_rows, "get") \
                else src_rows.get(s)
            if row is None:
                raise ValueError(f"no source row for vouched source {s}")
            arr = row if isinstance(row, np.ndarray) \
                else np.frombuffer(row, np.uint8)
            if arr.dtype != np.uint8 or arr.ndim != 1:
                raise ValueError(
                    f"source row {s} must be a flat uint8 buffer, got "
                    f"{arr.dtype} ndim={arr.ndim}"
                )
            need = int(lengths[s].sum())
            if arr.shape[0] != need:
                raise ValueError(
                    f"source row {s} is {arr.shape[0]}B but its lengths "
                    f"row sums to {need}B"
                )
            src[s] = arr
            src_offs[s] = row_offsets(lengths[s])

        plan = self.plan(lengths)
        col_offs = [row_offsets(lengths[:, d]) for d in range(D)]
        alloc = out_alloc if out_alloc is not None else (
            lambda n: host_bytes(self.device, n).numpy()
        )
        dst_rows: Dict[int, np.ndarray] = {}

        def get_dst(d: int) -> np.ndarray:
            buf = dst_rows.get(d)
            if buf is None:
                n = int(lengths[:, d].sum())
                buf = np.empty(0, np.uint8) if n == 0 else alloc(n)[:n]
                dst_rows[d] = buf
            return buf

        if plan.rounds == 0:
            rows = [
                DestRowView(get_dst(d), col_offs[d]) for d in range(D)
            ]
            return self._result(rows, range(D))

        own = src.get(self.rank)
        own_offs = src_offs.get(self.rank)

        def fill(r: int, mat: np.ndarray) -> None:
            lo, hi = plan.round_slice(r)
            for d in range(D):
                take = 0
                if own is not None:
                    take = max(0, min(hi, int(lengths[self.rank, d])) - lo)
                    o = int(own_offs[d]) + lo
                    mat[d, :take] = own[o : o + take]
                mat[d, take:] = 0  # pad spans ship zeros

        collect = _make_row_collect(plan, lengths, col_offs, get_dst)
        filled_dsts = self._run_tile_rounds(plan, fill, collect)
        sent = sum(int(lengths[s].sum()) for s in src)
        received = sum(
            int(lengths[:, d].sum()) for d in filled_dsts
        )
        # vs the legacy bytes path: assembly skipped the per-destination
        # join of the source payload; consumption skipped the per-pair
        # tobytes + trim materializations of the received payload
        counter("exchange_copy_bytes_avoided_total").inc(
            sent + 2 * received
        )
        rows: List[Optional[DestRowView]] = [None] * D
        for d in filled_dsts:
            rows[d] = DestRowView(get_dst(d), col_offs[d])
        if self.verify_integrity:
            self._verify_rows(
                src, src_offs, rows, filled_dsts, lengths
            )
        return self._result(rows, filled_dsts)

    # -- device-native padded exchange --------------------------------------
    def exchange_padded(
        self,
        lengths: np.ndarray,
        src_rows,
        local_sources: Optional[frozenset] = None,
        out_alloc=None,
        on_round=None,
        window_rounds: int = 0,
    ) -> HostLocalStreams:
        """Device-native exchange over :class:`PaddedSourceRow` buffers:
        the rank's source row goes to its device in ONE copy and the
        collective consumes it directly — no per-round host staging
        matrices, no ``bytes`` anywhere between assembly and the
        destination views.

        Two execution shapes, selected by ``window_rounds``:

        - ``window_rounds <= 0`` (or a single-round plan): ONE
          ``all_to_all`` of the rank's ``[D, C]`` row; the received
          ``[S, C]`` comes back in one copy into a pinned host matrix
          that the destination view keeps alive (``out_alloc`` is
          ignored), and ``on_round(0, 0, total_cols, rows)`` fires once.
        - ``window_rounds > 0``: tile rounds with at most that many
          collectives in flight; round ``r``'s tile is a slice of the one
          resident row on the device, landed tiles are copied into the
          ``out_alloc`` matrix (default: pinned host memory on a card,
          ``np.empty`` on the CPU), and ``on_round(r, lo, hi, rows)`` fires
          after each landing so decode can overlap round ``r + 1``'s
          collective.

        Each rank holds exactly its own padded row, so at D > 1 this is
        one collective of that row over the group.  Returns
        :class:`HostLocalStreams` of :class:`PaddedDestRowView` rows, the
        same consumer protocol as the host-staged path."""
        D = self.n_devices
        lengths = self._check_lengths(lengths)  # plan metadata
        if local_sources is None:
            local_sources = frozenset({self.rank})
        plan = self.plan(lengths)
        C = plan.total_cols
        if plan.rounds == 0:
            empty = np.zeros((D, 0), np.uint8)
            rows = [
                PaddedDestRowView(empty, lengths[:, d]) for d in range(D)
            ]
            return self._result(rows, range(D))

        src: Dict[int, PaddedSourceRow] = {}
        for s in sorted(local_sources):
            row = src_rows[s] if not hasattr(src_rows, "get") \
                else src_rows.get(s)
            if row is None:
                raise ValueError(f"no source row for vouched source {s}")
            if not isinstance(row, PaddedSourceRow):
                arr = row if isinstance(row, np.ndarray) \
                    else np.frombuffer(row, np.uint8)
                row = PaddedSourceRow(arr, C)
            if row.cols != C:
                raise ValueError(
                    f"source row {s} framed for cols={row.cols}, "
                    f"plan needs {C}"
                )
            if row.buf.dtype != np.uint8 or row.buf.ndim != 1 \
                    or row.buf.shape[0] != D * C:
                raise ValueError(
                    f"source row {s} must be flat uint8 [{D * C}], got "
                    f"{row.buf.dtype} shape={row.buf.shape}"
                )
            src[s] = row

        # word framing: every vouched row of every rank must sustain the
        # 4-byte view, or the whole exchange ships uint8 lanes — the
        # ranks agree, since a collective whose element type differs
        # between ranks hangs
        unaligned = any(DeviceStagingBridge.as_words(pr.buf) is None
                        for pr in src.values())
        use_words = self.group.agree_max(int(unaligned))[0] == 0
        itemsize = WORD if use_words else 1
        elem = torch.int32 if use_words else torch.uint8
        C_e = C // itemsize

        # one H2D of this rank's row; a row this rank does not vouch for
        # ships deterministic zeros
        bridge = DeviceStagingBridge(self.device)
        own = src.get(self.rank)
        if own is None:
            host_row, avoided = np.zeros(D * C, np.uint8), 0
        else:
            # the host-staged path would have copied this row's payload
            # through D * C bytes of per-round staging matrix
            host_row, avoided = own.buf, D * C
        x = bridge.to_device(host_row, self.device, avoided)
        x = x.view(elem).view(D, C_e)

        link = _Link(self.device)
        rows: List[Optional[PaddedDestRowView]] = [None] * D
        if window_rounds <= 0 or plan.rounds <= 1:
            y = self.group.all_to_all(x)
            host = host_bytes(self.device, (D, C))
            link.wait(link.to_host(host.view(elem), y))
            rows[self.rank] = PaddedDestRowView(
                host.numpy(), lengths[:, self.rank], keepalive=host
            )
            self.rounds_executed += 1
            if on_round is not None:
                on_round(0, 0, C, rows)
        else:
            alloc = out_alloc if out_alloc is not None else (
                lambda n: host_bytes(self.device, n).numpy()
            )
            mat = alloc(D * C)[: D * C].reshape(D, C)
            rows[self.rank] = PaddedDestRowView(mat, lengths[:, self.rank])
            window = max(1, int(window_rounds))
            tiles = x.view(D, plan.rounds, plan.tile_bytes // itemsize)
            stage = [host_bytes(self.device, (D, plan.tile_bytes))
                     for _ in range(min(window, plan.rounds))]
            inflight: deque = deque()

            def collect(r, slot, done):
                link.wait(done)
                lo, hi = plan.round_slice(r)
                mat[:, lo:hi] = stage[slot].numpy()
                self.rounds_executed += 1
                if on_round is not None:
                    on_round(r, lo, hi, rows)

            for r in range(plan.rounds):
                slot = r % len(stage)
                y = self.group.all_to_all(tiles[:, r].contiguous())
                inflight.append(
                    (r, slot, link.to_host(stage[slot].view(elem), y)))
                if len(inflight) >= window:
                    collect(*inflight.popleft())
            while inflight:
                collect(*inflight.popleft())

        if self.verify_integrity:
            row = rows[self.rank]
            for s in sorted(src):
                n = int(lengths[s, self.rank])
                sent = src[s].stream(self.rank, n)
                got = row[s]
                if not np.array_equal(got, sent):
                    self.integrity_failures += 1
                    raise ExchangeIntegrityError(
                        s, self.rank,
                        zlib.crc32(memoryview(sent)),
                        zlib.crc32(memoryview(got)),
                    )
        # the device path avoids everything the zero-copy host path
        # avoided (assembly joins + per-pair tobytes on receive) for the
        # streams this rank sends and receives
        sent = sum(int(lengths[s].sum()) for s in src)
        counter("exchange_copy_bytes_avoided_total").inc(
            sent + 2 * int(lengths[:, self.rank].sum())
        )
        self.device_exchanges += 1
        self.payload_bytes_moved += plan.payload_bytes
        self.padded_bytes_moved += plan.moved_bytes
        return self._result(rows, {self.rank})

    def _run_tile_rounds(self, plan: ExchangePlan, fill_round,
                         collect_round) -> set:
        """The ONE tile-round engine both byte paths share:
        ``fill_round(r, mat)`` writes this rank's ``[D, tile]`` row of
        round ``r`` into the (reused) host buffer ``mat``, every byte of
        it; ``collect_round(r, rank, local)`` consumes the received
        ``[S, tile]`` slab.  Rounds collect FIFO, at most
        ``max_rounds_in_flight`` in flight; each round's host buffers
        are reused only after its copy back has completed.  Returns the
        destinations addressable here: ``{rank}``."""
        D = self.n_devices
        link = _Link(self.device)
        slots = min(self.max_rounds_in_flight, plan.rounds)
        send, recv = ([host_bytes(self.device, (D, plan.tile_bytes))
                       for _ in range(slots)] for _ in range(2))
        inflight: deque = deque()

        def collect(r, slot, done):
            link.wait(done)
            collect_round(r, self.rank, recv[slot].numpy())

        for r in range(plan.rounds):
            slot = r % slots
            fill_round(r, send[slot].numpy())
            got = self.group.all_to_all(
                link.to_device(send[slot]).view(torch.int32))
            inflight.append(
                (r, slot, link.to_host(recv[slot].view(torch.int32), got)))
            self.rounds_executed += 1
            if len(inflight) >= self.max_rounds_in_flight:
                collect(*inflight.popleft())
        while inflight:
            collect(*inflight.popleft())
        self.payload_bytes_moved += plan.payload_bytes
        self.padded_bytes_moved += plan.moved_bytes
        return {self.rank}

    def _verify_rows(self, src, src_offs, rows, filled_dsts,
                     lengths) -> None:
        """Integrity check for the zero-copy path: pairs whose source
        row is held here and whose destination is this rank, comparing
        views without materializing."""
        for d in sorted(filled_dsts):
            row = rows[d]
            for s in sorted(src):
                o = int(src_offs[s][d])
                n = int(lengths[s, d])
                sent = src[s][o : o + n]
                got = row[s]
                if not np.array_equal(got, sent):
                    self.integrity_failures += 1
                    raise ExchangeIntegrityError(
                        s, d,
                        zlib.crc32(memoryview(sent)),
                        zlib.crc32(memoryview(got)),
                    )

    def _verify(self, streams, result, filled_dsts,
                local_sources=None) -> None:
        """End-to-end integrity: a device or link fault inside a
        collective corrupts silently, so received streams are compared
        against what the source enqueued and mismatches surface as
        retryable transport failures.  Scope: pairs whose source is
        vouched for here (default: this rank) and whose destination is
        this rank (for a pair across ranks neither end holds both byte
        strings)."""
        local_srcs = local_sources if local_sources is not None \
            else {self.rank}
        for d in sorted(filled_dsts):
            for s in sorted(local_srcs):
                if result[d][s] != streams[s][d]:
                    self.integrity_failures += 1
                    raise ExchangeIntegrityError(
                        s, d,
                        zlib.crc32(streams[s][d]),
                        zlib.crc32(result[d][s]),
                    )

    # -- on-device exchange (tensors already on the device) ------------------
    def a2a(self, x, donate: bool = False) -> torch.Tensor:
        """All-to-all this rank's ``[D, C]`` tensor (row d goes to rank
        d; a numpy array or a tensor elsewhere is moved to the device
        first): returns ``[S, C]`` on the device with row s from rank s —
        rank d's share of the JAX ``a2a``'s ``out[d, s] = x[s, d]``.  No
        host round trip.  uint8 rows of whole words ride as int32.

        ``donate=True`` says the caller gives up ``x``: in a group of
        one, where the exchange is the identity, the port returns ``x``
        itself instead of a copy; at D > 1 the collective needs an
        output buffer apart from its input, so ``x`` is left as it
        was."""
        D = self.n_devices
        if x.ndim != 2 or x.shape[0] != D:
            raise ValueError(
                f"expected [D={D}, C] array, got {tuple(x.shape)}")
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if D == 1:
            return x if donate else x.clone()
        x = x.contiguous()
        if x.dtype == torch.uint8 and x.shape[1] % WORD == 0:
            return self.group.all_to_all(x.view(torch.int32)).view(
                torch.uint8)
        return self.group.all_to_all(x)

    def stats(self) -> Dict[str, int]:
        return {
            "rounds_executed": self.rounds_executed,
            "payload_bytes_moved": self.payload_bytes_moved,
            "padded_bytes_moved": self.padded_bytes_moved,
            "integrity_failures": self.integrity_failures,
            "device_exchanges": self.device_exchanges,
        }
