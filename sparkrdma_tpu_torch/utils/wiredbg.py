"""Runtime wire-protocol frame validator (``spark.shuffle.tpu.wireDebug``).

Third runtime sanitizer in the dbglock/ledger lineage: the static half
of the wire contract lives in tools/wirecheck.py (WC01–WC05 over the
declarative ``WIRE_SCHEMA`` tables); this module is the runtime half.
When the manager flips it on (before building its node, like the lock
factory and the resource ledger), both TCP engines' receive paths and
the loopback dispatch plane validate every frame as it arrives:

- header sanity — known opcode, length within the frame bound;
- RPC frames decode through the declarative schemas (every count and
  length field bounds-checked against the received bytes) BEFORE the
  application listener sees them;
- every check lands in ``wire_frames_validated_total`` /
  ``wire_frames_rejected_total`` counters labeled by engine and opcode
  (``metrics_report.py`` renders the wire-health table from them), and
  every rejection logs with a hexdump context.

Off by default: call sites check :func:`wire_debug_enabled` first, so
the production receive path pays one module-global read per frame.

A rejected RPC frame is DROPPED — the blast radius is that one frame,
never the channel (the control plane's segments are independently
decodable, so a lost frame degrades to the existing timeout/retry
machinery).  A bad frame HEADER still tears the channel down in the
engines — a byte stream whose framing lies is desynced and cannot be
resynchronized — but the validator names the opcode and context first.
"""

from __future__ import annotations

import logging
from typing import Optional

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.obs import RECORDER, fr_event
from sparkrdma_tpu_torch.rpc.messages import (
    WireFormatError,
    decode_msg,
    hex_context,
)

logger = logging.getLogger(__name__)

_enabled = False


def set_wire_debug(on: bool) -> None:
    """Flip the process-global validator (manager does this from conf
    BEFORE building its node, the dbglock/ledger flow)."""
    global _enabled
    _enabled = bool(on)


def wire_debug_enabled() -> bool:
    return _enabled


def opcode_label(opcode) -> str:
    """Stable metric label for one transport opcode."""
    from sparkrdma_tpu_torch.transport import tcp as wire

    return {
        wire.OP_RPC: "rpc",
        wire.OP_READ_REQ: "read_req",
        wire.OP_READ_RESP: "read_resp",
    }.get(opcode, str(opcode))


def header_error(engine: str, opcode: int, length: int) -> Optional[str]:
    """Validate one frame header; returns the error description (after
    counting the rejection) or None after counting the validation."""
    from sparkrdma_tpu_torch.transport import tcp as wire

    label = opcode_label(opcode)
    err = None
    if opcode not in (wire.OP_RPC, wire.OP_READ_REQ, wire.OP_READ_RESP):
        err = f"unknown opcode {opcode}"
    elif not 0 <= length <= wire._MAX_FRAME:
        err = f"bad frame length {length} for opcode {label}"
    if err is None:
        counter(
            "wire_frames_validated_total", engine=engine, opcode=label
        ).inc()
        return None
    counter(
        "wire_frames_rejected_total", engine=engine, opcode=label
    ).inc()
    if RECORDER.enabled:
        fr_event(
            "transport", "wire_reject",
            engine=engine, opcode=label, reason=err,
        )
        # a lying frame header desyncs the channel — snapshot the
        # rings before the engine tears it down
        RECORDER.auto_dump("wire_reject")
    return err


def rpc_frame_ok(engine: str, frame) -> bool:
    """Schema-validate one RPC frame before dispatch.  A rejection is
    counted, hexdump-logged, and the frame dropped (one-frame blast
    radius); True means the frame decodes cleanly end to end."""
    try:
        decode_msg(bytes(frame))
    except WireFormatError as e:
        counter(
            "wire_frames_rejected_total", engine=engine, opcode="rpc"
        ).inc()
        logger.warning(
            "wireDebug[%s]: dropping RPC frame: %s (frame %s)",
            engine, e, hex_context(bytes(frame)),
        )
        if RECORDER.enabled:
            fr_event(
                "transport", "wire_reject",
                engine=engine, opcode="rpc", reason=str(e)[:200],
            )
            RECORDER.auto_dump("wire_reject")
        return False
    counter(
        "wire_frames_validated_total", engine=engine, opcode="rpc"
    ).inc()
    return True


__all__ = [
    "set_wire_debug",
    "wire_debug_enabled",
    "opcode_label",
    "header_error",
    "rpc_frame_ok",
]
