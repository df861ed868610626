"""One-pass flagged scans: the port of ``sparkrdma_tpu/ops/scan_kernels.py``.

The forward fills and segmented scans of ``ops/segment.py`` are all one
associative recurrence over (flag, columns) tuples (see ``_combine``).
On a CUDA tensor :func:`scan_flagged` runs the hand-written kernel of
``csrc/flagged_scan.cu`` (reduce-then-scan: CUDA blocks, unlike a TPU
grid, run in no order, so a carried sum needs a scan of tile
aggregates).  On a CPU tensor it runs :func:`scan_flagged_plain`, the
log-step loop of ``segment.py`` written for all four kinds, which is
also what the kernel is held against on the card.  There is no size or
dtype gate: a CUDA tensor always goes to the kernel, and a column the
kernel does not take raises.

Kinds:

- ``fill``: forward-fill the columns from flagged positions.  Positions
  before the first flag hold the identity with the output flag clear;
  consumers mask by the returned flag.
- ``add`` / ``min`` / ``max``: inclusive segmented scans with ``flag``
  marking segment heads.  ``add`` wraps in the column's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from sparkrdma_tpu_torch import _build

KINDS = ("fill", "add", "min", "max")
MAX_COLS = 3
_KIND_CODE = {"fill": 0, "add": 1, "min": 2, "max": 3}
_DTYPE_CODE = {
    torch.int32: 0, torch.uint32: 1, torch.int64: 2, torch.float32: 3,
}
_U32_MASK = (1 << 32) - 1

LAUNCHES = _build.LaunchCounter("flagged_scan")


def identity(kind: str, dtype: torch.dtype):
    """The neutral element of ``kind`` in ``dtype`` (Python scalar)."""
    if kind == "min":
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max if dtype != torch.uint32 else _U32_MASK
    if kind == "max":
        if dtype.is_floating_point:
            return float("-inf")
        return torch.iinfo(dtype).min if dtype != torch.uint32 else 0
    return 0  # add / fill


def _combine(kind: str, pf, pxs, cf, cxs):
    """combine(prev_aggregate, current_aggregate); prev = elements
    strictly earlier in scan order.  Not commutative."""
    f = pf | cf
    if kind == "fill":
        xs = [torch.where(cf, cx, px) for px, cx in zip(pxs, cxs)]
    elif kind == "add":
        xs = [torch.where(cf, cx, px + cx) for px, cx in zip(pxs, cxs)]
    elif kind == "min":
        xs = [torch.where(cf, cx, torch.minimum(px, cx))
              for px, cx in zip(pxs, cxs)]
    elif kind == "max":
        xs = [torch.where(cf, cx, torch.maximum(px, cx))
              for px, cx in zip(pxs, cxs)]
    else:
        raise ValueError(f"unknown scan kind {kind!r}")
    return f, xs


def _check(kind: str, flag: Optional[torch.Tensor],
           cols: Sequence[torch.Tensor]):
    if kind not in KINDS:
        raise ValueError(f"unknown scan kind {kind!r}; expected {KINDS}")
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"scan takes 1..{MAX_COLS} columns, got {len(cols)}")
    if flag is not None and (flag.dtype != torch.bool or flag.dim() != 1):
        raise ValueError(f"flag must be 1-D bool, got {flag.dtype} "
                         f"{tuple(flag.shape)}")
    ref = cols[0] if flag is None else flag
    for c in cols:
        if c.dim() != 1 or c.shape[0] != ref.shape[0]:
            raise ValueError(
                f"columns must be 1-D of length {ref.shape[0]}, got "
                f"{tuple(c.shape)}"
            )
        if c.dtype not in _DTYPE_CODE:
            raise ValueError(
                f"unsupported column dtype {c.dtype}; the scan takes "
                f"{sorted(str(d) for d in _DTYPE_CODE)}"
            )
        if c.device != ref.device:
            raise ValueError(f"column on {c.device}, flag on {ref.device}")


def scan_flagged_plain(
    kind: str, flag: torch.Tensor, cols: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The kernel's function in plain PyTorch: Hillis-Steele log-step
    over the whole arrays, shifting in (flag clear, identity).  uint32
    columns compute in int64 (PyTorch has no uint32 arithmetic) and
    wrap back."""
    _check(kind, flag, cols)
    n = int(flag.shape[0])
    dtypes = [c.dtype for c in cols]
    xs = [c.to(torch.int64) if c.dtype == torch.uint32 else c for c in cols]
    idents = [identity(kind, dt) for dt in dtypes]
    f = flag
    s = 1
    while s < n:
        pf = torch.cat([torch.zeros(s, dtype=torch.bool, device=f.device),
                        f[:-s]])
        pxs = [
            torch.cat([torch.full((s,), ident, dtype=x.dtype,
                                  device=x.device), x[:-s]])
            for x, ident in zip(xs, idents)
        ]
        f, xs = _combine(kind, pf, pxs, f, xs)
        s <<= 1
    if n <= 1:  # no step ran: do not hand back the inputs themselves
        f, xs = f.clone(), [x.clone() for x in xs]
    outs = [(x & _U32_MASK).to(torch.uint32) if dt == torch.uint32 else x
            for x, dt in zip(xs, dtypes)]
    return f, outs


def _scan_cuda(kind, flag, cols):
    """Launch the kernel.  A ``flag`` of None means no segment heads:
    the kernel then reads no flag and writes none (returned as None)."""
    for t in (flag, *cols):
        if t is not None and not t.is_contiguous():
            raise ValueError("scan_flagged takes contiguous tensors")
    lib = _build.load()
    dev = cols[0].device
    n = int(cols[0].shape[0])
    out_flag = (None if flag is None
                else torch.empty(n, dtype=torch.bool, device=dev))
    outs = [torch.empty_like(c) for c in cols]
    if n == 0:
        return out_flag, outs
    tile = lib.sr_flagged_scan_tile()
    n_tiles = -(-n // tile)
    scratch = torch.empty((1 + MAX_COLS) * n_tiles, dtype=torch.int64,
                          device=dev)
    pad = [None] * (MAX_COLS - len(cols))
    ins = [c.data_ptr() for c in cols] + pad
    outp = [o.data_ptr() for o in outs] + pad
    dts = [_DTYPE_CODE[c.dtype] for c in cols] + [0] * len(pad)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sr_flagged_scan(
            _KIND_CODE[kind],
            None if flag is None else flag.data_ptr(),
            None if flag is None else out_flag.data_ptr(),
            len(cols), *ins, *outp, *dts, n, scratch.data_ptr(), stream,
        )
    _build.check(rc, f"flagged_scan[{kind}]")
    LAUNCHES.bump()
    return out_flag, outs


def scan_flagged(
    kind: str, flag: torch.Tensor, cols: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One-pass (flag, columns) inclusive scan over 1-D tensors.

    Returns ``(flag_out: bool[n], cols_out)``.  CUDA tensors run the
    kernel (or raise); CPU tensors run :func:`scan_flagged_plain`.
    Columns may mix int32, uint32, int64 and float32.
    """
    cols = list(cols)
    _check(kind, flag, cols)
    if flag.device.type == "cuda":
        return _scan_cuda(kind, flag, cols)
    if flag.device.type != "cpu":
        raise ValueError(f"unsupported device {flag.device}")
    return scan_flagged_plain(kind, flag, cols)


def cumsum_1d(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in the values' own dtype (wrapping), as the
    ``add`` scan with no segment heads.  On a CUDA tensor the kernel
    gets no flag at all, so it moves only the values."""
    if vals.device.type == "cuda":
        _check("add", None, [vals])
        _f, (out,) = _scan_cuda("add", None, [vals])
        return out
    flag = torch.zeros(vals.shape[0], dtype=torch.bool, device=vals.device)
    _f, (out,) = scan_flagged("add", flag, (vals,))
    return out
