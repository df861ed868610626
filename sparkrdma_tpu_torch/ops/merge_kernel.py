"""Stable merge of sorted runs: the reduce side of the TeraSort exchange.

:func:`merge_runs` takes the ``[D, cap]`` block an exchange delivers,
row s from rank s, whose first ``rvalid[s]`` slots are real and
ascending and whose later slots hold the key dtype's max, and returns
(keys ``[D * cap]``, src int32 ``[D * cap]``): the block in the order
of a stable sort keyed (key, invalid), with ``src`` each output's flat
source slot ``s * cap + slot``.  The real rows come first, merged with
equal keys from the lower row first, then the padding slots in (row,
slot) order.

On a CUDA tensor it runs the hand-written kernel of
``csrc/merge_runs.cu`` (ceil(log2 D) rounds of a two-way merge path,
no host synchronisation); on a CPU tensor :func:`merge_runs_plain`,
the two stable sorts of ``ops/lexsort.py`` that the kernel replaces,
which is also what the kernel is held against on the card.  A CUDA
tensor always goes to the kernel, and a block it does not take raises.
Each call adds its ``D * cap`` slots to the registry's
``merge_rows_total{path=kernel|plain}``.
"""

from __future__ import annotations

import torch

from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.ops.lexsort import perm_by_key_invalid

_KEY_DTYPES = (torch.int32, torch.int64)

LAUNCHES = _build.LaunchCounter("merge_runs")


def _check(rk: torch.Tensor, rvalid: torch.Tensor) -> None:
    if rk.dim() != 2 or rk.dtype not in _KEY_DTYPES:
        raise ValueError(f"merge_runs takes an int32 or int64 [D, cap] "
                         f"block, got {rk.dtype} {tuple(rk.shape)}")
    if not rk.is_contiguous():
        raise ValueError("merge_runs takes a contiguous block")
    n_runs, cap = rk.shape
    if n_runs < 1:
        raise ValueError("merge_runs takes at least one row")
    if n_runs * cap >= 1 << 31:
        raise ValueError(f"merge_runs takes fewer than 2^31 slots, got "
                         f"{n_runs} x {cap}")
    if (rvalid.dtype != torch.int32 or rvalid.dim() != 1
            or rvalid.shape[0] != n_runs):
        raise ValueError(f"rvalid must be int32 [{n_runs}], got "
                         f"{rvalid.dtype} {tuple(rvalid.shape)}")
    if rvalid.device != rk.device:
        raise ValueError(f"rvalid on {rvalid.device}, block on {rk.device}")


def merge_runs_plain(rk: torch.Tensor, rvalid: torch.Tensor):
    """The kernel's function in plain PyTorch: one stable sort of the
    whole block keyed (key, invalid)."""
    _check(rk, rvalid)
    slot = torch.arange(rk.shape[1], device=rk.device)
    invalid = (slot[None, :] >= rvalid[:, None]).to(torch.int32)
    flat = rk.reshape(-1)
    perm = perm_by_key_invalid(flat, invalid.reshape(-1))
    return flat[perm], perm.to(torch.int32)


def _merge_runs_cuda(rk: torch.Tensor, rvalid: torch.Tensor):
    n_runs, cap = rk.shape
    keys = torch.empty(n_runs * cap, dtype=rk.dtype, device=rk.device)
    src = torch.empty(n_runs * cap, dtype=torch.int32, device=rk.device)
    if cap == 0:
        return keys, src
    lib = _build.load()
    # the rounds before the last ping-pong through one scratch pair
    tmp_k = tmp_s = None
    if lib.sr_merge_runs_rounds(n_runs) > 1:
        tmp_k, tmp_s = torch.empty_like(keys), torch.empty_like(src)
    rvalid = rvalid.contiguous()
    with torch.cuda.device(rk.device):
        stream = torch.cuda.current_stream(rk.device).cuda_stream
        rc = lib.sr_merge_runs(
            rk.data_ptr(), rvalid.data_ptr(), keys.data_ptr(),
            src.data_ptr(), None if tmp_k is None else tmp_k.data_ptr(),
            None if tmp_s is None else tmp_s.data_ptr(), n_runs, cap,
            rk.element_size(), stream,
        )
    _build.check(rc, "merge_runs")
    LAUNCHES.bump()
    return keys, src


def merge_runs(rk: torch.Tensor, rvalid: torch.Tensor):
    """Merge the rows of the ``[D, cap]`` block ``rk`` (int32 or int64,
    contiguous) by their int32 valid counts ``rvalid`` ``[D]``; returns
    (keys ``[D * cap]`` in ``rk``'s dtype, src int32 ``[D * cap]``).
    CUDA tensors run the kernel (or raise), CPU tensors the plain
    version."""
    _check(rk, rvalid)
    if rk.device.type == "cuda":
        counter("merge_rows_total", path="kernel").inc(rk.numel())
        return _merge_runs_cuda(rk, rvalid)
    if rk.device.type != "cpu":
        raise ValueError(f"unsupported device {rk.device}")
    counter("merge_rows_total", path="plain").inc(rk.numel())
    return merge_runs_plain(rk, rvalid)
