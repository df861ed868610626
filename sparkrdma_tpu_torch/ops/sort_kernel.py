"""Bitonic block sort and the two-phase full sort: the port of
``sparkrdma_tpu/ops/sort_kernel.py``.

:func:`sort_pairs_blocks` sorts (int32 key, int32 value) pairs within
consecutive blocks of ``block_rows * 128`` with the bitonic XOR network
of the Pallas kernel.  On a CUDA tensor it runs the hand-written kernel
of ``csrc/bitonic_block_sort.cu`` (one launch for blocks of up to
``block_rows = 1024``, over a thread-block cluster above 64); on a CPU
tensor it runs :func:`block_sort_plain`, the same network written with
tensor ops.
Both match the Pallas kernel bit for bit, values included: the network,
its direction bits and its tie rule make it a deterministic function.

:func:`sort_pairs_full` is the glue around it (block sorts, exact
per-block quantile splitters, bucket assembly, a batched bucket sort
with validity as the second key) in plain PyTorch.  The Pallas
version's ``fori_loop`` window copy is one batched gather here; its
outputs are identical, overflow included.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sparkrdma_tpu_torch import _build

LANES = 128

LAUNCHES = _build.LaunchCounter("bitonic_block_sort")


class BucketOverflowError(RuntimeError):
    """A bucket exceeded its capacity in sort_pairs_full: the sorted
    output is garbage (see the overflow contract in its docstring)."""


def bucket_cap(n: int, n_buckets: int = 16, cap_factor: float = 1.4) -> int:
    """Per-bucket row capacity sort_pairs_full allocates for ``n``
    rows; a bucket fill above this invalidates the whole result."""
    cap = int(math.ceil(n / n_buckets * cap_factor))
    return (cap + LANES - 1) // LANES * LANES


def _check_pairs(keys, vals, block_rows: int) -> int:
    """Validate and return log2 of the block size."""
    if keys.dim() != 1 or keys.shape != vals.shape:
        raise ValueError("keys/vals must be equal-length 1-D tensors")
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError(
            f"block sort takes int32 keys and values, got {keys.dtype}, "
            f"{vals.dtype}"
        )
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, vals on {vals.device}")
    B = block_rows * LANES
    if block_rows < 1 or B & (B - 1):
        raise ValueError(f"block size {B} must be a power of two")
    n = int(keys.shape[0])
    if n % B:
        raise ValueError(f"length {n} not a multiple of block {B}")
    return B.bit_length() - 1


def block_sort_plain(keys: torch.Tensor, vals: torch.Tensor,
                     block_rows: int = 1024):
    """The XOR network of ``_block_sort_body`` in plain PyTorch."""
    log_b = _check_pairs(keys, vals, block_rows)
    B = 1 << log_b
    nb = int(keys.shape[0]) // B
    k = keys.reshape(nb, B)
    v = vals.reshape(nb, B)
    flat = torch.arange(B, dtype=torch.int32, device=keys.device)

    def partner(x, d):  # x[i ^ d] within each block
        return x.reshape(nb, B // (2 * d), 2, d).flip(2).reshape(nb, B)

    for stage in range(1, log_b + 1):
        if stage < log_b:
            up = (flat & (1 << stage)) == 0
        else:
            up = torch.ones(B, dtype=torch.bool, device=keys.device)
        for j in range(stage - 1, -1, -1):
            d = 1 << j
            pk = partner(k, d)
            pv = partner(v, d)
            is_lower = (flat & d) == 0
            # ties go to the lower flat index
            mine_small = (k < pk) | ((k == pk) & is_lower)
            want_mine = (up == is_lower) == mine_small
            k = torch.where(want_mine, k, pk)
            v = torch.where(want_mine, v, pv)
    return k.reshape(-1), v.reshape(-1)


def cluster_shape(block_rows: int = 1024) -> dict:
    """The kernel's launch shape for blocks of ``block_rows * 128``
    pairs on the current card: CTAs per thread-block cluster,
    ``cudaOccupancyMaxActiveClusters`` for that cluster, threads and
    pairs per CTA."""
    B = block_rows * LANES
    if block_rows < 1 or B & (B - 1):
        raise ValueError(f"block size {B} must be a power of two")
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    _build.check(lib.sr_bitonic_block_sort_shape(B.bit_length() - 1, out),
                 "bitonic_block_sort shape")
    return dict(cluster=out[0], max_active_clusters=out[1],
                threads=out[2], pairs_per_cta=out[3])


def _block_sort_cuda(keys, vals, log_b: int):
    for t in (keys, vals):
        if not t.is_contiguous():
            raise ValueError("sort_pairs_blocks takes contiguous tensors")
    lib = _build.load()
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    n = int(keys.shape[0])
    if n == 0:
        return ok, ov
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.sr_bitonic_block_sort(
            keys.data_ptr(), vals.data_ptr(), ok.data_ptr(), ov.data_ptr(),
            n, log_b, stream,
        )
    _build.check(rc, "bitonic_block_sort")
    LAUNCHES.bump()
    return ok, ov


def sort_pairs_blocks(keys: torch.Tensor, vals: torch.Tensor,
                      block_rows: int = 1024):
    """Sort (keys, vals) within consecutive blocks of
    ``block_rows * 128`` pairs, each block ascending by key.  The length
    must be a multiple of the block, which must be a power of two;
    keys and values are int32.  CUDA tensors run the kernel (or raise),
    CPU tensors the plain version."""
    log_b = _check_pairs(keys, vals, block_rows)
    if keys.device.type == "cuda":
        return _block_sort_cuda(keys, vals, log_b)
    if keys.device.type != "cpu":
        raise ValueError(f"unsupported device {keys.device}")
    return block_sort_plain(keys, vals, block_rows)


def sort_pairs_full(keys: torch.Tensor, vals: torch.Tensor,
                    block_rows: int = 1024, n_buckets: int = 16,
                    cap_factor: float = 1.4):
    """Full (key, value) sort: block sorts, equal-frequency splitters
    from block quantiles, bucket assembly, batched bucket sort.  Returns
    ``(keys', vals', valid, fn, overflow)`` of padded length
    ``n_buckets * cap`` with ``valid`` marking real slots (padding sorts
    to each bucket's tail).

    OVERFLOW CONTRACT: when a bucket receives more than
    ``cap = bucket_cap(n, n_buckets, cap_factor)`` rows, every output is
    garbage.  Callers check ``overflow <= cap`` (the max per-bucket
    fill) or call :func:`sort_pairs_full_checked`, which raises.
    """
    n = int(keys.shape[0])
    B = block_rows * LANES
    if n % B or n == 0:
        raise ValueError(f"length {n} must be a positive multiple of {B}")
    dev = keys.device
    nb = n // B
    sk, sv = sort_pairs_blocks(keys, vals, block_rows=block_rows)
    kb = sk.reshape(nb, B)
    # equal-frequency splitters from exact per-block quantiles
    S = min(512, B)
    pos = (torch.arange(S, device=dev) * B) // S
    ssorted = torch.sort(kb[:, pos].reshape(-1)).values
    idx = (torch.arange(1, n_buckets, device=dev) * ssorted.shape[0]) \
        // n_buckets
    splitters = ssorted[idx]
    edges = torch.searchsorted(
        kb, splitters.expand(nb, -1).contiguous(), right=True
    ).to(torch.int32)                                # [nb, n_buckets-1]
    zeros = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    fulls = torch.full((nb, 1), B, dtype=torch.int32, device=dev)
    edges = torch.cat([zeros, edges, fulls], dim=1)
    counts = edges[:, 1:] - edges[:, :-1]            # [nb, n_buckets]
    starts = edges[:, :-1]
    cap = bucket_cap(n, n_buckets, cap_factor)
    ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
    bucket_off = ends - counts                       # offset of block b
    fn = ends[-1].contiguous()                       # per-bucket fill
    # window copy as one gather: slot p of bucket dst holds the row of
    # the block b whose window [off, off + count) covers p
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    b = torch.searchsorted(
        ends.t().contiguous(), slot.expand(n_buckets, cap).contiguous(),
        right=True,
    ).clamp_(max=nb - 1)                             # [n_buckets, cap]
    dst = torch.arange(n_buckets, device=dev)[:, None]
    src = b * B + starts[b, dst] + slot - bucket_off[b, dst]
    invalid = slot[None, :] >= fn[:, None]
    src = torch.where(invalid, 0, src)
    sentinel = torch.iinfo(keys.dtype).max
    fk = torch.where(invalid, sentinel, sk[src])
    fv = torch.where(invalid, 0, sv[src])
    # bucket sort on (key, invalid): one packed int64 key per row
    packed = (fk.to(torch.int64) << 1) | invalid.to(torch.int64)
    order = torch.sort(packed, dim=1, stable=True).indices
    ok = torch.gather(fk, 1, order)
    ov = torch.gather(fv, 1, order)
    valid = 1 - torch.gather(invalid, 1, order).to(torch.int32)
    overflow = fn.max()
    return ok.reshape(-1), ov.reshape(-1), valid.reshape(-1), fn, overflow


def sort_pairs_full_checked(keys: torch.Tensor, vals: torch.Tensor,
                            block_rows: int = 1024, n_buckets: int = 16,
                            cap_factor: float = 1.4):
    """sort_pairs_full with the overflow contract enforced: syncs the
    max bucket fill to the host and raises :class:`BucketOverflowError`
    instead of returning garbage."""
    out = sort_pairs_full(keys, vals, block_rows=block_rows,
                          n_buckets=n_buckets, cap_factor=cap_factor)
    cap = bucket_cap(int(keys.shape[0]), n_buckets, cap_factor)
    ovf = int(out[4])
    if ovf > cap:
        raise BucketOverflowError(
            f"bucket fill {ovf} > cap {cap} (n={int(keys.shape[0])}, "
            f"n_buckets={n_buckets}, cap_factor={cap_factor}) - retry "
            "with a higher cap_factor"
        )
    return out
