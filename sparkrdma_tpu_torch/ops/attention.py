"""Blockwise attention partials: the port of ``sparkrdma_tpu/ops/attention.py``.

One call computes the flash-style partials of attention between the
queries and ONE key/value block:

    m[i] = max_j s[i, j]                  (row max of masked scores)
    l[i] = sum_j exp(s[i, j] - m[i])      (unnormalised denominator)
    o[i] = sum_j exp(s[i, j] - m[i]) v[j]

with ``s = (q @ k^T in float32) * scale`` and an optional causal mask by
global positions ``q_offset + i >= k_offset + j``.  The ring step folds
the partials into its running accumulator (``models/ring_attention.py``).

``NEG_INF`` is a large FINITE number, not -inf: a row masked throughout
the call keeps ``m == NEG_INF``, its ``exp(NEG_INF - NEG_INF) = 1``
gives ``l = s_k`` and ``o = sum v``, and the fold's
``exp(NEG_INF - m_new) = 0`` annihilates those partials; -inf would give
inf - inf = NaN there.

On a CUDA tensor :func:`block_attention` launches the hand-written
kernel of ``csrc/block_attention.cu`` (or raises); on a CPU tensor it
runs :func:`block_attention_plain`, which is also what the kernel is
held against on the card.  The kernel takes float32, bfloat16 and
float16 at every ``d_head``: it is compiled at the head sizes
:data:`D_HEADS`, and past the largest of them it runs any multiple of
:data:`WIDE_ALIGN` as slabs of at most 256 columns of o, each
recomputing the scores over all of d.  Any other ``d_head`` runs the
kernel at the next such size on zero-padded q, k and v
(:func:`pad_head_dim`), which is exact.  Both follow the Pallas
kernel's arithmetic: the scale multiplies the float32
product, and ``p`` is cast to v's dtype before the ``p @ v`` product,
accumulated in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch import _build

NEG_INF = -1e30
BLOCK_Q = 128   # query rows per CUDA block (16-bit kernel)
BLOCK_K = 128   # keys per step of its loop over the K/V block (64 at d 256)
D_HEADS = (64, 128, 256)  # the head sizes the kernel is compiled at
WIDE_ALIGN = 64  # past D_HEADS[-1] the kernel runs multiples of this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES = _build.LaunchCounter("block_attention")

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def block_attention_plain(q, k, v, q_offset: int, k_offset: int,
                          causal: bool, scale: float) -> Partials:
    """The kernel's function in plain PyTorch over ``[..., s, d]``: q and
    k upcast to float32 for the product, ``p`` cast to v's dtype before
    a float32 ``p @ v``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[-2], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[-2], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), o


def _check(q, k, v):
    if q.dim() not in (2, 3):
        raise ValueError(f"q must be [s, d] or [N, s, d], got {tuple(q.shape)}")
    if k.shape != v.shape or k.dim() != q.dim():
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"share a shape of q's rank {q.dim()}")
    if k.shape[-1] != q.shape[-1] or k.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or d_head")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernel's 16-byte
    copies need (a view into a larger tensor may start anywhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def kernel_d_head(d: int) -> int:
    """The head size the kernel runs ``d`` at: the smallest of
    :data:`D_HEADS` at or above it, and past the largest ``d`` rounded
    up to a multiple of :data:`WIDE_ALIGN` (the slab kernels)."""
    for c in D_HEADS:
        if d <= c:
            return c
    return -(-d // WIDE_ALIGN) * WIDE_ALIGN


def pad_head_dim(inner, q, k, v, q_offset, k_offset, causal,
                 scale: float) -> Partials:
    """``inner(q, k, v, q_offset, k_offset, causal, scale)`` at the
    head size :func:`kernel_d_head` of q's ``d``: q, k and v
    zero-padded in the last dimension, ``o`` cut back to ``d``.  Exact:
    zero columns of q and k add 0 to every score, and zero columns of v
    give only the ``o`` columns that are cut off.  ``scale`` is the
    caller's, of the unpadded ``d``."""
    d = q.shape[-1]
    width = kernel_d_head(d)
    if width == d:
        return inner(q, k, v, q_offset, k_offset, causal, scale)
    q, k, v = (torch.nn.functional.pad(x, (0, width - d)) for x in (q, k, v))
    m, l, o = inner(q, k, v, q_offset, k_offset, causal, scale)
    return m, l, o[..., :d].contiguous()


def _attention_cuda(q, k, v, q_offset, k_offset, causal, scale) -> Partials:
    """One call of the kernel at a head size it runs (past 256 in
    bfloat16 and float16, a narrower last slab is a second launch)."""
    d = q.shape[-1]
    q3, k3, v3 = (_rows16(x.reshape(-1, x.shape[-2], d)) for x in (q, k, v))
    n, s_q, s_k = q3.shape[0], q3.shape[1], k3.shape[1]
    m = torch.empty((n, s_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((n, s_q, d), dtype=torch.float32, device=q.device)
    if m.numel() == 0:
        return (m.reshape(q.shape[:-1]), l.reshape(q.shape[:-1]),
                o.reshape(q.shape))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sr_block_attention(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            m.data_ptr(), l.data_ptr(), o.data_ptr(),
            n, s_q, s_k, d, int(q_offset), int(k_offset), int(causal),
            ctypes.c_float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    _build.check(rc, "block_attention")
    LAUNCHES.bump()
    return (m.reshape(q.shape[:-1]), l.reshape(q.shape[:-1]),
            o.reshape(q.shape))


def block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    k_offset: int = 0,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> Partials:
    """Partial attention of ``q`` ``[s_q, d]`` against one K/V block
    ``[s_k, d]``, or of a batch ``[N, s, d]`` (the JAX package's
    ``vmap``).  Returns float32 ``(m [(N,) s_q], l [(N,) s_q],
    o [(N,) s_q, d])``; ``o`` is not normalised.

    ``q_offset`` and ``k_offset`` are the global positions of row 0 of
    q and of k, used by the causal mask.  ``scale`` defaults to
    ``1 / sqrt(d)``.  ``block_q`` and ``block_k`` are tiling hints, any
    positive size, as in the JAX function: the CUDA kernel keeps its
    (BLOCK_Q, BLOCK_K) tile and the plain version takes no tile, as the
    JAX ``xla`` path does (a tile changes no result beyond the order of
    summation).  A non-positive size raises ``ValueError``.  CUDA
    tensors (float32, bfloat16 or float16, any d_head) run the kernel,
    at a padded head size where :func:`kernel_d_head` differs from
    d_head (:func:`pad_head_dim`); CPU tensors run
    :func:`block_attention_plain`.  Another dtype on CUDA raises
    ``ValueError``.
    """
    _check(q, k, v)
    if block_q < 1 or block_k < 1:
        raise ValueError(f"tile ({block_q}, {block_k}) must be positive")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cuda":
        if q.dtype not in _DTYPE_CODE:
            raise ValueError(f"the kernel takes "
                             f"{sorted(map(str, _DTYPE_CODE))}, got {q.dtype}")
        return pad_head_dim(_attention_cuda, q, k, v, q_offset, k_offset,
                            causal, float(scale))
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return block_attention_plain(q, k, v, q_offset, k_offset, causal,
                                 float(scale))
