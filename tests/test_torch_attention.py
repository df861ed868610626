"""The port's ``block_attention`` against the JAX package, on the CPU.

On a CPU tensor ``sparkrdma_tpu_torch.ops.attention.block_attention``
runs its plain version, which must compute the Pallas kernel's
function.  The same seeded numpy inputs go through the port and through
JAX's ``block_attention`` with ``impl="pallas"`` (interpret mode on the
CPU, as tests/test_attention_kernel.py runs it) and ``impl="xla"``; a
batch goes through ``jax.vmap``, as the JAX ring does.

Tolerances, as tests/test_attention_kernel.py holds Pallas against xla:
m and l rtol 1e-5, o rtol and atol 1e-4 (float32 sums in other orders).
In bfloat16 and float16, Pallas runs with one K block over all of s_k,
so both round ``p`` against the same row max, and o keeps rtol and atol
1e-4 relative to its scale (16-bit inputs are exact in float32; only
summation order differs).  That holds for the small cases of the older
tests; in general a term's ``p`` rounds to v's dtype on either side of
a rounding boundary when the two compute it in other orders, and JAX's
xla path does not round ``p`` at all.  So the head-size tests hold a
16-bit o within one step of that rounding per term, ``ulp * (p @ |v|)``
elementwise on top of the float32 tolerance, with ``ulp`` = 2^-7 for
bfloat16 and 2^-10 for float16 (relative) and ``p @ |v|`` from the
plain version on ``|v|``.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkrdma_tpu.ops import attention as jattn
from sparkrdma_tpu_torch.ops import attention as tattn

# the module: the models package exports a function of the same name
tring = importlib.import_module("sparkrdma_tpu_torch.models.ring_attention")

M_TOL = dict(rtol=1e-5)
O_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(n, s_q, s_k, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    return (rng.standard_normal(lead + (s_q, d)).astype(dtype),
            rng.standard_normal(lead + (s_k, d)).astype(dtype),
            rng.standard_normal(lead + (s_k, d)).astype(dtype))


def _jax(q, k, v, impl, jdtype=jnp.float32, **kw):
    # float32 runs Pallas over several K blocks (its online rescaling);
    # bfloat16 and float16 over one, so that p is rounded against the
    # full row max
    block_k = 32 if jdtype == jnp.float32 else k.shape[-2]
    blocks = dict(block_q=32, block_k=block_k) if impl == "pallas" else {}

    def one(qq, kk, vv):
        return jattn.block_attention(qq, kk, vv, impl=impl, **blocks, **kw)

    fn = one if q.ndim == 2 else jax.vmap(one)
    return tuple(np.asarray(x) for x in fn(
        *(jnp.asarray(x, jdtype) for x in (q, k, v))))


def _port(q, k, v, dtype=torch.float32, **kw):
    return tattn.block_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw)


def _close(got, want, p_rounding=None):
    """``p_rounding``: ``ulp * (p @ |v|)``, o's room for p rounded
    otherwise (module docstring)."""
    m, l, o = (x.numpy() for x in got)
    assert all(x.dtype == np.float32 for x in (m, l, o))
    np.testing.assert_allclose(m, want[0], **M_TOL)
    np.testing.assert_allclose(l, want[1], **M_TOL)
    if p_rounding is None:
        np.testing.assert_allclose(o, want[2], **O_TOL)
    else:
        lim = O_TOL["atol"] + O_TOL["rtol"] * np.abs(want[2]) + p_rounding
        assert (np.abs(o - want[2]) <= lim).all(), \
            float(np.abs(o - want[2]).max())


CASES = {
    # name: (batch, s_q, s_k, d, q_offset, k_offset)
    "square": (None, 64, 64, 64, 0, 0),
    "s_q_ne_s_k": (None, 64, 96, 64, 32, 0),
    "batch3": (3, 64, 96, 32, 0, 0),
    "k_ahead": (None, 64, 96, 64, 0, 16),
    "q_ahead": (3, 64, 64, 32, 128, 0),
}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_matches_jax(name, causal, impl):
    n, s_q, s_k, d, qo, ko = CASES[name]
    q, k, v = _qkv(n, s_q, s_k, d, seed=len(name) + causal)
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    _close(_port(q, k, v, **kw), _jax(q, k, v, impl, **kw))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("n", [None, 3])
def test_f32_fully_masked_rows_keep_neg_inf(n, impl):
    s_q, s_k = 64, 96
    q, k, v = _qkv(n, s_q, s_k, 32, seed=5)
    kw = dict(q_offset=0, k_offset=s_q, causal=True)  # every key ahead
    m, l, o = _port(q, k, v, **kw)
    assert bool((m == tattn.NEG_INF).all())
    assert bool((l == s_k).all())
    np.testing.assert_allclose(
        o.numpy(), np.broadcast_to(v.sum(-2, keepdims=True), o.shape),
        rtol=1e-5, atol=1e-5)
    _close((m, l, o), _jax(q, k, v, impl, **kw))


def test_f32_partly_masked_rows():
    # rows 0..15 see no key, the rest a growing prefix
    q, k, v = _qkv(None, 64, 64, 32, seed=6)
    kw = dict(q_offset=0, k_offset=16, causal=True)
    m, l, _o = _port(q, k, v, **kw)
    assert bool((m[:16] == tattn.NEG_INF).all())
    assert bool((m[16:] > tattn.NEG_INF).all())
    np.testing.assert_array_equal(l[:16].numpy(), np.full(16, 64.0))
    _close(_port(q, k, v, **kw), _jax(q, k, v, "pallas", **kw))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["s_q_ne_s_k", "batch3", "k_ahead"])
def test_bf16_matches_jax_pallas(name, causal):
    n, s_q, s_k, d, qo, ko = CASES[name]
    q, k, v = _qkv(n, s_q, s_k, d, seed=11 + len(name) + causal)
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    got = _port(q, k, v, dtype=torch.bfloat16, **kw)
    _close(got, _jax(q, k, v, "pallas", jdtype=jnp.bfloat16, **kw))


def test_plain_rounds_p_to_v_dtype():
    """bf16: the plain version differs from an unrounded f32 ``p @ v``
    (JAX's xla path) by the rounding of p, and equals it when p is
    rounded first."""
    q, k, v = _qkv(None, 64, 96, 32, seed=12)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    m, l, o = tattn.block_attention(qb, kb, vb, causal=True)
    s = (qb.float() @ kb.float().T) / np.sqrt(32)
    s = torch.where(torch.ones(64, 96, dtype=torch.bool).tril(), s,
                    torch.tensor(tattn.NEG_INF))
    p = torch.exp(s - m[:, None])
    assert torch.equal(o, p.to(torch.bfloat16).float() @ vb.float())
    assert not torch.equal(o, p @ vb.float())


def test_default_scale_is_inverse_sqrt_d():
    q, k, v = _qkv(2, 16, 16, 64, seed=13)
    a = _port(q, k, v)
    b = _port(q, k, v, scale=1 / 8.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "shapes,kw",
    [(((4, 8), (5, 8), (4, 8)), {}),
     (((4, 8), (4, 16), (4, 16)), {}),
     (((8,), (8,), (8,)), {}),
     (((2, 4, 8), (3, 4, 8), (3, 4, 8)), {}),
     (((4, 8), (4, 8), (4, 8)), dict(block_q=0)),
     (((4, 8), (4, 8), (4, 8)), dict(block_k=-128))],
)
def test_refuses_bad_shapes_and_tiles(shapes, kw):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tattn.block_attention(q, k, v, **kw)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize(
    "tile", [dict(block_q=32), dict(block_k=256),
             dict(block_q=512, block_k=1024)])
def test_any_positive_tile_matches_jax(tile, impl):
    """block_q and block_k are tiling hints, as in the JAX function: any
    positive size gives the JAX package's result for the same
    arguments."""
    n, s_q, s_k, d, qo, ko = CASES["s_q_ne_s_k"]
    q, k, v = _qkv(n, s_q, s_k, d, seed=31)
    kw = dict(q_offset=qo, k_offset=ko, causal=True)
    want = tuple(np.asarray(x) for x in jattn.block_attention(
        *(jnp.asarray(x) for x in (q, k, v)), impl=impl, **tile, **kw))
    _close(_port(q, k, v, **tile, **kw), want)


def test_refuses_mixed_dtypes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="dtypes differ"):
        tattn.block_attention(x, x, x.to(torch.bfloat16))


# Causal blocks whose 128-row q tiles (BLOCK_Q) straddle the diagonal:
# name: (s_q, s_k, q_offset, k_offset)
STRADDLE = {
    "q_ahead_200": (300, 500, 200, 0),
    "k_ahead_70": (300, 500, 0, 70),      # rows 0..69 see no key
    "k_past_q_block": (300, 500, 0, 400),  # every row sees no key
    "ring_diagonal_hop": (256, 384, 256, 256),
}


def _visited_keys(q0, q1, s_k, qo, ko):
    """Keys the CUDA kernel visits for q rows [q0, q1): a prefix of
    whole BLOCK_K tiles when every row sees key 0, else every key."""
    if qo + q0 < ko:  # a row masked throughout needs every tile
        return s_k
    c_max = qo + q1 - 1 - ko  # the last key any row of the tile sees
    return min(s_k, (c_max // tattn.BLOCK_K + 1) * tattn.BLOCK_K)


@pytest.mark.parametrize("name", sorted(STRADDLE))
def test_causal_tile_skip_is_exact(name):
    """The partials over the visited K prefix, folded with those over the
    skipped K tiles, equal the partials over the whole block: the skipped
    part is all NEG_INF, so its beta is 0 and m and l are unchanged."""
    s_q, s_k, qo, ko = STRADDLE[name]
    q, k, v = (torch.from_numpy(x) for x in _qkv(None, s_q, s_k, 32, seed=21))
    kw = dict(causal=True, scale=1 / np.sqrt(32))
    skipped_any = False
    for q0 in range(0, s_q, tattn.BLOCK_Q):
        q1 = min(q0 + tattn.BLOCK_Q, s_q)
        qt = q[q0:q1]
        full = tattn.block_attention_plain(qt, k, v, qo + q0, ko, **kw)
        n_vis = _visited_keys(q0, q1, s_k, qo, ko)
        if n_vis == s_k:
            continue
        skipped_any = True
        vis = tattn.block_attention_plain(qt, k[:n_vis], v[:n_vis], qo + q0,
                                          ko, **kw)
        skip = tattn.block_attention_plain(qt, k[n_vis:], v[n_vis:],
                                           qo + q0, ko + n_vis, **kw)
        assert bool((skip[0] == tattn.NEG_INF).all())
        assert bool((vis[0] > tattn.NEG_INF).all())
        beta = torch.exp(skip[0] - torch.maximum(vis[0], skip[0]))
        assert bool((beta == 0).all())
        m, l, o = tring.fold_partials(*vis, *skip)
        assert torch.equal(m, full[0]) and torch.equal(m, vis[0])
        assert torch.equal(l, vis[1])
        np.testing.assert_allclose(l.numpy(), full[1].numpy(), rtol=1e-6)
        np.testing.assert_allclose(o.numpy(), full[2].numpy(), rtol=1e-5,
                                   atol=1e-5)
    # only the block whose every row is masked throughout skips nothing
    assert skipped_any == (name != "k_past_q_block")


@pytest.mark.parametrize("name", ["k_ahead_70", "k_past_q_block"])
def test_rows_masked_throughout_keep_the_full_sum(name):
    """Rows that see no key: m == NEG_INF, l == s_k and o == sum v over
    every key, which is why their q tile visits every K tile (or, when
    the whole tile is masked, the kernel skips only the q.k^T product)."""
    s_q, s_k, qo, ko = STRADDLE[name]
    q, k, v = (torch.from_numpy(x) for x in _qkv(None, s_q, s_k, 32, seed=22))
    m, l, o = tattn.block_attention(q, k, v, qo, ko, causal=True)
    dead = (qo + torch.arange(s_q)) < ko
    assert bool(dead.any())
    assert bool((m[dead] == tattn.NEG_INF).all())
    assert bool((l[dead] == s_k).all())
    np.testing.assert_allclose(
        o[dead].numpy(),
        np.broadcast_to(v.sum(0).numpy(), o[dead].shape), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(STRADDLE))
def test_straddling_tiles_match_jax(name, impl):
    s_q, s_k, qo, ko = STRADDLE[name]
    q, k, v = _qkv(None, s_q, s_k, 32, seed=23 + len(name))
    kw = dict(q_offset=qo, k_offset=ko, causal=True)
    # one q block and K blocks of about 128 keys keep interpret mode fast
    blocks = dict(block_q=s_q, block_k=128) if impl == "pallas" else {}
    want = tuple(np.asarray(x) for x in jattn.block_attention(
        *(jnp.asarray(x) for x in (q, k, v)), impl=impl, **blocks, **kw))
    _close(_port(q, k, v, **kw), want)


# -- every head size to 256, in float32, bfloat16 and float16 ----------------

HEAD_DIMS = [32, 80, 96, 256]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
P_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# name: (s_q, s_k, q_offset, k_offset, causal)
HEAD_CASES = {
    "ragged": (48, 80, 32, 0, False),
    "ragged_causal": (48, 80, 32, 0, True),
    "straddle": (160, 288, 100, 0, True),   # a 128-row q tile straddles
    "k_ahead_70": (160, 288, 0, 70, True),  # rows 0..69 see no key
    "masked": (64, 96, 0, 64, True),        # every row sees no key
}


def _p_rounding(q, k, v, dt, **kw):
    """``ulp * (p @ |v|)`` of the plain version: o's room for p rounded
    otherwise, or not at all (module docstring)."""
    tdt = DTYPES[dt][0]
    _m, _l, pv = tattn.block_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, np.abs(v))), **kw)
    return P_ULP[dt] * pv.numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_every_head_size_and_dtype_matches_jax(d, dt, case, impl):
    """d 32, 80, 96 and 256 (the kernel runs 32 and 80 at 64 or 128, 96
    at 128, padded, and 256 natively) in the three dtypes the JAX
    function takes, causal and not, with q tiles straddling the
    diagonal and rows masked partly and throughout."""
    s_q, s_k, qo, ko, causal = HEAD_CASES[case]
    q, k, v = _qkv(None, s_q, s_k, d, seed=d + len(case) + len(dt))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    tdt, jdt = DTYPES[dt]
    got = _port(q, k, v, dtype=tdt, **kw)
    if case == "masked":
        assert bool((got[0] == tattn.NEG_INF).all())
        assert bool((got[1] == s_k).all())
    rounding = None if dt == "float32" else _p_rounding(q, k, v, dt, **kw)
    _close(got, _jax(q, k, v, impl, jdtype=jdt, **kw), rounding)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_padding_path_equals_the_unpadded_plain_version(dt):
    """The wrapper's padding (what a CUDA tensor at d 80 runs, here with
    the plain version inside): q, k, v padded to 128 columns and o cut
    back equal the plain version at d 80 exactly, since zero columns add
    exact zeros."""
    q, k, v = (torch.from_numpy(x).to(DTYPES[dt][0])
               for x in _qkv(2, 70, 150, 80, seed=41))
    scale = 1 / np.sqrt(80)
    for qo, ko, causal in ((0, 0, False), (30, 0, True), (0, 100, True)):
        seen = []

        def inner(*args):
            seen.append(args[0].shape[-1])
            return tattn.block_attention_plain(*args)

        got = tattn.pad_head_dim(inner, q, k, v, qo, ko, causal, scale)
        want = tattn.block_attention_plain(q, k, v, qo, ko, causal, scale)
        assert seen == [128]
        assert got[2].shape == (2, 70, 80)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_kernel_head_sizes():
    """Each d_head up to 256 runs at the smallest compiled size at or
    above it; past 256 the kernel runs every multiple of 64 (its slab
    kernels), so d_head rounds up to one."""
    assert [tattn.kernel_d_head(d) for d in (1, 32, 64, 65, 96, 128, 129,
                                             200, 256)] == \
        [64, 64, 64, 128, 128, 128, 256, 256, 256]
    assert [tattn.kernel_d_head(d) for d in (257, 300, 320, 512, 513, 576,
                                             1000, 2048)] == \
        [320, 320, 320, 512, 576, 576, 1024, 2048]


# -- past d_head 256 -----------------------------------------------------------

WIDE_DIMS = [300, 320, 512, 576]
WIDE_CASES = ("ragged_causal", "straddle", "masked")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_head_sizes_match_jax(d, dt, case, impl):
    """d 320, 512 and 576 (what the CUDA kernel runs as slabs of o: one
    full slab and a 64-column one, two full ones, two and a 64-column
    one) and d 300 (padded to 320) through the padding and dispatch
    helper around the plain version, in the three dtypes, against the
    JAX function, whose Pallas kernel takes any d."""
    s_q, s_k, qo, ko, causal = HEAD_CASES[case]
    q, k, v = _qkv(None, s_q, s_k, d, seed=d + len(case) + len(dt))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    tdt, jdt = DTYPES[dt]
    seen = []

    def inner(*args):
        seen.append(args[0].shape[-1])
        return tattn.block_attention_plain(*args)

    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = tattn.pad_head_dim(inner, tq, tk, tv, qo, ko, causal,
                             1 / np.sqrt(d))
    assert seen == [tattn.kernel_d_head(d)]
    assert got[2].shape == (s_q, d)
    for g, w in zip(got, _port(q, k, v, dtype=tdt, **kw)):
        assert torch.equal(g, w)
    if case == "masked":
        assert bool((got[0] == tattn.NEG_INF).all())
        assert bool((got[1] == s_k).all())
    rounding = None if dt == "float32" else _p_rounding(q, k, v, dt, **kw)
    _close(got, _jax(q, k, v, impl, jdtype=jdt, **kw), rounding)
