"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer results must match bit for bit; ``fill`` is compared under the
returned flag.  Attention partials are held with the tolerances of
:func:`_close_partials`.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.models import join as tjoin
from sparkrdma_tpu_torch.models import join_aggregate as tja
from sparkrdma_tpu_torch.models import terasort as tts
from sparkrdma_tpu_torch.models import topk as ttopk
from sparkrdma_tpu_torch.models import wordcount as twc
from sparkrdma_tpu_torch.ops import attention as tattn
from sparkrdma_tpu_torch.ops import partition as tpart
from sparkrdma_tpu_torch.ops import scan_kernels as tscan
from sparkrdma_tpu_torch.ops import segment as tseg
from sparkrdma_tpu_torch.ops import sort_kernel as tsort

I32 = np.iinfo(np.int32)


def _keys(pattern, n, rng):
    if pattern == "random":
        return rng.integers(I32.min, I32.max, n, dtype=np.int32,
                            endpoint=True)
    if pattern == "dups_extremes":
        k = rng.integers(0, 7, n, dtype=np.int32)
        k[: n // 8] = rng.choice(
            np.array([I32.max, I32.min, 0, -1], np.int32), n // 8
        )
        return k
    return np.full(n, 7, np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["random", "dups_extremes", "equal"])
def test_block_sort_kernel_matches_plain_on_card(cuda_device, pattern):
    """One CTA with the tile cut to the block (1-32 rows), one full CTA
    (64), clusters of 2, 8 and 16 (128, 512, 1024), and a cluster of 16
    with global passes beyond it (2048)."""
    rng = np.random.default_rng(1)
    for block_rows in (1, 2, 64, 128, 512, 1024, 2048):
        n = 4 * block_rows * 128
        k = torch.from_numpy(_keys(pattern, n, rng)).to(cuda_device)
        v = torch.arange(n, dtype=torch.int32, device=cuda_device)
        gk, gv = tsort.sort_pairs_blocks(k, v, block_rows=block_rows)
        wk, wv = tsort.block_sort_plain(k, v, block_rows=block_rows)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
        assert torch.equal(gk, torch.sort(k.view(-1, block_rows * 128),
                                          dim=1).values.reshape(-1))


@pytest.mark.gpu
def test_block_sort_kernel_takes_unaligned_views_on_card(cuda_device):
    n = 2 * 128 * 128
    k = torch.randint(-99, 99, (n + 1,), dtype=torch.int32,
                      device=cuda_device)[1:]
    v = torch.arange(n + 1, dtype=torch.int32, device=cuda_device)[1:]
    gk, gv = tsort.sort_pairs_blocks(k, v, block_rows=128)
    wk, wv = tsort.block_sort_plain(k, v, block_rows=128)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.gpu
def test_block_sort_cluster_shape_on_card(cuda_device):
    for block_rows, cluster in ((32, 1), (64, 1), (128, 2), (256, 4),
                                (512, 8), (1024, 16), (2048, 16)):
        shape = tsort.cluster_shape(block_rows)
        assert shape["cluster"] == cluster
        assert shape["max_active_clusters"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fill", "add", "min", "max"])
def test_scan_kernel_matches_plain_on_card(cuda_device, kind):
    rng = np.random.default_rng(2)
    n = 3 * 4096 + 77
    flag = torch.from_numpy(rng.random(n) < 0.01).to(cuda_device)
    cols = [torch.from_numpy(rng.integers(-99, 99, n).astype(dt))
            .to(cuda_device) for dt in (np.int32, np.int64, np.int32)]
    gf, gx = tscan.scan_flagged(kind, flag, cols)
    wf, wx = tscan.scan_flagged_plain(kind, flag, cols)
    assert torch.equal(gf, wf)
    for g, w in zip(gx, wx):
        m = wf if kind == "fill" else torch.ones_like(wf)
        assert torch.equal(g[m], w[m])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["add", "min"])
def test_scan_kernel_float32_and_uint32_on_card(cuda_device, kind):
    rng = np.random.default_rng(3)
    n = 5 * 4096 + 3
    flag = torch.from_numpy(rng.random(n) < 0.01).to(cuda_device)
    xf = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xu = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                          .astype(np.uint32))
    cols = [xf.to(cuda_device), xu.to(cuda_device)]
    _gf, (gx, gu) = tscan.scan_flagged(kind, flag, cols)
    _wf, (wx, wu) = tscan.scan_flagged_plain(kind, flag, cols)
    # float32 sums in another order in the kernel than in the log-step
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
    assert torch.equal(gu.long(), wu.long())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint32])
def test_cumsum_kernel_without_flags_on_card(cuda_device, dtype):
    rng = np.random.default_rng(4)
    n = 7 * 4096 + 5
    x = torch.from_numpy(rng.integers(0, 1 << 31, n).astype(np.int64))
    x = x.to(dtype).to(cuda_device)
    got = tscan.cumsum_1d(x)
    zero = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    _f, (want,) = tscan.scan_flagged_plain("add", zero, [x])
    assert got.dtype == dtype
    assert torch.equal(got.long(), want.long())


@pytest.mark.gpu
def test_scan_tile_matches_the_kernel(cuda_device):
    lib = _build.load()
    for n_cols in (1, 2, 3):
        for i32 in (True, False):
            assert lib.sr_flagged_scan_tile(n_cols, i32) == \
                tscan.tile_elems(n_cols, i32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fill", "add", "min", "max"])
def test_scan_kernel_many_tiles_on_card(cuda_device, kind):
    """2^24 + 17 elements: 2049 tiles for one int32 column and 4097 for
    more, so tiles fold long runs of their predecessors' aggregates
    before they meet an inclusive prefix (flags at 1e-4, so most tiles
    hold none); 1-3 int32 columns and a mixed int32/int64 set."""
    rng = np.random.default_rng(10)
    n = (1 << 24) + 17
    flag = torch.from_numpy(rng.random(n) < 1e-4).to(cuda_device)
    cols = [torch.from_numpy(rng.integers(I32.min, I32.max, n,
                                          dtype=np.int32)).to(cuda_device)
            for _ in range(3)]
    sets = [cols[:1], cols[:2], cols, [cols[0], cols[1].long() << 20]]
    for cs in sets:
        gf, gx = tscan.scan_flagged(kind, flag, cs)
        wf, wx = tscan.scan_flagged_plain(kind, flag, cs)
        assert torch.equal(gf, wf)
        m = wf if kind == "fill" else torch.ones_like(wf)
        for g, w in zip(gx, wx):
            assert torch.equal(g[m], w[m])
    if kind == "add":
        got = tscan.cumsum_1d(cols[0])
        _f, (want,) = tscan.scan_flagged_plain(
            "add", torch.zeros_like(flag), cols[:1])
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int64])
def test_scan_kernel_two_column_fill_on_card(cuda_device, dtype):
    """The join probe's fill: two uint32 (or int64) columns."""
    rng = np.random.default_rng(11)
    n = 9 * 4096 + 5
    flag = torch.from_numpy(rng.random(n) < 0.05).to(cuda_device)
    cols = [torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                             .astype(np.int64)).to(dtype).to(cuda_device)
            for _ in range(2)]
    gf, gx = tscan.scan_flagged("fill", flag, cols)
    wf, wx = tscan.scan_flagged_plain("fill", flag, cols)
    assert torch.equal(gf, wf)
    for g, w in zip(gx, wx):
        # CUDA indexes no uint32 tensor: compare as int64
        assert g.dtype == dtype and torch.equal(g.long()[wf], w.long()[wf])


SQL_N = 1 << 17


def _sql_cols(seed, n_dim, key_space):
    """Fact columns of SQL_N rows against a unique-keyed dimension,
    with about 10% of each side invalid."""
    rng = np.random.default_rng(seed)
    dk = rng.choice(key_space, n_dim, replace=False).astype(np.int32)
    cols = (rng.integers(0, key_space, SQL_N, dtype=np.int32),
            rng.integers(I32.min, I32.max, SQL_N, dtype=np.int32),
            (rng.random(SQL_N) < 0.9).astype(np.int32),
            dk, rng.integers(I32.min, I32.max, n_dim, dtype=np.int32),
            (rng.random(n_dim) < 0.9).astype(np.int32))
    return [torch.from_numpy(c) for c in cols]


def _same_on_card_and_cpu(step, cols, device, min_scans):
    """``step`` on the card and on the CPU: bit-exact outputs, and the
    card's run launched the flagged scan at least ``min_scans`` times."""
    want = step(*cols)
    _build.reset_launch_counts()
    got = step(*(c.to(device) for c in cols))
    assert _build.launch_counts()["flagged_scan"] >= min_scans
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hash", "broadcast"])
def test_join_steps_match_cpu_on_card(cuda_device, kind):
    cols = _sql_cols(1, 1 << 11, 1 << 12)
    if kind == "hash":
        step = tjoin.make_hash_join_step(1, SQL_N, 1 << 11, 2 * SQL_N)
    else:
        step = tjoin.make_broadcast_join_step(1, SQL_N, 1 << 11)
    _same_on_card_and_cpu(step, cols, cuda_device, 1)


def _gk1024(ku):
    return ku % 1024


def _xor(ku, fact_pay_u, dim_val_u):
    return (fact_pay_u ^ dim_val_u).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("hooks", ["defaults", "bench_tpcds"])
def test_join_aggregate_step_matches_cpu_on_card(cuda_device, hooks):
    gk, val = (tja._identity_group_key, None) if hooks == "defaults" \
        else (_gk1024, _xor)
    cols = _sql_cols(2, 1 << 11, 1 << 12)
    step = tja.make_broadcast_join_aggregate_step(1, SQL_N, 1 << 11, gk, val)
    # a fill, two prefix sums, a run-end fill, a min and a max scan
    _same_on_card_and_cpu(step, cols, cuda_device, 6)


@pytest.mark.gpu
def test_topk_step_matches_cpu_on_card(cuda_device):
    rng = np.random.default_rng(3)
    cols = [torch.from_numpy(c) for c in (
        rng.integers(0, 5000, SQL_N, dtype=np.int32),
        rng.integers(-100, 100, SQL_N, dtype=np.int32),
        (rng.random(SQL_N) < 0.9).astype(np.int32))]
    step = ttopk.make_topk_step(1, SQL_N, SQL_N, 100)
    _same_on_card_and_cpu(step, cols, cuda_device, 1)


STAGE_RANKS = 8


def _terasort_stages(keys, vals, valid, device):
    """One D = 8 rank's map side (sort, sample, splitters from its own
    sample, window fill) and the merge of the [8, cap] block it sends
    itself, every intermediate kept."""
    k, v = torch.from_numpy(keys).to(device), torch.from_numpy(vals).to(device)
    m = None if valid is None else torch.from_numpy(valid).to(device)
    sk, sv, n_real, sample = tts.sort_and_sample(k, v, m, 1024)
    splitters = tpart.make_range_splitters(sample, STAGE_RANKS)
    bk, bv, vc, counts = tts.fill_windows(sk, sv, n_real, splitters,
                                          keys.shape[0])
    return (sk, sv, n_real, sample, splitters, bk, bv, vc, counts,
            *tts.merge_received(bk, bv, vc))


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_terasort_rank_stages_match_cpu_on_card(cuda_device, wide):
    """TeraSort's rank-local stages at 2^17 rows on the card against
    the CPU, bit for bit: 8 B pairs with a validity column, or 100 B
    rows."""
    rng = np.random.default_rng(5)
    keys = _keys("dups_extremes", SQL_N, rng)
    vals = rng.integers(I32.min, I32.max, (SQL_N, 24) if wide else SQL_N,
                        dtype=np.int32)
    valid = None if wide else (rng.random(SQL_N) < 0.9).astype(np.int32)
    want = _terasort_stages(keys, vals, valid, "cpu")
    got = _terasort_stages(keys, vals, valid, cuda_device)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _keyed_stages(keys, vals, device):
    """One D = 8 rank's keyed map side and the reduction of the block
    it sends itself."""
    k, v = torch.from_numpy(keys).to(device), torch.from_numpy(vals).to(device)
    valid = torch.ones_like(k)
    ids = tpart.hash_partition_ids(k, STAGE_RANKS)
    cap = keys.shape[0] // 2
    (bk, bv, bm), counts = tpart.partition_to_buckets_dropping(
        ids, valid > 0, (k, v, valid), STAGE_RANKS, cap,
        fill_values=(I32.max, 0, 0))
    pk, pv, pm, _fill = twc._premask(bk.reshape(-1), bv.reshape(-1),
                                     bm.reshape(-1), 1, cap)
    return (ids, bk, bv, bm, counts, *tseg.reduce_by_key_local(pk, pv, pm))


@pytest.mark.gpu
def test_keyed_rank_stages_match_cpu_on_card(cuda_device):
    rng = np.random.default_rng(6)
    keys = _keys("random", SQL_N, rng) % 5000
    vals = rng.integers(-1000, 1000, SQL_N, dtype=np.int32)
    want = _keyed_stages(keys, vals, "cpu")
    _build.reset_launch_counts()
    got = _keyed_stages(keys, vals, cuda_device)
    assert _build.launch_counts()["flagged_scan"] >= 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_kernels_count_their_launches(cuda_device):
    _build.reset_launch_counts()
    k = torch.arange(512, dtype=torch.int32, device=cuda_device)
    tsort.sort_pairs_blocks(k, k, block_rows=4)
    tscan.cumsum_1d(k)
    x = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda_device)
    tattn.block_attention(x, x, x)
    assert _build.launch_counts() == {
        "flagged_scan": 1, "bitonic_block_sort": 1, "block_attention": 1,
    }


O_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7,
         torch.float16: 2.0 ** -10}
HALF = [torch.bfloat16, torch.float16]
# the compiled head sizes, and sizes the wrapper pads to them
D_HEADS = [32, 64, 80, 96, 128, 256]


def _close_partials(got, want, dtype):
    """m: float32 dot products summed in another order, atol and rtol
    1e-5, and rows masked throughout exactly NEG_INF.  l: rtol 1e-4 (the
    kernel's fast exponential and its order of summation).  o: within
    1e-4 of its largest magnitude in float32; in bfloat16 within 2^-7 of
    it, because the kernel rounds p to bfloat16 against the running max
    of each K tile and the plain version against the row max (one
    bfloat16 rounding, 2^-9 relative, per term of the sum); in float16
    within 2^-10 of it (one float16 rounding, 2^-11 relative, per
    term)."""
    (m, l, o), (wm, wl, wo) = got, want
    masked = wm == tattn.NEG_INF
    assert torch.equal(m[masked], wm[masked])
    torch.testing.assert_close(m[~masked], wm[~masked], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=0)
    scale = float(wo.abs().max())
    assert float((o - wo).abs().max()) <= O_TOL[dtype] * scale


def _qkv_cuda(n, s_q, s_k, d, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal((n, s, d)).astype(np.float32))
        .to(device=device, dtype=dtype)
        for s in (s_q, s_k, s_k))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", D_HEADS)
@pytest.mark.parametrize("dtype", HALF + [torch.float32])
def test_attention_kernel_matches_plain_on_card(cuda_device, dtype, d,
                                                causal):
    torch.backends.cuda.matmul.allow_tf32 = False  # plain in full f32
    for n, s_q, s_k, qo, ko in ((2, 256, 256, 0, 0),
                                (3, 100, 150, 50, 0),
                                (1, 64, 192, 64, 0)):
        q, k, v = _qkv_cuda(n, s_q, s_k, d, dtype, cuda_device, s_q + d)
        got = tattn.block_attention(q, k, v, qo, ko, causal)
        want = tattn.block_attention_plain(q, k, v, qo, ko, causal,
                                           1.0 / d ** 0.5)
        _close_partials(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 96, 256])
@pytest.mark.parametrize("dtype", HALF + [torch.float32])
def test_attention_kernel_masked_rows_on_card(cuda_device, dtype, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    s_q, s_k = 100, 150
    q, k, v = _qkv_cuda(3, s_q, s_k, d, dtype, cuda_device, 7)
    m, l, o = tattn.block_attention(q, k, v, 0, s_q, True)  # all masked
    assert bool((m == tattn.NEG_INF).all()) and bool((l == s_k).all())
    torch.testing.assert_close(
        o, v.float().sum(1, keepdim=True).expand_as(o), rtol=1e-4,
        atol=1e-3)
    for qo, ko in ((0, 70), (130, 130)):  # rows partly / fully masked
        got = tattn.block_attention(q, k, v, qo, ko, True)
        want = tattn.block_attention_plain(q, k, v, qo, ko, True,
                                           1.0 / d ** 0.5)
        _close_partials(got, want, dtype)


# 16-bit, causal: (n, s_q, s_k, q_offset, k_offset)
EDGE_CASES = [
    (1, 300, 500, 200, 0),     # 128-row q tiles straddle the diagonal
    (33, 130, 257, 0, 0),      # many heads; s_q, s_k not multiples of 128
    (2, 300, 500, 0, 70),      # rows 0..69 masked throughout
    (3, 200, 300, 0, 1000),    # the K block wholly in the future
    (2, 256, 384, 256, 256),   # a ring hop on the diagonal
    (1, 513, 129, 1000, 300),  # every row past every key
]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_attention_kernel_edges_on_card(cuda_device, case, dtype, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, s_q, s_k, qo, ko = case
    q, k, v = _qkv_cuda(n, s_q, s_k, d, dtype, cuda_device, s_q + s_k + d)
    got = tattn.block_attention(q, k, v, qo, ko, True)
    want = tattn.block_attention_plain(q, k, v, qo, ko, True, 1.0 / d ** 0.5)
    _close_partials(got, want, dtype)
    dead = (qo + torch.arange(s_q, device=cuda_device)) < ko
    assert bool((got[0][:, dead] == tattn.NEG_INF).all())
    assert bool((got[1][:, dead] == s_k).all())


@pytest.mark.gpu
def test_attention_kernel_refuses_other_d_head_on_card(cuda_device):
    """No d_head is refused: 257 runs the kernel (padded to 320, its
    slab kernel) in every dtype, with o at 257 columns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in HALF + [torch.float32]:
        q, k, v = _qkv_cuda(1, 64, 96, 257, dtype, cuda_device, 257)
        _build.reset_launch_counts()
        got = tattn.block_attention(q, k, v, 0, 0, True)
        assert _build.launch_counts()["block_attention"] == 1
        assert got[2].shape == (1, 64, 257)
        want = tattn.block_attention_plain(q, k, v, 0, 0, True,
                                           1.0 / 257 ** 0.5)
        _close_partials(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [320, 512, 576])
@pytest.mark.parametrize("dtype", HALF + [torch.float32])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_attention_kernel_wide_d_head_on_card(cuda_device, case, dtype, d):
    """Past d_head 256 (slabs of o: 256 + 64, 256 + 256, 2 x 256 + 64
    columns), causal, with ragged, straddling and fully masked rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, s_q, s_k, qo, ko = case
    q, k, v = _qkv_cuda(n, s_q, s_k, d, dtype, cuda_device, s_q + s_k + d)
    _build.reset_launch_counts()
    got = tattn.block_attention(q, k, v, qo, ko, True)
    assert _build.launch_counts()["block_attention"] == 1
    want = tattn.block_attention_plain(q, k, v, qo, ko, True, 1.0 / d ** 0.5)
    _close_partials(got, want, dtype)
    dead = (qo + torch.arange(s_q, device=cuda_device)) < ko
    assert bool((got[0][:, dead] == tattn.NEG_INF).all())
    assert bool((got[1][:, dead] == s_k).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 33, 200])
def test_attention_kernel_pads_to_a_compiled_d_head_on_card(cuda_device,
                                                            d):
    """A head size the kernel is not compiled at launches the kernel once
    at the next compiled size, and o comes back at d columns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv_cuda(2, 130, 200, d, torch.float16, cuda_device, d)
    _build.reset_launch_counts()
    got = tattn.block_attention(q, k, v, 0, 0, True)
    assert _build.launch_counts()["block_attention"] == 1
    assert got[2].shape == (2, 130, d)
    want = tattn.block_attention_plain(q, k, v, 0, 0, True, 1.0 / d ** 0.5)
    _close_partials(got, want, torch.float16)


# -- the byte data plane on the card (D = 1) ------------------------------------


def _byte_case(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n, dtype=np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 1, 2, 3])
def test_byte_plane_exchange_padded_on_card(cuda_device, window):
    """A pinned source row through the card, full shot and windowed:
    the received stream is the sent one, and the views hold pinned host
    memory the host reads only after the copies landed."""
    from sparkrdma_tpu_torch.memory.device_arena import DeviceStagingBridge
    from sparkrdma_tpu_torch.parallel.exchange import (
        PaddedSourceRow,
        TileExchange,
    )

    n = 5 * (1 << 16) + 333
    ex = TileExchange(device=cuda_device, tile_bytes=1 << 16,
                      verify_integrity=True)
    lengths = np.array([[n]], np.int64)
    cols = ex.plan(lengths).total_cols
    row = DeviceStagingBridge(cuda_device).alloc_row(cols)
    assert torch.from_numpy(row).is_pinned()
    row[:n] = _byte_case(window, n)
    row[n:] = 0
    landed = []
    out = ex.exchange_padded(lengths, {0: PaddedSourceRow(row, cols)},
                             window_rounds=window,
                             on_round=lambda r, lo, hi, rows:
                             landed.append((r, lo, hi)))
    assert np.array_equal(out[0][0], row[:n])
    assert landed[-1][2] == cols
    assert len(landed) == (1 if window == 0 else ex.plan(lengths).rounds)
    if window == 0:
        assert out[0].keepalive.is_pinned()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 2, 4])
def test_byte_plane_host_staged_rounds_on_card(cuda_device, window):
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange

    data = _byte_case(10 + window, 9 * 4096 + 17)
    ex = TileExchange(device=cuda_device, tile_bytes=4096,
                      max_rounds_in_flight=window, verify_integrity=True)
    lengths = np.array([[data.size]], np.int64)
    assert np.array_equal(ex.exchange_into(lengths, {0: data})[0][0], data)
    assert ex.exchange_bytes([[data.tobytes()]])[0][0] == data.tobytes()
    assert ex.stats()["rounds_executed"] == 2 * ex.plan(lengths).rounds


@pytest.mark.gpu
def test_byte_plane_a2a_and_arena_on_card(cuda_device):
    from sparkrdma_tpu_torch.memory.arena import ArenaManager
    from sparkrdma_tpu_torch.memory.device_arena import DeviceArena
    from sparkrdma_tpu_torch.parallel.exchange import TileExchange
    from sparkrdma_tpu_torch.utils.types import BlockLocation

    ex = TileExchange(device=cuda_device)
    x = torch.from_numpy(_byte_case(1, 4096).reshape(1, 4096))
    y = ex.a2a(x)
    assert y.is_cuda and torch.equal(y.cpu(), x)
    arena = DeviceArena(1 << 20, device=cuda_device)
    assert arena.array.is_cuda
    data = _byte_case(2, 300_000)
    span = arena.alloc(data.size)
    arena.write(span, data)  # asynchronous, from a pinned buffer
    assert arena.read(span.offset, data.size) == data.tobytes()
    mgr = ArenaManager()
    seg = mgr.register_arena_span(span)
    dev_seg = mgr.register(torch.from_numpy(data).to(cuda_device))
    assert mgr.read_block(BlockLocation(7, 1000, seg.mkey)) == \
        data[7:1007].tobytes()
    assert [bytes(b) for b in mgr.read_blocks(
        [BlockLocation(o, 50, dev_seg.mkey) for o in (0, 99_000, 5)])] == \
        [data[o:o + 50].tobytes() for o in (0, 99_000, 5)]
    mgr.stop()
    assert arena.stats()["allocated_bytes"] == 0


# -- the record-level shuffle on the host read plane --------------------------


def _reduce_job(device, n=30_000, keys=1024):
    """Config 2 of the card run at a small size: (int, 1) records over
    ``keys`` keys, 2 executors, 4 slices, 4 partitions."""
    from sparkrdma_tpu_torch.api import TpuShuffleContext

    data = [(i % keys, 1) for i in range(n)]
    ctx = TpuShuffleContext(num_executors=2, device=device)
    staged = []
    orig = [ex.resolver._to_device for ex in ctx.executors]
    for ex, fn in zip(ctx.executors, orig):
        def spy(host, fn=fn):
            t = fn(host)
            staged.append(bool(t.is_cuda))
            return t
        ex.resolver._to_device = spy
    try:
        out = sorted(ctx.parallelize(data, num_slices=4)
                     .reduce_by_key(lambda a, b: a + b, num_partitions=4)
                     .collect())
        pools = [ex.staging_pool.is_native for ex in ctx.executors]
    finally:
        ctx.stop()
    return out, staged, pools


@pytest.mark.gpu
def test_record_plane_reduce_by_key_on_card(cuda_device):
    """Every committed map output is a CUDA tensor, the result equals the
    CPU run's, and device memory returns to its start after stop()."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out, staged, pools = _reduce_job(cuda_device)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    assert staged and all(staged)
    assert all(pools)
    ref, ref_staged, _ = _reduce_job("cpu")
    assert out == ref
    assert sum(v for _k, v in out) == 30_000 and len(out) == 1024
    assert ref_staged and not any(ref_staged)


@pytest.mark.gpu
def test_context_device_count_launches_flagged_scan(cuda_device):
    from sparkrdma_tpu_torch.api import TpuShuffleContext

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 500, 1 << 16).astype(np.int32)
    want = dict(zip(*np.unique(keys, return_counts=True)))
    with TpuShuffleContext(num_executors=1, device=cuda_device) as ctx:
        _build.reset_launch_counts()
        got = ctx.device_count(keys)
        launched = _build.launch_counts()["flagged_scan"]
    assert launched >= 1
    assert got == {int(k): int(v) for k, v in want.items()}


def _colocated_run(device, window):
    """Every case of the co-located exchange on ``device``: the received
    rows of exchange_bytes, exchange_into and exchange_padded (full and
    windowed), the a2a, and the stats."""
    from sparkrdma_tpu_torch.parallel.exchange import (
        PaddedSourceRow,
        TileExchange,
    )

    D = 4
    rng = np.random.default_rng(12)
    lengths = rng.integers(0, 300_000, size=(D, D)).astype(np.int64)
    streams = [[rng.bytes(int(lengths[s, d])) for d in range(D)]
               for s in range(D)]
    ex = TileExchange.colocated(D, device=device, tile_bytes=64 << 10,
                                verify_integrity=True)
    out = {"bytes": ex.exchange_bytes(streams)}
    rows = {s: np.frombuffer(b"".join(streams[s]), np.uint8).copy()
            for s in range(D)}
    got = ex.exchange_into(lengths, rows)
    out["into"] = [[bytes(memoryview(got[d][s])) for s in range(D)]
                   for d in range(D)]
    cols = ex.plan(lengths).total_cols
    padded = {}
    for s in range(D):
        buf = np.zeros(D * cols, np.uint8)
        for d in range(D):
            buf[d * cols:d * cols + int(lengths[s, d])] = np.frombuffer(
                streams[s][d], np.uint8)
        padded[s] = PaddedSourceRow(buf, cols)
    events = []
    got = ex.exchange_padded(lengths, padded, window_rounds=window,
                             on_round=lambda r, lo, hi, _rows:
                             events.append((r, lo, hi)))
    out["padded"] = [[bytes(memoryview(got[d][s])) for s in range(D)]
                     for d in range(D)]
    out["events"] = events
    x = rng.integers(0, 256, size=(D, D, 512), dtype=np.uint8)
    out["a2a"] = ex.a2a(x).cpu().numpy()
    out["stats"] = ex.stats()
    want = [[streams[s][d] for s in range(D)] for d in range(D)]
    assert out["bytes"] == out["into"] == out["padded"] == want
    assert (out["a2a"] == x.transpose(1, 0, 2)).all()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 2])
def test_colocated_exchange_on_card(cuda_device, window):
    """The co-located exchange (E ranks in one process) on the card:
    every path's bytes, the round events, the a2a and the stats equal
    the CPU run's."""
    got = _colocated_run(cuda_device, window)
    ref = _colocated_run("cpu", window)
    for k in ("bytes", "into", "padded", "events", "stats"):
        assert got[k] == ref[k], k
    assert (got["a2a"] == ref["a2a"]).all()
    assert got["stats"]["device_exchanges"] == 1


def _plane_job(device, plane, device_path):
    from sparkrdma_tpu_torch.api import TpuShuffleContext
    from sparkrdma_tpu_torch.conf import TpuShuffleConf

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 700, 200_000).astype(np.int64)
    vals = rng.integers(-1000, 1000, 200_000).astype(np.int64)
    conf = TpuShuffleConf({
        "spark.shuffle.tpu.readPlane": plane,
        "spark.shuffle.tpu.serializer": "columnar",
        "spark.shuffle.tpu.bulkWindowMaps": "2",
        "spark.shuffle.tpu.deviceExchangeEnabled": str(device_path)})
    with TpuShuffleContext(num_executors=3, conf=conf,
                           device=device) as ctx:
        got = dict(ctx.parallelize_columns(keys, vals, num_slices=6)
                   .reduce_by_key("sum", num_partitions=6).collect())
        wp = ctx.executors[0].windowed_plane
        stats = wp.stats() if wp is not None else None
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0) + v
    assert got == want
    return got, stats


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["bulk", "windowed"])
def test_device_read_plane_on_card(cuda_device, plane):
    """A bulk and a windowed context job on the card with the padded
    device path on: the result equals the CPU run's, the windowed
    plane's exchange ran on the device, device memory returns to its
    start after stop(), and the source rows are pinned."""
    import gc

    from sparkrdma_tpu_torch.shuffle import bulk

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    got, stats = _plane_job(cuda_device, plane, True)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    if stats is not None:
        assert stats["device_exchanges"] > 0
    assert got == _plane_job("cpu", plane, True)[0]

    class Mgr:
        device = torch.device("cuda", torch.cuda.current_device())
        staging_pool = None

    row = bulk.source_row_alloc(Mgr())(1 << 20)
    assert torch.from_numpy(row).is_pinned()
