"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer results must match bit for bit; ``fill`` is compared under the
returned flag.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.ops import scan_kernels as tscan
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
    rng = np.random.default_rng(1)
    for block_rows in (4, 512):
        n = 4 * block_rows * 128
        k = torch.from_numpy(_keys(pattern, n, rng)).to(cuda_device)
        v = torch.arange(n, dtype=torch.int32, device=cuda_device)
        gk, gv = tsort.sort_pairs_blocks(k, v, block_rows=block_rows)
        wk, wv = tsort.block_sort_plain(k, v, block_rows=block_rows)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
        assert torch.equal(gk, torch.sort(k.view(-1, block_rows * 128),
                                          dim=1).values.reshape(-1))


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
def test_kernels_count_their_launches(cuda_device):
    _build.reset_launch_counts()
    k = torch.arange(512, dtype=torch.int32, device=cuda_device)
    tsort.sort_pairs_blocks(k, k, block_rows=4)
    tscan.cumsum_1d(k)
    assert _build.launch_counts() == {
        "flagged_scan": 1, "bitonic_block_sort": 1,
    }
