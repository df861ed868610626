"""The port's ring exchange and sequence-parallel attention against the
JAX package, on the CPU.

D = 1 runs in this process (``group=None`` on CPU tensors).  D = 2 and
4 run in a gloo world of D worker processes (tests/torch_ring_worker.py,
which imports neither JAX nor this conftest), spawned once per module
and per D over a ``file://`` store under a temporary directory.  Each
rank saves its outputs; each test gathers them (rank shards
concatenated on the sequence axis) and holds them against the JAX
package on ``make_mesh(D)`` over the full arrays.

Tolerances: float32 attention rtol 2e-4, atol 2e-5, the ring-vs-Ulysses
bound of __graft_entry__.py (the two sum in other orders).  bfloat16 is
held against the JAX Pallas path (interpret mode), which rounds ``p`` to
bfloat16 as the port does; both outputs are rounded to bfloat16, so one
bfloat16 step (2^-8 relative) plus the difference in summation order:
rtol and atol 1e-2.  ``RingExchange`` moves integers: bit for bit.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_ring_worker as worker
from sparkrdma_tpu.models.ring_attention import (
    ring_attention as jring,
    ulysses_attention as julysses,
)
from sparkrdma_tpu.parallel import make_mesh
from sparkrdma_tpu.parallel.ring import RingExchange as JRingExchange
from sparkrdma_tpu_torch import (
    ExchangeGroup,
    RingExchange,
    ring_attention,
    ulysses_attention,
)
from sparkrdma_tpu_torch.parallel import ring_shift, ring_shift_back

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 180


def _run_world(world, tmp):
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, str(pathlib.Path(worker.__file__)), str(r),
             str(world), str(store), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO),
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(D)``: the saved outputs of each rank of a D-rank gloo
    world, spawned once per module and per D."""
    cache = {}

    def get(D):
        if D not in cache:
            cache[D] = _run_world(D, tmp_path_factory.mktemp(f"gloo{D}"))
        return cache[D]

    return get


def _inputs(name, D):
    _sched, lead, dtype, causal, seed = worker.CASES[name]
    return worker.make_qkv(lead, D, seed), dtype, causal


def _jax_attention(name, D, impl):
    (q, k, v), dtype, causal = _inputs(name, D)
    jfn = jring if worker.CASES[name][0] == "ring" else julysses
    args = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    out = jfn(*args, mesh=make_mesh(D), causal=causal, impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _gathered(ranks, name):
    return torch.cat([r[name] for r in ranks], dim=-2).numpy()


F32_CASES = ["ring_f32_causal", "ring_f32", "ulysses_f32_causal",
             "ulysses_f32"]
BF16_CASES = ["ring_bf16_causal", "ulysses_bf16_causal"]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", F32_CASES)
def test_attention_f32_matches_jax(world, D, name):
    np.testing.assert_allclose(_gathered(world(D), name),
                               _jax_attention(name, D, "xla"), **F32_TOL)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", BF16_CASES)
def test_attention_bf16_matches_jax_pallas(world, D, name):
    np.testing.assert_allclose(_gathered(world(D), name),
                               _jax_attention(name, D, "pallas"),
                               **BF16_TOL)


@pytest.mark.parametrize("D", [2, 4])
def test_ring_and_ulysses_agree(world, D):
    ranks = world(D)
    np.testing.assert_allclose(_gathered(ranks, "ring_f32_causal_h4"),
                               _gathered(ranks, "ulysses_f32_causal"),
                               **F32_TOL)


@pytest.mark.parametrize("D", [2, 4])
def test_ulysses_refuses_heads_not_divisible(world, D):
    for r in world(D):
        assert f"not divisible by D={D}" in r["ulysses_error"]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("reverse", [False, True])
def test_all_shards_bit_exact_vs_jax(world, D, reverse):
    x = worker.ring_data(D)
    want = np.asarray(JRingExchange(make_mesh(D)).all_shards(
        jnp.asarray(x), reverse=reverse))
    key = "all_shards_back" if reverse else "all_shards"
    for rank, r in enumerate(world(D)):
        np.testing.assert_array_equal(r[key].numpy(), want[rank])


@pytest.mark.parametrize("D", [2, 4])
def test_ring_reduce_bit_exact_vs_jax(world, D):
    x = worker.ring_data(D)
    want = np.asarray(JRingExchange(make_mesh(D)).ring_reduce(
        jnp.asarray(x), init_fn=jnp.zeros_like,
        consume=lambda acc, src, cur: acc + cur * (src + 1)))
    for rank, r in enumerate(world(D)):
        np.testing.assert_array_equal(r["ring_reduce"].numpy(), want[rank])


@pytest.mark.parametrize("D", [2, 4])
def test_ring_shift_moves_shard_to_next_rank(world, D):
    x = worker.ring_data(D)
    for rank, r in enumerate(world(D)):
        np.testing.assert_array_equal(r["ring_shift"].numpy(),
                                      x[(rank - 1) % D])
        np.testing.assert_array_equal(r["ring_shift_back"].numpy(),
                                      x[(rank + 1) % D])


# ---- D = 1: group None, CPU tensors, in this process

@pytest.mark.parametrize("name", F32_CASES + BF16_CASES)
def test_one_rank_matches_jax(name):
    (q, k, v), dtype, causal = _inputs(name, 1)
    fn = ring_attention if worker.CASES[name][0] == "ring" else \
        ulysses_attention
    got = fn(*(torch.from_numpy(x).to(getattr(torch, dtype))
               for x in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    impl, tol = ("xla", F32_TOL) if dtype == "float32" else \
        ("pallas", BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_attention(name, 1, impl), **tol)


def test_one_rank_2d_input_and_group_object():
    (q, k, v), _dtype, _causal = _inputs("ring_f32_causal", 1)
    q2, k2, v2 = (torch.from_numpy(x[0, 0]) for x in (q, k, v))
    cpu = ExchangeGroup(device="cpu")
    assert (cpu.rank, cpu.size) == (0, 1)
    want = np.asarray(jring(*(jnp.asarray(x[0, 0]) for x in (q, k, v)),
                            mesh=make_mesh(1), causal=True))
    for fn in (ring_attention, ulysses_attention):
        np.testing.assert_allclose(
            fn(q2, k2, v2, group=cpu, causal=True).numpy(), want, **F32_TOL)


def test_one_rank_ring_exchange_is_local():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    ring = RingExchange(ExchangeGroup(device="cpu"))
    assert torch.equal(ring.all_shards(x), x[None])
    assert torch.equal(
        ring.ring_reduce(x, torch.zeros_like,
                         lambda acc, src, cur: acc + cur * (src + 1)), x)
    assert torch.equal(ring_shift(x), x) and torch.equal(ring_shift_back(x), x)


@pytest.mark.parametrize(
    "shapes,match",
    [(((4, 8), (4, 8), (5, 8)), "share a shape"),
     (((8,), (8,), (8,)), r"need \[\.\.\., S, d_head\]")],
)
def test_canonicalize_errors_match_jax(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match=match):
            fn(q, k, v)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 16, 8), np.float32)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x, x, x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExchangeGroup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RingExchange()
