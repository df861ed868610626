"""One rank of a gloo world for tests/test_torch_ring.py.

    python tests/torch_ring_worker.py RANK WORLD STORE_FILE OUT_DIR

Joins a ``world``-rank gloo group over a ``file://`` store (no TCP
port), runs every case of :data:`CASES` on this rank's sequence shard
through the port's ring, Ulysses and ``RingExchange``, and saves the
results to ``OUT_DIR/rank<RANK>.pt``.  Imports torch, numpy and
``sparkrdma_tpu_torch`` only: neither JAX nor the tests' conftest.
The test module imports it for :data:`CASES` and :func:`make_qkv`, so
both sides build the same inputs from the same seeds.
"""

import os
import sys

import numpy as np
import torch

S_LOCAL = 16
D_HEAD = 32
RING_LEN = 16

# name -> (schedule, leading dims, dtype, causal, seed).  Cases with one
# seed and leading dims get the same inputs (ring vs Ulysses agreement).
CASES = {
    "ring_f32_causal": ("ring", (2, 3), "float32", True, 1),
    "ring_f32": ("ring", (2, 3), "float32", False, 2),
    "ring_bf16_causal": ("ring", (2, 4), "bfloat16", True, 3),
    "ring_f32_causal_h4": ("ring", (2, 4), "float32", True, 4),
    "ulysses_f32_causal": ("ulysses", (2, 4), "float32", True, 4),
    "ulysses_f32": ("ulysses", (2, 4), "float32", False, 5),
    "ulysses_bf16_causal": ("ulysses", (2, 4), "bfloat16", True, 3),
}


def make_qkv(lead, world, seed):
    """float32 numpy q, k, v of shape ``lead + (S_LOCAL * world,
    D_HEAD)``."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (S_LOCAL * world, D_HEAD)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def ring_data(world):
    """The ``[world, RING_LEN]`` int32 shards of the RingExchange cases."""
    rng = np.random.default_rng(7)
    return rng.integers(-1000, 1000, (world, RING_LEN), dtype=np.int32)


def _shard(x, rank):
    lo = rank * S_LOCAL
    return x[..., lo:lo + S_LOCAL, :]


def run_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from sparkrdma_tpu_torch.models import ring_attention, ulysses_attention
    from sparkrdma_tpu_torch.parallel import (
        ExchangeGroup,
        RingExchange,
        ring_shift,
        ring_shift_back,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        group = ExchangeGroup(dist.group.WORLD, device="cpu")
        out = {}
        for name, (sched, lead, dtype, causal, seed) in CASES.items():
            q, k, v = (torch.from_numpy(np.ascontiguousarray(_shard(x, rank)))
                       .to(getattr(torch, dtype))
                       for x in make_qkv(lead, world, seed))
            fn = ring_attention if sched == "ring" else ulysses_attention
            out[name] = fn(q, k, v, group=group, causal=causal).float()
        bad = torch.zeros(3, S_LOCAL, D_HEAD)
        try:
            ulysses_attention(bad, bad, bad, group=group)
            out["ulysses_error"] = ""
        except ValueError as e:
            out["ulysses_error"] = str(e)
        shard = torch.from_numpy(ring_data(world)[rank])
        ring = RingExchange(group)
        out["all_shards"] = ring.all_shards(shard)
        out["all_shards_back"] = ring.all_shards(shard, reverse=True)
        out["ring_reduce"] = ring.ring_reduce(
            shard, init_fn=torch.zeros_like,
            consume=lambda acc, src, cur: acc + cur * (src + 1))
        out["ring_shift"] = ring_shift(shard, group)
        out["ring_shift_back"] = ring_shift_back(shard, group)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
