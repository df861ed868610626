"""sparkrdma_tpu_torch: the PyTorch/CUDA port of sparkrdma_tpu.

The JAX package ``sparkrdma_tpu`` stays as the reference; this package
imports ``torch`` and never ``jax`` or ``sparkrdma_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``, and raise when
CUDA is absent.  The hand-written kernels of ``csrc/`` build with
``nvcc`` at first use (``_build.py``).

The shuffle models: TeraSort (sortByKey, 8 B and wide records), the
two-phase block sort engine, WordCount (reduceByKey), keyed aggregation
(aggregateByKey), and the SQL-exchange models: hash and broadcast joins
(inner, left outer, semi, anti), the fused broadcast join + aggregate,
grouped top-k and the external (larger-than-memory) sort.  Each runs
on one GPU, or over a ``torch.distributed`` exchange group of D GPUs,
one process per GPU (``group=``): each rank passes its own shard (the
external sort: its own chunk stream) and gets what it owns after the
exchange.  Sequence-parallel attention (ring and Ulysses) runs on an
exchange group of any size, over the blockwise flash-attention kernel.
``python -m sparkrdma_tpu_torch.bench`` is the TeraSort benchmark, and
``sparkrdma_tpu_torch.entry.entry()`` the one-step compile entry.

The record-level shuffle (``api.py``: :class:`TpuShuffleContext` and its
``Dataset``; ``shuffle/``: the manager, writer, resolver and reader over
``transport/``) runs on the host read plane: each committed map output
is a tensor on the executor's device, and reducers fetch blocks as
one-sided reads over the loopback or TCP transport.
"""

from sparkrdma_tpu_torch.api import Dataset, TpuShuffleContext
from sparkrdma_tpu_torch.conf import TpuShuffleConf
from sparkrdma_tpu_torch.models import (
    JOIN_HOWS,
    BroadcastJoinAggregator,
    BroadcastJoiner,
    ExternalTeraSorter,
    GroupedTopK,
    HashJoiner,
    KeyedAggregator,
    KeyStats,
    TeraSorter,
    WordCounter,
    ring_attention,
    ulysses_attention,
)
from sparkrdma_tpu_torch.ops.attention import block_attention
from sparkrdma_tpu_torch.ops.sort_kernel import (
    sort_pairs_full,
    sort_pairs_full_checked,
)
from sparkrdma_tpu_torch.parallel import ExchangeGroup, RingExchange

__all__ = [
    "BroadcastJoinAggregator",
    "Dataset",
    "BroadcastJoiner",
    "ExchangeGroup",
    "ExternalTeraSorter",
    "GroupedTopK",
    "HashJoiner",
    "JOIN_HOWS",
    "KeyStats",
    "KeyedAggregator",
    "RingExchange",
    "TeraSorter",
    "TpuShuffleConf",
    "TpuShuffleContext",
    "WordCounter",
    "block_attention",
    "ring_attention",
    "sort_pairs_full",
    "sort_pairs_full_checked",
    "ulysses_attention",
]
