"""sparkrdma_tpu_torch: the PyTorch/CUDA port of sparkrdma_tpu.

The JAX package ``sparkrdma_tpu`` stays as the reference; this package
imports ``torch`` and never ``jax`` or ``sparkrdma_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``, and raise when
CUDA is absent.  The hand-written kernels of ``csrc/`` build with
``nvcc`` at first use (``_build.py``).

This slice covers one GPU: TeraSort (sortByKey, 8 B and wide records),
the two-phase block sort engine, WordCount (reduceByKey) and keyed
aggregation (aggregateByKey).
"""

from sparkrdma_tpu_torch.models import (
    KeyedAggregator,
    KeyStats,
    TeraSorter,
    WordCounter,
)
from sparkrdma_tpu_torch.ops.sort_kernel import (
    sort_pairs_full,
    sort_pairs_full_checked,
)

__all__ = [
    "KeyStats",
    "KeyedAggregator",
    "TeraSorter",
    "WordCounter",
    "sort_pairs_full",
    "sort_pairs_full_checked",
]
