from sparkrdma_tpu_torch.models.aggregate import KeyedAggregator, KeyStats
from sparkrdma_tpu_torch.models.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.models.wordcount import WordCounter

__all__ = [
    "KeyStats",
    "KeyedAggregator",
    "TeraSorter",
    "WordCounter",
    "ring_attention",
    "ulysses_attention",
]
