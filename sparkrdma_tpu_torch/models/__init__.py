from sparkrdma_tpu_torch.models.aggregate import KeyedAggregator, KeyStats
from sparkrdma_tpu_torch.models.external_sort import ExternalTeraSorter
from sparkrdma_tpu_torch.models.join import (
    JOIN_HOWS,
    BroadcastJoiner,
    HashJoiner,
    make_broadcast_join_step,
    make_hash_join_step,
)
from sparkrdma_tpu_torch.models.join_aggregate import (
    BroadcastJoinAggregator,
    make_broadcast_join_aggregate_step,
)
from sparkrdma_tpu_torch.models.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from sparkrdma_tpu_torch.models.terasort import (
    TeraSorter,
    make_sort_step,
    make_wide_sort_step,
)
from sparkrdma_tpu_torch.models.topk import GroupedTopK, make_topk_step
from sparkrdma_tpu_torch.models.wordcount import WordCounter

__all__ = [
    "BroadcastJoinAggregator",
    "BroadcastJoiner",
    "ExternalTeraSorter",
    "GroupedTopK",
    "HashJoiner",
    "JOIN_HOWS",
    "KeyStats",
    "KeyedAggregator",
    "TeraSorter",
    "WordCounter",
    "make_broadcast_join_aggregate_step",
    "make_broadcast_join_step",
    "make_hash_join_step",
    "make_sort_step",
    "make_topk_step",
    "make_wide_sort_step",
    "ring_attention",
    "ulysses_attention",
]
