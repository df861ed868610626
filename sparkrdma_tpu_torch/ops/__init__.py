from sparkrdma_tpu_torch.ops.attention import (
    NEG_INF,
    block_attention,
    block_attention_plain,
)
from sparkrdma_tpu_torch.ops.exchange import hash_exchange
from sparkrdma_tpu_torch.ops.merge_kernel import merge_runs, merge_runs_plain
from sparkrdma_tpu_torch.ops.partition import (
    bucketize_segments,
    hash_partition_ids,
    make_range_splitters,
    partition_to_buckets,
    partition_to_buckets_dropping,
    range_partition_ids,
)
from sparkrdma_tpu_torch.ops.scan_kernels import (
    cumsum_1d,
    scan_flagged,
    scan_flagged_plain,
)
from sparkrdma_tpu_torch.ops.segment import (
    aggregate_by_key_local,
    compact_flagged,
    reduce_by_key_local,
    segmented_scan,
)
from sparkrdma_tpu_torch.ops.sort_kernel import (
    BucketOverflowError,
    block_sort_plain,
    bucket_cap,
    sort_pairs_blocks,
    sort_pairs_full,
    sort_pairs_full_checked,
)

__all__ = [
    "BucketOverflowError",
    "NEG_INF",
    "aggregate_by_key_local",
    "block_attention",
    "block_attention_plain",
    "block_sort_plain",
    "bucket_cap",
    "bucketize_segments",
    "compact_flagged",
    "cumsum_1d",
    "hash_exchange",
    "hash_partition_ids",
    "make_range_splitters",
    "merge_runs",
    "merge_runs_plain",
    "partition_to_buckets",
    "partition_to_buckets_dropping",
    "range_partition_ids",
    "reduce_by_key_local",
    "scan_flagged",
    "scan_flagged_plain",
    "segmented_scan",
    "sort_pairs_blocks",
    "sort_pairs_full",
    "sort_pairs_full_checked",
]
