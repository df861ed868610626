from sparkrdma_tpu_torch.ops.scan_kernels import (
    cumsum_1d,
    scan_flagged,
    scan_flagged_plain,
)
from sparkrdma_tpu_torch.ops.segment import (
    aggregate_by_key_local,
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
    "aggregate_by_key_local",
    "block_sort_plain",
    "bucket_cap",
    "cumsum_1d",
    "reduce_by_key_local",
    "scan_flagged",
    "scan_flagged_plain",
    "segmented_scan",
    "sort_pairs_blocks",
    "sort_pairs_full",
    "sort_pairs_full_checked",
]
