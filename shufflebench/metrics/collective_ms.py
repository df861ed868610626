"""collective_ms: device ms a step in NCCL's kernels (the all_gather
of the samples and the three all_to_alls), mean over the ranks."""

from shufflebench import kernels


def read(run):
    s = kernels.seconds_per_step(run.trace, kernels.NCCL)
    return None if s is None else s * 1e3
