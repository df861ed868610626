"""gather_ms: device ms a step in row-gather kernels (``x[perm]``,
``index_select``; patterns in ``kernels.GATHER``, NCCL's excluded),
mean over the ranks."""

from shufflebench import kernels


def read(run):
    s = kernels.seconds_per_step(run.trace, kernels.GATHER, kernels.NCCL)
    return None if s is None else s * 1e3
