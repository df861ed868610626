"""sort_ms: device ms a step in torch.sort's radix-sort kernels
(patterns in ``kernels.SORT``), mean over the ranks."""

from shufflebench import kernels


def read(run):
    s = kernels.seconds_per_step(run.trace, kernels.SORT)
    return None if s is None else s * 1e3
