"""scan_roofline: the least time of the step's scans (the least bytes
the driver counts from the step's shapes, ``scan_bytes_per_step`` of
its ``info``, over the published HBM rate) as a share of kernel 1's
device time a step, in %."""

from shufflebench import kernels, peaks


def read(run):
    s = kernels.seconds_per_step(run.trace, kernels.SCAN)
    b = run.info.get("scan_bytes_per_step")
    if s is None or not b:
        return None
    return 100.0 * b / peaks.HBM_BYTES_PER_S / s
