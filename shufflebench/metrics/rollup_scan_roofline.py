"""rollup_scan_roofline: the least time of a query-67 step's scans (the
joins' probe fills, the compactions' and the rollup's cumsums, the
reduction's scans, the rank's fills: ``scan_bytes_per_step`` of the
driver's ``info``, over the published HBM rate) as a share of kernel
1's device time a step, in %; read as ``scan_roofline`` reads query
55's."""

from shufflebench import common


def read(run):
    return common.module("metrics", "scan_roofline").read(run)
