"""host_ms: the median over the window's untraced steps of the host
time from the step call to its return, before the device wait (ms,
rank 0's clock): the host side of the step entries."""

import statistics


def read(run):
    times = [s for s, traced in run.host_s if not traced]
    if not times:
        return None
    return statistics.median(times) * 1e3
