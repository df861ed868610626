"""step_p95_ms: the 95th percentile of the completion times of all
steps of the window, each from its call until the device wait returns
(rank 0's host clock), in ms."""

import statistics


def read(run):
    if len(run.steps_s) < 2:
        return None
    return statistics.quantiles(run.steps_s, n=20,
                                method="inclusive")[18] * 1e3
