"""idle_share: the share of the traced window in which no kernel,
copy or memset ran on the device, 100 x (1 - busy / wall), mean of the
ranks' busy and wall seconds."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
