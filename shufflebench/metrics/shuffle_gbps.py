"""shuffle_gbps: input bytes of every step completed in the window,
over the window's seconds, per card (GB/s, 1e9 B)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.bytes_per_step * run.ok_steps / run.window_s / 1e9
