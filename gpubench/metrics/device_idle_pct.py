"""The device: the share of the profiled window that no kernel, copy or
memset covers (the union of the profiler's device intervals)."""


def read(ctx):
    if ctx.intervals is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
