"""csrc/extend_fused.cu: the fused extension kernel's own device time in
the profiler's trace over the window, ms per thousand reads done in it."""


def read(ctx):
    return ctx.device_ms_per_kread(lambda name: "extend_fused" in name)
