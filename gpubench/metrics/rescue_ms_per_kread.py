"""The mate-rescue waves (NativePipeline._device_rescue -> ops.local_cuda):
the `rescue_w*` rows, ms per thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"].startswith("rescue_w"))
