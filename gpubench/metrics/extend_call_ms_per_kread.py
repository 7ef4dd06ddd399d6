"""pipeline.resident, the device call of the fused extension (H2D, the
gathers, the launch, D2H): the `extend_fused` rows, ms per thousand
reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "extend_fused")
