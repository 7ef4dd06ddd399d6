"""pipeline.resident, the device calls' pageable copies in (the
`<call>.h2d` spans inside `extend_fused`, `rescue_w*` and `cigar_r*`
rows), ms per thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"].endswith(".h2d"))
