"""pipeline.native_driver, the chunk's finish in C++ (mp_finalize[_pe],
mp_emit_sam: replay, pairing, SAM), ms per thousand reads done in the
window: the `host_chunk` rows with reads == 0, less the device rescue
waves and CIGAR rounds, whose rows (`rescue_w*`, `cigar_r*`) the port
opens inside that span: the layer's self time."""


def read(ctx):
    total = ctx.ms_per_kread(lambda r: r["kind"] == "host_chunk"
                             and r.get("reads", 0) == 0)
    if total is None:
        return None
    nested = ctx.ms_per_kread(lambda r: r["kind"].startswith(
        ("rescue_w", "cigar_r")))
    return total - (nested or 0.0)
