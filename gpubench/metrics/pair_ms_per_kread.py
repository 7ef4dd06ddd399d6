"""pipeline.native_driver, the C++ pairing of a chunk's finish: host mate
rescue and sam_pe in mp_finalize_pe, sam_pe in mp_finalize_pe_tail (the
`pair` phase stamps, inside the `host_chunk` finish rows), ms per
thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "pair")
