"""pipeline.native_driver, the C++ SMEM seeding of mp_chunk_start (its
`seed` phase stamps, inside the `host_chunk` start rows), ms per
thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "seed")
