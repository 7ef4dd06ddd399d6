"""pipeline.native_driver, the chunk's start in C++ (mp_chunk_start: seed,
chain and plan, with the device seeder it calls): the `host_chunk` rows
with reads > 0, ms per thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "host_chunk"
                            and r.get("reads", 0) > 0)
