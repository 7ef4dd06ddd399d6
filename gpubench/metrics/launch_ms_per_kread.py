"""pipeline.resident, the device calls' gathers and kernel enqueued on the
stream (the `<call>.launch` spans), ms per thousand reads done in the
window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"].endswith(".launch"))
