"""pipeline.resident, the device calls' wait for the stream and copy back
(the `<call>.wait` spans: `.cpu()` of the results), ms per thousand
reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"].endswith(".wait"))
