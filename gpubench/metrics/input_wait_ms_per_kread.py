"""The CLI's chunk loop blocked in the FASTQ streams' reads (the
`input.read` spans of io/fastq.iter_fastq_chunks: the harness's writers
and the pipe), ms per thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "input.read")
