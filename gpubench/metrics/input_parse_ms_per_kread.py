"""The CLI's chunk loop parsing FASTQ blocks into reads and slicing them
into chunks (the `input.parse` spans of io/fastq.iter_fastq_chunks), ms
per thousand reads done in the window."""


def read(ctx):
    return ctx.ms_per_kread(lambda r: r["kind"] == "input.parse")
