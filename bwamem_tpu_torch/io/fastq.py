"""FASTQ/FASTA read parsing and batching (the kseq.h equivalent).

Host-side streaming: yields (name, seq_codes, qual) and packs reads into
fixed-size batches for the device pipeline.  A C++ parser is the planned
native path for multi-GB/s ingest; this numpy version is the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from bwamem_tpu_torch.io.fasta import encode_seq
from bwamem_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class Read:
    name: str
    seq: np.ndarray          # 0..4 codes
    qual: str | None = None
    comment: str | None = None


def parse_fastq(text: str) -> Iterator[Read]:
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        if line.startswith("@"):
            header = line[1:]
            parts = header.split(None, 1)
            name = parts[0]
            comment = parts[1] if len(parts) > 1 else None
            seq = lines[i + 1].strip()
            # lines[i+2] is '+'
            qual = lines[i + 3].strip() if i + 3 < n else None
            yield Read(name=name, seq=encode_seq(seq), qual=qual,
                       comment=comment)
            i += 4
        elif line.startswith(">"):
            header = line[1:]
            name = header.split()[0]
            i += 1
            seq_parts = []
            while i < n and not lines[i].startswith((">", "@")):
                seq_parts.append(lines[i].strip())
                i += 1
            yield Read(name=name, seq=encode_seq("".join(seq_parts)))
        else:
            raise ValueError(f"bad record at line {i}: {line[:40]!r}")


def _open_seq(path: str):
    """Binary stream over `path`, transparently gunzipping (bwa's kseq
    reads through zlib, so .fq.gz / .fa.gz inputs are first-class)."""
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        import gzip

        return gzip.GzipFile(fileobj=f)
    return f


def read_fastq(path: str) -> list[Read]:
    with _open_seq(path) as f:
        buf = f.read()
    reads = _read_fastq_native(buf)
    if reads is not None:
        return reads
    return list(parse_fastq(buf.decode()))


def iter_fastq_chunks(path: str, chunk_reads: int,
                      block_bytes: int = 1 << 23,
                      tracer=None) -> Iterator[list[Read]]:
    """Stream a (strict 4-line) FASTQ file in bounded memory, yielding
    lists of `chunk_reads` reads — the WGS-scale ingest path (the
    reference host streams reads the same way; whole-file slurping is
    kept only for small inputs/tests).  FASTA input (multi-line
    records) falls back to a whole-file parse.  Gzipped inputs stream
    through zlib decompression block by block.  Given a `tracer`
    (utils.metrics.Tracer), the time blocked in the stream's read is
    `input.read` spans and the parsing and slicing `input.parse` spans;
    none is open while the caller holds a chunk."""
    with _open_seq(path) as f:
        with span(tracer, "input.read"):
            head = f.read(1)
        if head != b"@":  # FASTA or empty: no 4-line framing
            with span(tracer, "input.read"):
                buf = head + f.read()
            with span(tracer, "input.parse"):
                reads = _read_fastq_native(buf)
                if reads is None:
                    reads = list(parse_fastq(buf.decode()))
            for i in range(0, len(reads), chunk_reads):
                yield reads[i:i + chunk_reads]
            return
        carry = b"@"
        pending: list[Read] = []
        while True:
            with span(tracer, "input.read"):
                block = f.read(block_bytes)
            if not block:
                break
            with span(tracer, "input.parse"):
                buf = carry + block
                arr = np.frombuffer(buf, np.uint8)
                nls = np.flatnonzero(arr == 10)
                full = len(nls) // 4 * 4
                if full == 0:
                    carry = buf
                    continue
                pos = int(nls[full - 1]) + 1
                records, carry = buf[:pos], buf[pos:]
                pending.extend(_parse_span(records))
            while len(pending) >= chunk_reads:
                with span(tracer, "input.parse"):
                    chunk = pending[:chunk_reads]
                    pending = pending[chunk_reads:]
                yield chunk
        with span(tracer, "input.parse"):
            if carry.strip():
                if not carry.endswith(b"\n"):
                    carry += b"\n"
                pending.extend(_parse_span(carry))
        while pending:
            yield pending[:chunk_reads]
            pending = pending[chunk_reads:]


def _parse_span(span: bytes) -> list[Read]:
    reads = _read_fastq_native(span)
    if reads is None:
        reads = list(parse_fastq(span.decode()))
    return reads


def _read_fastq_native(buf: bytes) -> list[Read] | None:
    """csrc/fastq.cpp single-pass scanner + vectorized base encoding."""
    from bwamem_tpu_torch import native

    per_rec = 4 if buf[:1] == b"@" else 2  # FASTQ: 4 lines; FASTA: >= 2
    got = native.fastq_scan(buf, max_rec=buf.count(b"\n") // per_rec + 8)
    if got is None:
        return None
    n, off = got
    arr = np.frombuffer(buf, np.uint8)
    from bwamem_tpu_torch.io.fasta import _CODE

    reads = []
    for k in range(n):
        ns, ne, ss, se, qs = off[k]
        name = buf[ns:ne].decode()
        # comment = rest of the header line past the first whitespace
        # (bwa -C appends it verbatim to the SAM record)
        le = buf.index(b"\n", ne)
        cm = buf[ne:le].strip()
        comment = cm.decode() if cm else None
        if qs >= 0:
            seq = _CODE[arr[ss:se]]
            qual = buf[qs:qs + (se - ss)].decode()
            reads.append(Read(name=name, seq=seq, qual=qual,
                              comment=comment))
        else:
            span = arr[ss:se]
            keep = (span != 10) & (span != 13)  # strip newlines
            reads.append(Read(name=name, seq=_CODE[span[keep]],
                              comment=comment))
    return reads


def batches(reads: list[Read], batch_size: int) -> Iterator[list[Read]]:
    for i in range(0, len(reads), batch_size):
        yield reads[i:i + batch_size]
