"""FASTQ/FASTA read parsing and batching (the kseq.h equivalent).

Reads stream in as `ReadBatch`es: a run of records held as columns (the
base codes with per-read offsets, and the name, quality and comment
blobs with theirs), written in one pass over a block of the file by the
native parser (native/fastq.cpp, `native.fastq_pack`), with no Python
object per read.  The native host pipeline takes the columns as they
are (NativePipeline: the chunk's read matrix, the SAM names and
qualities); everything else sees a read-only sequence of `Read`s, made
on demand.  `parse_fastq` is the plain Python parser: the reference, and
the path where the native library is unavailable or a buffer is
malformed.
"""

from __future__ import annotations

import collections
import dataclasses
import operator
from collections.abc import Sequence
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


def _ragged_range(data, off, a: int, b: int):
    """Items a..b-1 of a ragged column (a blob, its offsets from 0)."""
    return data[off[a]:off[b]], off[a:b + 1] - off[a]


def _ragged_take(data, off, idx):
    """Items idx of a ragged column, in that order."""
    lens = off[idx + 1] - off[idx]
    new = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=new[1:])
    src = np.repeat(off[idx] - new[:-1], lens) + np.arange(new[-1])
    return data[src], new


def join_ragged(parts):
    """The ragged columns `parts` [(blob, offsets)] one after another."""
    if len(parts) == 1:
        return parts[0]
    data = np.concatenate([d for d, _ in parts])
    base = np.cumsum([0] + [int(o[-1]) for _, o in parts[:-1]])
    off = np.concatenate([parts[0][1][:1]]
                         + [o[1:] + b for (_, o), b in zip(parts, base)])
    return data, off


class ReadBatch(Sequence):
    """A run of reads as columns: `codes` (uint8 base codes, 0..4) with
    `seq_off`, and `names`, `quals`, `comments` (uint8 text blobs) with
    `name_off`, `qual_off`, `comment_off` (int64, n + 1 offsets from 0),
    and `has_qual` (bool: False for a FASTA record, whose Read has qual
    None).  An empty comment is a Read's None.

    A read-only sequence of Read: len, iteration, [i] (a Read made on
    demand; its seq is a view of `codes`), and slices, strided ones too
    (`-p`'s [0::2] / [1::2]), which are ReadBatches."""

    __slots__ = ("codes", "seq_off", "names", "name_off", "quals",
                 "qual_off", "comments", "comment_off", "has_qual")
    _RAGGED = (("codes", "seq_off"), ("names", "name_off"),
               ("quals", "qual_off"), ("comments", "comment_off"))

    def __init__(self, codes, seq_off, names, name_off, quals, qual_off,
                 comments, comment_off, has_qual):
        self.codes, self.seq_off = codes, seq_off
        self.names, self.name_off = names, name_off
        self.quals, self.qual_off = quals, qual_off
        self.comments, self.comment_off = comments, comment_off
        self.has_qual = has_qual

    @classmethod
    def _of(cls, ragged, has_qual):
        return cls(*(x for pair in ragged for x in pair), has_qual)

    def _ragged(self):
        return [(getattr(self, d), getattr(self, o))
                for d, o in self._RAGGED]

    @classmethod
    def from_arrays(cls, seqs, names, quals=None, comments=None
                    ) -> ReadBatch:
        """The columns of lists: base-code arrays, names, and qualities
        and comments (None: the list, or an item, absent)."""
        def text(items):
            blobs = [s.encode() if s else b"" for s in items]
            off = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=off[1:])
            return np.frombuffer(b"".join(blobs), np.uint8).copy(), off

        n = len(seqs)
        quals = quals or [None] * n
        off = np.zeros(n + 1, np.int64)
        np.cumsum([len(r) for r in seqs], out=off[1:])
        codes = (np.concatenate([np.asarray(r, np.uint8) for r in seqs])
                 if n else np.zeros(0, np.uint8))
        return cls(codes, off, *text(names), *text(quals),
                   *text(comments or [None] * n),
                   np.array([q is not None for q in quals], bool))

    @classmethod
    def from_reads(cls, reads) -> ReadBatch:
        """The columns of a list of Reads."""
        return cls.from_arrays([r.seq for r in reads],
                               [r.name for r in reads],
                               [r.qual for r in reads],
                               [r.comment for r in reads])

    @classmethod
    def concat(cls, batches) -> ReadBatch:
        """The batches one after another, column by column."""
        if len(batches) == 1:
            return batches[0]
        cols = zip(*(b._ragged() for b in batches))
        return cls._of([join_ragged(list(c)) for c in cols],
                       np.concatenate([b.has_qual for b in batches]))

    def __len__(self) -> int:
        return len(self.has_qual)

    @property
    def qlen(self) -> np.ndarray:
        """(n,) int64 read lengths."""
        return np.diff(self.seq_off)

    def take(self, idx) -> ReadBatch:
        """The reads at positions idx (int array), in that order."""
        idx = np.asarray(idx, np.int64)
        return self._of([_ragged_take(d, o, idx) for d, o in self._ragged()],
                        self.has_qual[idx])

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            a, b, step = i.indices(n)
            if step != 1:
                return self.take(np.arange(a, b, step))
            if a == 0 and b == n:
                return self
            b = max(a, b)
            return self._of([_ragged_range(d, o, a, b)
                             for d, o in self._ragged()], self.has_qual[a:b])
        i = operator.index(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("read index out of range")

        def text(data, off):
            return data[off[i]:off[i + 1]].tobytes().decode()

        comment = text(self.comments, self.comment_off)
        return Read(name=text(self.names, self.name_off),
                    seq=self.codes[self.seq_off[i]:self.seq_off[i + 1]],
                    qual=(text(self.quals, self.qual_off)
                          if self.has_qual[i] else None),
                    comment=comment or None)

    def matrix(self):
        """(mat, qlen): the (n, L) uint8 code matrix, each row padded
        with 4 past its read (L the longest read, at least 1; a view of
        `codes` when every read has length L), and (n,) int64 qlen."""
        qlen = self.qlen
        n = len(qlen)
        L = max(int(qlen.max()) if n else 0, 1)
        if self.codes.size == n * L:
            return self.codes.reshape(n, L), qlen
        mat = np.full((n, L), 4, np.uint8)
        mat[np.arange(L) < qlen[:, None]] = self.codes
        return mat, qlen


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
    return list(_parse(buf, len(buf)))


def iter_fastq_chunks(path: str, chunk_reads: int,
                      block_bytes: int = 1 << 23,
                      tracer=None) -> Iterator[ReadBatch]:
    """Stream a (strict 4-line) FASTQ file in bounded memory, yielding
    ReadBatches of `chunk_reads` reads (the last one shorter) — the
    WGS-scale ingest path (the reference host streams reads the same
    way; whole-file slurping is kept only for small inputs/tests).  Each
    block of `block_bytes` is cut after its last whole record and parsed
    into columns at once; a chunk that spans blocks joins their columns.
    FASTA input (multi-line records) is parsed whole.  Gzipped inputs
    stream through zlib decompression block by block.  Given a `tracer`
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
                reads = _parse(buf, len(buf))
            for i in range(0, len(reads), chunk_reads):
                with span(tracer, "input.parse"):
                    chunk = reads[i:i + chunk_reads]
                yield chunk
            return
        carry = b"@"
        pending = collections.deque()   # [batch, its first read not out]
        have = 0

        def cut(k):
            """The next k pending reads as one batch."""
            nonlocal have
            parts = []
            while k:
                b, a = pending[0]
                m = min(k, len(b) - a)
                parts.append(b[a:a + m])
                k -= m
                if a + m == len(b):
                    pending.popleft()
                else:
                    pending[0][1] = a + m
            have -= sum(len(p) for p in parts)
            return ReadBatch.concat(parts)

        def add(batch):
            nonlocal have
            if len(batch):
                pending.append([batch, 0])
                have += len(batch)

        while True:
            with span(tracer, "input.read"):
                block = f.read(block_bytes)
            if not block:
                break
            with span(tracer, "input.parse"):
                buf = carry + block
                pos, lines = _cut4(buf)
                if pos == 0:
                    carry = buf
                    continue
                add(_parse(buf, pos, lines))
                carry = buf[pos:]
            while have >= chunk_reads:
                with span(tracer, "input.parse"):
                    chunk = cut(chunk_reads)
                yield chunk
        with span(tracer, "input.parse"):
            if carry.strip():
                if not carry.endswith(b"\n"):
                    carry += b"\n"
                add(_parse(carry, len(carry)))
        while have:
            with span(tracer, "input.parse"):
                chunk = cut(min(chunk_reads, have))
            yield chunk


def _cut4(buf: bytes) -> tuple[int, int]:
    """(cut, lines): the byte just past the last whole 4-line record of
    buf (0: none) and the newlines before it."""
    from bwamem_tpu_torch import native

    got = native.fastq_cut(buf)
    if got is not None:
        return got
    nls = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
    full = len(nls) // 4 * 4
    return (int(nls[full - 1]) + 1 if full else 0), full


def _parse(buf: bytes, n: int, lines: int | None = None) -> ReadBatch:
    """The records of buf[:n] (`lines` newlines, counted if None) as a
    ReadBatch: the native packed parse, else (no library, or a buffer it
    refuses) parse_fastq's Reads."""
    from bwamem_tpu_torch import native

    if lines is None:
        lines = buf.count(b"\n", 0, n)
    # a record holds at least one newline unless it ends the buffer
    got = native.fastq_pack(buf, n, lines + 2)
    if got is not None:
        return ReadBatch(*got)
    return ReadBatch.from_reads(list(parse_fastq(buf[:n].decode())))


def batches(reads: list[Read], batch_size: int) -> Iterator[list[Read]]:
    for i in range(0, len(reads), batch_size):
        yield reads[i:i + batch_size]
