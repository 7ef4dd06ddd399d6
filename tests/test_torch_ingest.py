"""Packed read ingest (io/fastq.ReadBatch over native/fastq.cpp):

- `iter_fastq_chunks` yields ReadBatches of exactly `chunk_reads` reads
  (the last one shorter) whose reads equal `parse_fastq`'s field by field
  (names, comments, base codes, qualities, lengths) and the JAX package's
  `iter_fastq_chunks`, on blocks that cut a record inside each of its four
  lines, CRLF, no final newline, mixed lengths, N / IUPAC / lowercase
  bases, a gzipped file, chunks that span blocks, blocks shorter than a
  record, and FASTA;
- a ReadBatch is a read-only sequence of Read: indexing, slices (`-p`'s
  strided ones too), `take`, `concat` and its code matrix agree with the
  list of its reads;
- `ReadBatch.from_arrays` makes the batch of lists (absent qualities
  and comments too), the one NativePipeline makes of a list at its entry;
- `parallel.multihost`'s shard streams gather each shard's strided reads
  and pairs from batches, re-cut to the batch size;
- NativePipeline's SE and PE SAM from ReadBatches is byte-identical to
  that from lists of arrays with names and qualities, with host seeding
  and with the plain device seeder, and `packed_reads` counts the reads
  that came as a batch;
- `mem` (`--backend torch`) writes the same SAM from the native packed
  parse as from batches made of `parse_fastq`'s Reads (the library's
  parse refused), SE, PE, `-p` and `--device-seed`, with `-C` and `-R`,
  and its `[mem] counters` line reads `packed_reads` == `reads`."""

import contextlib
import gzip
import io
import json

import _torch_gate as gate
import numpy as np
import pytest
import torch

from bwamem_tpu.io import fastq as ref_fastq
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io import fastq
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.io.fastq import ReadBatch
from bwamem_tpu_torch.ops import smem_torch
from bwamem_tpu_torch.ops.types import params_from_options
from bwamem_tpu_torch.utils.metrics import Tracer

torch.set_num_threads(1)

ACGT = np.array(list("ACGT"))
RG = "@RG\\tID:x"


def _record(name, seq, qual, comment=None, eol="\n"):
    head = f"@{name}" + (f" {comment}" if comment else "")
    return eol.join([head, seq, "+", qual]) + eol


def _text(rng, n, lens=(150,), eol="\n", odd_bases=False):
    recs = []
    for i in range(n):
        k = int(rng.choice(lens))
        seq = "".join(ACGT[rng.integers(0, 4, k)])
        if odd_bases and k > 12:
            s = list(seq)
            for j in rng.integers(0, k, 6):
                s[j] = str(rng.choice(list("NRYKMSWnacgtx")))
            seq = "".join(s)
        qual = "".join(chr(33 + int(c)) for c in rng.integers(0, 41, k))
        comment = None if i % 3 == 0 else f"BC:Z:{i}\tx  {i}"
        recs.append(_record(f"read{i}", seq, qual, comment, eol))
    return "".join(recs)


def _split_in_line(text, line):
    """A block size whose first cut falls one byte into line `line` of
    the second record: the stream reads its first byte, then a block, so
    the cut is at 1 + block_bytes."""
    lines = text.splitlines(keepends=True)
    return sum(len(x) for x in lines[:4 + line])


# case: (text maker, chunk_reads, block_bytes, gzipped)
CASES = {
    **{f"cut_in_line{k}": (lambda rng, k=k: _text(rng, 60), 16,
                           ("line", k), False) for k in range(4)},
    "crlf": (lambda rng: _text(rng, 50, eol="\r\n"), 16, 1000, False),
    "no_final_newline": (lambda rng: _text(rng, 41)[:-1], 16, 777, False),
    "mixed_lengths": (lambda rng: _text(rng, 70, lens=(1, 35, 100, 151)),
                      12, 1500, False),
    "odd_bases": (lambda rng: _text(rng, 40, odd_bases=True), 16, 900,
                  False),
    "gzipped": (lambda rng: _text(rng, 64, lens=(90, 150)), 16, 1200,
                True),
    "chunks_span_blocks": (lambda rng: _text(rng, 90), 40, 2048, False),
    "block_below_a_record": (lambda rng: _text(rng, 20), 7, 50, False),
    "one_chunk": (lambda rng: _text(rng, 30), 1000, 1 << 23, False),
}


def _write(tmp_path, text, gz, name="in.fq"):
    p = tmp_path / (name + (".gz" if gz else ""))
    if gz:
        with gzip.open(p, "wb") as f:
            f.write(text.encode())
    else:
        p.write_bytes(text.encode())
    return str(p)


def _same_read(g, w, comments=True):
    assert g.name == w.name
    assert np.array_equal(g.seq, w.seq), g.name
    assert np.asarray(g.seq).dtype == np.uint8
    assert g.qual == w.qual
    if comments:
        assert g.comment == w.comment


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_equal_parse_and_jax(tmp_path, case):
    make, chunk_reads, block, gz = CASES[case]
    text = make(np.random.default_rng(len(case)))
    if isinstance(block, tuple):
        block = _split_in_line(text, block[1])
    path = _write(tmp_path, text, gz)
    got = list(fastq.iter_fastq_chunks(path, chunk_reads,
                                       block_bytes=block))
    want = list(fastq.parse_fastq(text))
    assert all(isinstance(c, ReadBatch) for c in got)
    sizes = [len(c) for c in got]
    assert sum(sizes) == len(want)
    assert all(s == chunk_reads for s in sizes[:-1])
    assert 0 < sizes[-1] <= chunk_reads
    flat = [r for c in got for r in c]
    for g, w in zip(flat, want):
        _same_read(g, w)
    # the columns themselves
    for c in got:
        assert np.array_equal(c.qlen, [len(r.seq) for r in c])
        assert np.array_equal(c.codes,
                              np.concatenate([r.seq for r in c]))
        assert c.names.tobytes() == "".join(r.name for r in c).encode()
        assert c.quals.tobytes() == "".join(r.qual for r in c).encode()
    ref = list(ref_fastq.iter_fastq_chunks(path, chunk_reads,
                                           block_bytes=block))
    assert sizes == [len(c) for c in ref]
    for g, w in zip(flat, [r for c in ref for r in c]):
        _same_read(g, w)


def test_fasta_input_is_one_batch_cut_into_chunks(tmp_path):
    """FASTA (multi-line records, no qualities) and a FASTQ record mixed
    in: the whole-file parse, cut into chunks, == the JAX package's."""
    text = (">c1 first contig\nACGTN\nacgt\r\nRY\n>c2\nTTTT\n"
            "@q1 c\nGGA\n+\nIII\n>c3\n\n>c4\nA\n")
    path = _write(tmp_path, text, False, "in.fa")
    got = list(fastq.iter_fastq_chunks(path, 2))
    ref = list(ref_fastq.iter_fastq_chunks(path, 2))
    assert [len(c) for c in got] == [len(c) for c in ref] == [2, 2, 1]
    flat = [r for c in got for r in c]
    for g, w in zip(flat, [r for c in ref for r in c]):
        _same_read(g, w)
    assert [r.qual for r in flat] == [None, None, "III", None, None]
    assert fastq.read_fastq(path)[1].name == "c2"


def _batch(n=11, seed=0):
    text = _text(np.random.default_rng(seed), n, lens=(5, 17, 30))
    return fastq._parse(text.encode(), len(text)), list(
        fastq.parse_fastq(text))


@pytest.mark.parametrize("key", [
    0, 5, -1, slice(None), slice(2, 7), slice(0, 11, 2), slice(1, None, 2),
    slice(9, 2, -3), slice(4, 4), [3, 0, 10, 3]])
def test_read_batch_is_a_sequence_of_reads(key):
    b, reads = _batch()
    if isinstance(key, list):
        got, want = b.take(key), [reads[k] for k in key]
    else:
        got, want = b[key], reads[key]
    if isinstance(want, list):
        assert isinstance(got, ReadBatch) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_read(g, w)
        mat, qlen = got.matrix()
        assert mat.dtype == np.uint8 and qlen.dtype == np.int64
        want_mat, want_qlen = gate.read_matrix([r.seq for r in want])
        assert np.array_equal(mat, want_mat)
        assert np.array_equal(qlen, want_qlen)
    else:
        _same_read(got, want)


def test_read_batch_join_and_matrix_view():
    b, reads = _batch(12, seed=3)
    j = ReadBatch.concat([b[:5], b[5:9], b[9:]])
    for g, w in zip(j, reads):
        _same_read(g, w)
    # one length: the matrix is a view of the codes
    text = _text(np.random.default_rng(1), 6, lens=(40,))
    u = fastq._parse(text.encode(), len(text))
    mat, qlen = u.matrix()
    assert np.shares_memory(mat, u.codes) and mat.shape == (6, 40)
    assert np.array_equal(qlen, [40] * 6)
    # a batch made from Reads, FASTA ones among them, is the same batch
    f = ReadBatch.from_reads(reads[:4] + [fastq.Read("fa", reads[0].seq)])
    assert [r.qual for r in f][3:] == [reads[3].qual, None]
    assert list(f.has_qual) == [True] * 4 + [False]
    with pytest.raises(IndexError):
        b[12]


@pytest.mark.parametrize("absent", ["none", "quals", "quals_comments"])
def test_read_batch_from_arrays_is_from_reads(absent):
    _, reads = _batch(9, seed=5)
    reads = [fastq.Read(r.name, r.seq, None if absent != "none" else r.qual,
                        None if absent == "quals_comments" else r.comment)
             for r in reads]
    got = ReadBatch.from_arrays(
        [r.seq.astype(np.int64) for r in reads], [r.name for r in reads],
        None if absent != "none" else [r.qual for r in reads],
        None if absent == "quals_comments" else [r.comment for r in reads])
    want = ReadBatch.from_reads(reads)
    for (gd, go), (wd, wo) in zip(got._ragged(), want._ragged()):
        assert gd.dtype == np.uint8 and np.array_equal(gd, wd)
        assert go.dtype == np.int64 and np.array_equal(go, wo)
    assert np.array_equal(got.has_qual, want.has_qual)
    assert got.has_qual.all() == (absent == "none")
    for g, w in zip(got, reads):
        _same_read(g, w)


@pytest.mark.parametrize("n_shards,b", [(2, 5), (3, 4), (3, 64)])
@pytest.mark.parametrize("ends", ["se", "pe"])
def test_shard_streams_gather_strided_batches(ends, n_shards, b):
    from bwamem_tpu_torch.parallel.multihost import (
        shard_chunk_stream,
        shard_pair_stream,
        shard_reads,
    )

    b1, r1 = _batch(41, seed=6)
    b2, r2 = _batch(41, seed=7)
    cuts = [0, 7, 8, 20, 41]            # chunks of uneven sizes
    for k in range(n_shards):
        idx = list(shard_reads(len(r1), k, n_shards))
        if ends == "se":
            got = list(shard_chunk_stream(
                (b1[a:z] for a, z in zip(cuts, cuts[1:])), k, n_shards, b))
            got = [(c,) for c in got]
            want = [[r1[i] for i in idx]]
        else:
            got = list(shard_pair_stream(
                ((b1[a:z], b2[a:z]) for a, z in zip(cuts, cuts[1:])), k,
                n_shards, b))
            want = [[r1[i] for i in idx], [r2[i] for i in idx]]
        assert [len(g[0]) for g in got] == \
            [min(b, len(idx) - i) for i in range(0, len(idx), b)]
        for e, w in enumerate(want):
            assert all(isinstance(g[e], ReadBatch) for g in got)
            flat = [r for g in got for r in g[e]]
            assert len(flat) == len(w)
            for g, x in zip(flat, w):
                _same_read(g, x)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(2024)
    genome = rng.integers(0, 4, 40000)
    genome[30000:30600] = genome[4000:4600]
    pac = genome.astype(np.uint8)
    ref = Reference(contigs=[Contig("g", 0, len(genome))], pac=pac)
    fm = build_index(pac)
    return ref, fm, pack_occ(fm), genome, rng


def _pair_text(rng, genome, n, lens=(70, 101, 150)):
    """FASTQ text of both ends of n FR pairs (mutated, lowercase and N
    bases, comments on some)."""
    ends = ([], [])
    for i in range(n):
        k = int(rng.choice(lens))
        p = int(rng.integers(0, len(genome) - 450))
        a = genome[p:p + k].copy()
        a[rng.integers(0, k, 2)] = rng.integers(0, 4, 2)
        b = 3 - genome[p + 300 - k:p + 300][::-1]
        for e, s in zip(ends, (a, b)):
            seq = list("".join(ACGT[s]))
            seq[int(rng.integers(0, k))] = "N"
            seq[int(rng.integers(0, k))] = seq[0].lower()
            q = "".join(chr(35 + int(c)) for c in rng.integers(0, 38, k))
            e.append(_record(f"p{i}", "".join(seq), q,
                             None if i % 2 else f"BX:Z:{i}"))
    return "".join(ends[0]), "".join(ends[1])


@pytest.fixture(scope="module")
def pipes(world):
    from bwamem_tpu_torch.pipeline import native_driver, resident

    if not native_driver.available():
        pytest.skip("the port's native host library is unavailable")
    ref, fm, po, *_ = world
    opt = MemOptions()
    ext = resident.make_fused_idx_backend(params_from_options(opt), ref.pac,
                                          torch.device("cpu"), blk_l=128)
    seeder = smem_torch.make_device_seeder(po, fm, opt, "cpu")
    return native_driver, opt, ext, seeder


def _lists(batch):
    return ([r.seq.astype(np.int64) for r in batch],
            [r.name for r in batch], [r.qual for r in batch])


@pytest.mark.parametrize("seeding", ["host", "device"])
@pytest.mark.parametrize("ends", ["se", "pe"])
def test_native_pipeline_batch_sam_is_the_lists_sam(world, pipes, ends,
                                                    seeding):
    native_driver, opt, ext, seeder = pipes
    ref, fm, po, genome, _ = world
    t1, t2 = _pair_text(np.random.default_rng(7), genome, 24)
    b1, b2 = (fastq._parse(t.encode(), len(t)) for t in (t1, t2))
    tracer = Tracer(None)
    got_pipe = native_driver.NativePipeline(opt, ref, fm, po, tracer=tracer)
    want_pipe = native_driver.NativePipeline(opt, ref, fm, po)
    if seeding == "device":
        got_pipe.seed_fn = seeder
    s1, names, q1 = _lists(b1)
    s2, _, q2 = _lists(b2)
    if ends == "se":
        b = ReadBatch.concat([b1, b2])
        s, n, q = _lists(b)
        got = got_pipe.align_chunk_text(b, ext)
        want = want_pipe.align_chunk_text(s, ext, names=n, quals=q)
        recs = got_pipe.align_chunk(b, ext)
        want_recs = want_pipe.align_chunk(s, ext, names=n, quals=q)
    else:
        got = got_pipe.align_pairs_chunk_text(b1, b2, ext)
        want = want_pipe.align_pairs_chunk_text(s1, s2, ext, names=names,
                                                quals1=q1, quals2=q2)
        recs = got_pipe.align_pairs_chunk(b1, b2, ext)
        want_recs = want_pipe.align_pairs_chunk(
            s1, s2, ext, names=names, quals1=q1, quals2=q2)
    assert got == want and got[1] >= 48
    assert [[r.line() for r in g] for g in recs] == \
        [[r.line() for r in g] for g in want_recs]
    lines = got[0].splitlines()
    assert sum(not int(x.split("\t")[1]) & 4 for x in lines) >= 40
    assert {x.split("\t")[10] for x in lines} != {"*"}
    c = tracer.counters
    assert c.packed_reads == c.reads == 2 * 48
    if seeding == "device":
        assert seeder.stats.counts["reads"] > 0


def test_list_input_counts_no_packed_reads(world, pipes):
    native_driver, opt, ext, _ = pipes
    ref, fm, po, genome, _ = world
    t1, _ = _pair_text(np.random.default_rng(8), genome, 8)
    s, n, q = _lists(fastq._parse(t1.encode(), len(t1)))
    tracer = Tracer(None)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, tracer=tracer)
    pipe.align_chunk_text(s, ext, names=n, quals=q)
    assert tracer.counters.reads == 8 and tracer.counters.packed_reads == 0


@pytest.fixture(scope="module")
def cli_files(world, tmp_path_factory):
    from bwamem_tpu_torch.__main__ import main

    ref, _, _, genome, _ = world
    tmp = tmp_path_factory.mktemp("ingest")
    fa = tmp / "ref.fa"
    fa.write_text(">g\n" + "".join(ACGT[genome]) + "\n")
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["index", str(fa)]) == 0
    t1, t2 = _pair_text(np.random.default_rng(11), genome, 40)
    r1, r2 = tmp / "r1.fq", tmp / "r2.fq"
    r1.write_text(t1)
    r2.write_text(t2)
    inter = tmp / "inter.fq"
    a, b = (t.splitlines(keepends=True) for t in (t1, t2))
    inter.write_text("".join("".join(a[i:i + 4] + b[i:i + 4])
                             for i in range(0, len(a), 4)))
    return str(fa), str(r1), str(r2), str(inter), tmp


# case: (flags, inputs, reads)
CLI = {
    "se": (["-C"], ["r1"], 40),
    "pe": (["-C"], ["r1", "r2"], 80),
    "interleaved": (["-p", "-C"], ["inter"], 80),
    "pe_device_seed": (["-C", "--device-seed"], ["r1", "r2"], 80),
}


def _run(files, flags, inputs, trace=None):
    from bwamem_tpu_torch.__main__ import main

    fa, r1, r2, inter, _ = files
    paths = {"r1": r1, "r2": r2, "inter": inter}
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["mem", "--backend", "torch", "-b", "16", "-R", RG,
                   *flags, *(["--trace", trace] if trace else []), fa,
                   *(paths[k] for k in inputs)])
    assert rc == 0, err.getvalue()[-2000:]
    body = [x for x in out.getvalue().splitlines()
            if not x.startswith("@PG")]
    return body, err.getvalue()


@pytest.mark.parametrize("case", sorted(CLI))
def test_mem_from_batches_is_mem_from_read_lists(cli_files, monkeypatch,
                                                 case):
    flags, inputs, n_reads = CLI[case]
    trace = str(cli_files[-1] / f"{case}.jsonl")
    got, err = _run(cli_files, flags, inputs, trace=trace)
    c = json.loads(err.split("[mem] counters: ")[1].splitlines()[0])
    assert c["packed_reads"] == c["reads"] == n_reads
    # the reference: every block parsed by parse_fastq into Reads, and
    # the batch made of them
    from bwamem_tpu_torch import native

    monkeypatch.setattr(native, "fastq_pack", lambda *a: None)
    want, _ = _run(cli_files, flags, inputs)
    assert got == want
    recs = [x for x in got if not x.startswith("@")]
    assert len(recs) >= n_reads
    assert any("\tBX:Z:" in x for x in recs)           # -C
    assert all("\tRG:Z:x" in x for x in recs)          # -R
