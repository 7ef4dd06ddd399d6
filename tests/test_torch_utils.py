"""The port's host utilities against the JAX package's copies:
tests/test_utils.py's checks on bwamem_tpu_torch/utils/metrics.py,
utils/checkpoint.py, io/fastq.py and pipeline/tasks.py, plus io/sam.py's
header and record text; every result equal to the reference's on the
same input, and a resume manifest written by either package read by the
other."""

import json

import numpy as np
import pytest
import torch

from bwamem_tpu.io import fastq as ref_fastq
from bwamem_tpu.io import sam as ref_sam
from bwamem_tpu.io.fasta import Contig as RefContig
from bwamem_tpu.pipeline import tasks as ref_tasks
from bwamem_tpu.utils import checkpoint as ref_checkpoint
from bwamem_tpu.utils import metrics as ref_metrics
from bwamem_tpu_torch.io import fastq, sam
from bwamem_tpu_torch.io.fasta import Contig
from bwamem_tpu_torch.pipeline.tasks import pack_tasks
from bwamem_tpu_torch.utils.checkpoint import Manifest
from bwamem_tpu_torch.utils.metrics import Tracer, band_cells, span

from _torch_gate import plain

torch.set_num_threads(1)


def test_band_cells():
    args = ([100, 50], [200, 100], [100, 10])
    assert band_cells(*args) == 200 * 100 + 100 * 21
    rng = np.random.default_rng(0)
    q, t, w = (rng.integers(0, 300, 64) for _ in range(3))
    assert band_cells(q, t, w) == ref_metrics.band_cells(q, t, w)


def test_tracer_counters(tmp_path):
    """The counters and row fields both tracers have agree on the same
    calls: the port's spans (`span`, what `mem` opens) against the
    reference's `batch` and `host` rows.  The port's rows add `id`,
    `parent` and `chunk`, stamp `t` to the microsecond and time `sec`
    themselves; its counters add `h2d_bytes` and drop `gcups` and
    `reads_per_sec`; it may add `gc` rows of its own."""
    rows = [("extend_L", 512, 10_000_000, 0.005),
            ("extend_R", 512, 10_000_000, 0.005)]
    shared = ("reads", "tasks", "band_cells", "device_batches")
    traces = []
    for mod, name in ((None, "port"), (ref_metrics, "ref")):
        path = tmp_path / f"{name}.jsonl"
        if mod is None:
            tr = Tracer(str(path))
            for kind, n_tasks, cells, _ in rows:
                with span(tr, kind, n_tasks=n_tasks, cells=cells):
                    pass
            with span(tr, "host_chunk", reads=300):
                tr.note(h2d_bytes=4096, copies=2)
            assert tr.counters.device_batches == 2
            assert tr.counters.h2d_bytes == 4096
        else:
            tr = mod.Tracer(str(path))
            for r in rows:
                tr.batch(*r)
            tr.host(300, 0.25)
        counters = tr.counters.as_dict()
        traces.append({k: counters[k] for k in shared})
        tr.close()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        if mod is None:
            lines = [x for x in lines if x["kind"] != "gc"]
            assert all({"id", "parent", "chunk"} <= set(x) for x in lines)
            assert all(x["sec"] >= 0 for x in lines)
            assert lines[-1].pop("h2d_bytes") == 4096
            assert lines[-1].pop("copies") == 2
        assert len(lines) == 3
        traces.append([{k: v for k, v in x.items()
                        if k not in ("t", "sec", "id", "parent", "chunk")}
                       for x in lines])
    assert traces[:2] == traces[2:]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manifest_resume(tmp_path, writer):
    """The manifest of an interrupted run, written by one package,
    resumes the same missing range in both."""
    p = str(tmp_path / "m.jsonl")
    make = Manifest if writer == "port" else ref_checkpoint.Manifest
    m = make(p)
    todo = m.pending(shard=0, n_reads=100, batch=40)
    assert [(r.start, r.end) for r in todo] == [(0, 40), (40, 80), (80, 100)]
    m.mark_done(todo[0])
    m.mark_done(todo[2])
    # a fresh process resumes exactly the missing range
    left = Manifest(p).pending(0, 100, 40)
    assert [(r.start, r.end) for r in left] == [(40, 80)]
    assert plain(left) == plain(
        ref_checkpoint.Manifest(p).pending(0, 100, 40))


def _same_reads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.name == w.name
        assert np.array_equal(g.seq, w.seq) and g.seq.dtype == w.seq.dtype
        assert g.qual == w.qual


def test_native_fastq_scan_matches_python(tmp_path):
    fq = ("@r1 comment\nACGTN\n+\nIIIII\n"
          "@r2\nTTTT\n+\n!!!!\n"
          ">fa1\nACGT\nACGT\n"
          "@r3\nGG\n+\nII\n")
    p = tmp_path / "t.fq"
    p.write_text(fq)
    got = fastq.read_fastq(str(p))
    want = list(fastq.parse_fastq(fq))
    assert len(got) == len(want) == 4
    _same_reads(got, want)
    _same_reads(got, ref_fastq.read_fastq(str(p)))
    _same_reads(want, list(ref_fastq.parse_fastq(fq)))


def test_iter_fastq_chunks_streaming(tmp_path):
    """Chunked streaming ingest == whole-file parse, across block
    boundaries that split records."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(257):
        n = int(rng.integers(30, 90))
        seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, n))
        q = "".join(chr(33 + int(c)) for c in rng.integers(0, 40, n))
        recs.append(f"@read{i} c{i}\n{seq}\n+\n{q}\n")
    text = "".join(recs)
    p = tmp_path / "s.fq"
    p.write_text(text[:-1])  # no trailing newline: edge case
    want = fastq.read_fastq(str(p))
    # tiny blocks force many record-splitting boundaries
    got = [r for chunk in fastq.iter_fastq_chunks(str(p), 50,
                                                  block_bytes=999)
           for r in chunk]
    assert len(got) == len(want) == 257
    _same_reads(got, want)
    _same_reads(got, [r for chunk in ref_fastq.iter_fastq_chunks(
        str(p), 50, block_bytes=999) for r in chunk])
    sizes = [len(c) for c in fastq.iter_fastq_chunks(str(p), 100,
                                                     block_bytes=1 << 12)]
    assert sizes == [100, 100, 57]


def test_pack_tasks_soa():
    qs = [np.array([0, 1, 2]), np.array([3] * 50), np.array([1, 2])]
    ts = [np.array([0, 1, 2, 3]), np.array([1] * 200), np.array([2])]
    kw = dict(h0=[10, 20, 5], w=[100] * 3, max_ins=[50] * 3,
              max_del=[50] * 3)
    b = pack_tasks(qs, ts, **kw)
    assert b.query.shape[1] % 128 == 0
    assert b.size % 8 == 0
    assert b.n_real == 3
    assert list(b.qlen[:3]) == [3, 50, 2]
    # padding tasks are inert (qlen 0) and cells() counts band areas
    assert all(b.qlen[3:] == 0)
    assert b.cells() == 4 * 3 + 200 * 50 + 1 * 2
    want = ref_tasks.pack_tasks(qs, ts, **kw)
    assert plain(b) == plain(want)
    assert (b.size, b.n_real, b.cells()) == (want.size, want.n_real,
                                             want.cells())


def test_sam_header_and_record_text():
    """io/sam.py: the header and a record's line, as the reference
    writes them."""
    contigs = [Contig("chr1", 0, 35000), Contig("chr2", 35000, 25000)]
    ref_contigs = [RefContig("chr1", 0, 35000), RefContig("chr2", 35000,
                                                          25000)]
    kw = dict(extra_lines=["@CO\tx"], rg_line="@RG\\tID:g\\tSM:s",
              pg_cl="mem ref.fa r.fq")
    assert sam.sam_header(contigs, **kw) == ref_sam.sam_header(ref_contigs,
                                                               **kw)
    fields = dict(qname="r1", flag=sam.FLAG_SECONDARY | 0x10, rname="chr1",
                  pos=5001, mapq=60, cigar="60M40S", rnext="=", pnext=5301,
                  tlen=400, seq="ACGT", qual="IIII",
                  tags=[("NM", "i", 0), ("MD", "Z", "60"), ("AS", "i", 60)])
    line = sam.SamRecord(**fields).line()
    assert line == ref_sam.SamRecord(**fields).line()
    emitted = sam.SamLine(line)
    assert (emitted.line(), emitted.flag, emitted.qname, emitted.mapq) == \
        (line, 0x110, "r1", 60)
