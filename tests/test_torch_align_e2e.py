"""The port's single-end pipeline (bwamem_tpu_torch/pipeline/align.py
over its io/fasta.py and io/sam.py) end to end: tests/test_align_e2e.py's
simulated reads -> SAM, checked against simulation truth (position,
strand, CIGAR, NM) and SAM internal consistency, and every read's
records byte-identical to the JAX package's on the same read (its own
reference and index of the same text)."""

import re

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions as RefOptions
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.io import fasta as ref_fasta
from bwamem_tpu.pipeline import align as ref_align
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.io.fasta import Contig, Reference, decode_seq
from bwamem_tpu_torch.io.sam import SamRecord
from bwamem_tpu_torch.pipeline.align import align_read, revcomp_read

torch.set_num_threads(1)

OPT = MemOptions()


class World:
    """One text as both packages' Reference and index; align() runs the
    port's align_read and holds its records to the reference's, byte for
    byte."""

    def __init__(self, pac, contigs):
        self.ref = Reference(contigs=[Contig(*c) for c in contigs], pac=pac)
        self.fm = build_index(pac)
        self._ref = ref_fasta.Reference(
            contigs=[ref_fasta.Contig(*c) for c in contigs], pac=pac)
        self._fm = ref_build_index(pac)
        assert decode_seq(pac[:50]) == ref_fasta.decode_seq(pac[:50])

    def align(self, name, read, opt=OPT, ref_opt=None):
        recs = align_read(opt, self.ref, self.fm, name, read)
        want = ref_align.align_read(ref_opt or RefOptions(), self._ref,
                                    self._fm, name, read)
        assert all(isinstance(r, SamRecord) for r in recs)
        assert [r.line() for r in recs] == [r.line() for r in want]
        return recs


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    pac = rng.integers(0, 4, 60000).astype(np.uint8)
    return World(pac, [("chr1", 0, 35000), ("chr2", 35000, 25000)]), rng


def simulate(rng, ref, pos, length=100, snps=0, ins=0, dele=0, rev=False):
    """Extract a read from the reference with mutations; returns
    (read_codes, truth)."""
    seq = ref.pac[pos:pos + length].astype(np.int64).copy()
    for p in sorted(rng.choice(np.arange(10, length - 10), snps,
                               replace=False)) if snps else []:
        seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
    if ins:
        p = int(rng.integers(20, len(seq) - 20))
        seq = np.concatenate([seq[:p], rng.integers(0, 4, ins), seq[p:]])
    if dele:
        p = int(rng.integers(20, len(seq) - 20 - dele))
        seq = np.concatenate([seq[:p], seq[p + dele:]])
    if rev:
        seq = revcomp_read(seq)
    return seq


def primary_of(records):
    prim = [r for r in records if not (r.flag & 0x900) and not (r.flag & 0x4)]
    assert len(prim) == 1, [((r.flag), r.rname, r.pos) for r in records]
    return prim[0]


def check_consistency(rec, read_len):
    if rec.flag & 0x4:
        return
    ops = re.findall(r"(\d+)([MIDSH])", rec.cigar)
    qsum = sum(int(n) for n, op in ops if op in "MIS")
    assert qsum == read_len
    assert len(rec.seq) == read_len
    nm = dict((t[0], t[2]) for t in rec.tags)["NM"]
    assert nm >= 0


def _nm(rec):
    return dict((t[0], t[2]) for t in rec.tags)["NM"]


def test_exact_read_maps_exactly(world):
    w, rng = world
    p = primary_of(w.align("r1", simulate(rng, w.ref, 5000)))
    assert p.rname == "chr1" and p.pos == 5001
    assert p.cigar == "100M"
    assert p.mapq > 0
    assert _nm(p) == 0


def test_read_on_chr2(world):
    w, rng = world
    p = primary_of(w.align("r2", simulate(rng, w.ref, 40000)))
    assert p.rname == "chr2" and p.pos == 40000 - 35000 + 1
    assert p.cigar == "100M"


def test_snp_read(world):
    w, rng = world
    p = primary_of(w.align("r3", simulate(rng, w.ref, 12000, snps=3)))
    assert p.rname == "chr1" and p.pos == 12001
    assert p.cigar == "100M"
    assert _nm(p) == 3


def test_insertion_read(world):
    w, rng = world
    read = simulate(rng, w.ref, 20000, ins=4)
    p = primary_of(w.align("r4", read))
    assert p.rname == "chr1" and p.pos == 20001
    assert "4I" in p.cigar
    check_consistency(p, len(read))


def test_deletion_read(world):
    w, rng = world
    read = simulate(rng, w.ref, 25000, dele=5)
    p = primary_of(w.align("r5", read))
    assert p.pos == 25001
    assert "5D" in p.cigar
    check_consistency(p, len(read))


def test_reverse_strand_read(world):
    w, rng = world
    read = simulate(rng, w.ref, 8000, snps=1, rev=True)
    p = primary_of(w.align("r6", read))
    assert p.flag & 0x10
    assert p.rname == "chr1" and p.pos == 8001
    assert p.cigar == "100M"
    # SEQ is printed on the forward strand
    assert p.seq == decode_seq(revcomp_read(read))


def test_soft_clipped_chimera(world):
    w, rng = world
    # half maps to chr1, half is random junk -> soft clip
    left = w.ref.pac[30000:30060].astype(np.int64)
    read = np.concatenate([left, rng.integers(0, 4, 40)])
    p = primary_of(w.align("r7", read))
    assert p.pos == 30001
    assert p.cigar.startswith("60M") and p.cigar.endswith("S")
    check_consistency(p, len(read))


def test_unmappable_read(world):
    w, _ = world
    recs = w.align("r8", np.full(80, 4, np.int64))  # all N
    assert len(recs) == 1
    assert recs[0].flag & 0x4
    assert recs[0].cigar == "*"


def test_batch_of_reads_all_place(world):
    w, rng = world
    ok = 0
    n = 30
    for i in range(n):
        pos = int(rng.integers(0, w.ref.l_pac - 150))
        rev = bool(rng.integers(0, 2))
        read = simulate(rng, w.ref, pos, snps=int(rng.integers(0, 4)),
                        rev=rev)
        recs = w.align(f"b{i}", read)
        if 35000 - 150 < pos < 35000:
            # contig-junction reads are correctly dropped (bwa parity)
            n -= 1
            continue
        p = primary_of(recs)
        rid = 0 if pos < 35000 else 1
        want_pos = pos - w.ref.contigs[rid].offset + 1
        if (p.rname == w.ref.contigs[rid].name and p.pos == want_pos
                and bool(p.flag & 0x10) == rev):
            ok += 1
        check_consistency(p, len(read))
    assert ok >= n - 1  # allow an occasional repeat-induced ambiguity


@pytest.fixture(scope="module")
def duplicated():
    """An exact 2 kb duplication and a read of its first copy."""
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 4, 2000).astype(np.uint8)
    pac = np.concatenate([seg, rng.integers(0, 4, 1000).astype(np.uint8),
                          seg])
    return World(pac, [("c", 0, len(pac))]), pac[500:600].astype(np.int64)


def test_mapq_zero_for_duplicated_segment(duplicated):
    w, read = duplicated
    recs = w.align("dup", read)
    p = primary_of(recs)
    assert p.mapq == 0  # ambiguous between the two copies
    # with -a the secondary copy is also reported
    secondaries = [r for r in recs if r.flag & 0x100]
    assert len(secondaries) >= 1


def test_xa_tag_without_flag_a(duplicated):
    """Duplicated locus + -a off: one record with an XA alternate."""
    w, read = duplicated
    recs = w.align("dup", read, MemOptions(flag_a=False),
                   RefOptions(flag_a=False))
    assert len(recs) == 1
    tags = dict((t[0], t[2]) for t in recs[0].tags)
    assert "XA" in tags
    alt = tags["XA"].rstrip(";").split(",")
    assert alt[0] == "c" and alt[2] == "100M"
    # the alternate is the other copy of the duplication
    assert abs(int(alt[1].lstrip("+-")) - 3501) < 5


def test_contig_junction_alignment_rejected():
    """Junction handling on the concatenated reference:
    (a) a read whose only (exact) seed bridges two contigs ends up
        unmapped (bwa drops bridging alignments);
    (b) a read seeded inside one contig whose EXTENSION would cross the
        junction gets soft-clipped at the contig end (bns_fetch_seq
        restricts the window to one contig)."""
    rng = np.random.default_rng(21)
    pac = rng.integers(0, 4, 4000).astype(np.uint8)
    w = World(pac, [("a", 0, 2000), ("b", 2000, 2000)])

    # (a) fully bridging exact read -> unmapped
    recs = w.align("jx", pac[1950:2050].astype(np.int64))
    assert all(r.flag & 0x4 for r in recs)

    # (b) seeds in contig a, tail crosses into b but is mutated so no
    # seed bridges; extension must clip at the contig end
    read2 = pac[1930:2030].astype(np.int64).copy()
    for p_ in range(60, 100, 9):
        read2[p_] = (read2[p_] + 1) % 4
    mapped = [r for r in w.align("jc", read2) if not r.flag & 0x4]
    assert mapped
    for r in mapped:
        span = sum(int(n) for n, op in re.findall(r"(\d+)([MD])", r.cigar))
        assert r.rname == "a"
        assert r.pos + span - 1 <= 2000, (r.rname, r.pos, r.cigar)
