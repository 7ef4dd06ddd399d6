"""The port's native C++ host pipeline (bwamem_tpu_torch/pipeline/
native_driver.NativePipeline over its own host library), with the
resident-reference backends on the CPU (pipeline/resident.py), against
the Python host: tests/test_native_pipe.py's cases that no other port
test covers (bwa options, threads, the SA tag, the text blob, the
regions export, degenerate reads; the paired-end ones are in
tests/test_torch_native_pipe_pe.py).  The oracle is the JAX package's
Python host (driver.align_batch / pair.align_pairs on its own index of
the same text), with the port's Python host beside it; where the JAX
test passes the extend_jax twin, the port's extension pass on the CPU
takes its place, held to extend_jax on the same inputs.  SAM is
compared byte for byte.

The cases with device rescue, device CIGAR, the fused and ship-ref
backends and the window gathers are in tests/test_torch_pe_device.py,
test_torch_phased.py, test_torch_pipeline.py and test_torch_gather.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.index.occ_packed import pack_occ as ref_pack_occ
from bwamem_tpu.io import fasta as ref_fasta
from bwamem_tpu.pipeline import driver as ref_driver
from bwamem_tpu.pipeline import pair as ref_pair
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.ops import types
from bwamem_tpu_torch.pipeline import driver, native_driver, pair, resident
from bwamem_tpu_torch.pipeline.align import revcomp_read

from _torch_gate import same_sam
from _torch_ref import check_against_jax, port_extend_fn, ref_options

torch.set_num_threads(1)

BLK = 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world():
    """Two contigs (rid resolution and junctions) as the port's Reference,
    index and packed occ, and the reference package's of the same text."""
    rng = np.random.default_rng(42)
    pac = rng.integers(0, 4, 120000).astype(np.uint8)
    contigs = [("chrA", 0, 70000), ("chrB", 70000, 50000)]
    fm, rfm = build_index(pac), ref_build_index(pac)
    return SimpleNamespace(
        ref=Reference(contigs=[Contig(*c) for c in contigs], pac=pac),
        fm=fm, po=pack_occ(fm), rfm=rfm, rpo=ref_pack_occ(rfm),
        rref=ref_fasta.Reference(contigs=[ref_fasta.Contig(*c)
                                          for c in contigs], pac=pac),
        rng=rng)


def make_reads(rng, ref, n, read_len=120):
    reads, names, quals = [], [], []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - read_len - 20))
        r = ref.pac[pos:pos + read_len].astype(np.int64).copy()
        kind = i % 5
        if kind == 1:  # substitutions
            for _ in range(4):
                p = int(rng.integers(0, read_len))
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # deletion in read
            d = int(rng.integers(1, 6))
            p = int(rng.integers(10, read_len - 10 - d))
            r = np.concatenate([r[:p], r[p + d:]])
        elif kind == 3:  # insertion in read
            ins = rng.integers(0, 4, int(rng.integers(1, 5)))
            p = int(rng.integers(10, read_len - 10))
            r = np.concatenate([r[:p], ins, r[p:]])
        elif kind == 4:  # junk / N-heavy (likely unmapped)
            if i % 10 == 4:
                r = rng.integers(0, 4, read_len).astype(np.int64)
            else:
                r[::3] = 4
        if rng.random() < 0.5:
            r = revcomp_read(r)
        reads.append(r)
        names.append(f"r{i}")
        quals.append("".join(chr(33 + int(x))
                             for x in rng.integers(20, 40, len(r))))
    return reads, names, quals


def _pe_world(rng, ref, n):
    r1s, r2s = [], []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - 500))
        isize = 300 + int(rng.integers(-30, 30))
        r1 = ref.pac[pos:pos + 100].astype(np.int64).copy()
        r2 = revcomp_read(
            ref.pac[pos + isize - 100:pos + isize].astype(np.int64))
        kind = i % 6
        if kind == 1:  # substitutions on read 1
            for _ in range(4):
                p = int(rng.integers(0, 100))
                r1[p] = (r1[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # heavily mutated mate -> rescue path
            m = ref.pac[pos + isize - 100:pos + isize].astype(
                np.int64).copy()
            for p in range(4, 100, 9):
                m[p] = (m[p] + 1 + rng.integers(0, 3)) % 4
            r2 = revcomp_read(m)
        elif kind == 3:  # unmappable mate (all N)
            r2 = np.full(100, 4, np.int64)
        r1s.append(r1)
        r2s.append(r2)
    return r1s, r2s


def _ext(opt, w):
    """The port's resident-reference fused backend on the CPU."""
    return resident.make_fused_idx_backend(types.params_from_options(opt),
                                           w.ref.pac, CPU, blk_l=BLK)


def _pipe(opt, w, nthreads=1):
    return native_driver.NativePipeline(opt, w.ref, w.fm, w.po,
                                        nthreads=nthreads, blk_l=BLK)


def python_se(opt, w, reads, names=None, quals=None, port_host=False,
              jax_check=False):
    """The JAX package's Python host SAM of SE reads; with port_host, the
    port's Python host beside it (equal, byte for byte); with jax_check,
    the first extension batch held to extend_jax."""
    fn = port_extend_fn(opt)
    want = ref_driver.align_batch(ref_options(opt), w.rref, w.rfm, reads,
                                  fn, names=names, quals=quals, po=w.rpo)
    if port_host:
        same_sam(driver.align_batch(opt, w.ref, w.fm, reads,
                                    port_extend_fn(opt), names=names,
                                    quals=quals, po=w.po), want)
    if jax_check:
        check_against_jax(fn, opt)
    return want


def python_pe(opt, w, r1s, r2s, port_host=False, **kw):
    """The JAX package's Python host SAM of pairs; with port_host, the
    port's Python host beside it."""
    want = ref_pair.align_pairs(ref_options(opt), w.rref, w.rfm, r1s, r2s,
                                po=w.rpo, extend_batch_fn=port_extend_fn(opt),
                                **kw)
    if port_host:
        same_sam(pair.align_pairs(opt, w.ref, w.fm, r1s, r2s, po=w.po,
                                  extend_batch_fn=port_extend_fn(opt), **kw),
                 want)
    return want


@pytest.mark.parametrize("case", ["defaults", "no_a_xa", "hard_clip",
                                  "threaded"])
def test_sam_identical(world, case):
    """Defaults; -a off (XA tags and secondary suppression); -M off
    (supplementary records with hard clips); four host threads."""
    opt = {"no_a_xa": MemOptions(flag_a=False),
           "hard_clip": MemOptions(flag_M=False)}.get(case, MemOptions())
    reads, names, quals = make_reads(world.rng, world.ref, 40)
    want = python_se(opt, world, reads, names, quals,
                     port_host=case != "threaded",
                     jax_check=case == "defaults")
    got = _pipe(opt, world, 4 if case == "threaded" else 1).align_chunk(
        reads, _ext(opt, world), names=names, quals=quals)
    same_sam(got, want)


def test_sa_tag_split_reads(world):
    """Chimeric reads (left half from chrA, right half from chrB) produce
    primary + supplementary records that cross-reference each other via
    SA:Z (bwa mem_aln2sam); native == Python byte for byte.  flag_M off
    so the split mate keeps 0x800 (with -M it becomes 0x100 per bwa but
    SA still appears — also asserted)."""
    w = world
    reads, names, quals = [], [], []
    for i in range(12):
        pa = int(w.rng.integers(0, 60000))
        pb = int(w.rng.integers(72000, 115000))
        r = np.concatenate([w.ref.pac[pa:pa + 70],
                            w.ref.pac[pb:pb + 70]]).astype(np.int64)
        reads.append(r)
        names.append(f"chim{i}")
        quals.append("I" * len(r))
    opt = MemOptions(flag_M=False)
    want = python_se(opt, w, reads, names, quals)
    same_sam(_pipe(opt, w).align_chunk(reads, _ext(opt, w), names=names,
                                       quals=quals), want)
    n_sa = n_supp = 0
    for rr in want:
        for line in (r.line() for r in rr):
            flag = int(line.split("\t")[1])
            if flag & 0x800:
                n_supp += 1
            if "\tSA:Z:" in line:
                n_sa += 1
                # each SA entry names a real contig and ends with ';'
                sa = line.split("SA:Z:")[1].split("\t")[0]
                assert sa.endswith(";")
                assert sa.split(",")[0] in ("chrA", "chrB")
    assert n_supp >= 8, n_supp
    assert n_sa >= 2 * n_supp, (n_sa, n_supp)  # primary + supp both tagged

    # -M: the split hit is remapped to 0x100 but SA survives
    opt_m = MemOptions()
    want_m = python_se(opt_m, w, reads, names, quals)
    same_sam(_pipe(opt_m, w).align_chunk(reads, _ext(opt_m, w), names=names,
                                         quals=quals), want_m)
    assert sum("\tSA:Z:" in r.line() for rr in want_m for r in rr) >= 16


def _text(recs):
    return "".join(r.line() + "\n" for rr in recs for r in rr)


def test_chunk_text_blob_parity(world):
    """align_chunk_text / align_pairs_chunk_text (the zero-object emit
    fast path) == the per-record SamLine output, byte for byte."""
    opt = MemOptions()
    w = world
    reads, names, quals = make_reads(w.rng, w.ref, 24)
    want = _pipe(opt, w).align_chunk(reads, _ext(opt, w), names=names,
                                     quals=quals)
    text, nrec = _pipe(opt, w).align_chunk_text(reads, _ext(opt, w),
                                                names=names, quals=quals)
    assert text == _text(want)
    assert nrec == sum(len(rr) for rr in want)

    r1s, r2s = _pe_world(w.rng, w.ref, 12)
    want_pe = _pipe(opt, w).align_pairs_chunk(r1s, r2s, _ext(opt, w))
    text_pe, nrec_pe = _pipe(opt, w).align_pairs_chunk_text(r1s, r2s,
                                                            _ext(opt, w))
    assert text_pe == _text(want_pe)
    assert nrec_pe == sum(len(rr) for rr in want_pe)


def test_native_random_options_fuzz(world):
    """Native SAM == Python SAM under randomized MemOptions (scoring,
    seed length, band, zdrop) — the runtime-parameter plumbing holds
    across the whole option space, not just defaults."""
    w = world
    for trial in range(3):
        rng = w.rng
        opt = MemOptions(
            a=int(rng.integers(1, 3)),
            b=int(rng.integers(2, 7)),
            o_del=int(rng.integers(4, 9)),
            e_del=int(rng.integers(1, 3)),
            o_ins=int(rng.integers(4, 9)),
            e_ins=int(rng.integers(1, 3)),
            w=int(rng.integers(40, 150)),
            zdrop=int(rng.integers(50, 200)),
            min_seed_len=int(rng.integers(15, 25)),
            T=int(rng.integers(20, 40)),
            flag_M=bool(rng.integers(0, 2)),
            flag_a=bool(rng.integers(0, 2)),
        )
        reads, names, quals = make_reads(rng, w.ref, 16)
        want = python_se(opt, w, reads, names, quals)
        got = _pipe(opt, w).align_chunk(reads, _ext(opt, w), names=names,
                                        quals=quals)
        same_sam(got, want)


def test_tiny_and_unmappable_reads(world):
    """Reads below the seed length, all-N reads and random (unmappable)
    reads flow through the native pipeline as unmapped records without
    crashing; native == Python."""
    opt = MemOptions()
    w = world
    reads = [
        w.ref.pac[100:115].astype(np.int64),          # 15 bp < k
        np.full(50, 4, np.int64),                     # all N
        w.rng.integers(0, 4, 120).astype(np.int64),   # random junk
        w.ref.pac[500:620].astype(np.int64),          # mappable control
    ]
    names = [f"edge{i}" for i in range(len(reads))]
    quals = [None] * len(reads)
    want = python_se(opt, w, reads, names, quals)
    same_sam(_pipe(opt, w).align_chunk(reads, _ext(opt, w), names=names,
                                       quals=quals), want)
    flags = [want[0][0].flag, want[1][0].flag]
    assert all(f & 0x4 for f in flags), flags  # tiny + all-N unmapped
    assert not (want[3][0].flag & 0x4)


def test_regions_match_compute_regions(world):
    """regions_chunk == the Python compute_regions pipeline, the port's
    and the reference's (PE input)."""
    from bwamem_tpu.pipeline import align as ref_align
    from bwamem_tpu.pipeline import chain as ref_chain
    from bwamem_tpu_torch.pipeline.align import compute_regions
    from bwamem_tpu_torch.pipeline.chain import chain_reads_batch

    opt = MemOptions()
    w = world
    reads, _, _ = make_reads(w.rng, w.ref, 30)

    def regions(mods, ref, fm, po, o):
        chains = mods[0](fm, po, reads, o)
        tables = mods[1].extension_tables(o, ref, reads, chains,
                                          port_extend_fn(opt))
        return [[(r.rb, r.re, r.qb, r.qe, r.score, r.truesc, r.w, r.seedcov,
                  r.seedlen0) for r in mods[2](
                      o, ref, fm, rd, mods[1].table_extend_fn(tables[i]),
                      chains=chains[i])] for i, rd in enumerate(reads)]

    want = regions((ref_chain.chain_reads_batch, ref_driver,
                    ref_align.compute_regions), w.rref, w.rfm, w.rpo,
                   ref_options(opt))
    assert regions((chain_reads_batch, driver, compute_regions), w.ref,
                   w.fm, w.po, opt) == want
    got = _pipe(opt, w).regions_chunk(reads, _ext(opt, w))
    for i, (wt, g) in enumerate(zip(want, got)):
        gt = [(r.rb, r.re, r.qb, r.qe, r.score, r.truesc, r.w, r.seedcov,
               r.seedlen0) for r in g]
        assert wt == gt, i
