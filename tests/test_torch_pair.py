"""The port's paired-end pipeline (bwamem_tpu_torch/pipeline/pair.py)
against the JAX package's copy: tests/test_pair.py's checks on the
port's module, and every pair's SAM byte-identical to the reference's
on the same reads (the reference's own index of the same text).  Where
the JAX test passes the extend_jax twin, the port's extension pass on
the CPU takes its place and is held to extend_jax on the same inputs."""

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions as RefOptions
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.index.occ_packed import pack_occ as ref_pack_occ
from bwamem_tpu.io.fasta import Contig as RefContig
from bwamem_tpu.io.fasta import Reference as RefReference
from bwamem_tpu.pipeline import pair as ref_pair
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.pipeline.align import revcomp_read
from bwamem_tpu_torch.pipeline.pair import _infer_dir, align_pairs

from _torch_gate import same_sam
from _torch_ref import check_against_jax, port_extend_fn

torch.set_num_threads(1)

OPT = MemOptions()


@pytest.fixture(scope="module")
def world():
    """(the port's reference and index, the reference package's of the
    same text, rng)."""
    rng = np.random.default_rng(77)
    pac = rng.integers(0, 4, 80000).astype(np.uint8)
    ref = Reference(contigs=[Contig("chr1", 0, 80000)], pac=pac)
    rref = RefReference(contigs=[RefContig("chr1", 0, 80000)], pac=pac)
    return ref, build_index(pac), rref, ref_build_index(pac), rng


def make_pairs(rng, ref, n, isize_mean=300, read_len=100):
    """FR-oriented pairs like a real library."""
    r1s, r2s, truths = [], [], []
    for _ in range(n):
        isize = int(rng.normal(isize_mean, 20))
        isize = max(read_len + 10, isize)
        pos = int(rng.integers(0, ref.l_pac - isize - 10))
        r1 = ref.pac[pos:pos + read_len].astype(np.int64)
        r2 = revcomp_read(
            ref.pac[pos + isize - read_len:pos + isize].astype(np.int64))
        r1s.append(r1)
        r2s.append(r2)
        truths.append((pos, pos + isize - read_len, isize))
    return r1s, r2s, truths


def _pairs(world, opt, r1s, r2s, ref_opt=None, **kw):
    """The port's align_pairs, held byte for byte to the reference's
    (whose index and reference are its own; `po` given means each
    package's packed occ)."""
    ref, fm, rref, rfm, _ = world
    ref_kw = dict(kw)
    if kw.get("po") is not None:
        ref_kw["po"] = ref_pack_occ(rfm)
    ref_kw.pop("extend_batch_fn", None)
    got = align_pairs(opt, ref, fm, r1s, r2s, **kw)
    same_sam(got, ref_pair.align_pairs(ref_opt or RefOptions(), rref, rfm,
                                       r1s, r2s, **ref_kw))
    return got


def test_infer_dir():
    l_pac = 1000
    # both forward
    assert _infer_dir(l_pac, 100, 300) == (0, 200)
    # read1 fwd at 100, read2 rev at (2000-1-1700)=299 -> FR
    d, dist = _infer_dir(l_pac, 100, 1700)
    assert d == 1
    # read1 rev, read2 fwd downstream -> RF
    d, _ = _infer_dir(l_pac, 1700, 100)
    assert d == 1  # symmetric call order: still FR by coordinates
    for a, b in ((100, 300), (100, 1700), (1700, 100), (1999, 0)):
        assert _infer_dir(l_pac, a, b) == ref_pair._infer_dir(l_pac, a, b)


def test_isize_inference(world):
    ref, rng = world[0], world[4]
    r1s, r2s, truths = make_pairs(rng, ref, 40)
    recs = _pairs(world, OPT, r1s, r2s)
    # re-derive pes through the public api by checking proper-pair flags
    proper = sum(1 for pair in recs for r in pair[:2] if r.flag & 0x2)
    assert proper >= 0.9 * 2 * len(r1s)


def test_pair_sam_fields(world):
    ref, rng = world[0], world[4]
    r1s, r2s, truths = make_pairs(rng, ref, 30)
    out = _pairs(world, OPT, r1s, r2s, names=[f"p{i}" for i in range(30)])
    ok_pos = 0
    for i, recs in enumerate(out):
        prim = [r for r in recs if not r.flag & 0x900]
        assert len(prim) == 2
        a, b = prim
        assert a.flag & 0x1 and b.flag & 0x1
        assert a.flag & 0x40 and b.flag & 0x80
        assert (a.flag & 0x10 == 0) and (b.flag & 0x10)  # FR orientation
        assert a.flag & 0x20  # mate reversed
        assert a.rnext == "=" and b.rnext == "="
        assert a.pnext == b.pos and b.pnext == a.pos
        p1, p2, isize = truths[i]
        if a.pos == p1 + 1 and b.pos == p2 + 1:
            ok_pos += 1
        assert a.tlen == -b.tlen
        assert abs(a.tlen) == isize or abs(a.tlen) == 0
    assert ok_pos >= 28


def test_one_end_unmappable(world):
    ref = world[0]
    r1 = ref.pac[5000:5100].astype(np.int64)
    r2 = np.full(100, 4, np.int64)  # all N
    recs = _pairs(world, OPT, [r1] * 12, [r2] * 12)[0]
    a = [r for r in recs if r.flag & 0x40][0]
    b = [r for r in recs if r.flag & 0x80][0]
    assert not a.flag & 0x4 and a.flag & 0x8  # mate unmapped
    assert b.flag & 0x4
    assert b.rname == a.rname and b.pos == a.pos  # placed at mate
    assert b.mapq == 0 and b.cigar == "*"


def test_distant_mates_not_proper(world):
    ref, rng = world[0], world[4]
    # train pes with 20 normal pairs, then one distant pair
    r1s, r2s, _ = make_pairs(rng, ref, 20)
    far1 = ref.pac[1000:1100].astype(np.int64)
    far2 = revcomp_read(ref.pac[60000:60100].astype(np.int64))
    out = _pairs(world, OPT, r1s + [far1], r2s + [far2])
    prim = [r for r in out[-1] if not r.flag & 0x900]
    assert all(not (r.flag & 0x2) for r in prim)  # not a proper pair
    assert all(not r.flag & 0x4 for r in prim)    # both still mapped


def test_mate_rescue(world):
    """A mate whose seeds are destroyed by heavy mutation is recovered by
    matesw from the anchor's insert window."""
    ref, rng = world[0], world[4]
    r1s, r2s, _ = make_pairs(rng, ref, 20)
    pos = 30000
    isize = 310
    good = ref.pac[pos:pos + 100].astype(np.int64)
    bad = ref.pac[pos + isize - 100:pos + isize].astype(np.int64).copy()
    # mutate every ~10th base: no 19bp exact seed survives, SW still wins
    for p in range(4, 100, 9):
        bad[p] = (bad[p] + 1 + rng.integers(0, 3)) % 4
    bad = revcomp_read(bad)
    last = _pairs(world, OPT, r1s + [good], r2s + [bad])[-1]
    a = [r for r in last if r.flag & 0x40 and not r.flag & 0x900][0]
    b = [r for r in last if r.flag & 0x80 and not r.flag & 0x900][0]
    assert not b.flag & 0x4, "mate was not rescued"
    # local SW may soft-clip a mutated edge; position within a few bp
    assert abs(b.pos - (pos + isize - 100 + 1)) <= 10
    assert b.flag & 0x10
    assert a.flag & 0x2 and b.flag & 0x2  # rescued into a proper pair


def test_rescue_skipped_when_consistent(world):
    """Pairs already consistent skip the SW (mem_matesw skip[] logic) —
    output must equal the no-rescue run."""
    ref, rng = world[0], world[4]
    r1s, r2s, _ = make_pairs(rng, ref, 15)
    out1 = _pairs(world, OPT, r1s, r2s)
    out2 = _pairs(world, MemOptions(max_matesw=0), r1s, r2s,
                  ref_opt=RefOptions(max_matesw=0))
    same_sam(out1, out2)


def test_align_pairs_batched_seeding_identical(world):
    ref, fm, rng = world[0], world[1], world[4]
    r1s, r2s, _ = make_pairs(rng, ref, 12)
    same_sam(_pairs(world, OPT, r1s, r2s, po=pack_occ(fm)),
             _pairs(world, OPT, r1s, r2s))


def test_align_pairs_device_extension_identical(world):
    """The PE path with the batched extension (the port's pass on the
    CPU, held to extend_jax on its first batch) must be byte-identical to
    the scalar path.  A substitution in every read makes the extension
    run (an exact read's one seed spans it)."""
    ref, fm, rng = world[0], world[1], world[4]
    r1s, r2s, _ = make_pairs(rng, ref, 10)
    for r in r1s + r2s:
        r[30] = (r[30] + 1) % 4
    fn = port_extend_fn(OPT)
    b = _pairs(world, OPT, r1s, r2s, po=pack_occ(fm), extend_batch_fn=fn)
    same_sam(b, _pairs(world, OPT, r1s, r2s))
    check_against_jax(fn, OPT)
