"""Read alignment: chains -> extension regions -> SAM records.

bwa-0.7.8 `mem_chain2aln` / `mem_sort_and_dedup` / `mem_mark_primary_se`
/ `mem_approx_mapq_se` / `mem_reg2aln` / `mem_reg2sam_se` semantics.
The extension calls go through `extend_fn`, which serves results
computed in batch beforehand (driver.py): extension order has no
cross-seed data dependency (a seed's right extension only depends on its
own left extension), so the batched pass extends every seed in two
phases and this module just consumes the results in bwa's sequential
order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .config import MemOptions
from .fasta import Reference, decode_seq
from .sam import SamRecord
from .chain import Chain
from .cigar import (
    D_OP,
    M_OP,
    S_OP,
    H_OP,
    cigar_ref_len,
    cigar_to_string,
    compute_nm_md,
    infer_bw,
    ksw_global,
)


@dataclasses.dataclass
class Region:
    """mem_alnreg_t."""

    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    score: int = -1
    truesc: int = -1
    w: int = 0
    seedcov: int = 0
    seedlen0: int = 0
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    secondary: int = -1


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    return min(max(l_del, l_ins, 1), opt.w << 1)


def _max_gap_bound(opt: MemOptions, qlen: int, o: int, e: int,
                   end_bonus: int) -> int:
    """ksw_extend2's internal max_ins/max_del band bound."""
    return max(int((qlen * opt.a + end_bonus - o) / e + 1.0), 1)


def _extend_with_doubling(opt, key, query, target, h0, pen_clip, prev_score,
                          extend_fn):
    """bwa's MAX_BAND_TRY loop (the FPGA runs this inside sw_extend,
    sw_extend.v:1765/1963).  Returns (result, attempted_w)."""
    qlen = len(query)
    max_ins = _max_gap_bound(opt, qlen, opt.o_ins, opt.e_ins, pen_clip)
    max_del = _max_gap_bound(opt, qlen, opt.o_del, opt.e_del, pen_clip)
    prev = prev_score
    res, aw = None, opt.w
    for k in range(2):  # MAX_BAND_TRY
        aw = opt.w << k
        res = extend_fn(key, query, target, aw, h0, max_ins, max_del, opt)
        if res.score == prev or res.max_off < (aw >> 1) + (aw >> 2):
            break
        prev = res.score
    return res, aw


def _seed_covered(opt: MemOptions, s, regions, l_query: int) -> bool:
    """bwa mem_chain2aln's contained-seed skip: is seed `s` already
    covered by an existing region closely enough that re-extending it
    cannot produce a different alignment?  NOTE the deliberate
    asymmetry, reproduced from bwa-0.7.8: the left-hand distances are
    measured from the REGION boundary (p.qb/p.rb) but the right-hand
    QUERY distance from the END OF THE READ (l_query - qend), not
    p.qe (PARITY.md §Deviations #9; C++ twin csrc/mempipe.cpp)."""
    for p in regions:
        if not (s.rbeg >= p.rb and s.rend <= p.re
                and s.qbeg >= p.qb and s.qend <= p.qe):
            continue
        if s.len - p.seedlen0 > 0.1 * l_query:
            continue  # the seed might give a better alignment
        # bwa clamps the window with the region's ACTUAL band p->w
        # (2*opt.w after band doubling), not opt.w
        qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
        mg = cal_max_gap(opt, min(qd, rd))
        ww = min(mg, p.w)
        if qd - rd < ww and rd - qd < ww:
            return True
        qd, rd = l_query - s.qend, p.re - s.rend
        mg = cal_max_gap(opt, min(qd, rd))
        ww = min(mg, p.w)
        if qd - rd < ww and rd - qd < ww:
            return True
    return False


def chain2aln(opt: MemOptions, ref: Reference, read: np.ndarray,
              chain: Chain, regions: list[Region],
              extend_fn, chain_index: int = 0) -> None:
    """Extend every seed of one chain into alignment regions
    (mem_chain2aln), appending to `regions` (shared across the read's
    chains — the contained-seed test sees earlier chains' regions)."""
    l_query = len(read)
    l_pac = ref.l_pac
    seeds = chain.seeds
    # max possible reference span of this chain
    rmax0, rmax1 = l_pac << 1, 0
    for t in seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick one side
        if seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    # restrict to the anchor seed's contig (bns_fetch_seq) so extension
    # cannot bridge a junction of the concatenated reference
    lo, hi = ref.contig_window(seeds[0].rbeg)
    rmax0 = max(rmax0, lo)
    rmax1 = min(rmax1, hi)
    rseq = ref.get_seq(rmax0, rmax1)

    # process seeds longest-first (bwa's srt array; ties -> later index)
    order = sorted(range(len(seeds)), key=lambda i: (seeds[i].len, i))
    for k in reversed(order):
        s = seeds[k]
        if _seed_covered(opt, s, regions, l_query):
            continue

        a = Region(w=opt.w, seedlen0=s.len)
        aw = [opt.w, opt.w]
        if s.qbeg > 0:  # left extension (reversed sequences)
            qs = read[:s.qbeg][::-1]
            rs = rseq[:s.rbeg - rmax0][::-1]
            res, aw[0] = _extend_with_doubling(
                opt, (chain_index, k, "L"), qs, rs, h0=s.len * opt.a,
                pen_clip=opt.pen_clip5, prev_score=-1, extend_fn=extend_fn)
            a.score = res.score
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip5:
                a.qb, a.rb = s.qbeg - res.qle, s.rbeg - res.tle
                a.truesc = a.score
            else:
                a.qb, a.rb = 0, s.rbeg - res.gtle
                a.truesc = res.gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb, a.rb = 0, s.rbeg

        if s.qend != l_query:  # right extension
            sc0 = a.score
            qe_off = s.qend
            re_off = s.rend - rmax0
            res, aw[1] = _extend_with_doubling(
                opt, (chain_index, k, "R"), read[qe_off:], rseq[re_off:],
                h0=sc0, pen_clip=opt.pen_clip3, prev_score=sc0,
                extend_fn=extend_fn)
            a.score = res.score
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip3:
                a.qe, a.re = qe_off + res.qle, s.rend + res.tle
                a.truesc += a.score - sc0
            else:
                a.qe, a.re = l_query, rmax0 + re_off + res.gtle
                a.truesc += res.gscore - sc0
        else:
            a.qe, a.re = l_query, s.rend

        a.w = max(aw[0], aw[1])
        a.seedcov = sum(
            t.len for t in seeds
            if (t.qbeg >= a.qb and t.qend <= a.qe
                and t.rbeg >= a.rb and t.rend <= a.re))
        regions.append(a)


MASK_LEVEL_REDUN = 0.95


def sort_and_dedup(opt: MemOptions, regions: list[Region]) -> list[Region]:
    """mem_sort_and_dedup: drop identical / heavily redundant regions."""
    if len(regions) <= 1:
        return regions
    regions = sorted(regions, key=lambda r: (r.rb, r.re, r.qb, r.qe,
                                             -r.score))
    out: list[Region] = []
    for r in regions:
        dup = False
        for q in out:
            if q.rb == r.rb and q.qb == r.qb and q.score == r.score:
                dup = True
                break
            # redundant: overlapping the same reference span almost fully
            b = max(q.rb, r.rb)
            e = min(q.re, r.re)
            if e > b:
                min_l = min(q.re - q.rb, r.re - r.rb)
                if e - b >= min_l * MASK_LEVEL_REDUN and min_l == r.re - r.rb \
                        and q.score >= r.score:
                    dup = True
                    break
        if not dup:
            out.append(r)
    # bwa's mem_sort_and_dedup ends with ks_introsort(mem_ars): score
    # descending — a[0] must be the best hit (mem_pestat reads it)
    out.sort(key=lambda r: (-r.score, r.rb, r.qb))
    return out


def mark_primary(opt: MemOptions, regions: list[Region]) -> list[Region]:
    """mem_mark_primary_se: score-desc sort, mark query-overlap
    secondaries, accumulate sub / sub_n for MAPQ."""
    if not regions:
        return regions
    for r in regions:
        r.sub = 0
        r.sub_n = 0
        r.secondary = -1
    regions = sorted(regions, key=lambda r: (-r.score, r.qb, r.rb))
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    kept: list[int] = []
    for i, p in enumerate(regions):
        placed = False
        for k in kept:
            q = regions[k]
            b_max = max(q.qb, p.qb)
            e_min = min(q.qe, p.qe)
            if e_min > b_max:
                min_l = min(p.qe - p.qb, q.qe - q.qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if q.sub == 0:
                        q.sub = p.score
                    if q.score - p.score <= tmp:
                        q.sub_n += 1
                    p.secondary = k
                    placed = True
                    break
        if not placed:
            kept.append(i)
    return regions


def approx_mapq_se(opt: MemOptions, a: Region) -> int:
    """mem_approx_mapq_se (bwa-0.7.8)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - float(l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapq_coef_len > 0:
        tmp = 1.0 if l < opt.mapq_coef_len else opt.mapq_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(30.0 * (1.0 - float(sub) / a.score)
                   * math.log(a.seedcov) + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    return max(0, min(mapq, 60))


@dataclasses.dataclass
class Alignment:
    """mem_aln_t: final per-record fields."""

    rid: int = -1
    pos: int = -1          # 0-based contig position
    is_rev: bool = False
    flag: int = 0
    mapq: int = 0
    cigar: list = dataclasses.field(default_factory=list)
    score: int = 0
    sub: int = -1
    nm: int = -1
    md: str = ""


def _gen_cigar_setup(opt: MemOptions, ref: Reference, read: np.ndarray,
                     ar: Region):
    """Segment extraction + initial band for the global realignment
    (bwa_gen_cigar2 preamble).  Returns (qseg, rseg, w2); w2 is None
    for the no-gap fast path."""
    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins))
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    # reference segment; reverse both for rev-strand hits so indels stay
    # leftmost on the forward strand (bwa_gen_cigar2)
    qseg = read[qb:qe].copy()
    rseg = ref.get_seq(rb, re)
    if rb >= ref.l_pac:
        qseg = qseg[::-1].copy()
        rseg = rseg[::-1].copy()
    if qe - qb == re - rb and w2 == 0:
        return qseg, rseg, None
    return qseg, rseg, w2


def reg2aln(opt: MemOptions, ref: Reference, read: np.ndarray,
            ar: Region) -> Alignment:
    """mem_reg2aln: global re-alignment for CIGAR, clipping, position."""
    a = Alignment()
    l_query = len(read)
    if ar.rb < 0 or ar.re < 0:
        a.flag |= 0x4
        return a
    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    qseg, rseg, w2 = _gen_cigar_setup(opt, ref, read, ar)
    if w2 is None:
        # bwa_gen_cigar2's no-gap fast path: straight match block,
        # score summed directly from the matrix
        mat = opt.mat
        score = int(mat[rseg, qseg].sum())
        cigar = [(M_OP, qe - qb)]
    else:
        last_sc = -(1 << 30)
        i = 0
        while True:
            w2 = min(w2, opt.w << 2)
            score, cigar = ksw_global(qseg, rseg, opt.mat, opt.o_del,
                                      opt.e_del, opt.o_ins, opt.e_ins, w2)
            if score == last_sc or w2 == opt.w << 2:
                break
            last_sc = score
            w2 <<= 1
            i += 1
            if not (i < 3 and score < ar.truesc - opt.a):
                break
    a.nm, a.md = compute_nm_md(qseg, rseg, cigar)
    pos2, is_rev = ref.depos(rb if rb < ref.l_pac else re - 1)
    a.is_rev = is_rev
    if is_rev:
        a.flag |= 0x10
    # squeeze out a leading OR trailing deletion — bwa-0.7.8's
    # mem_reg2aln uses an else-if, so a (band-forced, rare) CIGAR of
    # the form [D, ..., D] keeps its trailing D (PARITY.md §Deviations)
    if cigar and cigar[0][0] == D_OP:
        pos2 += cigar[0][1]
        cigar = cigar[1:]
    elif cigar and cigar[-1][0] == D_OP:
        cigar = cigar[:-1]
    # soft clips
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(S_OP, clip5)] + cigar
        if clip3:
            cigar = cigar + [(S_OP, clip3)]
    a.cigar = cigar
    a.rid = ref.pos2rid(pos2)
    # discard alignments bridging two contigs of the concatenated
    # reference (bwa drops these junction artifacts)
    span = cigar_ref_len(cigar)
    if a.rid < 0 or (span > 0
                     and ref.pos2rid(pos2 + span - 1) != a.rid):
        a.rid = -1
        a.flag |= 0x4
        return a
    a.pos = pos2 - ref.contigs[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    return a


def revcomp_read(read: np.ndarray) -> np.ndarray:
    rc = read[::-1].copy()
    acgt = rc < 4
    rc[acgt] = 3 - rc[acgt]
    return rc


def aln2sam(opt: MemOptions, ref: Reference, name: str, read: np.ndarray,
            qual: str | None, a: Alignment,
            mate: Alignment | None = None, which: int = 0) -> SamRecord:
    """mem_aln2sam.  `mate` set => paired output (flags 0x1/0x40/0x80,
    RNEXT/PNEXT/TLEN); `which` is 0 for read1, 1 for read2."""
    flag = a.flag
    if opt.flag_M and (flag & 0x800):
        flag = (flag & ~0x800) | 0x100
    if mate is not None:
        flag |= 0x1 | (0x40 if which == 0 else 0x80)
        if mate.rid < 0 or mate.flag & 0x4:
            flag |= 0x8
        elif mate.is_rev:
            flag |= 0x20
    if a.rid < 0 or flag & 0x4:
        flag = (flag | 0x4) & ~(0x10 | 0x100 | 0x800)
        rec = SamRecord(qname=name, flag=flag, rname="*", pos=0, mapq=0,
                        cigar="*", seq=decode_seq(read), qual=qual or "*")
        if mate is not None and mate.rid >= 0 and not (mate.flag & 0x4):
            # unmapped read in a pair is placed at its mate's coordinates
            rec.rname = ref.contigs[mate.rid].name
            rec.pos = mate.pos + 1
            rec.rnext = "="
            rec.pnext = mate.pos + 1
            if mate.is_rev:
                rec.flag |= 0x20
        return rec
    hard = bool(flag & 0x800)
    cigar = list(a.cigar)
    if hard:
        cigar = [(H_OP if op == S_OP else op, n) for op, n in cigar]
    if a.is_rev:
        out_read = revcomp_read(read)
        out_qual = qual[::-1] if qual else None
    else:
        out_read = read
        out_qual = qual
    if hard:
        clip5 = cigar[0][1] if cigar and cigar[0][0] == H_OP else 0
        clip3 = cigar[-1][1] if cigar and cigar[-1][0] == H_OP else 0
        out_read = out_read[clip5:len(out_read) - clip3]
        out_qual = (out_qual[clip5:len(out_qual) - clip3]
                    if out_qual else None)
    tags: list = [("NM", "i", a.nm), ("MD", "Z", a.md),
                  ("AS", "i", a.score)]
    if a.sub >= 0:
        tags.insert(2, ("XS", "i", a.sub))
    rec = SamRecord(
        qname=name, flag=flag, rname=ref.contigs[a.rid].name,
        pos=a.pos + 1, mapq=a.mapq, cigar=cigar_to_string(cigar),
        seq=decode_seq(out_read), qual=out_qual or "*", tags=tags)
    if mate is not None and mate.rid >= 0 and not (mate.flag & 0x4):
        rec.rnext = "=" if mate.rid == a.rid else ref.contigs[mate.rid].name
        rec.pnext = mate.pos + 1
        if mate.rid == a.rid and mate.cigar and cigar:
            p0 = a.pos + (cigar_ref_len(cigar) - 1 if a.is_rev else 0)
            p1 = mate.pos + (cigar_ref_len(mate.cigar) - 1
                             if mate.is_rev else 0)
            sign = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
            rec.tlen = -(p0 - p1 + sign)
    elif mate is not None and a.rid >= 0:
        # mate unmapped: it is placed at this read's coordinates
        rec.rnext = "="
        rec.pnext = a.pos + 1
    return rec


def compute_regions(opt: MemOptions, ref: Reference, read: np.ndarray,
                    extend_fn, chains: list[Chain]) -> list[Region]:
    """mem_align1_core: chains -> extended, deduped regions (primary
    marking is the caller's step — the PE path marks after mate rescue)."""
    regions: list[Region] = []
    for ci, c in enumerate(chains):
        chain2aln(opt, ref, read, c, regions, extend_fn=extend_fn,
                  chain_index=ci)
    return sort_and_dedup(opt, regions)


def align_read(opt: MemOptions, ref: Reference, name: str,
               read: np.ndarray, qual: str | None, extend_fn,
               chains: list[Chain]) -> list[SamRecord]:
    """Full single-end alignment of one read -> SAM records
    (mem_align1 + mem_reg2sam_se)."""
    regions = mark_primary(opt, compute_regions(opt, ref, read, extend_fn,
                                                chains))

    alns: list[Alignment] = []
    is_sec: list[bool] = []
    for p in regions:
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and not opt.flag_a:
            continue
        q = reg2aln(opt, ref, read, p)
        if p.secondary >= 0:
            q.sub = -1
        if alns and p.secondary < 0:  # supplementary
            q.flag |= 0x100 if opt.flag_M else 0x800
        if alns and q.mapq > alns[0].mapq:
            q.mapq = alns[0].mapq
        alns.append(q)
        is_sec.append(p.secondary >= 0)
    if not alns:
        return [aln2sam(opt, ref, name, read, qual,
                        Alignment(flag=0x4))]
    recs = [aln2sam(opt, ref, name, read, qual, a) for a in alns]
    # SA:Z (bwa mem_aln2sam, 0.7.6+): every non-secondary record of a
    # split read lists the OTHER non-secondary hits, cigars in
    # soft-clip form
    good = [j for j, a in enumerate(alns)
            if not is_sec[j] and a.rid >= 0 and a.cigar
            and not (a.flag & 0x4)]
    if len(good) > 1:
        for i, rec in enumerate(recs):
            if is_sec[i] or alns[i].rid < 0:
                continue
            parts = []
            for j in good:
                if j == i:
                    continue
                a = alns[j]
                sign = "-" if a.is_rev else "+"
                parts.append(
                    f"{ref.contigs[a.rid].name},{a.pos + 1},{sign},"
                    f"{cigar_to_string(a.cigar)},{a.mapq},{a.nm};")
            if parts:
                rec.tags.append(("SA", "Z", "".join(parts)))
    if not opt.flag_a:
        xa = xa_string(opt, ref, read, regions)
        if xa:
            recs[0].tags.append(("XA", "Z", xa))
    return recs


def xa_string(opt: MemOptions, ref: Reference, read: np.ndarray,
              regions: list[Region], cap: int = 5) -> str:
    """bwa's XA:Z tag: alternate hits (secondary regions) of the primary,
    as chr,±pos,CIGAR,NM; emitted when -a is off (mem_aln2sam XA path).
    bwa caps alternates at opt->max_XA_hits (5)."""
    alts = [p for p in regions if p.secondary == 0 and p.score >= opt.T]
    if not alts or len(alts) > cap:
        return ""
    parts = []
    for p in alts[:cap]:
        q = reg2aln(opt, ref, read, p)
        if q.rid < 0:
            continue
        sign = "-" if q.is_rev else "+"
        parts.append(f"{ref.contigs[q.rid].name},{sign}{q.pos + 1},"
                     f"{cigar_to_string(q.cigar)},{q.nm};")
    return "".join(parts)
