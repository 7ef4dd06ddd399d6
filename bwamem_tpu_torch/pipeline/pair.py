"""Paired-end machinery: insert-size inference, pair scoring, mate rescue.

bwa-0.7.8 `mem_pestat` / `mem_pair` / `mem_matesw` / `mem_sam_pe`
semantics.  The reference system inherits all of this from the stock bwa
host (the FPGA only sees single extension tasks); here it is host-side
logic over the batch's alignment regions, with mate rescue routed
through the same (batchable) extension kernel.

Orientations (bwa dir codes): 0=FF, 1=FR, 2=RF, 3=RR, computed from the
two-strand coordinates of the two ends.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.io.fasta import Reference
from bwamem_tpu_torch.pipeline.align import Region

MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclasses.dataclass
class PEStat:
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0
    failed: bool = True


def _infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """bwa mem_infer_dir: orientation code and distance of two two-strand
    coordinates.  b2 is projected onto read1's strand only when the
    strands differ; dir = (r1==r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3), so a
    both-forward pair with the mate upstream is RR (3), not FF."""
    r1 = 1 if b1 >= l_pac else 0
    r2 = 1 if b2 >= l_pac else 0
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


MIN_RATIO = 0.8


def explicit_pes(opt: MemOptions) -> list[PEStat] | None:
    """bwa mem -I: a user-specified FR insert-size distribution skips
    mem_pestat entirely.  Per bwa-0.7.8's documented formula: std
    defaults to 10% of the mean, high/low default to mean ± 4σ
    (+.499 rounding, low clamped to 1); FF/RF/RR stay failed."""
    if opt.pe_mean <= 0:
        return None
    mean = float(opt.pe_mean)
    std = float(opt.pe_std) if opt.pe_std > 0 else mean * 0.1
    high = (opt.pe_max if opt.pe_max > 0
            else int(mean + 4.0 * std + 0.499))
    low = (opt.pe_min if opt.pe_min > 0
           else int(mean - 4.0 * std + 0.499))
    low = max(low, 1)
    pes = [PEStat() for _ in range(4)]
    pes[1] = PEStat(low=low, high=high, avg=mean, std=std, failed=False)
    return pes


def cal_sub(opt: MemOptions, regs: list[Region]) -> int:
    """bwa cal_sub: score of the first region significantly overlapping
    the best region on the query (regs must be score-sorted), else
    min_seed_len * a."""
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def infer_isize(opt: MemOptions, l_pac: int,
                pairs: list[tuple[list[Region], list[Region]]],
                ) -> list[PEStat]:
    """mem_pestat: collect insert sizes of unique-best pairs per
    orientation, trim outliers by quartiles, fit mean/std.  Each element
    of `pairs` is the two ends' full score-sorted region lists (a[0] is
    the best hit; cal_sub scans the rest for the repeat filter)."""
    isize: list[list[int]] = [[], [], [], []]
    for r1, r2 in pairs:
        if not r1 or not r2:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if cal_sub(opt, r2) > MIN_RATIO * r2[0].score:
            continue
        d, dist = _infer_dir(l_pac, r1[0].rb, r2[0].rb)
        if 0 < dist <= opt.max_ins:
            isize[d].append(dist)
    stats = []
    for d in range(4):
        v = sorted(isize[d])
        st = PEStat()
        if len(v) < MIN_DIR_CNT:
            stats.append(st)
            continue
        p25 = v[int(0.25 * len(v) + 0.499)]
        p50 = v[int(0.50 * len(v) + 0.499)]
        p75 = v[int(0.75 * len(v) + 0.499)]
        st.low = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
        st.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        st.low = max(st.low, 1)
        trimmed = [x for x in v if st.low <= x <= st.high]
        if not trimmed:
            stats.append(st)
            continue
        st.avg = float(np.mean(trimmed))
        st.std = float(np.std(trimmed)) or 1.0
        st.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        st.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        st.low = min(st.low, int(st.avg - MAX_STDDEV * st.std + 0.499))
        st.high = max(st.high, int(st.avg + MAX_STDDEV * st.std + 0.499))
        st.low = max(st.low, 1)
        st.failed = False
        stats.append(st)
    # bwa: drop orientations with far fewer observations than the best
    counts = [len(x) for x in isize]
    cmax = max(counts) if counts else 0
    for d in range(4):
        if not stats[d].failed and counts[d] < cmax * MIN_DIR_RATIO:
            stats[d].failed = True
    return stats


def mem_pair(opt: MemOptions, l_pac: int, pes: list[PEStat],
             regs: tuple[list[Region], list[Region]],
             ) -> tuple[int, int, int, int, tuple[int, int] | None]:
    """bwa mem_pair: best properly-oriented pair of candidate regions.

    Returns (score, sub, n_sub, raw_pairs, (i1, i2)) where score is the
    paired score (sum + the Gaussian insert-size bonus), sub the
    second-best pair score, and (i1, i2) the winning region indices.
    """
    cands: list[tuple[int, int, int]] = []
    for i1, r1 in enumerate(regs[0]):
        for i2, r2 in enumerate(regs[1]):
            d, dist = _infer_dir(l_pac, r1.rb, r2.rb)
            if pes[d].failed or not (pes[d].low <= dist <= pes[d].high):
                continue
            ns = (dist - pes[d].avg) / pes[d].std
            # bwa: q = s1 + s2 + .721 * log(2*erfc(|ns|/sqrt(2))) * a
            q = (r1.score + r2.score
                 + int(0.721 * math.log(
                     2.0 * math.erfc(abs(ns) * (1.0 / math.sqrt(2.0))))
                     * opt.a + 0.499))
            cands.append((max(q, 0), i1, i2))
    if not cands:
        return 0, 0, 0, 0, None
    # bwa counts n_sub against the FINAL best within
    # max(a+b, o_del+e_del, o_ins+e_ins), and sub defaults to 0
    cands.sort()
    best = cands[-1]
    second = cands[-2][0] if len(cands) > 1 else 0
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    n_sub = sum(1 for q, _, _ in cands[:-1] if q >= best[0] - tmp)
    return best[0], second, n_sub, len(cands), (best[1], best[2])


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def sam_pe(opt: MemOptions, ref: Reference, pes: list[PEStat], name: str,
           reads, quals, regs2):
    """bwa mem_sam_pe: pair the two ends' regions and emit two SAM
    records (+ secondary records under -a)."""
    from bwamem_tpu_torch.pipeline import align as A

    a0 = A.mark_primary(opt, list(regs2[0]))
    a1 = A.mark_primary(opt, list(regs2[1]))
    regs = (a0, a1)
    extra_flag = 1

    def finish(z, q_se, extra_flag):
        h = []
        for i in (0, 1):
            if z[i] is not None:
                aln = A.reg2aln(opt, ref, reads[i], regs[i][z[i]])
                if q_se[i] is not None:
                    aln.mapq = q_se[i]
            else:
                aln = A.Alignment(flag=0x4)
            aln.flag |= extra_flag
            h.append(aln)
        recs = [
            A.aln2sam(opt, ref, name, reads[0], quals[0], h[0],
                      mate=h[1], which=0),
            A.aln2sam(opt, ref, name, reads[1], quals[1], h[1],
                      mate=h[0], which=1),
        ]
        if opt.flag_a:
            for i in (0, 1):
                for k, p in enumerate(regs[i]):
                    if k == (z[i] if z[i] is not None else -1):
                        continue
                    if p.secondary < 0 or p.score < opt.T:
                        continue
                    q = A.reg2aln(opt, ref, reads[i], p)
                    q.sub = -1
                    q.flag |= 0x100
                    recs.append(A.aln2sam(opt, ref, name, reads[i],
                                          quals[i], q,
                                          mate=h[1 - i], which=i))
        return recs

    # -P / MEM_F_NOPAIRING: bwa's `goto no_pairing` — skip straight to
    # the independent-ends emission below
    if a0 and a1 and not opt.skip_pairing:
        o, subo, n_sub, _, z = mem_pair(opt, ref.l_pac, pes, regs)
        if o > 0 and z is not None:
            # bail out if either end has an independent second hit
            is_multi = [
                any(p.secondary < 0 and p.score >= opt.T
                    for p in regs[i][1:])
                for i in (0, 1)
            ]
            if not (is_multi[0] or is_multi[1]):
                score_un = a0[0].score + a1[0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = max(0, min(q_pe, 60))
                if o > score_un:  # paired alignment preferred
                    c = [regs[0][z[0]], regs[1][z[1]]]
                    q_se = []
                    for i in (0, 1):
                        if c[i].secondary >= 0:
                            c[i].sub = regs[i][c[i].secondary].score
                            c[i].secondary = -2
                        q = A.approx_mapq_se(opt, c[i])
                        q = max(q, min(q_pe, q + 40))
                        q = min(q, raw_mapq(
                            c[i].score - c[i].csub, opt.a))
                        q_se.append(q)
                    return finish((z[0], z[1]), q_se, extra_flag | 2)
                q_se = [A.approx_mapq_se(opt, a0[0]),
                        A.approx_mapq_se(opt, a1[0])]
                return finish((0, 0), q_se, extra_flag)

    # no pairing: treat ends independently, but flag a coincidental
    # proper pair of the top hits
    z = [None, None]
    for i in (0, 1):
        if regs[i] and regs[i][0].score >= opt.T and \
                regs[i][0].secondary < 0:
            z[i] = 0
    if (z[0] is not None and z[1] is not None):
        d, dist = _infer_dir(ref.l_pac, regs[0][0].rb, regs[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    return finish(z, [None, None], extra_flag)


def align_pairs(opt: MemOptions, ref: Reference, fm, reads1, reads2,
                names=None, quals1=None, quals2=None,
                extend_fn=None, po=None, extend_batch_fn=None,
                native_pipe=None, raw_t_fn=None):
    """Full paired-end batch alignment (mem_process_seqs PE path):
    compute regions for all ends, infer the insert-size distribution
    from the batch, then pair and emit.  `po` switches to batched
    seeding; `extend_batch_fn` routes the two ends' extensions through
    the batched device driver (mate rescue stays host-side);
    `native_pipe` + `raw_t_fn` computes the regions through the C++
    host pipeline instead (identical output, pinned by
    tests/test_native_pipe.py)."""
    from bwamem_tpu_torch.pipeline import align as A

    n = len(reads1)
    if n == 0:
        return []   # a final empty chunk must not index all_chains[0]
    names = names or [f"pair{i}" for i in range(n)]
    quals1 = quals1 or [None] * n
    quals2 = quals2 or [None] * n
    all_reads = list(reads1) + list(reads2)
    if native_pipe is not None:
        all_regs = native_pipe.regions_chunk(all_reads, raw_t_fn)
        regs = [(all_regs[i], all_regs[n + i]) for i in range(n)]
    else:
        efn = extend_fn or A.default_extend_fn
        if po is not None:
            from bwamem_tpu_torch.pipeline.chain import chain_reads_batch

            all_chains = chain_reads_batch(fm, po, all_reads, opt)
        else:
            all_chains = [None] * (2 * n)
        if extend_batch_fn is not None:
            from bwamem_tpu_torch.pipeline.chain import chain_read
            from bwamem_tpu_torch.pipeline.driver import (
                extension_tables,
                table_extend_fn,
            )

            if all_chains[0] is None:
                all_chains = [chain_read(fm, r, opt) for r in all_reads]
            tables = extension_tables(opt, ref, all_reads, all_chains,
                                      extend_batch_fn)
            efns = [table_extend_fn(t) for t in tables]
        else:
            efns = [efn] * (2 * n)
        ch1, ch2 = all_chains[:n], all_chains[n:]
        regs = []
        for i, (r1, r2) in enumerate(zip(reads1, reads2)):
            regs.append((A.compute_regions(opt, ref, fm, r1, efns[i],
                                           chains=ch1[i]),
                         A.compute_regions(opt, ref, fm, r2, efns[n + i],
                                           chains=ch2[i])))
    pes = explicit_pes(opt) or infer_isize(opt, ref.l_pac, regs)
    out = []
    for i in range(n):
        if opt.max_matesw > 0:
            rescue_pairs(opt, ref, pes, (reads1[i], reads2[i]), regs[i])
        out.append(sam_pe(opt, ref, pes, names[i],
                          (reads1[i], reads2[i]),
                          (quals1[i], quals2[i]), regs[i]))
    return out


def mem_matesw(opt: MemOptions, ref: Reference, pes: list[PEStat],
               anchor: Region, mate_read: np.ndarray,
               mate_regs: list[Region]) -> int:
    """bwa mem_matesw: SW the mate read against the insert-size window
    around `anchor` for every orientation not yet covered by an existing
    mate region; appends rescued regions to mate_regs."""
    from bwamem_tpu_torch.ops.local_ref import ksw_align

    l_pac = ref.l_pac
    l_ms = len(mate_read)
    skip = [pes[r].failed for r in range(4)]
    for m in mate_regs:
        r, dist = _infer_dir(l_pac, anchor.rb, m.rb)
        if not pes[r].failed and pes[r].low <= dist <= pes[r].high:
            skip[r] = True
    if all(skip):
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = mate_read[::-1].copy()
            acgt = seq < 4
            seq[acgt] = 3 - seq[acgt]
        else:
            seq = mate_read
        if not is_rev:
            rb = anchor.rb + pes[r].low if is_larger else \
                anchor.rb - pes[r].high
            re = (anchor.rb + pes[r].high if is_larger else
                  anchor.rb - pes[r].low) + l_ms
        else:
            rb = (anchor.rb + pes[r].low if is_larger else
                  anchor.rb - pes[r].high) - l_ms
            re = anchor.rb + pes[r].high if is_larger else \
                anchor.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        # clamp to one strand (bns_fetch_seq centers on the anchor side)
        if rb < l_pac < re:
            if anchor.rb < l_pac:
                re = l_pac
            else:
                rb = l_pac
        if rb >= re:
            continue
        rseq = ref.get_seq(rb, re)
        score, qb, qe, tb, te, score2 = ksw_align(
            seq, rseq, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
        if score >= opt.min_seed_len * opt.a and qb >= 0:
            b = Region()
            if is_rev:
                b.qb = l_ms - qe
                b.qe = l_ms - qb
                b.rb = (l_pac << 1) - (rb + te)
                b.re = (l_pac << 1) - (rb + tb)
            else:
                b.qb, b.qe = qb, qe
                b.rb, b.re = rb + tb, rb + te
            b.score = b.truesc = score
            b.csub = score2
            b.secondary = -1
            b.w = opt.w
            b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
            mate_regs.append(b)
            n += 1
    return n


def rescue_pairs(opt: MemOptions, ref: Reference, pes: list[PEStat],
                 reads, regs2) -> None:
    """The mem_sam_pe rescue loop: for each end's near-best regions,
    try to rescue the other end (up to max_matesw anchors).

    BOTH ends' anchor lists are snapshotted BEFORE any matesw runs —
    exactly bwa-0.7.8's b[0]/b[1] kv_push loops in mem_sam_pe
    (bwamem_pair.c): a region rescued by end 0 never becomes an end-1
    anchor within the same pair.  (Round-2 snapshotted per end, a
    parity deviation; the up-front snapshot also makes the two ends'
    rescue chains independent, which the device rescue protocol's
    replay relies on.)"""
    anchors2 = []
    for i in (0, 1):
        regs_i = regs2[i]
        if not regs_i:
            anchors2.append([])
            continue
        best = max(r.score for r in regs_i)
        anchors2.append([r for r in regs_i
                         if r.score >= best - opt.pen_unpaired
                         ][:opt.max_matesw])
    for i in (0, 1):
        for a in anchors2[i]:
            mem_matesw(opt, ref, pes, a, reads[1 - i], regs2[1 - i])
