"""Batched extension driver: a copy of the port's Python host
(`bwamem_tpu_torch/pipeline/driver.py`, `mem --host python`) kept for
the reference aligner.

The host walks every read's chains, PLANS all extension tasks, runs two
batched phases (all left extensions, then all right extensions — a
seed's right h0 is its own left score, so there is no cross-seed
dependency), and then replays bwa's sequential mem_chain2aln control
flow against the precomputed result table.  Extension results are
bit-identical to the scalar path, so align_batch produces the same SAM
as align.align_read with the scalar extender.

The contained-seed skip (mem_chain2aln's "has this been extended
before" test) depends on earlier seeds' extension results, so the
batched path speculatively extends EVERY seed — wasted lanes are cheap,
serialized host<->device round trips are not.  Band doubling runs as
pass k=0 for all tasks plus pass k=1 consumed only where pass 0 did not
converge.

`extend_batch_fn(query, qlen, target, tlen, aw, h0)` takes numpy arrays
and returns per-lane results; here it is `aligner.make_extend_fn`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from .config import MemOptions
from .fasta import Reference
from . import align as A


class ExtendResult(NamedTuple):
    """One extension pass's outputs (bwa-0.7.8 ksw_extend2)."""

    score: int    # best local extension score (max over DP cells, seeded h0)
    qle: int      # query extension length at the best cell (max_j + 1)
    tle: int      # target extension length at the best cell (max_i + 1)
    gtle: int     # target length when the whole query is consumed (max_ie + 1)
    gscore: int   # best score reaching the end of the query (-1 if never)
    max_off: int  # max diagonal offset |j - i| seen at score improvements
    w_used: int   # band width actually used


def _plan_read(opt: MemOptions, ref: Reference, read: np.ndarray, chains):
    """Enumerate (key, query, target, h0|None, pen_clip) for every
    extension side, mirroring chain2aln's geometry exactly."""
    plans = []
    l_query = len(read)
    for ci, c in enumerate(chains):
        seeds = c.seeds
        rmax0, rmax1 = ref.l_pac << 1, 0
        for t in seeds:
            b = t.rbeg - (t.qbeg + A.cal_max_gap(opt, t.qbeg))
            e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                 + A.cal_max_gap(opt, l_query - t.qbeg - t.len))
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, ref.l_pac << 1)
        if rmax0 < ref.l_pac < rmax1:
            if seeds[0].rbeg < ref.l_pac:
                rmax1 = ref.l_pac
            else:
                rmax0 = ref.l_pac
        lo, hi = ref.contig_window(seeds[0].rbeg)
        rmax0 = max(rmax0, lo)
        rmax1 = min(rmax1, hi)
        rseq = ref.get_seq(rmax0, rmax1)
        for si, s in enumerate(seeds):
            if s.qbeg > 0:
                plans.append(((ci, si, "L"),
                              read[:s.qbeg][::-1],
                              rseq[:s.rbeg - rmax0][::-1],
                              s.len * opt.a, opt.pen_clip5))
            if s.qbeg + s.len != l_query:
                plans.append(((ci, si, "R"),
                              read[s.qbeg + s.len:],
                              rseq[s.rbeg + s.len - rmax0:],
                              None, opt.pen_clip3))
    return plans


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _bucket(n: int, buckets=(128, 160, 192, 256, 320, 384, 512, 640,
                             768, 1024, 1536, 2048, 3072, 4096)) -> int:
    """Smallest standard size >= n.  Fixed shape buckets keep the set of
    window shapes a run sees small; they are the JAX package's, so both
    packages pack the same batches (the sequence-axis buckets are finer
    than powers of two: 150 bp reads fall into 160, not 256)."""
    for b in buckets:
        if n <= b:
            return b
    return round_up(n, buckets[-1])


def _run_pass(opt, jobs, extend_batch_fn, k):
    """One kernel pass at attempted width opt.w<<k over a job list of
    (key, query, target, h0, pen_clip).  Returns the ExtendResults in
    job order.  Tasks are sorted by target length before packing, and
    the lane count follows the JAX package's ladder (512, 1024, ...)."""
    B = len(jobs)
    order = sorted(range(B), key=lambda i: -len(jobs[i][2]))
    qmax = _bucket(max(max((len(j[1]) for j in jobs), default=1), 1))
    tmax = _bucket(max(max((len(j[2]) for j in jobs), default=1), 1))
    Bp = _bucket(max(B, 512), (512, 1024, 2048, 4096, 8192, 16384))
    query = np.zeros((Bp, qmax), np.int32)
    target = np.zeros((Bp, tmax), np.int32)
    qlen = np.zeros(Bp, np.int32)
    tlen = np.zeros(Bp, np.int32)
    h0 = np.zeros(Bp, np.int32)
    max_ins = np.ones(Bp, np.int32)
    max_del = np.ones(Bp, np.int32)
    for slot, i in enumerate(order):
        key, q, t, h, pen = jobs[i]
        query[slot, :len(q)] = q
        target[slot, :len(t)] = t
        qlen[slot], tlen[slot], h0[slot] = len(q), len(t), h
        max_ins[slot] = A._max_gap_bound(opt, len(q), opt.o_ins,
                                         opt.e_ins, pen)
        max_del[slot] = A._max_gap_bound(opt, len(q), opt.o_del,
                                         opt.e_del, pen)
    aw = np.minimum(np.minimum(opt.w << k, max_ins),
                    max_del).astype(np.int32)
    res = extend_batch_fn(query, qlen, target, tlen, aw, h0)
    arr = {f: np.asarray(getattr(res, f)) for f in
           ("score", "qle", "tle", "gtle", "gscore", "max_off")}
    out: list[ExtendResult | None] = [None] * B
    for slot, i in enumerate(order):
        out[i] = ExtendResult(
            score=int(arr["score"][slot]), qle=int(arr["qle"][slot]),
            tle=int(arr["tle"][slot]), gtle=int(arr["gtle"][slot]),
            gscore=int(arr["gscore"][slot]),
            max_off=int(arr["max_off"][slot]), w_used=int(aw[slot]))
    return out


def _device_extend(opt: MemOptions, jobs, extend_batch_fn):
    """Batch one list of (key, query, target, h0, pen_clip) through the
    device kernel: pass k=0 for everything, then pass k=1 COMPACTED to
    the tasks whose pass-0 result did not converge (the FPGA re-runs
    internally, sw_extend.v:1963; we re-batch — most tasks converge, so
    the retry batch is a small fraction).
    Returns {key: {attempted_w: ExtendResult}}."""
    if not jobs:
        return {}
    out = {}
    res0 = _run_pass(opt, jobs, extend_batch_fn, 0)
    aw0 = opt.w
    retry = []
    for j, r0 in zip(jobs, res0):
        out[j[0]] = {aw0: r0}
        # a task needs pass 1 iff the bwa convergence test can fail for
        # it under ANY caller prev_score: score==prev may still hold, so
        # retry when the max_off test alone does not prove convergence
        if not (r0.max_off < (aw0 >> 1) + (aw0 >> 2)):
            retry.append(j)
    if retry:
        res1 = _run_pass(opt, retry, extend_batch_fn, 1)
        for j, r1 in zip(retry, res1):
            out[j[0]][opt.w << 1] = r1
    # converged tasks reuse their pass-0 result as the "pass 1" entry
    # (never consulted by _resolve, but keeps the table total)
    for j, r0 in zip(jobs, res0):
        out[j[0]].setdefault(opt.w << 1, r0)
    return out


def _resolve(opt: MemOptions, per_w, prev_score):
    """Replay the band-doubling convergence on precomputed pass results."""
    prev = prev_score
    res = None
    for k in (0, 1):
        aw = opt.w << k
        res = per_w[aw]
        if res.score == prev or res.max_off < (aw >> 1) + (aw >> 2):
            break
        prev = res.score
    return res


def extension_tables(opt: MemOptions, ref: Reference, reads, all_chains,
                     extend_batch_fn: Callable):
    """Plan + two batched device phases for a list of reads; returns
    per-read result tables consumed by the chain2aln replay."""
    all_plans = [_plan_read(opt, ref, r, ch)
                 for r, ch in zip(reads, all_chains)]

    # phase L
    left_jobs = [((ri,) + key, q, t, h, pen)
                 for ri, plans in enumerate(all_plans)
                 for key, q, t, h, pen in plans if key[2] == "L"]
    table = _device_extend(opt, left_jobs, extend_batch_fn)

    # phase R: h0 chained from the resolved left score of the same seed
    right_jobs = []
    for ri, plans in enumerate(all_plans):
        for key, q, t, h, pen in plans:
            if key[2] != "R":
                continue
            ci, si, _ = key
            s = all_chains[ri][ci].seeds[si]
            if s.qbeg > 0:
                sc0 = _resolve(opt, table[(ri, ci, si, "L")], -1).score
            else:
                sc0 = s.len * opt.a
            right_jobs.append(((ri,) + key, q, t, sc0, pen))
    table.update(_device_extend(opt, right_jobs, extend_batch_fn))
    tables = [dict() for _ in reads]
    for k, v in table.items():
        tables[k[0]][k[1:]] = v
    return tables


def table_extend_fn(local):
    def extend_fn(key, query, target, w_attempt, h0, max_ins, max_del, o):
        return local[key][w_attempt]
    return extend_fn
