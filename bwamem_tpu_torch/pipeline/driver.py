"""The Python host's batched extension, with no JAX: the counterpart of
bwamem_tpu/pipeline/driver.py:95-276 (`_run_pass`, `_device_extend`,
`extension_tables`, `align_batch`).

The host plans every extension task of a chunk, runs two batched
phases (all left extensions, then all right extensions seeded with the
resolved left score), each as pass k=0 plus a compacted k=1 retry, and
replays bwa's mem_chain2aln control flow against the result table.  The
reference module's helpers are JAX-free and reused as they are
(`_plan_read`, `_bucket`, `_resolve`, `table_extend_fn`); its
`_run_pass` wraps the batch in `jnp.asarray`, so it and everything that
calls it are ported here, taking numpy instead.

`extend_batch_fn(query, qlen, target, tlen, aw, h0) -> ExtendOut` is
typically `ops.extend.make_raw_backend(params, device)`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from bwamem_tpu.config import MemOptions
from bwamem_tpu.io.fasta import Reference
from bwamem_tpu.io.sam import SamRecord
from bwamem_tpu.ops.extend_ref import ExtendResult
from bwamem_tpu.pipeline import align as A
from bwamem_tpu.pipeline.chain import chain_read
from bwamem_tpu.pipeline.driver import (
    _bucket,
    _plan_read,
    _resolve,
    table_extend_fn,
)


def _run_pass(opt, jobs, extend_batch_fn, k):
    """One kernel pass at attempted width opt.w<<k over a job list of
    (key, query, target, h0, pen_clip).  Returns the ExtendResults in
    job order.  Tasks are sorted by target length before packing, and
    the lane count follows the reference's ladder (512, 1024, ...)."""
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
    """Pass k=0 for every job, then pass k=1 compacted to the jobs whose
    pass-0 result does not prove convergence by max_off alone.
    Returns {key: {attempted_w: ExtendResult}}; converged jobs reuse
    their pass-0 result as the (never consulted) pass-1 entry."""
    if not jobs:
        return {}
    out = {}
    res0 = _run_pass(opt, jobs, extend_batch_fn, 0)
    aw0 = opt.w
    retry = []
    for j, r0 in zip(jobs, res0):
        out[j[0]] = {aw0: r0}
        if not (r0.max_off < (aw0 >> 1) + (aw0 >> 2)):
            retry.append(j)
    if retry:
        res1 = _run_pass(opt, retry, extend_batch_fn, 1)
        for j, r1 in zip(retry, res1):
            out[j[0]][opt.w << 1] = r1
    for j, r0 in zip(jobs, res0):
        out[j[0]].setdefault(opt.w << 1, r0)
    return out


def extension_tables(opt: MemOptions, ref: Reference, reads, all_chains,
                     extend_batch_fn: Callable):
    """Plan + two batched extension phases for a list of reads; returns
    per-read result tables consumed by the chain2aln replay."""
    all_plans = [_plan_read(opt, ref, r, ch)
                 for r, ch in zip(reads, all_chains)]
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


def chains_of(opt: MemOptions, fm, reads, po=None):
    """Every read's chains: batched (native when available) seeding with
    `po` (index.occ_packed.pack_occ), else read by read."""
    if po is not None:
        from bwamem_tpu.pipeline.chain import chain_reads_batch

        return chain_reads_batch(fm, po, reads, opt)
    return [chain_read(fm, r, opt) for r in reads]


def align_batch(opt: MemOptions, ref: Reference, fm, reads,
                extend_batch_fn: Callable, names=None, quals=None,
                po=None, device_cigar: bool = False
                ) -> list[list[SamRecord]]:
    """Align a batch of reads with batched extension; SAM records equal
    to bwamem_tpu.pipeline.driver.align_batch's.  `device_cigar` is not
    ported (ROADMAP Queue 1 item 8, slice 4) and raises."""
    if device_cigar:
        raise NotImplementedError(
            "device_cigar is not ported: ROADMAP Queue 1 item 8 (slice 4)")
    names = names or [f"read{i}" for i in range(len(reads))]
    quals = quals or [None] * len(reads)
    all_chains = chains_of(opt, fm, reads, po)
    tables = extension_tables(opt, ref, reads, all_chains, extend_batch_fn)
    return [A.align_read(opt, ref, fm, names[ri], read, quals[ri],
                         extend_fn=table_extend_fn(tables[ri]),
                         chains=chains)
            for ri, (read, chains) in enumerate(zip(reads, all_chains))]
