"""Batched SMEM search: bwt_smem1 vectorized across a batch of reads.

The FM-index backward search is a chain of dependent rank queries — the
classic seeding bottleneck (SURVEY.md §7 "hard parts").  The reference
sidesteps it with host threads; we batch it: every read advances through
the same forward/backward phase structure in lockstep, each phase doing
one `rank4` row-gather + SWAR popcount over the whole batch
(index/occ_packed.py).  Control flow (interval pushes, stop conditions,
containment-filtered emission) runs as masked vector updates; the inner
scan over a read's live interval list is a short Python loop over the
interval slot axis (bounded by P_CAP) with (B,)-vectorized bodies.

Reads whose live-interval list overflows P_CAP (pathologically
repetitive) fall back to the scalar smem1 — output is EXACTLY
equal to the scalar path for every read, verified by fuzzing.
"""

from __future__ import annotations

import numpy as np

from .fmbuild import FMIndex
from .fmindex import BiInterval, smem1
from .occ_packed import PackedOcc, extend_backward4

P_CAP = 24   # live-interval slots per read (bwa's prev/curr vectors)
M_CAP = 64   # emitted SMEMs per smem1 call


def smem1_batch(po: PackedOcc, fm: FMIndex, reads: np.ndarray,
                qlen: np.ndarray, x: np.ndarray,
                min_intv: np.ndarray) -> tuple[np.ndarray, list]:
    """Batched bwt_smem1 at per-read positions x.

    reads: (B, L) int codes (pad with 4); qlen, x, min_intv: (B,).
    Returns (next_x (B,), mems: list of per-read lists of BiInterval).
    Reads with x >= qlen or q[x] > 3 return next_x = x + 1 and no mems.
    """
    B, L = reads.shape
    q = reads
    startable = (x < qlen) & (q[np.arange(B), np.minimum(x, L - 1)] < 4)
    ret = x + 1

    # --- forward pass ---
    # state: current bi-interval + qe; push list fcur
    cx0 = np.zeros(B, np.int64)
    cx1 = np.zeros(B, np.int64)
    cs = np.zeros(B, np.int64)
    cqe = np.zeros(B, np.int64)
    c0 = q[np.arange(B), np.minimum(x, L - 1)].astype(np.int64)
    c0 = np.where(startable, c0, 0)
    C = po.C
    cx0 = np.where(startable, C[c0], 0)
    cs = np.where(startable, C[c0 + 1] - C[c0], 0)
    cx1 = np.where(startable, C[3 - c0], 0)
    cqe = x + 1
    f_x0 = np.zeros((B, P_CAP), np.int64)
    f_x1 = np.zeros((B, P_CAP), np.int64)
    f_s = np.zeros((B, P_CAP), np.int64)
    f_qe = np.zeros((B, P_CAP), np.int64)
    f_n = np.zeros(B, np.int64)
    active = startable.copy()
    overflow = np.zeros(B, bool)

    def fpush(mask):
        rows = np.nonzero(mask)[0]
        if len(rows) == 0:
            return
        slots = f_n[rows]
        ok = slots < P_CAP
        overflow[rows[~ok]] = True
        rows = rows[ok]
        slots = slots[ok]
        f_x0[rows, slots] = cx0[rows]
        f_x1[rows, slots] = cx1[rows]
        f_s[rows, slots] = cs[rows]
        f_qe[rows, slots] = cqe[rows]
        f_n[rows] += 1

    for t in range(1, L + 1):
        if not active.any():
            break
        i = x + t
        at_end = active & (i >= qlen)
        in_seq = active & ~at_end
        ch = q[np.arange(B), np.minimum(i, L - 1)].astype(np.int64)
        amb = in_seq & (ch > 3)
        # push current & stop for reads at the end or at an N
        fpush(at_end | amb)
        active = active & ~(at_end | amb)
        ext = in_seq & ~amb & active
        if ext.any():
            nx0, nx1, ns = extend_backward4(po, cx1, cx0, cs)  # fwd via swap
            # forward ext by ch == backward ext of revcomp by 3-ch
            cc = 3 - ch
            ex1 = nx0[np.arange(B), cc]     # swapped back
            ex0 = nx1[np.arange(B), cc]
            es = ns[np.arange(B), cc]
            changed = ext & (es != cs)
            fpush(changed)
            too_small = changed & (es < min_intv)
            active = active & ~too_small
            upd = ext & ~too_small
            cx0 = np.where(upd, ex0, cx0)
            cx1 = np.where(upd, ex1, cx1)
            cs = np.where(upd, es, cs)
            cqe = np.where(upd, i + 1, cqe)
    fpush(active)  # reached i == len
    # return value: qe of the longest (last-pushed) interval
    has = startable & (f_n > 0)
    last = np.maximum(f_n - 1, 0)
    ret = np.where(has, f_qe[np.arange(B), last], ret)

    # --- backward pass (prev = reversed fcur: longest first) ---
    p_x0 = np.zeros((B, P_CAP), np.int64)
    p_x1 = np.zeros((B, P_CAP), np.int64)
    p_s = np.zeros((B, P_CAP), np.int64)
    p_qe = np.zeros((B, P_CAP), np.int64)
    p_n = f_n.copy()
    for b in range(B):          # small reversal copy (host-side packing)
        n = int(f_n[b])
        if n:
            p_x0[b, :n] = f_x0[b, :n][::-1]
            p_x1[b, :n] = f_x1[b, :n][::-1]
            p_s[b, :n] = f_s[b, :n][::-1]
            p_qe[b, :n] = f_qe[b, :n][::-1]

    m_qb = np.zeros((B, M_CAP), np.int64)
    m_qe = np.zeros((B, M_CAP), np.int64)
    m_x0 = np.zeros((B, M_CAP), np.int64)
    m_x1 = np.zeros((B, M_CAP), np.int64)
    m_s = np.zeros((B, M_CAP), np.int64)
    m_n = np.zeros(B, np.int64)
    back_active = startable & (p_n > 0)

    tmax_back = int(x.max(initial=0)) + 1 if B else 0
    for t in range(1, tmax_back + 2):
        if not back_active.any():
            break
        i = x - t
        live = back_active & (i >= -1)
        ch = np.where(i >= 0, q[np.arange(B), np.maximum(i, 0)], 4)
        cvalid = live & (i >= 0) & (ch < 4)
        # batched extension of ALL prev slots by the read's char
        nx0, nx1, ns = extend_backward4(po, p_x0, p_x1, p_s)
        chc = np.clip(ch, 0, 3).astype(np.int64)
        bI = np.arange(B)[:, None]
        sel_x0 = nx0[bI, np.arange(P_CAP)[None, :], chc[:, None]]
        sel_x1 = nx1[bI, np.arange(P_CAP)[None, :], chc[:, None]]
        sel_s = ns[bI, np.arange(P_CAP)[None, :], chc[:, None]]
        # sequential scan over slots (short python loop, vector body)
        n_x0 = np.zeros_like(p_x0)
        n_x1 = np.zeros_like(p_x1)
        n_s = np.zeros_like(p_s)
        n_qe = np.zeros_like(p_qe)
        n_cnt = np.zeros(B, np.int64)
        last_pushed_s = np.full(B, -1, np.int64)
        maxP = int(p_n.max(initial=0))
        for j in range(maxP):
            has_j = live & (j < p_n)
            stop_j = has_j & (~cvalid | (sel_s[:, j] < min_intv))
            keep_j = has_j & ~stop_j
            # emission: stopping slot with no pushes yet this round
            emit = stop_j & (n_cnt == 0)
            emit &= (m_n == 0) | (i + 1 < m_qb[np.arange(B),
                                               np.maximum(m_n - 1, 0)])
            rows = np.nonzero(emit & (m_n < M_CAP))[0]
            if len(rows):
                sl = m_n[rows]
                m_qb[rows, sl] = i[rows] + 1
                m_qe[rows, sl] = p_qe[rows, j]
                m_x0[rows, sl] = p_x0[rows, j]
                m_x1[rows, sl] = p_x1[rows, j]
                m_s[rows, sl] = p_s[rows, j]
                m_n[rows] += 1
            # push: kept slot whose extended size differs from last pushed
            push = keep_j & ((n_cnt == 0) | (sel_s[:, j] != last_pushed_s))
            rows = np.nonzero(push)[0]
            if len(rows):
                sl = n_cnt[rows]
                n_x0[rows, sl] = sel_x0[rows, j]
                n_x1[rows, sl] = sel_x1[rows, j]
                n_s[rows, sl] = sel_s[rows, j]
                n_qe[rows, sl] = p_qe[rows, j]
                n_cnt[rows] += 1
                last_pushed_s[rows] = sel_s[rows, j]
        p_x0, p_x1, p_s, p_qe = n_x0, n_x1, n_s, n_qe
        p_n = n_cnt
        back_active = back_active & (p_n > 0)

    # --- assemble per-read results (scalar fallback on overflow) ---
    out: list[list[BiInterval]] = []
    next_x = ret.copy()
    for b in range(B):
        if not startable[b]:
            out.append([])
            next_x[b] = x[b] + 1
            continue
        if overflow[b] or m_n[b] >= M_CAP:
            nx, mems = smem1(fm, q[b, :qlen[b]], int(x[b]),
                             int(min_intv[b]))
            out.append(mems)
            next_x[b] = nx
            continue
        mems = [
            BiInterval(x0=int(m_x0[b, k]), x1=int(m_x1[b, k]),
                       s=int(m_s[b, k]), qb=int(m_qb[b, k]),
                       qe=int(m_qe[b, k]))
            for k in range(int(m_n[b]))
        ]
        mems.reverse()
        out.append(mems)
    return next_x, out


def collect_smems_batch(po: PackedOcc, fm: FMIndex, reads: list[np.ndarray],
                        min_seed_len: int, split_len: int, split_width: int,
                        ) -> list[list[BiInterval]]:
    """Batched bwa-0.7.8 mem_collect_intv across a batch of reads:
    first-round SMEMs and the re-seeding of long low-occurrence SMEMs
    from their middle base."""
    B = len(reads)
    L = max((len(r) for r in reads), default=1)
    q = np.full((B, L), 4, np.int64)
    qlen = np.zeros(B, np.int64)
    for b, r in enumerate(reads):
        q[b, :len(r)] = r
        qlen[b] = len(r)

    mems: list[list[BiInterval]] = [[] for _ in range(B)]
    x = np.zeros(B, np.int64)
    while True:
        todo = x < qlen
        if not todo.any():
            break
        # skip N positions (vector)
        at = q[np.arange(B), np.minimum(x, L - 1)]
        skip = todo & (at > 3)
        x = np.where(skip, x + 1, x)
        run = todo & ~skip
        if not run.any():
            continue
        # only the still-active rows ride the batch (later rounds have few)
        rows = np.nonzero(run)[0]
        nx, got = smem1_batch(po, fm, q[rows], qlen[rows], x[rows],
                              np.ones(len(rows), np.int64))
        for k, b in enumerate(rows):
            mems[b].extend(m for m in got[k] if m.qlen >= min_seed_len)
        x[rows] = nx

    # second round: re-seed long low-occ SMEMs from their middle
    jobs = []
    for b in range(B):
        for p in mems[b]:
            if p.qlen >= split_len and p.s <= split_width:
                jobs.append((b, (p.qb + p.qe) // 2, p.s + 1))
    for j0 in range(0, len(jobs), B):
        chunk = jobs[j0:j0 + B]
        rows = np.array([c[0] for c in chunk])
        sub_q = q[rows]
        sub_qlen = qlen[rows]
        sub_x = np.array([c[1] for c in chunk], np.int64)
        sub_mi = np.array([c[2] for c in chunk], np.int64)
        _, got = smem1_batch(po, fm, sub_q, sub_qlen, sub_x, sub_mi)
        for k, (b, _, _) in enumerate(chunk):
            mems[b].extend(m for m in got[k] if m.qlen >= min_seed_len)

    for b in range(B):
        mems[b].sort(key=lambda m: (m.qb, m.qe))
    return mems
