"""Local Smith-Waterman with start+end coordinates (bwa's ksw_align).

Used by mate rescue (mem_matesw): align the unplaced mate against the
insert-size window around its anchor.  Numpy, one target row at a time,
the query axis vectorised (the F recurrence as a prefix maximum).

Returns (score, qb, qe, tb, te, score2):
  [qb, qe) x [tb, te) the best local alignment; score2 the best score
  at a target end-position further than half the query length from te
  (the KSW_XSUBO second-best used for b.csub).
"""

from __future__ import annotations

import numpy as np


def _forward_local(query, target, mat, o_del, e_del, o_ins, e_ins):
    """Row-vectorized local SW; returns (H_best, te, qe, end_scores) where
    end_scores[i] = best cell score in target row i."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = np.zeros(qlen + 1, np.int64)
    E = np.zeros(qlen + 1, np.int64)
    best, bi, bj = 0, -1, -1
    row_best = np.zeros(tlen, np.int64)
    for i in range(tlen):
        s = mat[target[i], query]
        # M from previous row's H (diag)
        M = H[:-1] + s
        # E(i, j) available in E; F via prefix recurrence
        Hdiag = np.maximum(M, E[1:])
        Hdiag = np.maximum(Hdiag, 0)
        # F(j+1) = max(F(j) - e_ins, H(j) - oe_ins, 0) opens from the
        # pre-F Hdiag (max(Hdiag, F) - oe_ins <= max(F - e_ins,
        # Hdiag - oe_ins) since oe_ins >= e_ins), so F is a running
        # prefix maximum of Hdiag(j') - oe_ins - e_ins*(j-1-j')
        jj = np.arange(qlen, dtype=np.int64)
        run = np.maximum.accumulate(Hdiag - oe_ins + e_ins * jj)
        F = np.zeros(qlen, np.int64)
        F[1:] = np.maximum(run[:-1] - e_ins * jj[:-1], 0)
        newH = np.empty(qlen + 1, np.int64)
        newH[0] = 0
        newH[1:] = np.maximum(Hdiag, F)
        E[1:] = np.maximum(E[1:] - e_del, newH[1:] - oe_del)
        E[1:] = np.maximum(E[1:], 0)
        H = newH
        rb = int(H.max())
        row_best[i] = rb
        if rb > best:
            best = rb
            bi = i
            bj = int(H.argmax()) - 1
    return best, bi, bj, row_best


def ksw_align(query, target, mat, o_del, e_del, o_ins, e_ins
              ) -> tuple[int, int, int, int, int, int]:
    query = np.asarray(query)
    target = np.asarray(target)
    if len(query) == 0 or len(target) == 0:
        return 0, -1, -1, -1, -1, 0
    score, te_i, qe_j, row_best = _forward_local(
        query, target, mat, o_del, e_del, o_ins, e_ins)
    if score <= 0:
        return 0, -1, -1, -1, -1, 0
    qe, te = qe_j + 1, te_i + 1
    # start positions: re-run on reversed prefixes
    s2, ti2, qj2, _ = _forward_local(
        query[:qe][::-1], target[:te][::-1], mat, o_del, e_del, o_ins, e_ins)
    qb = qe - (qj2 + 1)
    tb = te - (ti2 + 1)
    # second-best: best row score at least half a query length away from te
    half = max(len(query) // 2, 1)
    mask = np.abs(np.arange(len(target)) - te_i) >= half
    score2 = int(row_best[mask].max()) if mask.any() else 0
    return int(score), int(qb), int(qe), int(tb), int(te), score2
