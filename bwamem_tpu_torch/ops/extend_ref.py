"""Scalar golden reference of the banded affine-gap seed extension.

This is the exact algorithm the reference FPGA implements in
`sw_pe_array_sw_extend.v` (bwa-0.7.8 `ksw_extend2`
semantics; see SURVEY.md §2.5 for the line-by-line decode):

  * banded DP over (target rows i, query columns j) with adaptive band
    [beg, end) per row (band clamp: sw_extend.v:1894-1895, 1777-1778),
  * affine gaps with separate insertion/deletion penalties,
  * the M/H split ("M = H(i-1,j-1) ? H(i-1,j-1)+s : 0") that disallows
    adjacent-indel CIGARs (zero-cell guard at sw_extend.v:1797,1818-1821),
  * E/F updates driven by M, not H (sw_extend.v:1770-1771, 1780-1781),
  * first-row/first-column initialisation from h0
    (sw_extend.v:1979, 1974, 1796),
  * row-max==0 early break (sw_extend.v:1942),
  * zero-run band trimming between rows (sw_extend.v:1766-1769, 1782-1790),
  * gscore / max_ie tracking at the j==qlen boundary (sw_extend.v:1791,
    1829-1833),
  * max_off = max |mj - i| tracking (sw_extend.v:1707-1708),
  * optional Z-dropoff (bwa-0.7.8 has it; the FPGA omits it — pass
    zdrop=0 to reproduce the hardware exactly),
  * the band-doubling retry loop k=0,1 with the bwa convergence test
    `score == prev || max_off < (w>>1)+(w>>2)`, which the FPGA moved
    inside the kernel (sw_extend.v:1765, 1963, 1878, 1969-1970).

Everything downstream (the JAX twin, the Pallas kernel) is fuzz-tested
against this file.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ExtendResult(NamedTuple):
    """The 7 return values of sw_extend (ap_return_0..6 mapping proven in
    SURVEY.md §2.5 via proc_element usage)."""

    score: int    # best local extension score (max over DP cells, seeded h0)
    qle: int      # query extension length at the best cell (max_j + 1)
    tle: int      # target extension length at the best cell (max_i + 1)
    gtle: int     # target length when the whole query is consumed (max_ie + 1)
    gscore: int   # best score reaching the end of the query (-1 if never)
    max_off: int  # max diagonal offset |j - i| seen at score improvements
    w_used: int   # band width actually used (after doubling/clamping)


def ksw_extend_core(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    h0: int,
    zdrop: int = 0,
) -> ExtendResult:
    """One banded extension pass at fixed band width `w` (no doubling).

    query/target: int arrays of base codes (0..4); mat: (m,m) int matrix.
    """
    qlen, tlen = len(query), len(target)
    assert qlen > 0 and h0 > 0
    m = mat.shape[0]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    # query profile: qp[c][j] = mat[c, query[j]]
    qp = mat[:, query].astype(np.int64)  # (m, qlen)

    eh_h = np.zeros(qlen + 2, dtype=np.int64)  # H diag storage (eh[j].h)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)  # E storage (eh[j].e)

    # First (virtual) row: eh[0].h = h0; eh[1].h = max(h0-oe_ins, 0);
    # then decreasing by e_ins while positive.
    eh_h[0] = h0
    eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > e_ins:
        eh_h[j] = eh_h[j - 1] - e_ins
        j += 1

    max_score = h0
    max_i = -1
    max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    beg, end = 0, qlen

    for i in range(tlen):
        f = 0
        row_max = 0
        mj = -1
        q = qp[target[i]]
        # band clamp
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        # first column of this row
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            # eh[j] holds { H(i-1,j-1), E(i,j) }; f = F(i,j); h1 = H(i,j-1)
            M = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1  # becomes H(i,j-1) for row i+1
            M = M + q[j] if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            if h >= row_max:   # mj = m > h ? mj : j  (ties pick the later j)
                mj = j
                row_max = h
            t = M - oe_del
            t = t if t > 0 else 0
            e -= e_del
            e = e if e > t else t
            eh_e[j] = e
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= e_ins
            f = f if f > t else t
        eh_h[end] = h1
        eh_e[end] = 0
        if end == qlen:
            # gscore/max_ie at the query boundary; ties pick the later row:
            #   max_ie = gscore > h1 ? max_ie : i
            #   gscore = gscore > h1 ? gscore : h1
            if not (gscore > h1):
                max_ie = i
            if h1 > gscore:
                gscore = h1
        if row_max == 0:
            break
        if row_max > max_score:
            max_score = row_max
            max_i, max_j = i, mj
            off = mj - i if mj >= i else i - mj
            if off > max_off:
                max_off = off
        elif zdrop > 0:
            # Z-dropoff break (bwa-0.7.8 ksw_extend2; absent in the FPGA)
            if i - max_i > mj - max_j:
                if max_score - row_max - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if max_score - row_max - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # zero-run band trimming for the next row
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen

    return ExtendResult(
        score=int(max_score),
        qle=int(max_j + 1),
        tle=int(max_i + 1),
        gtle=int(max_ie + 1),
        gscore=int(gscore),
        max_off=int(max_off),
        w_used=int(w),
    )


def ksw_extend(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    h0: int,
    zdrop: int = 0,
    max_ins: int | None = None,
    max_del: int | None = None,
    max_band_try: int = 2,
) -> ExtendResult:
    """Full extension including the band-doubling retry loop.

    bwa computes per-task `max_ins`/`max_del` bounds on the host and the
    FPGA receives them in descriptor words d5/d6 (SURVEY.md §2.3), clamping
    `aw = min(w << k, max_ins, max_del)` (sw_extend.v:1881, 1890).  If not
    given, they are computed here the bwa way from qlen and the matrix max
    (with end_bonus = the relevant clip penalty folded in by the caller).
    """
    query = np.asarray(query)
    target = np.asarray(target)
    if max_ins is None:
        max_ins = _max_gap(len(query), mat, o_ins, e_ins, 0)
    if max_del is None:
        max_del = _max_gap(len(query), mat, o_del, e_del, 0)
    prev_score = -1
    res = None
    for k in range(max_band_try):
        aw = w << k
        aw = min(aw, max_ins, max_del)
        res = ksw_extend_core(
            query, target, mat, o_del, e_del, o_ins, e_ins, aw, h0, zdrop
        )
        res = res._replace(w_used=aw)
        if res.score == prev_score or res.max_off < (aw >> 1) + (aw >> 2):
            break
        prev_score = res.score
    return res


def _max_gap(qlen: int, mat: np.ndarray, o: int, e: int, end_bonus: int) -> int:
    """bwa's max gap-length bound: (qlen*max_match + end_bonus - o)/e + 1."""
    mx = int(mat.max())
    g = int((qlen * mx + end_bonus - o) / e + 1.0)
    return max(g, 1)


def ksw_extend_naive(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    h0: int,
) -> tuple[int, int]:
    """Independent full-matrix DP checker (no band, no early exits, no
    zero-trim) used only by tests to sanity-check `ksw_extend_core` when the
    band is wide enough to cover the whole matrix.  Returns (score, gscore).
    """
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    # 1-based (i, j); Hprev[j] = H(i-1, j) with H(·,0) the first column.
    Hprev = np.zeros(qlen + 1, dtype=np.int64)
    Hprev[0] = h0
    for j in range(1, qlen + 1):
        v = h0 - o_ins - e_ins * j
        Hprev[j] = v if v > 0 else 0
    E = np.zeros(qlen + 1, dtype=np.int64)  # E(i, ·); E(row 1, ·) = 0
    best = h0
    gscore = -1
    for i in range(1, tlen + 1):
        H = np.zeros(qlen + 1, dtype=np.int64)
        h_first = h0 - (o_del + e_del * i)
        H[0] = h_first if h_first > 0 else 0
        f = 0
        Enew = np.zeros(qlen + 1, dtype=np.int64)
        for j in range(1, qlen + 1):
            Mdiag = Hprev[j - 1]
            M = Mdiag + mat[target[i - 1], query[j - 1]] if Mdiag else 0
            h = max(M, E[j], f)
            H[j] = h
            best = max(best, h)
            Enew[j] = max(E[j] - e_del, max(M - oe_del, 0))
            f = max(f - e_ins, max(M - oe_ins, 0))
        gscore = max(gscore, H[qlen])
        Hprev = H
        E = Enew
    return int(best), int(gscore)
