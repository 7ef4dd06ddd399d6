"""FM-index queries: bi-interval extension, SMEM search, SA lookup.

Scalar golden implementation of bwa-0.7.8's seeding machinery
(`bwt_extend`, `bwt_smem1`, `bwt_sa`).  The reference FPGA does not do
seeding — it runs on the host CPU (SURVEY.md §0: the AFU accelerates
only `ksw_extend`); this module is the behavioural model the batched
JAX/Pallas seeding kernels are fuzzed against.

Conventions: SA space is [0, seq_len2+1) including the sentinel row.
A bi-interval (x0, x1, s) tracks:
  x0 = SA-interval start of pattern P,
  x1 = SA-interval start of revcomp(P)  (well-defined because the text
       contains both strands — the bwa two-strand trick),
  s  = interval size (equal for both).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .fmbuild import FMIndex


@dataclasses.dataclass(frozen=True)
class BiInterval:
    x0: int
    x1: int
    s: int
    # query span [qb, qe) carried alongside (bwa packs it into .info)
    qb: int = 0
    qe: int = 0

    @property
    def qlen(self) -> int:
        return self.qe - self.qb


def interval_of_char(fm: FMIndex, c: int) -> BiInterval:
    """bwa's bwt_set_intv: the bi-interval of the single-character pattern."""
    x0 = int(fm.C[c])
    s = int(fm.C[c + 1] - fm.C[c])
    x1 = int(fm.C[3 - c])  # revcomp of char c is char 3-c; same size
    return BiInterval(x0=x0, x1=x1, s=s)


def extend_backward(fm: FMIndex, ik: BiInterval) -> list[BiInterval]:
    """All four backward extensions c·P of pattern P (bwa bwt_extend is_back=1).

    Returns [ok_0, ok_1, ok_2, ok_3] where ok_c is the bi-interval of
    pattern (c + P).  The x1 companions are reconstructed from the
    complement-order tiling of the old x1 interval:
       [sentinel][c=3][c=2][c=1][c=0]  partitions  [x1, x1+s)
    """
    lo, hi = ik.x0, ik.x0 + ik.s
    tk = [fm.rank(c, lo) for c in range(4)]
    tl = [fm.rank(c, hi) for c in range(4)]
    sizes = [tl[c] - tk[c] for c in range(4)]
    has_sentinel = 1 if (lo <= fm.primary < hi) else 0
    x1 = [0] * 4
    x1[3] = ik.x1 + has_sentinel
    x1[2] = x1[3] + sizes[3]
    x1[1] = x1[2] + sizes[2]
    x1[0] = x1[1] + sizes[1]
    return [
        BiInterval(x0=int(fm.C[c]) + tk[c], x1=x1[c], s=sizes[c],
                   qb=ik.qb, qe=ik.qe)
        for c in range(4)
    ]


def extend_forward(fm: FMIndex, ik: BiInterval) -> list[BiInterval]:
    """All four forward extensions P·c (bwt_extend is_back=0): backward
    extension of revcomp(P) by comp(c), with x0/x1 roles swapped."""
    swapped = BiInterval(x0=ik.x1, x1=ik.x0, s=ik.s, qb=ik.qb, qe=ik.qe)
    exts = extend_backward(fm, swapped)
    # extension of revcomp(P) by comp(c) corresponds to P·c
    return [
        BiInterval(x0=e.x1, x1=e.x0, s=e.s, qb=ik.qb, qe=ik.qe)
        for e in (exts[3 - c] for c in range(4))
    ]


def smem1(fm: FMIndex, q: np.ndarray, x: int, min_intv: int = 1,
          ) -> tuple[int, list[BiInterval]]:
    """All SMEMs of read `q` passing through position x (bwa bwt_smem1).

    Returns (next_x, mems): next_x is where the caller's scan resumes (the
    end of the longest forward extension), mems are maximal intervals with
    qb/qe filled, ordered by increasing qb (as bwa produces them).
    """
    n = len(q)
    if q[x] > 3:
        return x + 1, []
    ik = interval_of_char(fm, int(q[x]))
    ik = dataclasses.replace(ik, qb=x, qe=x + 1)
    curr: list[BiInterval] = []
    # --- forward extension collecting size-change break points ---
    i = x + 1
    while i < n:
        if q[i] < 4:
            ok = extend_forward(fm, ik)[int(q[i])]
            if ok.s != ik.s:
                curr.append(ik)
                if ok.s < min_intv:
                    break
            ik = dataclasses.replace(ok, qb=x, qe=i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    if i == n:
        curr.append(ik)
    ret = curr[-1].qe  # the furthest forward end reached
    prev = curr[::-1]  # longest first
    mems: list[BiInterval] = []
    # --- backward extension over the collected set ---
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for p in prev:
            ok = extend_backward(fm, p)[c] if c >= 0 else None
            if ok is None or ok.s < min_intv:
                if len(curr) == 0:
                    if len(mems) == 0 or i + 1 < mems[-1].qb:
                        mems.append(dataclasses.replace(p, qb=i + 1))
            elif len(curr) == 0 or ok.s != curr[-1].s:
                curr.append(dataclasses.replace(ok, qb=p.qb, qe=p.qe))
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()  # bwa returns them sorted by qb ascending
    return ret, mems
