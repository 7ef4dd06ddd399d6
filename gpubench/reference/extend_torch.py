"""Plain PyTorch banded seed extension (bwa-0.7.8 ksw_extend2), int32.

`band_pass` runs one banded pass for every lane at once, in the
transposed (qmax, B) layout: query columns on dim 0, lanes on dim 1;
`extend_t` is one pass a lane.  The serial F recurrence is a prefix max
(`torch.cummax`) over P[k] = M[k] + e_ins*k - oe_ins.

An invalid lane (qlen, tlen or h0 <= 0) gives best = h0,
qle = tle = gtle = 0, gscore = -1, max_off = 0 and the pass's aw.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 29)
BIG = 1 << 29


def prm_ints(prm) -> list[int]:
    """[a, b, o_del, e_del, o_ins, e_ins, zdrop] from the (8,) scoring
    block (numpy, list or tensor on any device)."""
    if isinstance(prm, torch.Tensor):
        prm = prm.tolist()
    return [int(x) for x in np.asarray(prm).ravel()[:7]]


def band_pass(target, query, qlen, tlen, aw, h0, prm):
    """One banded extension pass for every lane.

    target (TL, B), query (QM, B): base codes (any integer dtype, > 3
    is N); qlen, tlen, aw, h0: (B,) int32.  Target row i is read at
    min(i, TL-1).  Returns (best, max_j, max_i, max_ie, gscore,
    max_off), each (B,) int32, with ksw_extend2 semantics.
    """
    qmax, B = query.shape
    if qmax > 1024:
        raise ValueError(f"qmax {qmax} > 1024 (argmax key H*1024 + j)")
    dev = query.device
    dt = torch.int32
    neg_v, big_v = NEG, BIG
    a, b, o_del, e_del, o_ins, e_ins, zdrop = prm_ints(prm)

    def c(v):
        return torch.tensor(v, dtype=dt, device=dev)

    zero, neg, big = c(0), c(neg_v), c(big_v)
    s_match, s_mis, s_n = c(a), c(-b), c(-1)
    query = query.to(dt)
    target = target.to(dt)
    qlen, tlen, aw, h0 = (x.to(dt) for x in (qlen, tlen, aw, h0))
    oe_del = c(o_del) + c(e_del)
    oe_ins = c(o_ins) + c(e_ins)
    o_del, e_del, e_ins = c(o_del), c(e_del), c(e_ins)

    sidx = torch.arange(qmax, dtype=dt, device=dev)[:, None]
    query_isN = query > 3
    ej_oe = e_ins * sidx - oe_ins
    ejm1 = e_ins * (sidx - 1)
    neg_row = torch.full((1, B), neg_v, dtype=dt, device=dev)

    eh_h = torch.where(
        sidx == 0, h0,
        torch.where(sidx <= qlen,
                    (h0 - oe_ins - (sidx - 1) * e_ins).clamp_min(0), zero))
    eh_e = torch.zeros_like(eh_h)

    valid = (qlen > 0) & (tlen > 0) & (h0 > 0)
    done = ~valid
    beg = torch.zeros(B, dtype=dt, device=dev)
    end = qlen.clone()
    best = h0.clone()
    max_i = torch.full((B,), -1, dtype=dt, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=dt, device=dev)

    n_rows = int(torch.where(valid, tlen, zero).max())
    t_last = target.shape[0] - 1
    for i in range(n_rows):
        # the all-done test is a device sync: take it once per 8 rows
        # (rows past a lane's end are masked no-ops either way)
        if i and i % 8 == 0 and bool(done.all()):
            break
        active = ~done & (i < tlen)
        begc = torch.maximum(beg, i - aw)
        endc = torch.minimum(torch.minimum(end, i + aw + 1), qlen)
        h1_first = torch.where(
            begc == 0, (h0 - (o_del + e_del * (i + 1))).clamp_min(0), zero)

        t_row = target[min(i, t_last)][None, :]
        s = torch.where(query_isN | (t_row > 3), s_n,
                        torch.where(query == t_row, s_match, s_mis))
        in_band = (sidx >= begc) & (sidx < endc)
        M = torch.where(eh_h != 0, eh_h + s, zero)
        Pk = torch.where(in_band, M + ej_oe, neg)
        S = torch.cummax(Pk, dim=0).values
        F = (torch.cat([neg_row, S[:-1]], 0) - ejm1).clamp_min(0)
        H = torch.where(in_band, torch.maximum(torch.maximum(M, eh_e), F),
                        zero)

        # row max and its argmax in one reduction (ties -> larger j)
        kmax = (H * 1024 + sidx).amax(0)
        row_max = kmax >> 10
        mj = kmax & 1023
        eq_end = sidx == endc
        Hsh = torch.cat([h1_first[None, :], H[:-1]], 0)
        h1_last = torch.where(sidx == endc - 1, H, neg).amax(0)
        h1_last = torch.where(endc > begc, h1_last, h1_first)

        wb = (in_band | eq_end) & active
        Enew = torch.where(
            eq_end, zero,
            torch.maximum(eh_e - e_del, (M - oe_del).clamp_min(0)))
        eh_h = torch.where(wb, Hsh, eh_h)
        eh_e = torch.where(wb, Enew, eh_e)

        at_qend = active & (endc == qlen)
        max_ie = torch.where(at_qend & ~(gscore > h1_last), i, max_ie)
        gscore = torch.where(at_qend, torch.maximum(gscore, h1_last),
                             gscore)

        break_zero = active & (row_max == 0)
        improved = active & (row_max > best)
        best = torch.where(improved, row_max, best)
        max_off = torch.where(
            improved, torch.maximum(max_off, (mj - i).abs()), max_off)
        stop = break_zero | (i + 1 >= tlen)
        if zdrop > 0:
            di = i - max_i
            dj = mj - max_j
            pen = torch.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            stop = stop | (active & ~break_zero & ~improved
                           & (best - row_max - pen > zdrop))
        max_i = torch.where(improved, i, max_i)
        max_j = torch.where(improved, mj, max_j)
        done = done | stop

        # two-sided zero-run band trim for the next row
        scan = in_band & ((eh_h != 0) | (eh_e != 0))
        new_beg = torch.minimum(torch.where(scan, sidx, big).amin(0), endc)
        last_in = torch.where(scan, sidx, begc - 1).amax(0)
        last_nz = torch.maximum(
            last_in, torch.where(h1_last != 0, endc, begc - 1))
        new_end = torch.minimum(last_nz + 2, qlen)
        beg = torch.where(active, new_beg, beg)
        end = torch.where(active, new_end, end)
    return best, max_j, max_i, max_ie, gscore, max_off


def _group(res, aw):
    best, max_j, max_i, max_ie, gscore, max_off = res
    return [best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off, aw,
            torch.zeros_like(best)]


def extend_t(query_t, target_t, scal_t, prm):
    """One banded pass per lane, plain PyTorch.

    query_t (QM, B), target_t (TM, B): base codes; scal_t (8, B) int32
    with rows [qlen, tlen, aw, h0, 0...].  Returns (8, B) int32:
    [score, qle, tle, gtle, gscore, max_off, aw, 0].
    """
    scal_t = scal_t.to(torch.int32)
    res = band_pass(target_t, query_t, scal_t[0], scal_t[1], scal_t[2],
                    scal_t[3], prm)
    return torch.stack(_group(res, scal_t[2]), 0)
