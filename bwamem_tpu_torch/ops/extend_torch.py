"""Plain PyTorch banded seed extension — the CPU path of the port and the
oracle its CUDA kernel is held to.

A line-for-line counterpart of the Pallas kernel bodies in
bwamem_tpu/ops/extend_pallas.py: `band_pass` is `_band_pass` (one
banded ksw_extend2 pass, every lane at once, in the transposed
(qmax, B) layout: query columns on dim 0, lanes on dim 1),
`extend_fused` is `_extend_kernel_fused` (L0, the L1 band-doubling
retry, R0 seeded with the left score, the R1 retry) and `extend_t` is
`_extend_kernel_t` (one pass per lane: the per-phase protocol).  The
serial F recurrence is a prefix max (`torch.cummax`) over
P[k] = M[k] + e_ins*k - oe_ins, exactly as the Pallas form computes it.

Outputs are bit-identical to the Pallas kernels on every lane and row,
padding lanes and lanes that did not retry included: an invalid or
inactive lane (qlen, tlen or h0 <= 0, or a retry lane that
converged) gives best = h0, qle = tle = gtle = 0, gscore = -1,
max_off = 0 and the pass's aw.

Every function takes `compute_dtype`, as the Pallas entry points do:
torch.int32 (the default), or torch.int16 for 16-bit H/E/F cells with
-/+2^14 as the sentinels, which is `_band_pass` at `dt == jnp.int16`
operation for operation (only the row-maximum key H*1024 + j is
widened to int32).  The 16-bit results equal the 32-bit ones while no
intermediate leaves the 16-bit range; extend_cuda.check_i16_range
states that range.  The 16-bit version is the specification of the
16-bit kernels.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 29)
BIG = 1 << 29
NEG16 = -(1 << 14)
BIG16 = 1 << 14


def prm_ints(prm) -> list[int]:
    """[a, b, o_del, e_del, o_ins, e_ins, zdrop] from the (8,) scoring
    block (numpy, list or tensor on any device)."""
    if isinstance(prm, torch.Tensor):
        prm = prm.tolist()
    return [int(x) for x in np.asarray(prm).ravel()[:7]]


def _wrap16(v: int) -> int:
    """v as a 16-bit two's-complement value (what .astype(int16) makes)."""
    return ((v + (1 << 15)) & 0xFFFF) - (1 << 15)


def band_pass(target, query, qlen, tlen, aw, h0, prm, inactive=None,
              cells=None, compute_dtype=torch.int32):
    """One banded extension pass for every lane.

    target (TL, B), query (QM, B): base codes (any integer dtype, > 3
    is N); qlen, tlen, aw, h0: (B,) int32; `inactive` (optional (B,)
    bool) marks lanes this pass skips.  Target row i is read at
    min(i, TL-1), as the Pallas kernel reads it.  Returns (best, max_j,
    max_i, max_ie, gscore, max_off), each (B,) int32, with
    ksw_extend_core semantics.  `cells` (optional, a one-element list)
    gains the number of (i, j) cells inside [beg, end) of the rows each
    lane runs: the work these inputs need, for a roofline bound.
    `compute_dtype` is the type of the cells and of everything else but
    the row-maximum key (int32): torch.int32 or torch.int16.
    """
    prm = prm_ints(prm)
    qmax, B = query.shape
    if qmax > 1024:
        raise ValueError(f"qmax {qmax} > 1024 (argmax key H*1024 + j)")
    dev = query.device
    dt = compute_dtype
    if dt == torch.int16:
        # the scalars wrap as the casts of the Pallas body wrap them
        prm = [_wrap16(x) for x in prm]
        neg_v, big_v = NEG16, BIG16
    elif dt == torch.int32:
        neg_v, big_v = NEG, BIG
    else:
        raise ValueError(f"compute_dtype {dt}: want torch.int32 or int16")
    a, b, o_del, e_del, o_ins, e_ins, zdrop = prm

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

    sidx32 = torch.arange(qmax, dtype=torch.int32, device=dev)[:, None]
    sidx = sidx32.to(dt)
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
    if inactive is not None:
        valid = valid & ~inactive
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
        if cells is not None:
            cells[0] += int(torch.where(active, (endc - begc).clamp_min(0),
                                        zero).sum(dtype=torch.int64))

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

        # row max and its argmax in one reduction (ties -> larger j);
        # the key is int32 whatever the cells are
        kmax = (H.to(torch.int32) * 1024 + sidx32).amax(0)
        row_max = (kmax >> 10).to(dt)
        mj = (kmax & 1023).to(dt)
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


def extend_fused(ql, tl, qr, tr, scal, tmax2, prm, cells=None,
                 compute_dtype=torch.int32):
    """The fused whole-alignment extension, plain PyTorch.

    ql (QL, B), tl (TL, B), qr (QR, B), tr (TR, B): base codes; scal
    (16, B) int32 with rows [0]=qlen_l [1]=tlen_l [2]=aw0_l [3]=h0_seed
    [4]=aw1_l [5]=qlen_r [6]=tlen_r [7]=aw0_r [8]=aw1_r [9]=w; tmax2
    (B/blk, 2) per-block row bounds, which only bound loops and so are
    not needed here.  Returns (32, B) int32: [L0 | L1 | R0 | R1] x
    [score, qle, tle, gtle, gscore, max_off, aw, 0].  `cells` and
    `compute_dtype` as in band_pass (cells summed over the four
    passes).
    """
    del tmax2
    scal = scal.to(compute_dtype)
    w = scal[9]
    thr = (w >> 1) + (w >> 2)
    kw = dict(cells=cells, compute_dtype=compute_dtype)
    l0 = band_pass(tl, ql, scal[0], scal[1], scal[2], scal[3], prm, **kw)
    conv_l = l0[5] < thr
    l1 = band_pass(tl, ql, scal[0], scal[1], scal[4], scal[3], prm,
                   inactive=conv_l, **kw)
    # lanes with no left task fall through to h0_seed (best = h0)
    h0_r = torch.where(conv_l, l0[0], l1[0])
    r0 = band_pass(tr, qr, scal[5], scal[6], scal[7], h0_r, prm, **kw)
    conv_r = r0[5] < thr
    r1 = band_pass(tr, qr, scal[5], scal[6], scal[8], h0_r, prm,
                   inactive=conv_r, **kw)
    rows = (_group(l0, scal[2]) + _group(l1, scal[4])
            + _group(r0, scal[7]) + _group(r1, scal[8]))
    return torch.stack(rows, 0).to(torch.int32)


def extend_t(query_t, target_t, scal_t, tmax, prm, cells=None,
             compute_dtype=torch.int32):
    """One banded pass per lane, plain PyTorch.

    query_t (QM, B), target_t (TM, B): base codes; scal_t (8, B) int32
    with rows [qlen, tlen, aw, h0, 0...]; tmax (B/blk,) per-block row
    bounds, which only bound loops and so are not needed here.  Returns
    (8, B) int32: [score, qle, tle, gtle, gscore, max_off, aw, 0].
    `cells` and `compute_dtype` as in band_pass.
    """
    del tmax
    scal_t = scal_t.to(compute_dtype)
    res = band_pass(target_t, query_t, scal_t[0], scal_t[1], scal_t[2],
                    scal_t[3], prm, cells=cells,
                    compute_dtype=compute_dtype)
    return torch.stack(_group(res, scal_t[2]), 0).to(torch.int32)
