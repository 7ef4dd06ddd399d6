"""Batched local Smith-Waterman (bwa's ksw_align) on the device: the
counterpart of bwamem_tpu/ops/local_jax.py.

The mate-rescue compute (mem_matesw: align the unplaced mate against
the insert-size window around its anchor; ops/local_ref.py is the
scalar oracle, csrc/kswlocal.cpp the host production path).  Plain
PyTorch on tensors of one device: in the JAX package this is `lax.scan`
and `lax.cummax` outside any Pallas kernel, so there is no TPU kernel
to replace.  One Python iteration per target row, the whole query axis
and every task of the wave vectorised; that is tens of thousands of
small launches a wave on a GPU: on a card every caller runs the kernel
of csrc/local_sw.cu instead (ops/local_cuda), and this is its plain
version.

- The local-SW F recurrence F(j+1) = max(F(j)-e_ins, H(j)-oe_ins, 0)
  looks serial because H(j) = max(Hdiag(j), F(j)), but
  max(Hdiag,F)-oe_ins <= max(F-e_ins, Hdiag-oe_ins) given oe >= e, so F
  opens from the pre-F Hdiag and the row is a running prefix maximum
  (`torch.cummax`).
- Best cell with bwa's exact tie-breaking: the first row with a
  strictly greater score, the leftmost column within the row
  (`torch.argmax` promises no order among ties, so the first maximal
  column is taken explicitly); per-row best scores are kept for the
  KSW_XSUBO second best.
- Start coordinates by the reversed-prefix second fill.

Returns exactly ops/local_ref.ksw_align's (score, qb, qe, tb, te,
score2) per task (tests/test_torch_local.py).
"""

from __future__ import annotations

import numpy as np
import torch

from bwamem_tpu_torch.device import to_device

_NEGB = -(1 << 28)


def fill(query, qlen, target, tlen, mat, pens):
    """Forward local fill.  query (B, qmax), target (B, tmax): base
    codes 0..4; qlen, tlen (B,); mat (5, 5); pens [o_del, e_del, o_ins,
    e_ins]; all int32 tensors on one device.  Returns (best, bi, bj,
    row_best): best = the largest cell score (0 floor), (bi, bj) its
    0-based (target, query) cell with bwa's tie-breaking, row_best
    (tmax, B)."""
    B, qmax = query.shape
    tmax = target.shape[1]
    dev = query.device
    i32 = torch.int32
    o_del, e_del, o_ins, e_ins = (pens[k] for k in range(4))
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jidx = torch.arange(qmax, dtype=i32, device=dev)[None, :]
    qprof = mat.to(i32)[:, query.long()]               # (5, B, qmax)
    qmask = jidx < qlen[:, None]
    ramp = e_ins * jidx
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    big = torch.tensor(qmax, dtype=i32, device=dev)

    H = torch.zeros((B, qmax + 1), dtype=i32, device=dev)
    E = torch.zeros((B, qmax + 1), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bi = torch.full((B,), -1, dtype=i32, device=dev)
    bj = torch.full((B,), -1, dtype=i32, device=dev)
    row_best = torch.zeros((tmax, B), dtype=i32, device=dev)
    t_rows = target.t().long().clamp(0, 4)             # (tmax, B)
    lanes = torch.arange(B, device=dev)
    for i in range(tmax):
        live = i < tlen                                # (B,)
        sub = qprof[t_rows[i], lanes]                  # (B, qmax)
        M = H[:, :qmax] + sub
        Hd = torch.maximum(M, E[:, 1:]).clamp_min(0)
        Hd = torch.where(qmask, Hd, 0)                 # cols past qlen dead
        # F(j) = max(0, max_{j'<j} Hd(j') - oe_ins - e_ins*(j-j'-1))
        A = torch.where(qmask, Hd + ramp, _NEGB)
        S = torch.cummax(A, dim=1).values
        F = torch.cat(
            [zero_col, (S[:, :-1] - oe_ins - ramp[:, :-1]).clamp_min(0)],
            dim=1)[:, :qmax]
        h = torch.where(qmask, torch.maximum(Hd, F), 0)
        newH = torch.cat([zero_col, h], dim=1)
        newE = torch.cat(
            [zero_col, torch.maximum(E[:, 1:] - e_del, h - oe_del)
             .clamp_min(0)], dim=1)
        lv = live[:, None]
        H = torch.where(lv, newH, H)
        E = torch.where(lv, newE, E)
        rb = torch.where(lv, h, 0).amax(1)
        row_best[i] = rb
        upd = live & (rb > best)                       # strict >: first row
        best = torch.where(upd, rb, best)
        bi = torch.where(upd, i, bi)
        # the leftmost column that holds the row's own maximum
        first = torch.where(h == h.amax(1, keepdim=True), jidx, big).amin(1)
        bj = torch.where(upd, first, bj)
    return best, bi, bj, row_best


def reverse_prefix(seq, end):
    """seq (B, L) -> rev (B, L) with rev[b, j] = seq[b, end[b]-1-j] for
    j < end[b], pad 4 elsewhere."""
    L = seq.shape[1]
    j = torch.arange(L, dtype=torch.int32, device=seq.device)[None, :]
    src = (end[:, None] - 1 - j).clamp(0, L - 1)
    out = torch.gather(seq, 1, src.long())
    return torch.where(j < end[:, None], out, 4)


def align6(query, qlen, target, tlen, mat, pens):
    """Whole ksw_align: forward fill, reversed-prefix second fill for
    the start coordinates, KSW_XSUBO second best.  Arguments as `fill`.
    Returns (6, B) int32 rows [score, qb, qe, tb, te, score2]; lanes
    with qlen == 0 (padding) come back with all-zero scores."""
    tmax = target.shape[1]
    best, bi, bj, row_best = fill(query, qlen, target, tlen, mat, pens)
    qe = bj + 1
    te = bi + 1
    qrev = reverse_prefix(query, qe)
    trev = reverse_prefix(target, te)
    _, ti2, qj2, _ = fill(qrev, qe, trev, te, mat, pens)
    qb = qe - (qj2 + 1)
    tb = te - (ti2 + 1)
    iidx = torch.arange(tmax, dtype=torch.int32,
                        device=query.device)[:, None]
    half = (qlen // 2).clamp_min(1)
    m = ((iidx - bi[None, :]).abs() >= half[None, :]) & (iidx < tlen[None, :])
    score2 = torch.where(m, row_best, 0).amax(0)
    return torch.stack([best, qb, qe, tb, te, score2]).to(torch.int32)



def _align6_host(device, query, qlen, target, tlen, mat, pens):
    """align6 of host arrays on `device` through the dispatcher
    (ops/local_cuda: the kernel on a card); (6, B) int32 numpy."""
    from bwamem_tpu_torch.ops import local_cuda

    return local_cuda.align6(*(to_device(x, np.int32, device)
                               for x in (query, qlen, target, tlen, mat,
                                         pens))).cpu().numpy()


def make_rescue_backend(device):
    """The device backend of NativePipeline's mem_matesw protocol
    with host-shipped windows (mp_rescue_*; `--device-rescue
    --ship-ref`) on `device` (a torch.device): takes the batch's padded
    int8 (Bp, lq) mate sequences, (Bp, lt) reference windows and
    (2, Bp) int32 lengths plus the matrix and the four gap penalties,
    returns (6, Bp) int32 numpy [score, qb, qe, tb, te, score2], the
    rows local_ref.ksw_align computes per task.  Keeps no state, so it
    is safe to call from several threads."""
    device = torch.device(device)

    def fn(seq_i8, rseq_i8, lens, mat, o_del, e_del, o_ins, e_ins):
        return _align6_host(device, seq_i8, lens[0], rseq_i8, lens[1], mat,
                            [o_del, e_del, o_ins, e_ins])

    return fn


def ksw_align_batch(tasks, mat, o_del, e_del, o_ins, e_ins, device
                    ) -> list[tuple[int, int, int, int, int, int]]:
    """Batched drop-in for per-task local_ref.ksw_align: tasks is a
    list of (query codes, target codes); returns (score, qb, qe, tb,
    te, score2) per task, identical to the scalar oracle.  The tasks
    run on `device` in one padded batch (power-of-two shapes)."""
    from bwamem_tpu_torch.ops.global_torch import _pow2

    out: list = [None] * len(tasks)
    idx, qs, ts = [], [], []
    for i, (q, t) in enumerate(tasks):
        if len(q) == 0 or len(t) == 0:
            out[i] = (0, -1, -1, -1, -1, 0)
        else:
            idx.append(i)
            qs.append(np.asarray(q, np.int32))
            ts.append(np.asarray(t, np.int32))
    if not idx:
        return out
    B = len(idx)
    qmax = _pow2(max(len(q) for q in qs), 16)
    tmax = _pow2(max(len(t) for t in ts), 16)
    qa = np.full((B, qmax), 4, np.int32)
    ta = np.full((B, tmax), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(zip(qs, ts)):
        qa[b, :len(q)] = q
        ta[b, :len(t)] = t
        qlen[b], tlen[b] = len(q), len(t)
    out6 = _align6_host(torch.device(device), qa, qlen, ta, tlen, mat,
                        [o_del, e_del, o_ins, e_ins])
    best, qb, qe, tb, te, score2 = out6
    for b, i in enumerate(idx):
        if best[b] <= 0:
            out[i] = (0, -1, -1, -1, -1, 0)
        else:
            out[i] = (int(best[b]), int(qb[b]), int(qe[b]), int(tb[b]),
                      int(te[b]), int(score2[b]))
    return out
