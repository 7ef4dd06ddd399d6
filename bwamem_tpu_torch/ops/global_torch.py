"""Batched banded global alignment with traceback on the device: the
counterpart of bwamem_tpu/ops/global_jax.py.

bwa runs ksw_global on the host after the extension to produce CIGARs;
this is the device-side variant of that second pass, byte-identical in
(score, CIGAR) to pipeline/cigar.ksw_global.  Plain PyTorch on tensors
of one device: in the JAX package this is two `lax.scan`s under one jit,
outside any Pallas kernel.  On a card every caller runs the kernel of
csrc/global_sw.cu instead (ops/global_cuda), and `global_batch` is its
plain version.

- FILL: one Python iteration per target row, the whole query axis and
  every task vectorised.  In ksw_global2 the E/F recurrences open from M
  (the diagonal), so a row has no serial dependency once F is a running
  prefix maximum (`torch.cummax`).  Per-task bands are masks; state
  outside the band is left unchanged, which reproduces the scalar
  band-edge writes.  The 6-bit ksw.c z codes (H direction | E
  continuation | F continuation) go into a (tmax, B, qmax) uint8 volume.
- TRACEBACK: at most qmax + tmax steps walk all tasks in lockstep: one
  gather into the z volume a step (its flat index in int64: 16384 tasks
  x 1024 x 256 pass 2^31), `which = (z >> (which << 1)) & 3` as ksw.c on
  a widened integer, one step-op per task per step (3 = done); the D/I
  tail after either edge is part of the same loop.
- The host does only the run-length encoding of the step-ops (numpy over
  the whole batch).

The scoring parameters are arguments, not constants.
"""

from __future__ import annotations

import numpy as np
import torch

from bwamem_tpu_torch.device import to_device

from bwamem_tpu_torch.pipeline.cigar import D_OP, I_OP, M_OP, NEG_INF

NEG = int(NEG_INF)


def global_batch(query, qlen, target, tlen, w, mat, pens):
    """Fill + traceback for a (B,) batch of global alignment tasks.

    query (B, qmax), target (B, tmax): base codes 0..4; qlen, tlen, w
    (B,) (every task has qlen >= 1 and tlen >= 1: empty dimensions are
    host fast paths, cigar.ksw_global); mat (5, 5); pens = [o_del,
    e_del, o_ins, e_ins]; all int32 tensors on one device.

    Returns (score (B,), steps (qmax + tmax, B) int8 step-ops in ksw's
    `which` coding emitted back to front: 0=M 1=D 2=I 3=done).
    """
    B, qmax = query.shape
    tmax = target.shape[1]
    dev = query.device
    i32 = torch.int32
    o_del, e_del, o_ins, e_ins = (pens[k] for k in range(4))
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w = torch.maximum(w, (tlen - qlen).abs())
    jidx = torch.arange(qmax, dtype=i32, device=dev)[None, :]   # (1, qmax)
    lanes = torch.arange(B, device=dev)
    qprof = mat.to(i32)[:, query.long()]               # (5, B, qmax)
    ramp = e_ins * jidx
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)

    # first row: eh_h[j] = -(o_ins + e_ins*j) for 1 <= j <= min(w, qlen),
    # eh_h[0] = 0, else NEG.  State is (B, qmax+1).
    j1 = torch.arange(qmax + 1, dtype=i32, device=dev)[None, :]
    eh_h = torch.where(j1 <= torch.minimum(w, qlen)[:, None],
                       -(o_ins + e_ins * j1), NEG).to(i32)
    eh_h[:, 0] = 0
    eh_e = torch.full((B, qmax + 1), NEG, dtype=i32, device=dev)
    z = torch.zeros((tmax, B, qmax), dtype=torch.uint8, device=dev)
    t_rows = target.t().long().clamp(0, 4)             # (tmax, B)
    for i in range(tmax):
        live = (i < tlen)[:, None]                     # (B, 1)
        beg = (i - w).clamp_min(0)[:, None]
        end = torch.minimum(i + w + 1, qlen)[:, None]  # exclusive
        inb = live & (jidx >= beg) & (jidx < end)

        m = eh_h[:, :qmax] + qprof[t_rows[i], lanes]
        e = eh_e[:, :qmax]
        d = (m < e).to(i32)                            # H dir: 0=M, 1=E
        hme = torch.maximum(m, e)
        # F(j) = max_{j'<j} (M(j') - oe_ins - e_ins*(j-j'-1)), fresh at
        # beg: A = NEG outside the band keeps the prefix maximum from
        # leaking across the band's edge
        A = torch.where(inb, m + ramp, NEG)
        S = torch.cummax(A, dim=1).values
        f = torch.cat([neg_col, S[:, :-1] - oe_ins - ramp[:, :-1]], dim=1)
        d = torch.where(f > hme, 2, d)
        h = torch.maximum(hme, f)
        d = d | ((e - e_del > m - oe_del).to(i32) << 2)    # 0x04: E goes on
        new_e = torch.maximum(e - e_del, m - oe_del)
        d = d | ((f - e_ins > m - oe_ins).to(i32) << 5)    # 0x20: F goes on
        z[i] = torch.where(inb, d, 0).to(torch.uint8)

        # writeback: eh_h[j+1] <- h[j] for j in band; eh_h[beg] <- left
        # edge; eh_e in band; eh_e[end] <- NEG
        shif = torch.cat([neg_col, h], dim=1)
        eh_h = torch.where(live & (j1 >= beg + 1) & (j1 <= end), shif, eh_h)
        left = torch.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
        eh_h = torch.where(live & (j1 == beg), left, eh_h)
        eh_e = torch.where(live & (j1 >= beg) & (j1 < end),
                           torch.cat([new_e, neg_col], dim=1), eh_e)
        eh_e = torch.where(live & (j1 == end), NEG, eh_e)
    score = eh_h[lanes, qlen.long()]                   # H(tlen-1, qlen-1)

    # traceback: all tasks in lockstep, one gather a step
    z_flat = z.reshape(-1)
    smax = qmax + tmax
    steps = torch.empty((smax, B), dtype=torch.int8, device=dev)
    i, k = tlen - 1, qlen - 1
    which = torch.zeros(B, dtype=i32, device=dev)
    one, two, three = (torch.tensor(v, dtype=i32, device=dev)
                       for v in (1, 2, 3))
    for s in range(smax):
        both = (i >= 0) & (k >= 0)
        idx = (i.clamp_min(0).long() * B + lanes) * qmax \
            + k.clamp_min(0).long()
        zv = z_flat[idx].to(i32)
        nxt = (zv >> (which << 1)) & 3
        op = torch.where(
            both, nxt,
            torch.where(i >= 0, one, torch.where(k >= 0, two, three)))
        i = i - ((op == 0) | (op == 1)).to(i32)
        k = k - ((op == 0) | (op == 2)).to(i32)
        which = torch.where(both, nxt, which)
        steps[s] = op.to(torch.int8)
    return score, steps


def band_width(qlen, tlen, w, qmax: int) -> int:
    """The widest band of a round's lanes, host arrays (B,): min(2 w' + 1,
    qlen) with w' = max(w, |tlen - qlen|), qlen clipped to the query window
    qmax; at least 1.  The CUDA kernel sizes its window from it."""
    qlen, tlen, w = (np.asarray(x, np.int64) for x in (qlen, tlen, w))
    wp = np.maximum(w, np.abs(tlen - qlen))
    qn = np.clip(qlen, 0, qmax)
    return max(int(np.minimum(2 * wp + 1, qn).max(initial=0)), 1)


_WHICH2OP = np.array([M_OP, D_OP, I_OP, -1], np.int8)


def rle_cigars(steps: np.ndarray) -> list[list[tuple[int, int]]]:
    """(smax, B) device step-ops -> per-task CIGAR [(op, len), ...].

    Steps were emitted back to front; vectorised numpy run-length
    encoding over the whole batch (one pass, no per-base Python)."""
    B = steps.shape[1]
    ops = _WHICH2OP[steps.T]                           # (B, smax), -1 done
    n = (ops >= 0).sum(1)                              # steps per task
    flat = ops[ops >= 0]                               # concat, task-major
    row = np.repeat(np.arange(B), n)
    if flat.size == 0:
        return [[] for _ in range(B)]
    brk = np.flatnonzero((flat[1:] != flat[:-1]) | (row[1:] != row[:-1]))
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [flat.size]])
    runs = ends - starts
    run_op = flat[starts]
    run_row = row[starts]
    out: list[list[tuple[int, int]]] = [[] for _ in range(B)]
    for r, o, ln in zip(run_row.tolist(), run_op.tolist(), runs.tolist()):
        out[r].append((int(o), int(ln)))
    for c in out:
        c.reverse()                                    # back to front
    return out


def pack_cigar_round(score, steps):
    """(score, steps) tensors of global_batch -> the mp_cigar round
    triple (scores (Bp,) int32, counts (Bp,) int32, flat (op, len) int32
    pairs task-major), all numpy."""
    score, steps = score.cpu().numpy(), steps.cpu().numpy()
    cigars = rle_cigars(steps)
    ncig = np.array([len(c) for c in cigars], np.int32)
    flat = np.fromiter(
        (x for c in cigars for p in c for x in p), np.int32,
        count=2 * int(ncig.sum()))
    return np.asarray(score, np.int32), ncig, flat



def _global_batch_host(device, query, qlen, target, tlen, w, mat, pens):
    """global_batch of host arrays on `device` through the dispatcher
    (ops/global_cuda: the kernel on a card); (score, steps) tensors."""
    from bwamem_tpu_torch.ops import global_cuda

    return global_cuda.global_batch(*(
        to_device(x, np.int32, device)
        for x in (query, qlen, target, tlen, w, mat, pens)),
        band=band_width(qlen, tlen, w, np.shape(query)[1]))


def make_cigar_backend(device):
    """The device backend of NativePipeline's mp_cigar_* round protocol
    with host-shipped segments (`--device-cigar --ship-ref`) on `device`
    (a torch.device): one round = padded int8 (Bp, lq) query segments,
    (Bp, lt) reference segments and (3, Bp) int32 [qlen, tlen, band]
    rows in; (scores (Bp,) int32, counts (Bp,) int32, flat (op, len)
    int32 pairs task-major) out, numpy.  Fill and traceback run on the
    device; only the run-length encoding is host numpy.  Keeps no state,
    so it is safe to call from several threads."""
    device = torch.device(device)

    def fn(q_i8, t_i8, meta, mat, o_del, e_del, o_ins, e_ins):
        return pack_cigar_round(*_global_batch_host(
            device, q_i8, meta[0], t_i8, meta[1], meta[2], mat,
            [o_del, e_del, o_ins, e_ins]))

    return fn


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


def ksw_global_batch(tasks, mat, o_del, e_del, o_ins, e_ins, device
                     ) -> list[tuple[int, list[tuple[int, int]]]]:
    """Batched drop-in for per-task cigar.ksw_global.

    tasks: list of (query codes, target codes, w).  Returns
    [(score, cigar), ...], byte-identical to the scalar oracle
    (tests/test_torch_global.py).  Tasks with an empty dimension take the
    host fast path; the rest run on `device` in one batch padded to
    power-of-two (qmax, tmax)."""
    from bwamem_tpu_torch.pipeline.cigar import ksw_global

    out: list = [None] * len(tasks)
    idx, qs, ts, ws = [], [], [], []
    for i, (q, t, w) in enumerate(tasks):
        if len(q) == 0 or len(t) == 0:
            out[i] = ksw_global(np.asarray(q), np.asarray(t), mat,
                                o_del, e_del, o_ins, e_ins, w,
                                use_native=False)
        else:
            idx.append(i)
            qs.append(np.asarray(q, np.int32))
            ts.append(np.asarray(t, np.int32))
            ws.append(int(w))
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
    score, steps = _global_batch_host(
        torch.device(device), qa, qlen, ta, tlen, ws, mat,
        [o_del, e_del, o_ins, e_ins])
    score = score.cpu().numpy()
    cigars = rle_cigars(steps.cpu().numpy())
    for b, i in enumerate(idx):
        out[i] = (int(score[b]), cigars[b])
    return out
