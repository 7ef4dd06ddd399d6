"""Correctness gate inputs for the extension kernels: seeded random
batches that reach every branch of the fused and the per-phase kernel,
and the check of one pass's fields against the scalar bwa-0.7.8 oracle.  Shared by the tests of the port
and chip_smoke.py (which puts this directory on sys.path)."""

from __future__ import annotations

import numpy as np

from bwamem_tpu.config import build_mat
from bwamem_tpu.ops.extend_ref import ksw_extend_core
from bwamem_tpu_torch.ops.extend_torch import prm_ints


def _task(rng, n, qmax, tmax, w):
    """n (query, target, qlen, tlen) tasks as (qmax, n) / (tmax, n) int8
    columns: half the targets carry a mutated copy of the query after a
    shift of up to 2w rows (shifted lanes need the band-doubling retry),
    the rest are random; about 2% N codes on both sides."""
    q = rng.integers(0, 4, (qmax, n)).astype(np.int8)
    t = rng.integers(0, 4, (tmax, n)).astype(np.int8)
    rel = np.flatnonzero(rng.random(n) < 0.5)
    for i in rel:
        d = int(rng.integers(w[i] // 2, 2 * w[i] + 1)) \
            if rng.random() < 0.4 else 0
        L = min(qmax, tmax - d)
        if L <= 0:
            continue
        seg = q[:L, i].copy()
        mut = rng.random(L) < 0.03
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        t[d:d + L, i] = seg
    q[rng.random(q.shape) < 0.02] = 4
    t[rng.random(t.shape) < 0.02] = 4
    qlen = rng.integers(1, qmax + 1, n).astype(np.int32)
    tlen = rng.integers(1, tmax + 1, n).astype(np.int32)
    long_ = rng.random(n) < 0.5          # full-length tasks are common
    qlen[long_] = qmax
    tlen[long_] = tmax
    return q, t, qlen, tlen


def random_fused_batch(seed, B, dims, *, n_pad=0, blk_l=512):
    """A fused batch (ql, tl, qr, tr, scal, tmax2) of B lanes, numpy.

    dims = (QL, TL, QR, TR).  The last `n_pad` lanes are padding (all
    scalars 0); among the rest some lanes have no left task, no right
    task, tlen 0 or h0 0, and w varies so both retry outcomes occur."""
    QL, TL, QR, TR = dims
    rng = np.random.default_rng(seed)
    # bwa's default w is 100; narrower bands where the windows are short
    # keep the shifted (retry) lanes inside the target window
    w = rng.integers(4, max(5, min(101, min(TL, TR) // 2)),
                     B).astype(np.int32)
    ql, tl, qlen_l, tlen_l = _task(rng, B, QL, TL, w)
    qr, tr, qlen_r, tlen_r = _task(rng, B, QR, TR, w)
    scal = np.zeros((16, B), np.int32)
    cap = rng.integers(1, 201, B).astype(np.int32)  # max_ins/max_del bound
    scal[0], scal[1] = qlen_l, tlen_l
    scal[2] = np.minimum(w, cap)
    scal[3] = rng.integers(1, 60, B)
    scal[4] = np.minimum(w << 1, cap)
    scal[5], scal[6] = qlen_r, tlen_r
    scal[7] = np.minimum(w, cap)
    scal[8] = np.minimum(w << 1, cap)
    scal[9] = w
    kind = rng.integers(0, 16, B)
    scal[0][kind == 1] = 0                      # no left task
    scal[5][kind == 2] = 0                      # no right task
    scal[1][kind == 3] = 0                      # empty left target
    scal[3][kind == 4] = 0                      # h0 = 0: nothing runs
    scal[6][kind == 5] = 0                      # empty right target
    if n_pad:
        scal[:, B - n_pad:] = 0
    tmax2 = np.stack([_row_bounds(scal[0], scal[1], blk_l),
                      _row_bounds(scal[5], scal[6], blk_l)], 1)
    return ql, tl, qr, tr, scal, tmax2


def _row_bounds(qlen, tlen, blk_l):
    """Per-block row bound: the longest tlen among lanes with qlen > 0."""
    grid = len(qlen) // blk_l
    return np.max(np.where(qlen.reshape(grid, blk_l) > 0,
                           tlen.reshape(grid, blk_l), 0),
                  axis=1).astype(np.int32)


def random_t_batch(seed, B, qmax, tmax, *, n_pad=0, blk_l=512):
    """A per-phase batch (query_t, target_t, scal_t, tmax) of B lanes,
    numpy: (qmax, B) / (tmax, B) int8 windows with N codes, scal_t (8, B)
    int32 = [qlen, tlen, aw, h0, 0...] and the (B/blk_l,) row bounds.
    The last `n_pad` lanes are padding (all scalars 0); among the rest
    some lanes have qlen, tlen or h0 of 0, and the band varies."""
    rng = np.random.default_rng(seed)
    w = rng.integers(4, max(5, min(101, tmax // 2)), B).astype(np.int32)
    q, t, qlen, tlen = _task(rng, B, qmax, tmax, w)
    scal = np.zeros((8, B), np.int32)
    scal[0], scal[1], scal[2] = qlen, tlen, w
    scal[3] = rng.integers(1, 60, B)
    kind = rng.integers(0, 16, B)
    scal[0][kind == 1] = 0                      # no task
    scal[1][kind == 2] = 0                      # empty target
    scal[3][kind == 3] = 0                      # h0 = 0: nothing runs
    if n_pad:
        scal[:, B - n_pad:] = 0
    return q, t, scal, _row_bounds(scal[0], scal[1], blk_l)


def valid_l0_lanes(scal) -> np.ndarray:
    """Lanes whose first task (the fused L0, or the per-phase pass: both
    read qlen, tlen and h0 from scal rows 0, 1 and 3) the scalar oracle
    can run."""
    scal = np.asarray(scal)
    return np.flatnonzero((scal[0] > 0) & (scal[1] > 0) & (scal[3] > 0))


def l0_scalar_mismatches(out, ql, tl, scal, prm, lanes) -> list:
    """Hold fields 0-5 of a result against the scalar bwa-0.7.8 oracle
    bwamem_tpu.ops.extend_ref.ksw_extend_core on `lanes`: the L0 group
    of a fused (32, B) result with its ql, tl and (16, B) scal, or an
    extend_t (8, B) result with its query, target and (8, B) scal
    (numpy inputs; valid lanes, codes 0..4).  Returns the mismatching
    (lane, got, want) triples."""
    a, b, o_del, e_del, o_ins, e_ins, zdrop = prm_ints(prm)
    mat = build_mat(a, b)
    bad = []
    for i in lanes:
        i = int(i)
        want = ksw_extend_core(
            ql[:scal[0, i], i].astype(np.int64),
            tl[:scal[1, i], i].astype(np.int64), mat, o_del, e_del,
            o_ins, e_ins, w=int(scal[2, i]), h0=int(scal[3, i]),
            zdrop=zdrop)
        got = tuple(int(out[f, i]) for f in range(6))
        exp = (want.score, want.qle, want.tle, want.gtle, want.gscore,
               want.max_off)
        if got != exp:
            bad.append((i, got, exp))
    return bad
