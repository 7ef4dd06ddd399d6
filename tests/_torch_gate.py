"""Correctness gate inputs for the extension kernels: seeded random
batches that reach every branch of the fused and the per-phase kernel, a
batch of hard cases built for the cooperating-threads pass (strip edges,
long gaps, ties, trims), and the check of one pass's fields against the
scalar bwa-0.7.8 oracle (the port's own numpy `ksw_extend_core`).  For
the seeding kernels: a contig made to overflow their slots and a read
batch over it.
Shared by the tests of the port and chip_smoke.py (which puts this
directory on sys.path); imports numpy and the port only."""

from __future__ import annotations

import numpy as np

from bwamem_tpu_torch.config import build_mat
from bwamem_tpu_torch.ops.extend_ref import ksw_extend_core
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


HARD_QLENS = (1, 31, 32, 33, 100, 150, 1023, 1024)
HARD_AWS = (1, 2, 100)


def _hard_cases(rng, qmax, tmax):
    """The hard cases as (query, target, tlen, aw, h0) tuples: 1-D code
    arrays with len(query) <= qmax and len(target) <= tmax; tlen may
    exceed len(target) (rows past the window re-read its last row)."""
    cases = []

    def rand(n):
        return rng.integers(0, 4, n).astype(np.int8)

    def fit(t):
        return t[:tmax]

    for qlen in (n for n in HARD_QLENS if n <= qmax):
        for aw in HARD_AWS:
            q = rand(qlen)
            # the query itself, then a random tail
            cases.append((q, fit(np.concatenate([q, rand(40)])), None, aw,
                          int(rng.integers(1, 80))))
            # three substitutions and an N on each side
            t = np.concatenate([q, rand(24)])
            for k in rng.integers(0, qlen, 3):
                t[k] = (t[k] + 1) & 3
            t[rng.integers(0, len(t))] = 4
            qn = q.copy()
            qn[rng.integers(0, qlen)] = 4
            cases.append((qn, fit(t), None, aw, int(rng.integers(20, 60))))
            if qlen < 100:
                continue
            for gap in (7, 23, 41):
                cut = int(rng.integers(20, qlen - gap - 20))
                # long insertion: the query holds `gap` bases the target
                # lacks, so F runs along the row across several strips
                t = np.concatenate([q[:cut], q[cut + gap:], rand(16)])
                cases.append((q, fit(t), None, aw, 90))
                # long deletion: the target holds `gap` bases more, so E
                # runs down the column across as many rows
                t = np.concatenate([q[:cut], rand(gap), q[cut:], rand(16)])
                cases.append((q, fit(t), None, aw, 90))
    # row-maximum ties that sweep across every strip edge: a query of
    # period p against itself, where the diagonal shifted by p starts
    # oe_ins + p - 1 + a lower and the main diagonal loses exactly that
    # to m substitutions among its first p columns (a + b = 5 each):
    # from row p on, columns i and i + p tie, and the larger wins
    for p_, m in ((4, 2), (9, 3), (14, 4)):
        for qlen in (n for n in (33, 100, 150, 1024) if n <= qmax):
            unit = np.resize(np.arange(4, dtype=np.int8), p_)
            unit[p_ - 1] = (unit[0] + 2) & 3    # no shorter period
            t = np.resize(unit, min(qlen + 20, tmax))
            q = np.resize(unit, qlen)
            q[:m] = (q[:m] + 1) & 3
            cases.append((q, t, None, 100, 50))
    for qlen in (n for n in (100, 150, 1024) if n <= qmax):
        # Z-drop stop: a narrow band cannot follow the vertical gap, so
        # after the matching prefix the diagonal falls b per row
        q = rand(qlen)
        t = fit(np.concatenate([q[:qlen // 2], rand(tmax)]))
        cases.append((q, t, None, 2, 40))
        cases.append((q, t, None, 100, 40))
        # tlen beyond the target window: rows past it re-read its last
        # row while the band [i - aw, qlen) is still open
        t = fit(np.concatenate([q, rand(tmax)]))
        cases.append((q, t, tmax + 24, 100, 60))
        # all N on one side
        cases.append((np.full(qlen, 4, np.int8), t, None, 100, 30))
        cases.append((q, np.full(len(t), 4, np.int8), None, 100, 30))
    q = rand(min(150, qmax))
    t = fit(np.concatenate([q, rand(30)]))
    cases.append((q[:0], t, None, 100, 30))        # empty query
    cases.append((q, t, 0, 100, 30))               # empty target
    cases.append((q, t, None, 100, 0))             # h0 = 0
    return cases


def hard_t_batch(seed, qmax, tmax=None, *, blk_l=128):
    """The hard cases as a per-phase batch (query_t, target_t, scal_t,
    bounds), numpy, in a query window of qmax columns (cases longer than
    it are left out) and a target window of tmax rows (qmax + 64 if not
    given); the lane count is padded to a multiple of blk_l with empty
    lanes.  The cases: qlen in HARD_QLENS x aw in HARD_AWS, each as an
    exact copy and with substitutions and N codes; long insertions and
    deletions; row-maximum ties on both sides of every strip edge; a
    Z-drop stop; tlen beyond the target window; all-N windows; empty
    and h0 = 0 lanes."""
    tmax = tmax or qmax + 64
    cases = _hard_cases(np.random.default_rng(seed), qmax, tmax)
    B = -(-len(cases) // blk_l) * blk_l
    q = np.zeros((qmax, B), np.int8)
    t = np.zeros((tmax, B), np.int8)
    scal = np.zeros((8, B), np.int32)
    for i, (qc, tc, tlen, aw, h0) in enumerate(cases):
        q[:len(qc), i] = qc
        t[:len(tc), i] = tc
        t[len(tc):, i] = tc[-1] if len(tc) else 0
        scal[:4, i] = (len(qc), len(tc) if tlen is None else tlen, aw, h0)
    return q, t, scal, _row_bounds(scal[0], scal[1], blk_l)


def hard_fused_batch(seed, qmax, tmax=None, *, blk_l=128):
    """The hard cases as a fused batch (ql, tl, qr, tr, scal, tmax2):
    the left side is hard_t_batch(seed), the right side the same cases
    from another seed in reversed lane order, so every case meets an
    unrelated one and is seeded with its left score; w is the case's
    band, so the long gaps take the retry at twice the band."""
    ql, tl, sl, _ = hard_t_batch(seed, qmax, tmax, blk_l=blk_l)
    qr, tr, sr, _ = hard_t_batch(seed + 1, qmax, tmax, blk_l=blk_l)
    n = int((sl[3] > 0).sum() + 2)           # the cases, without padding
    rev = np.arange(ql.shape[1])
    rev[:n] = rev[:n][::-1]
    qr, tr, sr = qr[:, rev], tr[:, rev], sr[:, rev]
    scal = np.zeros((16, ql.shape[1]), np.int32)
    scal[0], scal[1], scal[2], scal[3] = sl[0], sl[1], sl[2], sl[3]
    scal[4] = sl[2] << 1
    scal[5], scal[6], scal[7] = sr[0], sr[1], sr[2]
    scal[8] = sr[2] << 1
    scal[9] = np.maximum(sl[2], sr[2])
    tmax2 = np.stack([_row_bounds(scal[0], scal[1], blk_l),
                      _row_bounds(scal[5], scal[6], blk_l)], 1)
    return (ql, tl, np.ascontiguousarray(qr), np.ascontiguousarray(tr),
            scal, tmax2)


def capacity_t_batch(seed=9):
    """The reference hardware's caps as one per-phase batch (the JAX
    package's tests/test_extend_pallas.py:130): 8 lanes, qlen 255 in a
    256-column window, tlen 2047 in a 2048-row window, the query equal to
    the target's prefix, band 100, h0 100.  Returns the (256, 8) /
    (2048, 8) int8 windows, the (8, 8) scalars and the row bound."""
    QM, TM, B = 256, 2048, 8
    rng = np.random.default_rng(seed)
    query = rng.integers(0, 4, (B, QM)).astype(np.int32)
    target = np.zeros((B, TM), np.int32)
    target[:, :QM] = query
    target[:, QM:] = rng.integers(0, 4, (B, TM - QM))
    scal = np.zeros((8, B), np.int32)
    scal[:4] = [[255] * B, [2047] * B, [100] * B, [100] * B]
    return (np.ascontiguousarray(query.T, np.int8),
            np.ascontiguousarray(target.T, np.int8), scal,
            np.array([2047], np.int32))


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
    (numpy inputs; valid lanes, codes 0..4; target rows past the window
    re-read its last row, as the kernels do).  Returns the mismatching
    (lane, got, want) triples."""
    a, b, o_del, e_del, o_ins, e_ins, zdrop = prm_ints(prm)
    mat = build_mat(a, b)
    bad = []
    for i in lanes:
        i = int(i)
        rows = np.minimum(np.arange(scal[1, i]), tl.shape[0] - 1)
        want = ksw_extend_core(
            ql[:scal[0, i], i].astype(np.int64),
            tl[rows, i].astype(np.int64), mat, o_del, e_del,
            o_ins, e_ins, w=int(scal[2, i]), h0=int(scal[3, i]),
            zdrop=zdrop)
        got = tuple(int(out[f, i]) for f in range(6))
        exp = (want.score, want.qle, want.tle, want.gtle, want.gscore,
               want.max_off)
        if got != exp:
            bad.append((i, got, exp))
    return bad


def overflow_contig(rng, n_rep=1100):
    """A contig made to overflow the seeding slots: runs A^k of every k in
    1..40, each ended by a random C, G or T (an all-A read then meets more
    than 24 distinct interval sizes), and a 40 bp segment repeated n_rep
    times (past -c 500 its occurrences are subsampled).  Returns the two
    parts as int64 codes."""
    hp = np.concatenate([np.r_[np.zeros(k, np.int64), rng.integers(1, 4, 1)]
                         for k in range(1, 41)])
    return hp, np.tile(rng.integers(0, 4, 40), n_rep)


def seed_gate_reads(rng, genome, hp, rep, n, read_len=150):
    """Reads for the seeding gate over a genome and the overflow contig
    (hp, rep): all-A reads and reads of the homopolymer runs, 16 reads of
    the repeat, all-N reads, reads with N runs (interior, at either end,
    one base, nearly all), reads shorter than -k (1..18 bases), then reads
    of the genome with 1% substitutions, every other one
    reverse-complemented, to n reads in all.  int64 codes, N = 4."""
    L = read_len
    span = np.arange(L)

    def from_genome(n):
        pos = rng.integers(0, len(genome) - L, n)
        R = genome[pos[:, None] + span].astype(np.int64)
        mut = rng.random(R.shape) < 0.01
        R[mut] = rng.integers(0, 4, int(mut.sum()))
        R[1::2] = 3 - R[1::2, ::-1]
        return list(R)

    reads = [np.zeros(L, np.int64), np.zeros(2 * L // 5, np.int64)]
    reads += [hp[o:o + L] for o in range(0, len(hp) - L, 97)]
    reads += [rep[o:o + L] for o in rng.integers(0, len(rep) - L, 16)]
    reads += [np.full(L, 4, np.int64), np.full(L // 4, 4, np.int64)]
    runs = ((4 * L // 15, 7 * L // 15), (4 * L // 5, L), (0, L // 15),
            (L // 2, L // 2 + 1), (L // 15, 14 * L // 15), (1, L - 1))
    for r, (a, b) in zip(from_genome(len(runs)), runs):
        r[a:b] = 4
        reads.append(r)
    reads += [g[:k] for g, k in zip(from_genome(18), range(1, 19))]
    if n < len(reads):
        raise ValueError(f"{n} reads asked for, {len(reads)} made to order")
    return reads + from_genome(n - len(reads))


def read_matrix(reads):
    """(B, L) uint8 codes padded with 4 and (B,) int64 lengths."""
    qlen = np.array([len(r) for r in reads], np.int64)
    mat = np.full((len(reads), max(int(qlen.max(initial=0)), 1)), 4,
                  np.uint8)
    for b, r in enumerate(reads):
        mat[b, :len(r)] = r
    return mat, qlen
