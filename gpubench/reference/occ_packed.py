"""Packed-BWT rank structures for batched (vectorized) FM-index queries.

The scalar FMIndex.rank counts a byte slice per query — fine for tests,
hopeless for millions of reads.  This module packs the BWT into 2-bit
lanes (16 symbols per uint32 word, 4 words per 64-symbol Occ block) so
a rank query is: one row-gather of the block's checkpoint counts, one
row-gather of its 4 packed words, then branch-free SWAR popcounts.
Every operation vectorizes over arbitrarily many simultaneous queries,
in numpy.

This is the TPU-native analogue of the reference host's occ table; the
FPGA never sees the index (seeding is host-side in the reference too,
SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .fmbuild import OCC_BLOCK, FMIndex

WORD_SYMS = 16  # 2-bit symbols per uint32
BLOCK_WORDS = OCC_BLOCK // WORD_SYMS  # 4


@dataclasses.dataclass
class PackedOcc:
    """Device-layout rank structures.

    occ_rows: (NB+1, 4) int32 — checkpoint ranks per 64-symbol block
    pk_rows:  (NB+1, 4) uint32 — 2-bit packed symbols (lane j = bits
              [2j, 2j+1], symbol index within block = 16*word + lane)
    va_rows:  (NB+1, 4) uint32 — 0b01 lanes where the symbol is A/C/G/T
    """

    occ_rows: np.ndarray
    pk_rows: np.ndarray
    va_rows: np.ndarray
    C: np.ndarray          # (6,) int64
    primary: int
    n_rows: int            # seq_len2 + 1


def pack_occ(fm: FMIndex) -> PackedOcc:
    n = len(fm.bwt)
    nb = (n + OCC_BLOCK - 1) // OCC_BLOCK
    shifts = (2 * np.arange(WORD_SYMS, dtype=np.uint32))
    pk = np.empty(nb * BLOCK_WORDS, np.uint32)
    va = np.empty(nb * BLOCK_WORDS, np.uint32)
    # chunked packing: the uint32 lane expansion is 4 bytes/symbol and
    # three temporaries wide — 75 GB at GRCh38 scale if done whole-array
    CHUNK = 1 << 26  # symbols per chunk (multiple of OCC_BLOCK)
    for s0 in range(0, nb * OCC_BLOCK, CHUNK):
        s1 = min(s0 + CHUNK, nb * OCC_BLOCK)
        span = fm.bwt[s0:min(s1, n)]
        if s1 > n:
            span = np.concatenate([span, np.full(s1 - max(s0, n), 5,
                                                 np.uint8)])
        lanes = span.reshape(-1, WORD_SYMS).astype(np.uint32)
        valid = (lanes < 4).astype(np.uint32)
        codes = np.where(valid, lanes, 0)
        w0 = s0 // WORD_SYMS
        pk[w0:w0 + lanes.shape[0]] = (codes << shifts).sum(
            axis=1, dtype=np.uint32)
        va[w0:w0 + lanes.shape[0]] = (valid << shifts).sum(
            axis=1, dtype=np.uint32)
    # int32 checkpoint ranks cap per-symbol counts at 2^31-1: fine up
    # to ~8.6 Gsym of balanced two-strand text (GRCh38 is 6.2 Gsym with
    # counts ~1.55e9) — fail loudly rather than overflow silently
    if int(fm.occ_cp[:4].max()) >= (1 << 31):
        raise OverflowError(
            "occ checkpoint exceeds int32 — reference too large for "
            "the packed rank layout")
    occ_rows = np.ascontiguousarray(fm.occ_cp[:4].T).astype(np.int32)
    if occ_rows.shape[0] < nb + 1:
        occ_rows = np.pad(occ_rows,
                          ((0, nb + 1 - occ_rows.shape[0]), (0, 0)),
                          mode="edge")
    return PackedOcc(
        occ_rows=occ_rows,
        pk_rows=pk.reshape(nb, BLOCK_WORDS),
        va_rows=va.reshape(nb, BLOCK_WORDS),
        C=fm.C.copy(),
        primary=fm.primary,
        n_rows=n,
    )


def _popcount32(x):
    """Branch-free SWAR popcount of uint32 numpy arrays (the product
    wraps at 32 bits)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def block_counts(words, vals, r):
    """Per-symbol counts of the first r (0..64) symbols of one Occ
    block.  words/vals: (..., 4) uint32 packed lanes; r: (...,) int.
    Returns (..., 4) int32 counts WITHIN the block (no checkpoint
    added), for rank4 below."""
    wi = np.arange(BLOCK_WORDS, dtype=r.dtype)
    nsym = np.clip(r[..., None] - WORD_SYMS * wi, 0, WORD_SYMS)
    full = nsym >= WORD_SYMS
    pmask = np.where(
        full,
        np.uint32(0xFFFFFFFF),
        (np.uint32(1) << (2 * nsym).astype(np.uint32)) - np.uint32(1))
    counts = []
    for c in range(4):
        pat = np.uint32(c * 0x55555555)
        t = words ^ pat
        q = (~t) & ((~t) >> 1) & np.uint32(0x55555555)
        q = q & vals & pmask
        counts.append(_popcount32(q).sum(axis=-1))
    return np.stack(counts, axis=-1).astype(np.int32)


def rank4(po: PackedOcc, i):
    """Counts of each character 0..3 in bwt[0:i) for a batch of positions.

    i: integer array of any shape (values in [0, n_rows]); returns
    (..., 4) int32.
    """
    i = np.asarray(i)
    blk = i // OCC_BLOCK
    r = i - blk * OCC_BLOCK                       # 0..63
    base = np.asarray(po.occ_rows)[blk]           # (..., 4)
    words = np.asarray(po.pk_rows)[blk]           # (..., 4) uint32
    vals = np.asarray(po.va_rows)[blk]            # (..., 4) uint32
    return block_counts(words, vals, r) + base


def extend_backward4(po: PackedOcc, x0, x1, s):
    """Batched bwt_extend (is_back=1): all 4 backward extensions of the
    bi-intervals (x0, x1, s).  Shapes: x0/x1/s (...,); returns
    (nx0, nx1, ns) each (..., 4)."""
    x0 = np.asarray(x0)
    tk = rank4(po, x0)                    # (..., 4)
    tl = rank4(po, x0 + s)
    ns = tl - tk
    wi = np.int64
    C4 = np.asarray(po.C)[:4].astype(wi)
    nx0 = C4 + tk
    has_sent = ((x0 <= po.primary) & (po.primary < x0 + s)).astype(ns.dtype)
    nx1_3 = np.asarray(x1) + has_sent
    nx1_2 = nx1_3 + ns[..., 3]
    nx1_1 = nx1_2 + ns[..., 2]
    nx1_0 = nx1_1 + ns[..., 1]
    nx1 = np.stack([nx1_0, nx1_1, nx1_2, nx1_3], axis=-1)
    return nx0.astype(wi), nx1.astype(wi), ns.astype(wi)


def sa_value_batch(po: PackedOcc, ssa: np.ndarray, sa_intv: int,
                   rows: np.ndarray) -> np.ndarray:
    """Batched bwt_sa: text positions for a batch of SA rows via masked
    lockstep LF-walks (each <= sa_intv steps)."""
    r = np.asarray(rows).astype(np.int64).copy()
    d = np.zeros_like(r)
    val = np.zeros_like(r)
    done = np.zeros(r.shape, bool)
    ssa = np.asarray(ssa)
    # row-sampled SA walks are only EXPECTED to take ~sa_intv steps;
    # individual walks can be much longer — iterate until all resolve
    for _ in range(po.n_rows + 1):
        hitp = ~done & (r == po.primary)
        val = np.where(hitp, d, val)
        done = done | hitp
        sampled = ~done & (r % sa_intv == 0)
        val = np.where(sampled, ssa[(r // sa_intv) % len(ssa)] + d, val)
        done = done | sampled
        if bool(done.all()):
            break
        # LF step for the rest: symbol at row r from the packed words
        blk = r // OCC_BLOCK
        off = r - blk * OCC_BLOCK
        w = np.asarray(po.pk_rows)[blk, off // WORD_SYMS]
        lane = (off % WORD_SYMS).astype(np.uint32)
        sym = (w >> (2 * lane)) & 3
        vbit = (np.asarray(po.va_rows)[blk, off // WORD_SYMS]
                >> (2 * lane)) & 1
        c = np.where(vbit == 1, sym.astype(np.int64), 4)
        rk4 = rank4(po, r)
        rankc = np.take_along_axis(
            rk4, np.minimum(c, 3)[..., None].astype(np.int64),
            axis=-1)[..., 0]
        n_before = r - rk4.sum(axis=-1) - (po.primary < r)
        rankc = np.where(c == 4, n_before, rankc)
        Carr = np.asarray(po.C)
        newr = Carr[np.minimum(c, 4)] + rankc
        r = np.where(done, r, newr)
        d = np.where(done, d, d + 1)
    return val
