"""FM-index construction (the `bwa index` equivalent).

The reference system relies on the stock bwa-0.7.8 index (BWT over the
concatenation of the forward genome and its reverse complement, sampled
suffix array); the FPGA never sees it — seeding runs on host CPU threads
(SURVEY.md §0, §2.1 item 5).  Here the index is built host-side with
numpy and laid out for device residence (packed 2-bit BWT + Occ
checkpoint blocks sized for HBM-friendly gathers, see fmindex.py).

Construction is a vectorized prefix-doubling suffix sort — O(n log^2 n)
but fully numpy-vectorized, good to tens of megabases.  (A C++ SA-IS
for full human genomes is the planned native-code path.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

OCC_BLOCK = 64  # bases per Occ checkpoint block


def revcomp_codes(seq: np.ndarray) -> np.ndarray:
    """Reverse complement in 0..4 codes (3-c for ACGT, N stays N)."""
    rc = seq[::-1].copy()
    acgt = rc < 4
    rc[acgt] = 3 - rc[acgt]
    return rc


def suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array of `s` (codes), implicit terminal sentinel smaller than
    every symbol (shorter-suffix-first tie-break). Returns SA WITHOUT the
    sentinel row, i.e. a permutation of 0..n-1.

    Uses the native linear-time SA-IS (csrc/sais.cpp) when available,
    falling back to vectorized numpy prefix-doubling."""
    n = len(s)
    if n == 0:
        return np.zeros(0, np.int64)
    from bwamem_tpu_torch import native

    sa = native.sais_u8(np.asarray(s, np.uint8))
    if sa is not None:
        return sa
    rank = np.asarray(s, np.int64)
    sa = np.argsort(rank, kind="stable")
    r = np.empty(n, np.int64)
    r[sa] = np.concatenate([[0], np.cumsum(rank[sa][1:] != rank[sa][:-1])])
    rank = r
    k = 1
    while rank[sa[-1]] != n - 1:
        rank2 = np.full(n, -1, np.int64)
        rank2[: n - k] = rank[k:]
        sa = np.lexsort((rank2, rank))
        a, b = rank[sa], rank2[sa]
        changed = np.concatenate(
            [[0], ((a[1:] != a[:-1]) | (b[1:] != b[:-1])).astype(np.int64)])
        r = np.empty(n, np.int64)
        r[sa] = np.cumsum(changed)
        rank = r
        k *= 2
    return sa


@dataclasses.dataclass
class FMIndex:
    """Two-strand FM-index, bwa-style (text = forward ++ revcomp(forward)).

    SA space has seq_len2+1 rows (the sentinel row included); `primary` is
    the row whose suffix is the whole text (BWT char = sentinel there).
    """

    l_pac: int            # forward genome length
    seq_len2: int         # 2 * l_pac
    primary: int
    C: np.ndarray         # (6,) int64: C[c] = 1 + #{chars < c}; C[5] = total+1
    bwt: np.ndarray       # (seq_len2+1,) uint8 codes, 5 at the primary row
    occ_cp: np.ndarray    # (5, nblocks+1) int64 checkpoint ranks per OCC_BLOCK
    sa_intv: int
    ssa: np.ndarray       # sampled SA: ssa[r // sa_intv] for r % sa_intv == 0
    pac: np.ndarray       # (l_pac,) uint8 forward genome codes (0..4)

    def rank(self, c: int, i: int) -> int:
        """# occurrences of c in bwt[0:i) (the primary row never counts)."""
        blk = i // OCC_BLOCK
        base = int(self.occ_cp[c, blk])
        rem = np.count_nonzero(self.bwt[blk * OCC_BLOCK : i] == c)
        return base + int(rem)

    def rank2(self, c: int, lo: int, hi: int) -> tuple[int, int]:
        return self.rank(c, lo), self.rank(c, hi)

    def sa_value(self, r: int) -> int:
        """Invert the BWT: text position of the suffix at SA row r
        (bwa's bwt_sa LF-walk to the nearest sampled row)."""
        d = 0
        while True:
            if r == self.primary:
                return d
            if r % self.sa_intv == 0:
                return int(self.ssa[r // self.sa_intv]) + d
            c = int(self.bwt[r])
            r = int(self.C[c]) + self.rank(c, r)
            d += 1


def build_index(pac: np.ndarray, sa_intv: int = 8) -> FMIndex:
    """Build the two-strand FM-index from forward genome codes (0..4).

    Ns (code 4) participate as a 5th symbol in the suffix sort but SMEM
    search never extends through them (bwa skips non-ACGT in the query;
    reference segments with N never produce exact seed matches because a
    read base 0..3 != 4).
    """
    pac = np.asarray(pac, np.uint8)
    l_pac = len(pac)
    text = np.concatenate([pac, revcomp_codes(pac)])
    n2 = len(text)
    from bwamem_tpu_torch import native

    nb = native.sais_bwt_u8(text, sa_intv)
    if nb is not None:
        # packed 40-bit SA-IS emitting bwt/ssa directly: ~8.3 bytes/
        # symbol peak — the path that fits a GRCh38-scale (6.2 Gsym)
        # two-strand build on a 125 GB host
        bwt, ssa, primary = nb
    else:
        sa = suffix_array(text)
        # full SA including the sentinel row at index 0
        sa_full = np.concatenate([[n2], sa]).astype(np.int64)
        del sa
        # BWT: char preceding each suffix; sentinel (code 5) at the
        # primary row.  Chunked so no second int64 index array coexists
        # with the SA (at scale `sa_full - 1` alone is another 50 GB)
        primary = int(np.nonzero(sa_full == 0)[0][0])
        bwt = np.empty(n2 + 1, np.uint8)
        CH = 1 << 26
        for i0 in range(0, n2 + 1, CH):
            sl = sa_full[i0:i0 + CH] - 1
            np.maximum(sl, 0, out=sl)  # primary's placeholder
            bwt[i0:i0 + CH] = text[sl]
        bwt[primary] = 5
        # sampled SA at row multiples of sa_intv; the full SA (the
        # largest allocation, 8 bytes/row) must not coexist with the
        # Occ temporaries below
        ssa = sa_full[::sa_intv].copy()
        del sa_full
    # C array over codes 0..4 (sentinel occupies rank 0)
    counts = np.bincount(text, minlength=5)
    C = np.zeros(6, np.int64)
    C[0] = 1
    for c in range(1, 6):
        C[c] = C[c - 1] + counts[c - 1]
    del text
    # Occ checkpoints, built in bounded-memory chunks (a whole-array
    # int64 cumsum is 8 bytes/symbol — 50 GB at GRCh38 scale)
    nblocks = (n2 + 1 + OCC_BLOCK - 1) // OCC_BLOCK
    occ_cp = np.zeros((5, nblocks + 1), np.int64)
    CHUNK_BLOCKS = 1 << 20  # 64 Msymbols per chunk
    base = np.zeros(5, np.int64)
    for b0 in range(0, nblocks, CHUNK_BLOCKS):
        b1 = min(b0 + CHUNK_BLOCKS, nblocks)
        s0, s1 = b0 * OCC_BLOCK, min(b1 * OCC_BLOCK, n2 + 1)
        span = bwt[s0:s1]
        pad = b1 * OCC_BLOCK - s0 - len(span)
        if pad:
            span = np.concatenate([span, np.full(pad, 5, np.uint8)])
        blk = span.reshape(b1 - b0, OCC_BLOCK)
        for c in range(5):
            per = np.count_nonzero(blk == c, axis=1)
            occ_cp[c, b0:b1] = base[c] + np.concatenate(
                [[0], np.cumsum(per[:-1])])
            base[c] += int(per.sum())
    occ_cp[:, nblocks] = base
    return FMIndex(
        l_pac=l_pac, seq_len2=n2, primary=primary, C=C, bwt=bwt,
        occ_cp=occ_cp, sa_intv=sa_intv, ssa=ssa, pac=pac)
