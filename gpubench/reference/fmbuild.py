"""FM-index construction for the reference aligner.

bwa-0.7.8's index: the BWT of the forward genome followed by its reverse
complement, an implicit terminal sentinel, Occ checkpoints every 64
symbols.  The suffix array comes from a prefix-doubling sort in plain
PyTorch (one `torch.sort` of 64-bit keys a round), run on whatever
device the caller names: on the card it sorts a chr20-scale text in
seconds.  The suffix array is unique, so any correct construction gives
bwa's row order; the sampled suffix array keeps every row (sa_intv 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

OCC_BLOCK = 64  # bases per Occ checkpoint block


def revcomp_codes(seq: np.ndarray) -> np.ndarray:
    """Reverse complement in 0..4 codes (3-c for ACGT, N stays N)."""
    rc = seq[::-1].copy()
    acgt = rc < 4
    rc[acgt] = 3 - rc[acgt]
    return rc


def suffix_array(s: np.ndarray, device="cpu") -> np.ndarray:
    """Suffix array of `s` (codes), implicit terminal sentinel smaller
    than every symbol (a shorter suffix sorts first).  Returns the SA
    without the sentinel row: a permutation of 0..n-1 (int64)."""
    n = len(s)
    if n == 0:
        return np.zeros(0, np.int64)
    sym = torch.from_numpy(np.asarray(s, np.int64)).to(device)
    # ranks start at 1; 0 stands for "past the end of the text"
    rank = torch.empty(n, dtype=torch.int64, device=device)
    key, sa = torch.sort(sym)
    new = torch.ones(n, dtype=torch.int64, device=device)
    new[1:] = (key[1:] != key[:-1]).to(torch.int64)
    rank[sa] = torch.cumsum(new, 0)
    del key, sym
    k = 1
    while int(rank.max()) < n:
        nxt = torch.zeros(n, dtype=torch.int64, device=device)
        nxt[: n - k] = rank[k:]
        key, sa = torch.sort(rank * (n + 1) + nxt)
        del nxt
        new = torch.ones(n, dtype=torch.int64, device=device)
        new[1:] = (key[1:] != key[:-1]).to(torch.int64)
        del key
        rank[sa] = torch.cumsum(new, 0)
        del new
        k *= 2
    out = sa.cpu().numpy()
    del sa, rank
    return out


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


def build_index(pac: np.ndarray, device="cpu") -> FMIndex:
    """The two-strand FM-index of forward genome codes (0..4), the suffix
    sort on `device`."""
    pac = np.asarray(pac, np.uint8)
    l_pac = len(pac)
    text = np.concatenate([pac, revcomp_codes(pac)])
    n2 = len(text)
    sa = suffix_array(text, device)
    # full SA including the sentinel row at index 0
    sa_full = np.empty(n2 + 1, np.int64)
    sa_full[0] = n2
    sa_full[1:] = sa
    del sa
    primary = int(np.flatnonzero(sa_full == 0)[0])
    bwt = text[np.maximum(sa_full - 1, 0)]
    bwt[primary] = 5
    counts = np.bincount(text, minlength=5)
    C = np.zeros(6, np.int64)
    C[0] = 1
    for c in range(1, 6):
        C[c] = C[c - 1] + counts[c - 1]
    del text
    nblocks = (n2 + 1 + OCC_BLOCK - 1) // OCC_BLOCK
    padded = np.full(nblocks * OCC_BLOCK, 5, np.uint8)
    padded[: n2 + 1] = bwt
    blk = padded.reshape(nblocks, OCC_BLOCK)
    occ_cp = np.zeros((5, nblocks + 1), np.int64)
    for c in range(5):
        per = np.count_nonzero(blk == c, axis=1)
        np.cumsum(per, out=occ_cp[c, 1:])
    return FMIndex(
        l_pac=l_pac, seq_len2=n2, primary=primary, C=C, bwt=bwt,
        occ_cp=occ_cp, sa_intv=1, ssa=sa_full, pac=pac)
