"""Reference parsing and encoding (the bwa bntseq/pac equivalent).

Multi-contig FASTA -> one concatenated 0..4-coded array (`pac`) plus
per-contig annotations; two-strand coordinates [0, 2*l_pac) follow bwa:
positions >= l_pac are on the reverse-complement strand, converted back
with pos' = 2*l_pac - 1 - pos (bns_depos).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_CODE = np.full(256, 4, np.uint8)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i
_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode_seq(codes: np.ndarray) -> str:
    return _CHARS[np.minimum(codes, 4)].tobytes().decode()


@dataclasses.dataclass
class Contig:
    name: str
    offset: int
    length: int


@dataclasses.dataclass
class Reference:
    """Concatenated genome (bwa bntseq_t + pac)."""

    contigs: list[Contig]
    pac: np.ndarray  # (l_pac,) uint8 codes 0..4

    @property
    def l_pac(self) -> int:
        return len(self.pac)

    def depos(self, pos: int) -> tuple[int, bool]:
        """Two-strand coordinate -> (forward coordinate, is_rev)
        (bns_depos)."""
        if pos >= self.l_pac:
            return (self.l_pac << 1) - 1 - pos, True
        return pos, False

    def pos2rid(self, pos: int) -> int:
        """Forward coordinate -> contig index (bns_pos2rid); -1 if the
        position is outside every contig (shouldn't happen for valid
        alignments)."""
        for i, c in enumerate(self.contigs):
            if c.offset <= pos < c.offset + c.length:
                return i
        return -1

    def contig_window(self, pos: int) -> tuple[int, int]:
        """Two-strand coordinate bounds of the contig containing `pos`
        (bns_fetch_seq's one-contig restriction)."""
        l2 = self.l_pac << 1
        if pos < self.l_pac:
            c = self.contigs[self.pos2rid(pos)]
            return c.offset, c.offset + c.length
        c = self.contigs[self.pos2rid(l2 - 1 - pos)]
        return l2 - (c.offset + c.length), l2 - c.offset

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Fetch [beg, end) in two-strand coordinates (bns_get_seq);
        requires the range to not cross the strand boundary."""
        l2 = self.l_pac << 1
        assert 0 <= beg <= end <= l2
        assert end <= self.l_pac or beg >= self.l_pac, "crosses strand boundary"
        if end <= self.l_pac:
            return self.pac[beg:end].copy()
        rc = self.pac[l2 - end: l2 - beg][::-1].copy()
        acgt = rc < 4
        rc[acgt] = 3 - rc[acgt]
        return rc


