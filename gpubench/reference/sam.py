"""SAM record model and writer (bwa mem_aln2sam equivalent output layer)."""

from __future__ import annotations

import dataclasses

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based; 0 = unmapped
    mapq: int
    cigar: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[tuple[str, str, object]] = dataclasses.field(
        default_factory=list)

    def line(self) -> str:
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos),
            str(self.mapq), self.cigar, self.rnext, str(self.pnext),
            str(self.tlen), self.seq, self.qual,
        ]
        for tag, typ, val in self.tags:
            fields.append(f"{tag}:{typ}:{val}")
        return "\t".join(fields)


