"""Reads made from `--seed`, in the manner of wgsim (Heng Li's read
simulator in samtools) under its published defaults.

wgsim first mutates the reference into a haplotype (mutation rate
`mut_rate`, a share `indel_frac` of the mutations indels whose length
grows while a draw is under `indel_ext`; insertions and deletions alike),
then draws fragments of `outer_dist` +- `outer_std` bases at uniform
positions of the haplotype, reads `read_len` bases from each end (read 1
on either strand at random, read 2 from the other end of the fragment,
reverse complemented: FR pairs) and substitutes each base with
probability `base_error`.  Every base gets the quality character `qual`.
A single-end mix keeps read 1 alone.

The benchmark makes a pool of `pool` reads (or pairs) from the seed and
streams it round after round; the reads of a stream are the pool's rows
in order, renamed by their place in the stream.  Every seed gives the
same sizes and the same distributions of positions and errors, only in
another draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
NAME_DIGITS = 10


def haplotype(genome: np.ndarray, mix: dict, rng) -> np.ndarray:
    """wgsim's mutated copy of `genome` (0..3 codes)."""
    n = len(genome)
    n_mut = int(rng.binomial(n, mix["mut_rate"]))
    pos = np.unique(rng.integers(0, n, n_mut))
    indel = rng.random(len(pos)) < mix["indel_frac"]
    hap = genome.copy()
    sub = pos[~indel]
    hap[sub] = (hap[sub] + rng.integers(1, 4, len(sub))) % 4
    ip = pos[indel]
    lens = rng.geometric(1.0 - mix["indel_ext"], len(ip))
    ins = rng.random(len(ip)) < 0.5
    keep = np.ones(n, bool)
    for p, ln in zip(ip[~ins], lens[~ins]):
        keep[p:p + ln] = False
    at = np.repeat(ip[ins], lens[ins])
    vals = rng.integers(0, 4, len(at)).astype(np.uint8)
    hap = np.insert(hap, at, vals)
    keep = np.insert(keep, at, True)
    return hap[keep]


def _errors(reads: np.ndarray, rate: float, rng) -> np.ndarray:
    err = rng.random(reads.shape) < rate
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    return reads


def _revcomp(reads: np.ndarray) -> np.ndarray:
    return (3 - reads[:, ::-1]).astype(np.uint8)


@dataclasses.dataclass
class Pool:
    """The reads of a stream: `ends` holds one (pool, read_len) array of
    0..3 codes per FASTQ file (two for pairs), row i of each the same
    fragment."""

    ends: list
    read_len: int
    qual: str
    prefix: str

    @property
    def size(self) -> int:
        return self.ends[0].shape[0]

    def name(self, g: int) -> str:
        return f"{self.prefix}{g:0{NAME_DIGITS}d}"

    def records(self, end: int) -> tuple[np.ndarray, int]:
        """(pool, record bytes) uint8 FASTQ records of file `end` with the
        name digits blank, and the column where the digits start."""
        L = self.read_len
        head = b"@" + self.prefix.encode()
        width = len(head) + NAME_DIGITS + 1 + L + 3 + L + 1
        rec = np.empty((self.size, width), np.uint8)
        o = 0
        rec[:, :len(head)] = np.frombuffer(head, np.uint8)
        o = len(head) + NAME_DIGITS
        rec[:, o] = 10
        rec[:, o + 1:o + 1 + L] = ACGT[self.ends[end]]
        o += 1 + L
        rec[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, o + 3:o + 3 + L] = ord(self.qual)
        rec[:, -1] = 10
        return rec, len(head)


def make_pool(genome: np.ndarray, mix: dict, seed: int) -> Pool:
    """The pool of a traffic mix drawn from `seed`."""
    rng = np.random.default_rng([seed, 0x77676D])    # "wgm"
    hap = haplotype(genome, mix, rng)
    n, L = int(mix["pool"]), int(mix["read_len"])
    frag = np.rint(rng.normal(mix["outer_dist"], mix["outer_std"], n))
    frag = np.clip(frag, L, None).astype(np.int64)
    start = (rng.random(n) * (len(hap) - frag + 1)).astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(hap, L)   # no copy
    left = win[start]
    right = _revcomp(win[start + frag - L])
    flip = rng.random(n) < 0.5           # read 1 from the reverse strand
    r1 = np.where(flip[:, None], right, left)
    r2 = np.where(flip[:, None], left, right)
    rate = mix["base_error"]
    ends = [_errors(r1, rate, rng)]
    if mix["paired"]:
        ends.append(_errors(r2, rate, rng))
    return Pool(ends=ends, read_len=L, qual=mix["qual"],
                prefix="p" if mix["paired"] else "r")
