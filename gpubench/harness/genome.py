"""A deployment's reference genome, made from its configuration file.

No sequence can be fetched, so the genome is synthetic: the published
length, a random background, and repeat families inserted at the copy
numbers or genome shares the configuration states.  Each family has one
random consensus; each copy takes the consensus (its 3' end, where the
family is 5'-truncated), lies on either strand, and carries
substitutions at a divergence drawn per copy.  The same configuration
always gives the same genome (its own `seed`), as a published reference
is one file.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _copy_lengths(rng, fam, target_bp: int | None) -> np.ndarray:
    """Copy lengths of one family: `copies` of them, or as many as fill
    `target_bp`.  Full-length copies with probability `full_frac`, else
    5'-truncated to `min_len` + an exponential of mean `trunc_mean`."""
    full = fam["length"]
    full_frac = fam.get("full_frac", 1.0)

    def draw(n):
        ln = np.full(n, full, np.int64)
        cut = rng.random(n) >= full_frac
        ln[cut] = np.minimum(
            full, fam.get("min_len", 1)
            + rng.exponential(fam.get("trunc_mean", full), int(cut.sum()))
            .astype(np.int64))
        return ln

    if "copies" in fam:
        return draw(int(fam["copies"]))
    out, total = [], 0
    while total < target_bp:
        ln = draw(4096)
        out.append(ln)
        total += int(ln.sum())
    ln = np.concatenate(out)
    return ln[: int(np.searchsorted(np.cumsum(ln), target_bp)) + 1]


def _family_copies(rng, fam, length: int):
    """(bases, copy lengths) of every copy of one family, concatenated."""
    cons = rng.integers(0, 4, fam["length"]).astype(np.uint8)
    target = int(fam["share"] * length) if "share" in fam else None
    lens = _copy_lengths(rng, fam, target)
    n = len(lens)
    lo, hi = fam["divergence"]
    div = rng.uniform(lo, hi, n)
    rev = rng.random(n) < 0.5
    first = np.repeat(np.cumsum(lens) - lens, lens)
    k = np.arange(int(lens.sum()), dtype=np.int64) - first   # base in copy
    ln = np.repeat(lens, lens)
    r = np.repeat(rev, lens)
    src = np.where(r, ln - 1 - k, k) + (fam["length"] - ln)  # 3' end kept
    bases = cons[src]
    bases = np.where(r, 3 - bases, bases).astype(np.uint8)
    mut = rng.random(len(bases)) < np.repeat(div, lens)
    bases[mut] = (bases[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return bases, lens


def make_genome(spec: dict) -> np.ndarray:
    """The genome of a configuration's `genome` block as 0..3 codes."""
    rng = np.random.default_rng(spec["seed"])
    length = int(spec["length"])
    parts = [_family_copies(rng, fam, length) for fam in spec["families"]]
    bases = (np.concatenate([b for b, _ in parts]) if parts
             else np.zeros(0, np.uint8))
    lens = (np.concatenate([ln for _, ln in parts]) if parts
            else np.zeros(0, np.int64))
    if len(bases) > length // 2:
        raise ValueError("repeat families fill more than half the genome")
    # copies in a random order, between random stretches of background
    order = rng.permutation(len(lens))
    starts = np.cumsum(lens) - lens
    background = rng.integers(0, 4, length - len(bases)).astype(np.uint8)
    cuts = np.sort(rng.integers(0, len(background) + 1, len(lens)))
    pieces, prev = [], 0
    for c, i in zip(cuts, order):
        pieces.append(background[prev:c])
        pieces.append(bases[starts[i]:starts[i] + lens[i]])
        prev = c
    pieces.append(background[prev:])
    genome = np.concatenate(pieces)
    assert len(genome) == length
    return genome


def write_fasta(path: str, name: str, genome: np.ndarray) -> None:
    """FASTA of one contig, 80 bases a line."""
    seq = ACGT[genome]
    full = len(seq) // 80 * 80
    lines = np.empty((full // 80, 81), np.uint8)
    lines[:, :80] = seq[:full].reshape(-1, 80)
    lines[:, 80] = 10
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(lines.tobytes())
        if full < len(seq):
            f.write(seq[full:].tobytes() + b"\n")


def read_fasta_codes(path: str) -> np.ndarray:
    """The 0..3 codes of a one-contig FASTA written by write_fasta."""
    code = np.full(256, 4, np.uint8)
    code[ACGT] = np.arange(4, dtype=np.uint8)
    with open(path, "rb") as f:
        f.readline()
        arr = np.frombuffer(f.read(), np.uint8)
    return code[arr[arr != 10]]
