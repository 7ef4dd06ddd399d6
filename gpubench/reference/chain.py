"""Seed chaining — bwa-0.7.8 `mem_chain` / `mem_chain_flt` semantics.

The reference system runs this stage on host CPU threads (the FPGA only
accelerates extension — SURVEY.md §0); we keep it host-side too, numpy/
python scalar first (the golden twin), with the batched-vectorized
version following the same semantics.

Algorithm (mem.c of bwa-0.7.8):
  * seeds = (rbeg, qbeg, len) triples enumerated from SMEM intervals'
    suffix-array positions (subsampled to max_occ with stride s/max_occ),
  * greedy chain insertion: each seed merges into the chain whose anchor
    position (first seed rbeg) is the closest one <= seed.rbeg iff it is
    colinear within band w and gap < max_chain_gap on both query and
    reference, not crossing the forward/reverse strand boundary;
    otherwise it opens a new chain,
  * chain weight = min(query coverage, reference coverage) of its seeds,
  * filtering: sort by weight desc, drop chains lighter than
    drop_ratio * best weight or shorter than min_seed_len, and mask
    chains whose query span overlaps a kept chain by >= mask_level of
    the shorter span (the shadowed chain is remembered for MAPQ/XS).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from .config import MemOptions
from .fmbuild import FMIndex


@dataclasses.dataclass
class Seed:
    rbeg: int   # two-strand reference coordinate [0, 2*l_pac)
    qbeg: int
    len: int

    @property
    def qend(self) -> int:
        return self.qbeg + self.len

    @property
    def rend(self) -> int:
        return self.rbeg + self.len


@dataclasses.dataclass
class Chain:
    seeds: list[Seed]
    pos: int            # anchor = first seed rbeg (the B-tree key in bwa)
    w: int = 0          # weight, filled by weight()
    first_shadow: int = -1  # index of first chain shadowed by this one
    kept: bool = True

    @property
    def qbeg(self) -> int:
        return self.seeds[0].qbeg

    @property
    def qend(self) -> int:
        return self.seeds[-1].qend

    @property
    def rbeg(self) -> int:
        return self.seeds[0].rbeg

    @property
    def rend(self) -> int:
        return self.seeds[-1].rend


def _test_and_merge(opt: MemOptions, l_pac: int, c: Chain, s: Seed) -> bool:
    """bwa test_and_merge: True if the seed is contained in / merged into
    chain c; False requests a new chain."""
    last = c.seeds[-1]
    qend, rend = last.qend, last.rend
    # bwa requires FULL containment (p->qbeg + p->len <= qend etc.): a
    # colinear seed merely starting inside the chain must still be
    # appended, not discarded
    if (s.rbeg >= c.seeds[0].rbeg and s.qbeg >= c.seeds[0].qbeg
            and s.qend <= qend and s.rend <= rend):
        return True  # contained seed, do nothing
    # don't chain across the forward/reverse strand boundary
    if (c.seeds[0].rbeg < l_pac or last.rbeg < l_pac) and s.rbeg >= l_pac:
        return False
    x = s.qbeg - last.qbeg  # non-negative (seeds arrive sorted by qbeg)
    y = s.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(s)
        return True
    return False


def chain_seeds(opt: MemOptions, l_pac: int, seeds: list[Seed]) -> list[Chain]:
    """Greedy insertion keyed by anchor rbeg (bwa's kbtree lower-bound)."""
    chains: list[Chain] = []
    keys: list[tuple[int, int]] = []  # sorted (pos, insertion_id) keys
    for s in seeds:
        merged = False
        # the chain with the largest pos <= s.rbeg
        idx = bisect.bisect_right(keys, (s.rbeg, 1 << 60)) - 1
        if idx >= 0:
            merged = _test_and_merge(opt, l_pac, _chain_at(chains, keys, idx), s)
        if not merged:
            c = Chain(seeds=[s], pos=s.rbeg)
            bisect.insort(keys, (s.rbeg, len(chains)))
            chains.append(c)
    return chains


def _chain_at(chains: list[Chain], keys: list[tuple[int, int]], idx: int
              ) -> Chain:
    return chains[keys[idx][1]]


def chain_weight(c: Chain) -> int:
    """min(query coverage, reference coverage) — bwa mem_chain_weight."""
    w_q = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w_q += s.len
        elif s.qend > end:
            w_q += s.qend - end
        end = max(end, s.qend)
    w_r = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w_r += s.len
        elif s.rend > end:
            w_r += s.rend - end
        end = max(end, s.rend)
    return min(w_q, w_r)


def filter_chains(opt: MemOptions, chains: list[Chain]) -> list[Chain]:
    """mem_chain_flt: weight sort + overlap filtering.

    An overlapping chain is only dropped when it is SIGNIFICANTLY weaker
    than the kept chain it overlaps (w_i < w_j * drop_ratio and
    w_j - w_i >= 2*min_seed_len); equal-strength chains at duplicated
    loci are all kept — that is what makes repeats end up with MAPQ 0.
    The first shadowed-but-kept competitor is remembered (a[j].first)."""
    if not chains:
        return []
    for c in chains:
        c.w = chain_weight(c)
    chains = sorted(chains, key=lambda c: (-c.w, c.pos))
    kept: list[Chain] = [chains[0]]
    for i, c in enumerate(chains[1:], start=1):
        drop = False
        for k in kept:
            b_max = max(k.qbeg, c.qbeg)
            e_min = min(k.qend, c.qend)
            if e_min > b_max:  # overlap on the query
                min_l = min(c.qend - c.qbeg, k.qend - k.qbeg)
                if (e_min - b_max >= min_l * opt.mask_level
                        and min_l < opt.max_chain_gap):
                    if k.first_shadow < 0:
                        k.first_shadow = i
                    if (c.w < k.w * opt.drop_ratio
                            and k.w - c.w >= opt.min_seed_len * 2):
                        drop = True
                        break
        if drop:
            c.kept = False
        else:
            kept.append(c)
    return kept


def collect_seeds_batch(fm: FMIndex, po, reads: list[np.ndarray],
                        opt: MemOptions) -> list[list[Seed]]:
    """Positioned seeds of every read (the mem_chain seeding loop):
    batched SMEM search + one batched SA lookup for every occurrence,
    subsampled to max_occ with stride s // max_occ."""
    from .occ_packed import sa_value_batch
    from .smem_batch import collect_smems_batch

    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    memss = collect_smems_batch(po, fm, reads, opt.min_seed_len,
                                split_len, opt.split_width)
    rows: list[int] = []
    meta: list[tuple[int, int, int]] = []
    for b, mems in enumerate(memss):
        for m in mems:
            step = m.s // opt.max_occ if m.s > opt.max_occ else 1
            k = 0
            count = 0
            while k < m.s and count < opt.max_occ:
                rows.append(m.x0 + k)
                meta.append((b, m.qb, m.qlen))
                k += step
                count += 1
    seeds: list[list[Seed]] = [[] for _ in reads]
    if rows:
        vals = sa_value_batch(po, fm.ssa, fm.sa_intv,
                              np.asarray(rows, np.int64))
        for (b, qb, ln), rb in zip(meta, vals):
            seeds[b].append(Seed(rbeg=int(rb), qbeg=qb, len=ln))
    return seeds


def chain_reads_batch(fm: FMIndex, po, reads: list[np.ndarray],
                      opt: MemOptions) -> list[list[Chain]]:
    """Seed, chain and filter every read: numpy-batched seeding, then
    per-read chaining (bwa inserts seeds in SMEM order, sorted by qbeg,
    then occurrence; chaining relies on qbeg monotonicity within a
    chain)."""
    all_seeds = collect_seeds_batch(fm, po, reads, opt)
    return [
        filter_chains(opt, chain_seeds(opt, fm.l_pac, s)) if s else []
        for s in all_seeds
    ]
