"""The port's chaining (bwamem_tpu_torch/pipeline/chain.py, over its
index/build.py) against the JAX package's copy: tests/test_chain.py's
checks on the port's module, and every result equal, field for field, to
the reference's on the same input."""

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions as RefOptions
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.pipeline import chain as ref_chain
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.pipeline.chain import (
    Chain,
    Seed,
    chain_read,
    chain_seeds,
    chain_weight,
    collect_seeds,
    filter_chains,
)

from _torch_gate import plain

torch.set_num_threads(1)

OPT, REF_OPT = MemOptions(), RefOptions()


def _ref_seeds(seeds):
    return [ref_chain.Seed(s.rbeg, s.qbeg, s.len) for s in seeds]


def _ref_chains(chains):
    return [ref_chain.Chain(seeds=_ref_seeds(c.seeds), pos=c.pos)
            for c in chains]


# (l_pac, seeds as (rbeg, qbeg, len), seeds in each chain)
CHAIN_CASES = {
    "colinear_one_chain": (10**6, [(1000, 0, 25), (1030, 30, 25),
                                   (1061, 60, 30)], [3]),
    "distant_two_chains": (10**6, [(1000, 0, 25), (500000, 30, 25)], [1, 1]),
    # diagonal offset beyond w=100 cannot chain
    "band_violation": (10**6, [(1000, 0, 25), (1300, 30, 25)], [1, 1]),
    # the band's edges: a diagonal offset of exactly w chains, w + 1 not
    "band_edge_ref": (10**6, [(1000, 0, 25), (1130, 30, 25)], [2]),
    "band_edge_ref_plus_one": (10**6, [(1000, 0, 25), (1131, 30, 25)],
                               [1, 1]),
    "band_edge_query": (10**6, [(1000, 0, 25), (1030, 130, 25)], [2]),
    "band_edge_query_plus_one": (10**6, [(1000, 0, 25), (1029, 130, 25)],
                                 [1, 1]),
    # crosses into the reverse complement
    "strand_boundary": (2000, [(1990, 0, 25), (2030, 40, 25)], [1, 1]),
    # contained: not appended
    "contained_absorbed": (10**6, [(1000, 0, 50), (1010, 10, 20)], [1]),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_seeds(case):
    l_pac, spec, sizes = CHAIN_CASES[case]
    seeds = [Seed(*s) for s in spec]
    chains = chain_seeds(OPT, l_pac, seeds)
    assert [len(c.seeds) for c in chains] == sizes
    want = ref_chain.chain_seeds(REF_OPT, l_pac, _ref_seeds(seeds))
    assert plain(chains) == plain(want)


@pytest.mark.parametrize("seed", range(4))
def test_chain_seeds_random_matches_reference(seed):
    """Random seed sets sorted by query start, near one another on both
    strands, chained and filtered as the reference does."""
    rng = np.random.default_rng(seed)
    l_pac = 5000
    qb = np.sort(rng.integers(0, 150, 40))
    seeds = [Seed(int(rng.integers(0, 2 * l_pac - 60)) if k % 3 == 0
                  else int(1000 + q + rng.integers(-120, 120)), int(q),
                  int(rng.integers(15, 40))) for k, q in enumerate(qb)]
    chains = chain_seeds(OPT, l_pac, seeds)
    want = ref_chain.chain_seeds(REF_OPT, l_pac, _ref_seeds(seeds))
    assert plain(chains) == plain(want)
    assert [chain_weight(c) for c in chains] == \
        [ref_chain.chain_weight(c) for c in want]
    assert plain(filter_chains(OPT, chains)) == \
        plain(ref_chain.filter_chains(REF_OPT, want))


def test_chain_weight_overlaps():
    c = Chain(seeds=[Seed(1000, 0, 30), Seed(1020, 20, 30)], pos=1000)
    # query coverage: [0,50) = 50; ref coverage: [1000,1050) = 50
    assert chain_weight(c) == 50
    assert ref_chain.chain_weight(_ref_chains([c])[0]) == 50


def _filtered(chains):
    kept = filter_chains(OPT, chains)
    want = ref_chain.filter_chains(REF_OPT, _ref_chains(chains))
    assert plain(kept) == plain(want)
    return kept


def test_filter_drop_weak_overlapping():
    big = Chain(seeds=[Seed(1000, 0, 80)], pos=1000)
    small = Chain(seeds=[Seed(9000, 85, 20)], pos=9000)  # non-overlapping
    tiny = Chain(seeds=[Seed(5000, 50, 10)], pos=5000)   # weak + overlapping
    kept = _filtered([big, small, tiny])
    spans = {(c.qbeg, c.qend) for c in kept}
    assert (0, 80) in spans
    assert (85, 105) in spans       # non-overlapping chains are never dropped
    assert (50, 60) not in spans    # weak overlapping chain is dropped


def test_filter_keeps_equal_weight_duplicates():
    """Two equal chains at duplicated loci both survive (-> MAPQ 0 later)."""
    a = Chain(seeds=[Seed(1000, 0, 60)], pos=1000)
    b = Chain(seeds=[Seed(50000, 0, 60)], pos=50000)
    kept = _filtered([a, b])
    assert len(kept) == 2
    assert kept[0].first_shadow == 1  # remembers the shadowed competitor


def test_end_to_end_chaining_on_index():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    fm, rfm = build_index(genome), ref_build_index(genome)
    # read with one SNP: both flanks should seed and land in ONE chain
    read = genome[12000:12100].astype(np.int64).copy()
    read[50] = (read[50] + 1) % 4
    chains = chain_read(fm, read, OPT)
    assert len(chains) == 1
    c = chains[0]
    assert c.rbeg == 12000 and c.qbeg == 0
    assert c.rend == 12100
    assert plain(chains) == plain(ref_chain.chain_read(rfm, read, REF_OPT))
    # reverse-strand read chains on the reverse coordinates
    rc = read[::-1].copy()
    rc[rc < 4] = 3 - rc[rc < 4]
    chains_rc = chain_read(fm, rc, OPT)
    assert len(chains_rc) == 1
    assert chains_rc[0].rbeg >= fm.l_pac
    assert plain(chains_rc) == plain(ref_chain.chain_read(rfm, rc, REF_OPT))


def test_repetitive_seed_subsampling():
    # a genome with a heavy repeat: seeds capped at max_occ
    unit = np.array([0, 1, 2, 3, 0, 0, 1, 3, 2, 1] * 3, dtype=np.uint8)
    genome = np.tile(unit, 700)  # 21 kb of repeat
    fm = build_index(genome)
    read = np.tile(unit, 2).astype(np.int64)  # 60 bp, massively repetitive
    seeds = collect_seeds(fm, read, MemOptions(max_occ=50))
    assert 0 < len(seeds) <= 50 * 4
    want = ref_chain.collect_seeds(ref_build_index(genome), read,
                                   RefOptions(max_occ=50))
    assert plain(seeds) == plain(want)
