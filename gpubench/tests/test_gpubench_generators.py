"""The genome and read generators are deterministic for their seed."""

import json
import os

import numpy as np

from harness.genome import make_genome, read_fasta_codes, write_fasta
from harness.reads import haplotype, make_pool

from _tiny import DATA


def _spec():
    with open(os.path.join(DATA, "configs", "tiny.json")) as f:
        return json.load(f)


def _mix(name):
    with open(os.path.join(DATA, "traffic", name + ".json")) as f:
        return json.load(f)


def test_genome_is_fixed_by_its_config(tmp_path):
    g = make_genome(_spec()["genome"])
    assert len(g) == _spec()["genome"]["length"]
    assert np.array_equal(g, make_genome(_spec()["genome"]))
    assert g.max() <= 3
    write_fasta(str(tmp_path / "g.fa"), "tiny", g)
    assert np.array_equal(read_fasta_codes(str(tmp_path / "g.fa")), g)


def test_genome_holds_its_repeats():
    spec = _spec()["genome"]
    g = make_genome(spec)
    # a 1 kb family of 6 low-divergence copies: its 25-mers recur
    k = 25
    view = np.lib.stride_tricks.sliding_window_view(g, k)
    keys = (view.astype(np.int64) * (4 ** np.arange(k))).sum(axis=1)
    _, counts = np.unique(keys, return_counts=True)
    assert (counts >= 3).sum() > 500


def test_pool_is_fixed_by_the_seed():
    g = make_genome(_spec()["genome"])
    for name in ("tiny_se", "tiny_pe"):
        mix = _mix(name)
        a, b, c = (make_pool(g, mix, s) for s in (7, 7, 2 ** 31 + 9))
        assert len(a.ends) == (2 if mix["paired"] else 1)
        for x, y, z in zip(a.ends, b.ends, c.ends):
            assert x.shape == z.shape == (mix["pool"], mix["read_len"])
            assert np.array_equal(x, y)
            assert not np.array_equal(x, z)


def test_pool_errors_and_pairs():
    g = make_genome(_spec()["genome"])
    mix = dict(_mix("tiny_pe"), pool=4000)
    pool = make_pool(g, mix, 3)
    rec, col = pool.records(0)
    assert rec.shape[0] == 4000
    assert bytes(rec[0, :col]) == b"@p"
    # read 1 comes from either strand, about half each
    text = "".join("ACGT"[x] for x in g)
    fwd = rev = 0
    for r in pool.ends[0][:200]:
        fwd += text.find("".join("ACGT"[x] for x in r[:12])) >= 0
        rc = "".join("ACGT"[3 - x] for x in r[::-1][:12])
        rev += text.find(rc) >= 0
    assert 55 < fwd < 135 and 55 < rev < 135


def test_haplotype_mutates_at_the_rate():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    mix = {"mut_rate": 0.001, "indel_frac": 0.15, "indel_ext": 0.3}
    h = haplotype(g, mix, np.random.default_rng(1))
    assert 0 < abs(len(h) - len(g)) < 300
    assert not np.array_equal(h[:100_000], g[:100_000])
