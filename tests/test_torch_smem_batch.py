"""The port's batched SMEM search (bwamem_tpu_torch/index/smem_batch.py
over index/occ_packed.py) against the scalar golden twin, as
tests/test_smem_batch.py holds the JAX package's copy, and against that
copy: the same intervals and chains on the same reads; the port's native
seeding against its Python path."""

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions as RefOptions
from bwamem_tpu.index import smem_batch as ref_smem_batch
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.index.occ_packed import pack_occ as ref_pack_occ
from bwamem_tpu.pipeline import chain as ref_chain
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.fmindex import collect_smems, smem1
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.index.smem_batch import collect_smems_batch, smem1_batch
from bwamem_tpu_torch.pipeline.chain import (
    chain_read,
    chain_reads_batch,
    collect_seeds_batch,
    collect_seeds_native,
)

from _torch_gate import plain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    """(the port's fm and packed occ, the reference's of the same text)."""
    rng = np.random.default_rng(13)
    pac = rng.integers(0, 4, 20000).astype(np.uint8)
    # plant a repeat so intervals with s > 1 occur
    pac[15000:15500] = pac[2000:2500]
    fm, rfm = build_index(pac), ref_build_index(pac)
    return fm, pack_occ(fm), rfm, ref_pack_occ(rfm)


def make_reads(rng, fm, n, L=90):
    reads = []
    for i in range(n):
        pos = int(rng.integers(0, fm.l_pac - L - 5))
        r = fm.pac[pos:pos + L].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, 6))):
            r[rng.integers(0, L)] = rng.integers(0, 5)  # SNPs + Ns
        if rng.random() < 0.3:
            rc = r[::-1].copy()
            rc[rc < 4] = 3 - rc[rc < 4]
            r = rc
        reads.append(r)
    return reads


def ivs(mems):
    return [(m.qb, m.qe, m.x0, m.x1, m.s) for m in mems]


def test_packed_occ_equals_reference(world):
    fm, po, rfm, rpo = world
    assert plain(po) == plain(rpo)


def _batch(world, q, qlen, x, mi):
    """The port's smem1_batch, held to the reference's."""
    fm, po, rfm, rpo = world
    nx, got = smem1_batch(po, fm, q, qlen, x, mi)
    wnx, want = ref_smem_batch.smem1_batch(rpo, rfm, q, qlen, x, mi)
    np.testing.assert_array_equal(nx, wnx)
    assert plain(got) == plain(want)
    return nx, got


@pytest.mark.parametrize("seed", range(4))
def test_smem1_batch_matches_scalar(world, seed):
    fm = world[0]
    rng = np.random.default_rng(100 + seed)
    reads = make_reads(rng, fm, 16)
    L = max(len(r) for r in reads)
    q = np.full((len(reads), L), 4, np.int64)
    qlen = np.zeros(len(reads), np.int64)
    for b, r in enumerate(reads):
        q[b, :len(r)] = r
        qlen[b] = len(r)
    x = rng.integers(0, qlen)
    mi = np.ones(len(reads), np.int64)
    nx, got = _batch(world, q, qlen, x.astype(np.int64), mi)
    for b, r in enumerate(reads):
        if r[x[b]] > 3:
            assert nx[b] == x[b] + 1 and got[b] == []
            continue
        wx, want = smem1(fm, r, int(x[b]))
        assert nx[b] == wx, b
        assert ivs(got[b]) == ivs(want), b


def _collect(world, reads):
    fm, po, rfm, rpo = world
    got = collect_smems_batch(po, fm, reads, 19, 28, 10)
    assert plain(got) == plain(ref_smem_batch.collect_smems_batch(
        rpo, rfm, reads, 19, 28, 10))
    return got


@pytest.mark.parametrize("seed", range(3))
def test_collect_batch_matches_scalar(world, seed):
    fm = world[0]
    rng = np.random.default_rng(200 + seed)
    reads = make_reads(rng, fm, 12)
    got = _collect(world, reads)
    for b, r in enumerate(reads):
        want = collect_smems(fm, r, 19, 28, 10)
        assert ivs(got[b]) == ivs(want), b


def test_repeat_read_with_reseed(world):
    fm = world[0]
    # read inside the planted repeat: s==2 intervals + re-seeding path
    r = fm.pac[2100:2200].astype(np.int64)
    got = _collect(world, [r])[0]
    want = collect_smems(fm, r, 19, 28, 10)
    assert ivs(got) == ivs(want)
    assert any(m.s >= 2 for m in got)


@pytest.mark.parametrize("x", [30, 45])
def test_min_intv_per_read(world, x):
    """Each read's own min_intv: one row a value in 1..5 at one start,
    every row == the scalar smem1 at its min_intv, and a row whose
    min_intv is the occurrence count of a repeat interval drops it."""
    fm = world[0]
    r = fm.pac[2100:2160].astype(np.int64)
    mi = np.array([1, 2, 3, 4, 5], np.int64)
    q = r[None, :].repeat(len(mi), axis=0)
    qlen = np.full(len(mi), len(r), np.int64)
    _, got = _batch(world, q, qlen, np.full(len(mi), x, np.int64), mi)
    for b, m in enumerate(mi):
        assert ivs(got[b]) == ivs(smem1(fm, r, x, int(m))[1]), (b, m)
    assert ivs(got[0]) != ivs(got[2])


def test_chain_reads_batch_matches_scalar(world):
    fm, po, rfm, rpo = world
    opt = MemOptions()
    rng = np.random.default_rng(555)
    reads = make_reads(rng, fm, 10)
    got = chain_reads_batch(fm, po, reads, opt)
    assert plain(got) == plain(ref_chain.chain_reads_batch(
        rfm, rpo, reads, RefOptions()))
    for b, r in enumerate(reads):
        want = chain_read(fm, r, opt)
        g = [(c.pos, [(s.rbeg, s.qbeg, s.len) for s in c.seeds])
             for c in got[b]]
        w = [(c.pos, [(s.rbeg, s.qbeg, s.len) for s in c.seeds])
             for c in want]
        assert g == w, b


def test_native_seeding_matches_python(world):
    """The port's native seeding (its own host library) == its Python
    path == the reference's Python path."""
    fm, po, rfm, rpo = world
    opt = MemOptions()
    rng = np.random.default_rng(808)
    reads = make_reads(rng, fm, 16)
    # include the repeat region (s>1 intervals + reseeding) and an N read
    reads.append(fm.pac[2100:2200].astype(np.int64))
    nr = fm.pac[300:400].astype(np.int64).copy()
    nr[::17] = 4
    reads.append(nr)
    native = collect_seeds_native(fm, po, reads, opt)
    assert native is not None, "the port's host library"
    python = collect_seeds_batch(fm, po, reads, opt)
    assert plain(python) == plain(ref_chain.collect_seeds_batch(
        rfm, rpo, reads, RefOptions()))
    for b in range(len(reads)):
        g = [(s.rbeg, s.qbeg, s.len) for s in native[b]]
        w = [(s.rbeg, s.qbeg, s.len) for s in python[b]]
        assert g == w, b
