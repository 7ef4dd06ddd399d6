"""The port's scalar banded extension (bwamem_tpu_torch/ops/extend_ref.py)
against its independent oracle, the naive full-matrix DP, as
tests/test_extend_ref.py holds the JAX package's copy, and against that
copy: every ExtendResult equal, field for field, on the same task."""

import numpy as np
import pytest
import torch

from bwamem_tpu.ops import extend_ref as ref_extend
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.ops.extend_ref import (
    ksw_extend,
    ksw_extend_core,
    ksw_extend_naive,
)

from _torch_gate import plain

torch.set_num_threads(1)

OPT = MemOptions()
MAT = OPT.mat


def _rand_task(rng, qmax=60, tmax=80, mutate=True):
    """A random extension task: target is a mutated copy of the query plus
    flanking noise, so scores are non-trivial."""
    qlen = rng.integers(1, qmax + 1)
    query = rng.integers(0, 4, qlen)
    if mutate:
        target = query.copy()
        # point mutations
        nmut = rng.integers(0, max(1, qlen // 6) + 1)
        for _ in range(nmut):
            p = rng.integers(0, len(target))
            target[p] = rng.integers(0, 4)
        # indels
        for _ in range(rng.integers(0, 3)):
            p = rng.integers(0, len(target) + 1)
            if rng.random() < 0.5 and len(target) > 1:
                target = np.delete(target, min(p, len(target) - 1))
            else:
                target = np.insert(target, p, rng.integers(0, 4))
        tail = rng.integers(0, 4, rng.integers(0, tmax // 3))
        target = np.concatenate([target, tail])
    else:
        target = rng.integers(0, 4, rng.integers(1, tmax + 1))
    if len(target) == 0:
        target = rng.integers(0, 4, 1)
    h0 = int(rng.integers(1, 100))
    return query.astype(np.int64), target.astype(np.int64), h0


def _core(q, t, pens, w, h0):
    """The port's ksw_extend_core, held to the reference's."""
    got = ksw_extend_core(q, t, MAT, *pens, w=w, h0=h0)
    assert plain(got) == plain(ref_extend.ksw_extend_core(q, t, MAT, *pens,
                                                          w=w, h0=h0))
    return got


def _naive(q, t, pens, w, h0):
    got = ksw_extend_naive(q, t, MAT, *pens, w, h0)
    assert got == ref_extend.ksw_extend_naive(q, t, MAT, *pens, w, h0)
    return got


DEFAULT = (6, 1, 6, 1)


def test_perfect_match_score():
    # extending a perfect match adds +1 per base, global hit at the end
    q = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    r = _core(q, q.copy(), DEFAULT, 100, 30)
    assert r.score == 30 + 8
    assert r.qle == 8 and r.tle == 8
    assert r.gscore == 38 and r.gtle == 8
    assert r.max_off == 0


def test_mismatch_tail_clipped():
    # 5 matching bases then 3 mismatching: local score stops at the match
    q = np.concatenate([np.zeros(5, np.int64), np.full(3, 2, np.int64)])
    t = np.concatenate([np.zeros(5, np.int64), np.full(3, 3, np.int64)])
    r = _core(q, t, DEFAULT, 100, 20)
    assert r.score == 25
    assert r.qle == 5 and r.tle == 5
    # global (to query end): a 3-base insertion (-6-3) beats 3 mismatches (-12)
    assert r.gscore == 25 - 9
    assert r.gtle == 5


def test_deletion_in_target():
    # target has one extra base (deletion from query's perspective):
    # query must open a deletion gap to reach the end
    q = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3])
    t = np.concatenate([q[:6], np.array([2]), q[6:]])
    r = _core(q, t, DEFAULT, 100, 20)
    # global: 12 matches - (6+1) gap = 20 + 12 - 7 = 25
    assert r.gscore == 25
    assert r.gtle == 13


def test_h0_zero_row_first_row():
    # tiny h0: the first virtual row decays quickly
    q = np.array([2, 2, 2, 2])
    t = np.array([3, 3, 3, 3])
    r = _core(q, t, DEFAULT, 100, 1)
    # everything mismatches; score stays h0, no cell improves
    assert r.score == 1
    assert r.qle == 0 and r.tle == 0


def test_early_break_row_max_zero():
    # after enough mismatching rows all cells hit 0 and the row loop breaks
    q = np.full(4, 0, np.int64)
    t = np.full(60, 1, np.int64)
    r = _core(q, t, DEFAULT, 100, 3)
    assert r.score == 3  # never improves


@pytest.mark.parametrize("pens,seed", [(DEFAULT, s) for s in range(40)]
                         + [((5, 2, 7, 1), 1000 + s) for s in range(20)],
                         ids=[f"default-{s}" for s in range(40)]
                         + [f"asymmetric-{s}" for s in range(20)])
def test_core_matches_naive_full_band(pens, seed):
    """With a band wide enough to cover the whole matrix, the banded core
    with all its early exits must equal a plain full-matrix DP (score and
    gscore), under bwa's penalties (seeds 0-39) and asymmetric ones
    (seeds 1000-1019)."""
    rng = np.random.default_rng(seed)
    q, t, h0 = _rand_task(rng)
    w = max(len(q), len(t)) + 2
    r = _core(q, t, pens, w, h0)
    naive_score, naive_gscore = _naive(q, t, pens, w, h0)
    assert r.score == naive_score
    assert r.gscore == naive_gscore


@pytest.mark.parametrize("seed", range(20))
def test_narrow_band_never_beats_wide(seed):
    rng = np.random.default_rng(2000 + seed)
    q, t, h0 = _rand_task(rng)
    wide = _core(q, t, DEFAULT, max(len(q), len(t)) + 2, h0)
    narrow = _core(q, t, DEFAULT, 5, h0)
    assert narrow.score <= wide.score


def test_band_doubling_converges():
    rng = np.random.default_rng(7)
    # a task with a big indel that needs a wider band
    q = rng.integers(0, 4, 80)
    t = np.concatenate([q[:40], rng.integers(0, 4, 12), q[40:]])
    r_small = ksw_extend(q, t, MAT, *DEFAULT, w=4, h0=50)
    assert plain(r_small) == plain(ref_extend.ksw_extend(q, t, MAT, *DEFAULT,
                                                         w=4, h0=50))
    r_big = _core(q, t, DEFAULT, 8, 50)
    # the doubling loop ran the second pass at w=8 (clamped by max_ins/max_del)
    assert r_small.w_used in (4, 8)
    if r_small.w_used == 8:
        assert r_small.score == r_big.score


def test_qle_tle_consistency():
    rng = np.random.default_rng(11)
    for _ in range(25):
        q, t, h0 = _rand_task(rng)
        r = _core(q, t, DEFAULT, 100, h0)
        assert 0 <= r.qle <= len(q)
        assert 0 <= r.tle <= len(t)
        assert -1 <= r.gtle - 1 < len(t)
        assert r.score >= h0
