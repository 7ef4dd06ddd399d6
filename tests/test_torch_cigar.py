"""The port's banded global alignment and NM/MD (bwamem_tpu_torch/
pipeline/cigar.py: ksw_global, _ksw_global_rows, compute_nm_md) against
the JAX package's copy: tests/test_cigar.py's checks on the port's
module, its independent oracles (the unbanded affine DP, the scalar loop
against the row-vectorised fill), and every score, CIGAR and MD equal
to the reference's on the same input (the reference may take its
native or its numpy path: both give the same answer)."""

import numpy as np
import pytest
import torch

from bwamem_tpu.pipeline import cigar as ref_cigar
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.pipeline import cigar as C
from bwamem_tpu_torch.pipeline.cigar import (
    D_OP,
    I_OP,
    M_OP,
    cigar_query_len,
    cigar_ref_len,
    cigar_to_string,
    compute_nm_md,
    ksw_global,
)

torch.set_num_threads(1)

OPT = MemOptions()
MAT = OPT.mat


def _global(q, t, w):
    """The port's ksw_global, held to the reference's."""
    got = ksw_global(q, t, MAT, 6, 1, 6, 1, w=w)
    assert got == ref_cigar.ksw_global(q, t, MAT, 6, 1, 6, 1, w=w)
    return got


def _nm_md(q, t, cig):
    got = compute_nm_md(q, t, cig)
    assert got == ref_cigar.compute_nm_md(q, t, cig)
    return got


def test_perfect_match():
    q = np.array([0, 1, 2, 3] * 5)
    s, cig = _global(q, q, 10)
    assert s == 20
    assert cig == [(M_OP, 20)]
    assert cigar_to_string(cig) == "20M" == ref_cigar.cigar_to_string(cig)


def test_single_mismatch():
    q = np.array([0, 1, 2, 3] * 5)
    t = q.copy()
    t[7] = (t[7] + 1) % 4
    s, cig = _global(q, t, 10)
    assert s == 19 - 4  # 19 matches + 1 mismatch(-4)
    assert cig == [(M_OP, 20)]
    nm, md = _nm_md(q, t, cig)
    assert nm == 1
    assert md == "7" + "ACGTN"[t[7]] + "12"


def test_deletion():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 30)
    q = np.concatenate([t[:10], t[13:]])  # 3-base deletion from query
    s, cig = _global(q, t, 10)
    assert cig == [(M_OP, 10), (D_OP, 3), (M_OP, 17)]
    assert s == 27 - (6 + 3)
    nm, md = _nm_md(q, t, cig)
    assert nm == 3
    assert md.startswith("10^")


def test_insertion():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 4, 30)
    q = np.concatenate([t[:12], np.array([0, 1]), t[12:]])
    s, cig = _global(q, t, 10)
    assert (I_OP, 2) in cig
    assert cigar_query_len(cig) == 32
    assert cigar_ref_len(cig) == 30
    nm, _ = _nm_md(q, t, cig)
    assert nm == 2


@pytest.mark.parametrize("seed", range(10))
def test_lengths_always_consistent(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, rng.integers(1, 60))
    t = rng.integers(0, 4, rng.integers(1, 60))
    s, cig = _global(q, t, max(len(q), len(t)))
    assert cigar_query_len(cig) == len(q) == ref_cigar.cigar_query_len(cig)
    assert cigar_ref_len(cig) == len(t) == ref_cigar.cigar_ref_len(cig)


@pytest.mark.parametrize("seed", range(10))
def test_score_matches_unbanded_dp(seed):
    """Global score must equal an independent NW affine DP when the band
    covers the matrix."""
    rng = np.random.default_rng(100 + seed)
    q = rng.integers(0, 4, rng.integers(1, 25))
    t = rng.integers(0, 4, rng.integers(1, 25))
    s, cig = _global(q, t, len(q) + len(t))
    assert s == _nw_affine(q, t)


def _nw_affine(q, t, a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1):
    NEG = -(10 ** 9)
    n, m = len(t), len(q)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)  # gap in query (del)
    F = np.full((n + 1, m + 1), NEG, np.int64)  # gap in target (ins)
    H[0, 0] = 0
    for j in range(1, m + 1):
        F[0, j] = -(o_ins + e_ins * j)
        H[0, j] = F[0, j]
    for i in range(1, n + 1):
        E[i, 0] = -(o_del + e_del * i)
        H[i, 0] = E[i, 0]
        for j in range(1, m + 1):
            sc = a if q[j - 1] == t[i - 1] else -b
            E[i, j] = max(H[i - 1, j] - o_del - e_del, E[i - 1, j] - e_del)
            F[i, j] = max(H[i, j - 1] - o_ins - e_ins, F[i, j - 1] - e_ins)
            H[i, j] = max(H[i - 1, j - 1] + sc, E[i, j], F[i, j])
    return int(H[n, m])


@pytest.mark.parametrize("seed", range(8))
def test_vectorized_rows_match_scalar(seed, monkeypatch):
    """The port's row-vectorized fill must be byte-identical to the
    scalar twin (score AND cigar AND implicit z choices): the port's
    native ksw_global, which the public call takes first, with the
    dispatch to the row fill made to crash if taken; and to the
    reference's row fill."""
    rng = np.random.default_rng(900 + seed)
    qlen = int(rng.integers(30, 200))
    q = rng.integers(0, 4, qlen)
    t = q.copy()
    for _ in range(int(rng.integers(0, 8))):
        t[rng.integers(0, len(t))] = rng.integers(0, 4)
    for _ in range(int(rng.integers(0, 3))):
        p = int(rng.integers(1, len(t) - 1))
        if rng.random() < 0.5:
            t = np.delete(t, p)
        else:
            t = np.insert(t, p, rng.integers(0, 4))
    w = int(rng.integers(1, 60))
    rows = C._ksw_global_rows(q, t, MAT, 6, 1, 6, 1, w)
    assert rows == ref_cigar._ksw_global_rows(q, t, MAT, 6, 1, 6, 1, w)
    monkeypatch.setattr(C, "_ksw_global_rows", None)
    assert rows == C.ksw_global(q, t, MAT, 6, 1, 6, 1, w)
