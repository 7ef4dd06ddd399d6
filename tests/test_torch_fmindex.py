"""The port's FM-index (bwamem_tpu_torch/index/build.py, index/fmindex.py
and its native SA-IS) against brute-force string search over the
two-strand text, as tests/test_fmindex.py holds the JAX package's copy,
and against that copy: the same index arrays, intervals and SMEMs on
the same input."""

import numpy as np
import pytest
import torch

from bwamem_tpu.index import build as ref_build
from bwamem_tpu.index import fmindex as ref_fmindex
from bwamem_tpu_torch import native
from bwamem_tpu_torch.index.build import (
    build_index,
    revcomp_codes,
    suffix_array,
)
from bwamem_tpu_torch.index.fmindex import (
    collect_smems,
    extend_backward,
    extend_forward,
    interval_of_char,
    sa_positions,
    smem1,
)

from _torch_gate import plain

torch.set_num_threads(1)


def brute_occurrences(text: np.ndarray, pat: np.ndarray) -> list[int]:
    m = len(pat)
    if m == 0 or m > len(text):
        return []
    wins = np.lib.stride_tricks.sliding_window_view(text, m)
    return list(np.nonzero((wins == pat).all(axis=1))[0])


@pytest.fixture(scope="module")
def small_index():
    """(the port's index, the reference's of the same text, the
    two-strand text)."""
    rng = np.random.default_rng(123)
    pac = rng.integers(0, 4, 400).astype(np.uint8)
    fm = build_index(pac, sa_intv=4)
    text = np.concatenate([pac, revcomp_codes(pac)])
    return fm, ref_build.build_index(pac, sa_intv=4), text


def test_index_equals_reference(small_index):
    """Every field of the port's FMIndex == the reference's."""
    fm, rfm, _ = small_index
    assert plain(fm) == plain(rfm)


def test_suffix_array_correct():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 4, 200).astype(np.uint8)
    sa = suffix_array(s)
    sufs = sorted(range(len(s)), key=lambda i: tuple(s[i:]))
    assert list(sa) == sufs
    np.testing.assert_array_equal(sa, ref_build.suffix_array(s))


def test_sais_bwt_direct_matches_int64_path():
    """The port's packed 40-bit direct-BWT construction (bwamem_sais_bwt_u8,
    the GRCh38-scale memory-bounded path) == the int64-SA construction,
    for bwt, ssa and primary, across sizes and N-bearing texts."""
    assert native.get_lib() is not None, "the port's host library"
    rng = np.random.default_rng(9)
    for n, nfrac in ((1, 0.0), (37, 0.0), (1000, 0.1), (20000, 0.02)):
        pac = rng.integers(0, 4, n).astype(np.uint8)
        pac[rng.random(n) < nfrac] = 4
        text = np.concatenate([pac, revcomp_codes(pac)])
        n2 = len(text)
        got = native.sais_bwt_u8(text, 8)
        assert got is not None
        bwt, ssa, primary = got
        sa = suffix_array(text)
        sa_full = np.concatenate([[n2], sa]).astype(np.int64)
        want_primary = int(np.nonzero(sa_full == 0)[0][0])
        want_bwt = text[np.maximum(sa_full - 1, 0)]
        want_bwt[want_primary] = 5
        assert primary == want_primary, n
        assert np.array_equal(bwt, want_bwt), n
        assert np.array_equal(ssa, sa_full[::8]), n


def test_rank_matches_direct(small_index):
    fm, rfm, _ = small_index
    rng = np.random.default_rng(0)
    for _ in range(50):
        c = int(rng.integers(0, 4))
        i = int(rng.integers(0, fm.seq_len2 + 2))
        assert fm.rank(c, i) == int(np.count_nonzero(fm.bwt[:i] == c)) \
            == rfm.rank(c, i)


def test_sa_value_all_rows(small_index):
    fm, rfm, text = small_index
    n2 = fm.seq_len2
    sa_full = np.concatenate([[n2], suffix_array(text)])
    for r in range(0, n2 + 1, 7):
        assert fm.sa_value(r) == sa_full[r] == rfm.sa_value(r), f"row {r}"


def test_single_char_intervals(small_index):
    fm, rfm, text = small_index
    for c in range(4):
        ik = interval_of_char(fm, c)
        assert plain(ik) == plain(ref_fmindex.interval_of_char(rfm, c))
        assert ik.s == int(np.count_nonzero(text == c))
        # every row in the interval starts with c
        positions = sorted(fm.sa_value(r) for r in range(ik.x0, ik.x0 + ik.s))
        assert all(text[p] == c for p in positions)


def _check_pattern_interval(fm, text, pat, ik):
    """ik must be exactly the SA interval of pat, with x1 = interval of rc."""
    occ = brute_occurrences(text, pat)
    assert ik.s == len(occ)
    if ik.s:
        got = sorted(fm.sa_value(r) for r in range(ik.x0, ik.x0 + ik.s))
        assert got == occ
        rc = revcomp_codes(pat)
        occ_rc = brute_occurrences(text, rc)
        got_rc = sorted(fm.sa_value(r) for r in range(ik.x1, ik.x1 + ik.s))
        assert got_rc == occ_rc


def _ref_iv(ik):
    return ref_fmindex.BiInterval(**plain(ik)[1])


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("seed", range(8))
def test_extension_intervals(small_index, seed, direction):
    """A random substring of the text (a non-empty interval) grown a base
    at a time backward (tests/test_fmindex.py seeds 0-7) or forward
    (seeds 100-107), then by each base once more: every interval exact
    and equal to the reference's extension of the same interval."""
    fm, rfm, text = small_index
    back = direction == "backward"
    ext, ref_ext = ((extend_backward, ref_fmindex.extend_backward) if back
                    else (extend_forward, ref_fmindex.extend_forward))
    rng = np.random.default_rng(seed if back else 100 + seed)
    start = int(rng.integers(0, len(text) - 20))
    ln = int(rng.integers(1, 12))
    pat = text[start:start + ln].copy()
    order = range(ln - 2, -1, -1) if back else range(1, ln)
    ik = interval_of_char(fm, int(pat[-1] if back else pat[0]))
    for j in order:
        ik = ext(fm, ik)[int(pat[j])]
    _check_pattern_interval(fm, text, pat, ik)
    exts = ext(fm, ik)
    assert plain(exts) == plain(ref_ext(rfm, _ref_iv(ik)))
    for c in range(4):
        grown = np.concatenate([[c], pat] if back else [pat, [c]])
        _check_pattern_interval(fm, text, grown, exts[c])


def brute_smems_through(text, q, x):
    """All maximal exact matches of q covering position x (min_intv=1)."""
    n = len(q)
    out = set()
    for qb in range(0, x + 1):
        for qe in range(x + 1, n + 1):
            if np.any(q[qb:qe] > 3):
                continue
            if not brute_occurrences(text, q[qb:qe]):
                continue
            left_ext = (qb > 0 and q[qb - 1] < 4
                        and bool(brute_occurrences(text, q[qb - 1:qe])))
            right_ext = (qe < n and q[qe] < 4
                         and bool(brute_occurrences(text, q[qb:qe + 1])))
            if not left_ext and not right_ext:
                out.add((qb, qe))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_smem1_matches_bruteforce(small_index, seed):
    fm, rfm, text = small_index
    rng = np.random.default_rng(200 + seed)
    # read = mutated substring of the forward strand
    start = int(rng.integers(0, fm.l_pac - 60))
    q = fm.pac[start:start + 50].copy().astype(np.int64)
    for _ in range(rng.integers(1, 5)):
        q[rng.integers(0, len(q))] = rng.integers(0, 4)
    x = int(rng.integers(0, len(q)))
    if q[x] > 3:
        return
    got_smem = smem1(fm, q, x)
    assert plain(got_smem) == plain(ref_fmindex.smem1(rfm, q, x))
    got = {(m.qb, m.qe) for m in got_smem[1]}
    want = brute_smems_through(text, q, x)
    assert got == want, f"x={x} got={sorted(got)} want={sorted(want)}"
    # intervals themselves must be exact
    for m in got_smem[1]:
        _check_pattern_interval(fm, text, q[m.qb:m.qe], m)


def test_smem_n_bases_split(small_index):
    fm, rfm, _ = small_index
    q = fm.pac[10:40].copy().astype(np.int64)
    q[15] = 4  # N in the middle
    left, right = smem1(fm, q, 5), smem1(fm, q, 20)
    assert all(m.qe <= 15 for m in left[1])
    assert all(m.qb >= 16 for m in right[1])
    assert plain([left, right]) == plain([ref_fmindex.smem1(rfm, q, 5),
                                          ref_fmindex.smem1(rfm, q, 20)])


def test_collect_smems_covers_read(small_index):
    fm, rfm, text = small_index
    q = fm.pac[100:180].copy().astype(np.int64)
    q[40] = (q[40] + 1) % 4  # one SNP splits the exact match
    mems = collect_smems(fm, q, min_seed_len=19, split_len=28, split_width=10)
    assert mems, "expected seeds"
    assert plain(mems) == plain(ref_fmindex.collect_smems(
        rfm, q, min_seed_len=19, split_len=28, split_width=10))
    spans = [(m.qb, m.qe) for m in mems]
    assert spans == sorted(spans)
    for m in mems:
        assert m.qlen >= 19
        _check_pattern_interval(fm, text, q[m.qb:m.qe], m)
    # the two flanks of the SNP must both be seeded
    assert any(m.qe <= 41 for m in mems)
    assert any(m.qb >= 40 for m in mems)


def test_sa_positions_subsampling(small_index):
    fm, rfm, text = small_index
    # a 1-char pattern has many occurrences; max_occ subsampling kicks in
    ik = interval_of_char(fm, 0)
    pos = sa_positions(fm, ik, max_occ=10)
    assert len(pos) == 10
    assert plain(pos) == plain(ref_fmindex.sa_positions(rfm, _ref_iv(ik),
                                                        max_occ=10))
    step = ik.s // 10
    for k, (rb, row) in enumerate(pos):
        assert row == ik.x0 + k * step
        assert text[rb] == 0
