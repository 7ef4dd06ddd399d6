"""The port's native ksw_global / NM-MD / local SW twins (its own host
library, bwamem_tpu_torch/native) fuzzed against the pure-Python golden
implementations of its pipeline/cigar.py and ops/local_ref.py, as
tests/test_ksw_native.py fuzzes the JAX package's, and each Python
answer held to the reference's Python path on the same input.

The port's library builds atomically (a temp file, then os.replace), so
these tests need it and do not skip without it."""

import numpy as np
import torch

from bwamem_tpu.ops import local_ref as ref_local
from bwamem_tpu.pipeline import cigar as ref_cigar
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.native import (
    cigar_nm_md_native,
    get_lib,
    ksw_global_native,
)
from bwamem_tpu_torch.ops.local_ref import ksw_align
from bwamem_tpu_torch.pipeline.cigar import compute_nm_md, ksw_global

torch.set_num_threads(1)

OPT = MemOptions()
PENS = (OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins)


def _mutate(rng, seq, sub=0.05, ind=0.03):
    out = []
    for c in seq:
        r = rng.random()
        if r < ind / 2:
            continue  # deletion
        if r < ind:
            out.append(int(rng.integers(0, 4)))  # insertion
        if rng.random() < sub:
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(c))
    return np.array(out or [0], np.int64)


def _python_global(query, target, w):
    """The port's Python ksw_global, held to the reference's."""
    got = ksw_global(query, target, OPT.mat, *PENS, w, use_native=False)
    assert got == ref_cigar.ksw_global(query, target, OPT.mat, *PENS, w,
                                       use_native=False)
    return got


def test_ksw_global_fuzz_vs_python():
    assert get_lib() is not None, "the port's host library"
    rng = np.random.default_rng(11)
    for trial in range(150):
        tlen = int(rng.integers(1, 120))
        target = rng.integers(0, 4, tlen).astype(np.int64)
        query = _mutate(rng, target)
        if rng.random() < 0.1:  # sprinkle N
            query[rng.integers(0, len(query))] = 4
        w = int(rng.integers(1, 30))
        got = ksw_global_native(query, target, OPT.mat, *PENS, w)
        want = _python_global(query, target, w)
        assert got == want, (trial, query.tolist(), target.tolist(), w)


def test_ksw_global_fuzz_large_banded():
    """Exercise the row-vectorized Python path (tlen*band >= 4096)."""
    rng = np.random.default_rng(7)
    for trial in range(10):
        tlen = int(rng.integers(150, 400))
        target = rng.integers(0, 4, tlen).astype(np.int64)
        query = _mutate(rng, target)
        w = int(rng.integers(20, 60))
        got = ksw_global_native(query, target, OPT.mat, *PENS, w)
        assert got == _python_global(query, target, w), trial


def test_nm_md_fuzz_vs_python():
    rng = np.random.default_rng(23)
    for trial in range(100):
        tlen = int(rng.integers(1, 150))
        target = rng.integers(0, 5, tlen).astype(np.int64)
        query = _mutate(rng, target)
        w = int(rng.integers(1, 25))
        _, cigar = _python_global(query, target, w)
        if rng.random() < 0.3 and cigar:
            cigar = [(3, 5)] + cigar  # leading soft clip
            query = np.concatenate([rng.integers(0, 4, 5), query])
        got = cigar_nm_md_native(query, target, cigar)
        want = compute_nm_md(query, target, cigar, use_native=False)
        assert want == ref_cigar.compute_nm_md(query, target, cigar,
                                               use_native=False)
        assert got == want, trial


def test_ksw_align_fuzz_vs_python():
    """Native local SW (mate rescue) == the Python twin, including
    start/end coordinates, tie-breaking and the KSW_XSUBO second best."""
    rng = np.random.default_rng(31)
    for trial in range(120):
        tlen = int(rng.integers(1, 400))
        target = rng.integers(0, 4, tlen).astype(np.int64)
        if rng.random() < 0.8 and tlen > 60:
            # plant the query inside the window, mutated
            off = int(rng.integers(0, tlen - 50))
            ln = int(rng.integers(30, min(120, tlen - off)))
            query = _mutate(rng, target[off:off + ln])
        else:
            query = rng.integers(0, 4,
                                 int(rng.integers(1, 80))).astype(np.int64)
        got = ksw_align(query, target, OPT.mat, *PENS)
        want = ksw_align(query, target, OPT.mat, *PENS, use_native=False)
        assert want == ref_local.ksw_align(query, target, OPT.mat, *PENS,
                                           use_native=False)
        assert got == want, (trial, query.tolist(), target.tolist())


def test_alignment_via_public_path_uses_native():
    """ksw_global with use_native default must equal the python path."""
    rng = np.random.default_rng(5)
    target = rng.integers(0, 4, 200).astype(np.int64)
    query = _mutate(rng, target)
    a = ksw_global(query, target, OPT.mat, *PENS, 25)
    assert a == ksw_global_native(query, target, OPT.mat, *PENS, 25)
    assert a == _python_global(query, target, 25)
