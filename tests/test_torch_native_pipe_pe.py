"""The port's native C++ host pipeline on paired-end chunks
(bwamem_tpu_torch/pipeline/native_driver.NativePipeline, its C++ pairing
and the resident-reference backends on the CPU) against the JAX
package's Python host: tests/test_native_pipe.py's PE cases that no
other port test covers (the regions export under pair.align_pairs, the
all-C++ PE path with and without -a, the text path with device rescue
or CIGAR, mixed read lengths).  The helpers and the oracle are
tests/test_torch_native_pipe.py's.  SAM is compared byte for byte."""

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.ops import types
from bwamem_tpu_torch.pipeline import native_driver, pair, resident
from bwamem_tpu_torch.pipeline.align import revcomp_read

from _torch_gate import same_sam
from test_torch_native_pipe import (  # noqa: F401 (world: a fixture)
    BLK,
    CPU,
    _ext,
    _pe_world,
    _pipe,
    _text,
    python_pe,
    world,
)

torch.set_num_threads(1)


def test_pe_native_regions_identical(world):
    """pair.align_pairs through the native regions path (the per-phase
    backend) == the Python path.  A substitution in every read 1 makes
    the extension run."""
    opt = MemOptions()
    w = world
    r1s, r2s = [], []
    for i in range(16):
        pos = int(w.rng.integers(0, w.ref.l_pac - 500))
        isize = 300 + int(w.rng.integers(-30, 30))
        r1s.append(w.ref.pac[pos:pos + 100].astype(np.int64))
        r1s[-1][40] = (r1s[-1][40] + 1) % 4
        r2s.append(revcomp_read(
            w.ref.pac[pos + isize - 100:pos + isize].astype(np.int64)))
    want = python_pe(opt, w, r1s, r2s)
    raw_t = native_driver.make_raw_t_backend(types.params_from_options(opt),
                                             CPU, blk_l=BLK)
    got = pair.align_pairs(opt, w.ref, w.fm, r1s, r2s, po=w.po,
                           native_pipe=_pipe(opt, w), raw_t_fn=raw_t)
    same_sam(got, want)
    assert raw_t.dispatches >= 2


@pytest.mark.parametrize("flag_a", [True, False], ids=["defaults", "no_a"])
def test_pe_full_native_sam_identical(world, flag_a):
    """The all-C++ PE path (mp_finalize_pe: pestat, mate rescue, pairing,
    sam_pe) == the Python align_pairs oracle, byte for byte, including
    rescued mates, unmapped ends, TLEN and mate fields."""
    opt = MemOptions(flag_a=flag_a)
    w = world
    n = 36 if flag_a else 24
    r1s, r2s = _pe_world(w.rng, w.ref, n)
    kw = {}
    if flag_a:
        kw = dict(names=[f"p{i}" for i in range(n)],
                  quals1=["".join(chr(33 + int(x)) for x in
                                  w.rng.integers(20, 40, len(r)))
                          for r in r1s],
                  quals2=["".join(chr(33 + int(x)) for x in
                                  w.rng.integers(20, 40, len(r)))
                          for r in r2s])
    want = python_pe(opt, w, r1s, r2s, port_host=True, **kw)
    got = _pipe(opt, w, 3 if flag_a else 1).align_pairs_chunk(
        r1s, r2s, _ext(opt, w), **kw)
    same_sam(got, want)


@pytest.mark.parametrize("what", ["rescue", "cigar"])
def test_pe_text_with_idx_backends(world, what):
    """The zero-object PE text path composed with resident-reference
    device rescue (mates made discordant, so rescue fires) or device
    CIGAR == the per-record path with the same backend == the Python
    host, byte for byte, the protocol firing."""
    opt = MemOptions()
    w = world
    n = 24 if what == "rescue" else 16
    r1s, r2s = _pe_world(w.rng, w.ref, n)
    if what == "rescue":
        for i in range(0, n, 6):
            r2s[i] = revcomp_read(r2s[i])  # discordant: rescue fires
    make = (resident.make_rescue_idx_backend if what == "rescue"
            else resident.make_cigar_idx_backend)
    base = make(w.ref.pac, CPU)
    calls = []

    def counting(*a):
        calls.append(a[1].shape)
        return base(*a)

    counting.idx = True
    kw = {f"{what}_fn": counting}
    want = _pipe(opt, w).align_pairs_chunk(r1s, r2s, _ext(opt, w), **kw)
    n_first = len(calls)
    text, nrec = _pipe(opt, w).align_pairs_chunk_text(r1s, r2s,
                                                      _ext(opt, w), **kw)
    assert n_first and len(calls) == 2 * n_first, "no wave or round fired"
    assert text == _text(want)
    assert nrec == sum(len(rr) for rr in want)
    same_sam(want, python_pe(opt, w, r1s, r2s))


def test_pe_mixed_read_lengths(world):
    """PE with different read lengths per end (150 vs 100 bp) and per
    pair: padding in the read matrix, TLEN and rescue windows stay
    correct; native == Python."""
    opt = MemOptions()
    w = world
    r1s, r2s = [], []
    for i in range(16):
        l1 = int(w.rng.integers(80, 151))
        l2 = int(w.rng.integers(60, 121))
        pos = int(w.rng.integers(0, w.ref.l_pac - 500))
        a = w.ref.pac[pos:pos + l1].astype(np.int64).copy()
        b = revcomp_read(w.ref.pac[pos + 300 - l2:pos + 300]
                         .astype(np.int64))
        p = int(w.rng.integers(0, l1))
        a[p] = (a[p] + 1) % 4
        r1s.append(a)
        r2s.append(b)
    want = python_pe(opt, w, r1s, r2s)
    same_sam(_pipe(opt, w).align_pairs_chunk(r1s, r2s, _ext(opt, w)), want)
