"""The port's packed-rank structures (bwamem_tpu_torch/index/occ_packed.py)
against its scalar FM-index, as tests/test_occ_packed.py holds the JAX
package's copy, and against that copy on the same text.  Where the JAX
test runs the expressions under jax.numpy, this one runs the port's
device twin (ops/smem_torch.DeviceOcc on the CPU); the xp namespace of
the port's copy is numpy only, and a torch namespace is refused.  The
`_wide_int` dtype of each namespace is pinned by
tests/test_torch_selfcontained.py."""

import dataclasses
import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

from bwamem_tpu.index import occ_packed as ref_occ
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu_torch.index import fmindex as F
from bwamem_tpu_torch.index.build import FMIndex, build_index
from bwamem_tpu_torch.index.occ_packed import (
    PackedOcc,
    extend_backward4,
    extend_forward4,
    pack_occ,
    rank4,
    sa_value_batch,
)
from bwamem_tpu_torch.ops import smem_torch

from _torch_gate import plain

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world():
    """(the port's fm and packed occ, the reference's packed occ of the
    same text)."""
    rng = np.random.default_rng(6)
    pac = rng.integers(0, 5, 3000).astype(np.uint8)  # includes Ns
    pac[pac == 4] = np.where(rng.random((pac == 4).sum()) < 0.9, 0, 4)
    fm = build_index(pac)
    po = pack_occ(fm)
    rpo = ref_occ.pack_occ(ref_build_index(pac))
    assert plain(po) == plain(rpo)
    return fm, po, rpo


def test_rank4_matches_scalar(world):
    fm, po, rpo = world
    rng = np.random.default_rng(0)
    pos = rng.integers(0, fm.seq_len2 + 2, 500)
    got = rank4(po, pos)
    np.testing.assert_array_equal(got, ref_occ.rank4(rpo, pos))
    for k in range(0, 500, 17):
        for c in range(4):
            assert got[k, c] == fm.rank(c, int(pos[k])), (k, c)


def test_rank4_edges(world):
    fm, po, rpo = world
    edges = np.array([0, 1, 63, 64, 65, fm.seq_len2 + 1])
    got = rank4(po, edges)
    np.testing.assert_array_equal(got, ref_occ.rank4(rpo, edges))
    for k, i in enumerate(edges):
        for c in range(4):
            assert got[k, c] == fm.rank(c, int(i))


def test_extend_backward4_matches_scalar(world):
    fm, po, rpo = world
    rng = np.random.default_rng(1)
    iks = []
    for _ in range(40):
        c = int(rng.integers(0, 4))
        ik = F.interval_of_char(fm, c)
        for _ in range(int(rng.integers(0, 4))):
            exts = F.extend_backward(fm, ik)
            nz = [e for e in exts if e.s > 0]
            if not nz:
                break
            ik = nz[int(rng.integers(0, len(nz)))]
        iks.append(ik)
    x0 = np.array([k.x0 for k in iks])
    x1 = np.array([k.x1 for k in iks])
    s = np.array([k.s for k in iks])
    got = extend_backward4(po, x0, x1, s)
    assert plain(got) == plain(ref_occ.extend_backward4(rpo, x0, x1, s))
    nx0, nx1, ns = got
    for k, ik in enumerate(iks):
        want = F.extend_backward(fm, ik)
        for c in range(4):
            assert (nx0[k, c], nx1[k, c], ns[k, c]) == \
                (want[c].x0, want[c].x1, want[c].s), (k, c)


def test_extend_forward4_matches_scalar(world):
    fm, po, rpo = world
    ik = F.interval_of_char(fm, 2)
    args = (np.array([ik.x0]), np.array([ik.x1]), np.array([ik.s]))
    got = extend_forward4(po, *args)
    assert plain(got) == plain(ref_occ.extend_forward4(rpo, *args))
    nx0, nx1, ns = got
    want = F.extend_forward(fm, ik)
    for c in range(4):
        assert (nx0[0, c], nx1[0, c], ns[0, c]) == \
            (want[c].x0, want[c].x1, want[c].s), c


def test_sa_value_batch(world):
    fm, po, rpo = world
    rng = np.random.default_rng(2)
    rows = rng.integers(0, fm.seq_len2 + 1, 300)
    got = sa_value_batch(po, fm.ssa, fm.sa_intv, rows)
    np.testing.assert_array_equal(
        got, ref_occ.sa_value_batch(rpo, fm.ssa, fm.sa_intv, rows))
    for k in range(0, 300, 13):
        assert got[k] == fm.sa_value(int(rows[k])), k


def test_device_rank_and_extend_match_numpy(world):
    """The port's device twin (smem_torch over a DeviceOcc on the CPU)
    gives what the numpy expressions give."""
    fm, po, _ = world
    d = smem_torch.DeviceOcc(po, CPU)
    rng = np.random.default_rng(3)
    pos = rng.integers(0, fm.seq_len2 + 1, 64)
    got = smem_torch.rank4(d, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), rank4(po, pos))
    x0 = np.minimum(pos[:16].astype(np.int64), fm.seq_len2 - 5)
    s = rng.integers(1, 5, 16).astype(np.int64)
    t = [torch.from_numpy(v) for v in (x0, x0, s)]
    for dev_fn, host_fn in ((smem_torch.extend_backward4, extend_backward4),
                            (smem_torch.extend_forward4, extend_forward4)):
        for g, w in zip(dev_fn(d, *t), host_fn(po, x0, x0, s)):
            np.testing.assert_array_equal(g.numpy(), w)


def test_device_path_keeps_64_bit_positions(world):
    """The device twin's positions and SA values are int64, with no
    warning raised, and equal to the numpy path's; the port's numpy
    expressions refuse a torch namespace rather than run it wrong."""
    fm, po, _ = world
    d = smem_torch.DeviceOcc(po, CPU)
    rng = np.random.default_rng(4)
    x0 = rng.integers(0, fm.seq_len2 - 5, 16).astype(np.int64)
    s = rng.integers(1, 5, 16).astype(np.int64)
    rows = rng.integers(0, fm.seq_len2 + 1, 32).astype(np.int64)
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = smem_torch.extend_backward4(d, *(torch.from_numpy(v)
                                               for v in (x0, x0, s)))
        vals = smem_torch.sa_batch(d, ssa, fm.sa_intv, torch.from_numpy(rows))
    assert all(g.dtype == torch.int64 for g in (*got, vals))
    for g, w in zip(got, extend_backward4(po, x0, x0, s)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        vals.numpy(), sa_value_batch(po, fm.ssa, fm.sa_intv, rows))
    for call in (lambda: rank4(po, torch.from_numpy(rows), torch),
                 lambda: sa_value_batch(po, ssa, fm.sa_intv,
                                        torch.from_numpy(rows), torch)):
        with pytest.raises(TypeError, match="smem_torch"):
            call()


def test_cache_roundtrip_bit_identical(world, tmp_path, monkeypatch):
    """The port's FMIndex and PackedOcc round-trip through the benchmark
    cache format (bench/cachefmt.py, numpy only) with exact dtypes and
    values: the fields the format names are the port's, as the
    reference's."""
    spec = importlib.util.spec_from_file_location(
        "cachefmt", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "bench", "cachefmt.py"))
    cachefmt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cachefmt)

    fm, po, _ = world
    monkeypatch.setattr(cachefmt, "idx_path",
                        lambda n: str(tmp_path / f"idx_{n}.npz"))
    monkeypatch.setattr(cachefmt, "occ_path",
                        lambda n: str(tmp_path / f"occ_{n}.npz"))
    assert {f.name for f in dataclasses.fields(FMIndex)} >= \
        set(cachefmt.IDX_FIELDS)
    assert {f.name for f in dataclasses.fields(PackedOcc)} == \
        set(cachefmt.OCC_FIELDS)
    n_bp = 3000
    cachefmt.save_idx(n_bp, fm)
    cachefmt.save_occ(n_bp, po)

    z = cachefmt.load_idx(n_bp)
    assert z is not None
    fm2 = FMIndex(**{f: (int(z[f]) if z[f].ndim == 0 else z[f])
                     for f in cachefmt.IDX_FIELDS})
    for f in ("C", "bwt", "occ_cp", "ssa", "pac"):
        a, b = getattr(fm, f), getattr(fm2, f)
        assert a.dtype == b.dtype, f"idx {f} dtype drift: {a.dtype}->{b.dtype}"
        np.testing.assert_array_equal(a, b)
    for f in ("l_pac", "seq_len2", "primary", "sa_intv"):
        assert getattr(fm, f) == getattr(fm2, f)

    z = cachefmt.load_occ(n_bp)
    assert z is not None
    po2 = PackedOcc(**{f: (int(z[f]) if z[f].ndim == 0 else z[f])
                       for f in cachefmt.OCC_FIELDS})
    assert plain(po2) == plain(po)

    # a wrong format version must force a rebuild, not a silent reuse
    monkeypatch.setattr(cachefmt, "OCC_FMT", cachefmt.OCC_FMT + 1)
    assert cachefmt.load_occ(n_bp) is None
    # a truncated file must fail closed too
    p = cachefmt.occ_path(n_bp)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[: len(raw) // 2])
    monkeypatch.setattr(cachefmt, "OCC_FMT", cachefmt.OCC_FMT - 1)
    assert cachefmt.load_occ(n_bp) is None
