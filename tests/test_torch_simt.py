"""The CUDA pass body itself, on the CPU: bwamem_tpu_torch/csrc/band_pass.cuh
is compiled by g++ against a stand-in cuda_runtime.h (tests/_simt/) whose
warp primitives run the threads of a group as cooperative fibers, and the
two kernel bodies (extend_t_body, extend_fused_body, through the same
shape dispatch as the launchers) are held against the plain PyTorch
version on every row of every alignment: exact equality, integers.  This
runs the very source that nvcc compiles for the card, at every group
width and strip length of the dispatch table, with 32-bit cells and with
the packed 16-bit cells (the _i16 entry points; the stand-in header gives
the packed DPX intrinsics the semantics of the CUDA math API), each
against the plain version of the same cell type."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import extend_torch

import _torch_gate as gate

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
BLK = 128


def _prm(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100):
    return np.array([a, b, o_del, e_del, o_ins, e_ins, zdrop, 0], np.int32)


@pytest.fixture(scope="module")
def simt(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("simt") / "libsimt.so")
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
           "-I", os.path.join(_HERE, "_simt"),
           "-I", os.path.join(_ROOT, "bwamem_tpu_torch", "csrc"),
           "-o", so, os.path.join(_HERE, "_simt", "simt_emulate.cpp")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError:
        pytest.skip("no g++")
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.emu_extend_t, lib.emu_extend_t_i16):
        fn.restype = i32
        fn.argtypes = [vp, i32, vp, i32, vp, i64] + [i32] * 7 + [vp]
    for fn in (lib.emu_extend_fused, lib.emu_extend_fused_i16):
        fn.restype = i32
        fn.argtypes = ([vp, i32, vp, i32, vp, i32, vp, i32, vp, i64]
                       + [i32] * 7 + [vp])
    return lib


# cell type -> (suffix of the emulated entry point, the plain version's
# compute_dtype)
CELLS = {"i32": ("", torch.int32), "i16": ("_i16", torch.int16)}


def _emu_t(lib, batch, prm, cells="i32"):
    q, t, scal, _ = (np.ascontiguousarray(x) for x in batch)
    out = np.full((8, q.shape[1]), -77, np.int32)
    rc = getattr(lib, "emu_extend_t" + CELLS[cells][0])(
        q.ctypes.data, q.shape[0], t.ctypes.data, t.shape[0],
        scal.ctypes.data, q.shape[1], *extend_torch.prm_ints(prm),
        out.ctypes.data)
    assert rc == 0
    return out


def _emu_fused(lib, batch, prm, cells="i32"):
    ql, tl, qr, tr, scal, _ = (np.ascontiguousarray(x) for x in batch)
    out = np.full((32, ql.shape[1]), -77, np.int32)
    rc = getattr(lib, "emu_extend_fused" + CELLS[cells][0])(
        ql.ctypes.data, ql.shape[0], tl.ctypes.data, tl.shape[0],
        qr.ctypes.data, qr.shape[0], tr.ctypes.data, tr.shape[0],
        scal.ctypes.data, ql.shape[1], *extend_torch.prm_ints(prm),
        out.ctypes.data)
    assert rc == 0
    return out


def _plain_t(batch, prm, cells="i32"):
    return extend_torch.extend_t(*(torch.from_numpy(x) for x in batch), prm,
                                 compute_dtype=CELLS[cells][1]).numpy()


def _plain_fused(batch, prm, cells="i32"):
    return extend_torch.extend_fused(
        *(torch.from_numpy(x) for x in batch), prm,
        compute_dtype=CELLS[cells][1]).numpy()


def _same(got, want):
    bad = np.argwhere(got != want)
    assert bad.size == 0, (len(bad), bad[:8], got[tuple(bad[0])],
                           want[tuple(bad[0])])


# one query window per row of the dispatch table: (group, strip) =
# (8,4) (16,4) (32,4) (32,5) (32,6) (32,8) and the shared-memory row
QMAXES = (24, 33, 104, 160, 180, 250, 300)


@pytest.mark.parametrize("qmax", QMAXES)
@pytest.mark.parametrize("zdrop", [100, 0])
def test_pass_body_t_matches_plain_random(simt, qmax, zdrop):
    batch = gate.random_t_batch(qmax + zdrop, BLK, qmax, qmax + 70,
                                n_pad=9, blk_l=BLK)
    prm = _prm(zdrop=zdrop)
    _same(_emu_t(simt, batch, prm), _plain_t(batch, prm))


@pytest.mark.parametrize("qmax", QMAXES)
@pytest.mark.parametrize("zdrop", [100, 0])
def test_pass_body_t_i16_matches_plain_random(simt, qmax, zdrop):
    batch = gate.random_t_batch(qmax + zdrop, BLK, qmax, qmax + 70,
                                n_pad=9, blk_l=BLK)
    prm = _prm(zdrop=zdrop)
    _same(_emu_t(simt, batch, prm, "i16"), _plain_t(batch, prm, "i16"))


@pytest.mark.parametrize("cells", list(CELLS))
@pytest.mark.parametrize("pen", [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3),
                                 (2, 3, 2, 1, 2, 1)])
@pytest.mark.parametrize("qmax", [104, 160, 300])
def test_pass_body_t_matches_plain_penalties(simt, qmax, pen, cells):
    batch = gate.random_t_batch(sum(pen), BLK, qmax, 200, n_pad=3,
                                blk_l=BLK)
    prm = _prm(*pen, zdrop=40)
    _same(_emu_t(simt, batch, prm, cells), _plain_t(batch, prm, cells))


@pytest.mark.parametrize("qmax", QMAXES + (1024,))
def test_pass_body_t_matches_plain_hard_cases(simt, qmax):
    batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    for zdrop in (100, 0):
        prm = _prm(zdrop=zdrop)
        _same(_emu_t(simt, batch, prm), _plain_t(batch, prm))


@pytest.mark.parametrize("qmax", QMAXES + (1024,))
def test_pass_body_t_i16_matches_plain_hard_cases(simt, qmax):
    """The packed 16-bit body on the hard cases, zdrop on; off as well in
    one register window and one shared-memory window."""
    batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    for zdrop in (100, 0) if qmax in (104, 300) else (100,):
        prm = _prm(zdrop=zdrop)
        _same(_emu_t(simt, batch, prm, "i16"), _plain_t(batch, prm, "i16"))


@pytest.mark.parametrize("cells", list(CELLS))
@pytest.mark.parametrize("shape", [(24, 60, 30, 50), (60, 90, 40, 90),
                                   (104, 160, 96, 160), (160, 200, 150, 220),
                                   (250, 120, 180, 120), (300, 80, 280, 90)])
def test_pass_body_fused_matches_plain_random(simt, shape, cells):
    batch = gate.random_fused_batch(sum(shape), BLK, shape, n_pad=7,
                                    blk_l=BLK)
    prm = _prm()
    _same(_emu_fused(simt, batch, prm, cells),
          _plain_fused(batch, prm, cells))


@pytest.mark.parametrize("qmax,cells", [(160, "i32"), (1024, "i32"),
                                        (160, "i16")])
def test_pass_body_fused_matches_plain_hard_cases(simt, qmax, cells):
    batch = gate.hard_fused_batch(11, qmax, blk_l=BLK)
    prm = _prm()
    _same(_emu_fused(simt, batch, prm, cells),
          _plain_fused(batch, prm, cells))


def test_stand_in_packed_intrinsics(simt):
    """The stand-in header's packed intrinsics wrap and compare per signed
    halfword, as the CUDA math API says (through the 16-bit body: a batch
    whose scores reach the top of the exact range, 2^14 - 1)."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 4, (128, BLK)).astype(np.int8)
    t = np.concatenate([q, rng.integers(0, 4, (32, BLK)).astype(np.int8)])
    scal = np.zeros((8, BLK), np.int32)
    scal[0], scal[1], scal[2], scal[3] = 128, 160, 100, 127
    batch = (q, t, scal, np.array([160], np.int32))
    prm = _prm(a=127, b=127, o_del=60, e_del=9, o_ins=70, e_ins=11)
    want = _plain_t(batch, prm, "i32")
    assert want[0].max() == 127 + 127 * 128 == (1 << 14) - 1
    _same(_plain_t(batch, prm, "i16"), want)
    _same(_emu_t(simt, batch, prm, "i16"), want)
