"""The CUDA pass body itself, on the CPU: bwamem_tpu_torch/csrc/band_pass.cuh
is compiled by g++ against a stand-in cuda_runtime.h (tests/_simt/) whose
warp primitives run the threads of a group as cooperative fibers, and the
two kernel bodies (extend_t_body, extend_fused_body, through the same
shape dispatch as the launchers) are held against the plain PyTorch
version on every row of every alignment: exact equality, integers.  This
runs the very source that nvcc compiles for the card, at every group
width and strip length of the dispatch table."""

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
    lib.emu_extend_t.restype = i32
    lib.emu_extend_t.argtypes = ([vp, i32, vp, i32, vp, i64] + [i32] * 7
                                 + [vp])
    lib.emu_extend_fused.restype = i32
    lib.emu_extend_fused.argtypes = (
        [vp, i32, vp, i32, vp, i32, vp, i32, vp, i64] + [i32] * 7 + [vp])
    return lib


def _emu_t(lib, batch, prm):
    q, t, scal, _ = (np.ascontiguousarray(x) for x in batch)
    out = np.full((8, q.shape[1]), -77, np.int32)
    rc = lib.emu_extend_t(q.ctypes.data, q.shape[0], t.ctypes.data,
                          t.shape[0], scal.ctypes.data, q.shape[1],
                          *extend_torch.prm_ints(prm), out.ctypes.data)
    assert rc == 0
    return out


def _emu_fused(lib, batch, prm):
    ql, tl, qr, tr, scal, _ = (np.ascontiguousarray(x) for x in batch)
    out = np.full((32, ql.shape[1]), -77, np.int32)
    rc = lib.emu_extend_fused(
        ql.ctypes.data, ql.shape[0], tl.ctypes.data, tl.shape[0],
        qr.ctypes.data, qr.shape[0], tr.ctypes.data, tr.shape[0],
        scal.ctypes.data, ql.shape[1], *extend_torch.prm_ints(prm),
        out.ctypes.data)
    assert rc == 0
    return out


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
    want = extend_torch.extend_t(*(torch.from_numpy(x) for x in batch),
                                 prm).numpy()
    _same(_emu_t(simt, batch, prm), want)


@pytest.mark.parametrize("pen", [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3),
                                 (2, 3, 2, 1, 2, 1)])
@pytest.mark.parametrize("qmax", [104, 160, 300])
def test_pass_body_t_matches_plain_penalties(simt, qmax, pen):
    batch = gate.random_t_batch(sum(pen), BLK, qmax, 200, n_pad=3,
                                blk_l=BLK)
    prm = _prm(*pen, zdrop=40)
    want = extend_torch.extend_t(*(torch.from_numpy(x) for x in batch),
                                 prm).numpy()
    _same(_emu_t(simt, batch, prm), want)


@pytest.mark.parametrize("qmax", QMAXES + (1024,))
def test_pass_body_t_matches_plain_hard_cases(simt, qmax):
    batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    for zdrop in (100, 0):
        prm = _prm(zdrop=zdrop)
        want = extend_torch.extend_t(
            *(torch.from_numpy(x) for x in batch), prm).numpy()
        _same(_emu_t(simt, batch, prm), want)


@pytest.mark.parametrize("shape", [(24, 60, 30, 50), (60, 90, 40, 90),
                                   (104, 160, 96, 160), (160, 200, 150, 220),
                                   (250, 120, 180, 120), (300, 80, 280, 90)])
def test_pass_body_fused_matches_plain_random(simt, shape):
    batch = gate.random_fused_batch(sum(shape), BLK, shape, n_pad=7,
                                    blk_l=BLK)
    prm = _prm()
    want = extend_torch.extend_fused(
        *(torch.from_numpy(x) for x in batch), prm).numpy()
    _same(_emu_fused(simt, batch, prm), want)


@pytest.mark.parametrize("qmax", [160, 1024])
def test_pass_body_fused_matches_plain_hard_cases(simt, qmax):
    batch = gate.hard_fused_batch(11, qmax, blk_l=BLK)
    prm = _prm()
    want = extend_torch.extend_fused(
        *(torch.from_numpy(x) for x in batch), prm).numpy()
    _same(_emu_fused(simt, batch, prm), want)
