"""The mate-rescue and CIGAR kernels' CUDA source itself, on the CPU:
bwamem_tpu_torch/csrc/local_sw.cuh and global_sw.cuh (the bodies of
bwt_local_align6 and bwt_global_cigar, over sw_rows.cuh) are compiled by
g++ against the stand-in cuda_runtime.h of tests/_simt/ through
tests/_simt/simt_sw_emulate.cpp, whose launchers make the kernels' launch
(shape table, grid, per-group scratch slots, which start as garbage) and
run the threads of each group as fibers.  Both bodies are held, exactly,
against the plain PyTorch versions (ops/local_torch.align6,
ops/global_torch.global_batch) and the JAX package's compiled programs
(local_jax._align6, global_jax._global_batch): on the task generators of
tests/test_torch_local.py / test_torch_global.py (random matrices and
penalties, ties, N codes), on the hard-case batches of tests/
_torch_gate.py (an arbitrary 5x5 matrix, padding lanes, best-0 lanes,
bands narrower than |tlen - qlen|, tlen above and below qlen) in a window
for every group width and strip of the launch table and for the memory row
beyond it, and on a few lanes at a long target window."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.ops import global_jax, local_jax
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.ops import global_torch, local_torch

import _torch_gate as gate
from test_global_jax import _rand_task as _rand_global
from test_local_jax import _rand_task as _rand_local

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)

# one window per row of sw_rows.cuh's launch table: (group, strip) = (8, 4)
# (16, 4) (32, 4) (32, 5) (32, 6) (32, 8), and the memory row (32, 0)
WINDOWS = {(8, 4): (24, 60), (16, 4): (50, 100), (32, 4): (100, 130),
           (32, 5): (160, 300), (32, 6): (180, 200), (32, 8): (250, 90),
           (32, 0): (300, 200)}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("simt_sw") / "libsimt_sw.so")
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
           "-I", os.path.join(_HERE, "_simt"),
           "-I", os.path.join(_ROOT, "bwamem_tpu_torch", "csrc"),
           "-o", so, os.path.join(_HERE, "_simt", "simt_sw_emulate.cpp")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError:
        pytest.skip("no g++")
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.emu_local_align6.argtypes = [vp, i32, vp, vp, i32, vp, i64, vp, vp,
                                     vp]
    lib.emu_global_cigar.argtypes = [vp, i32, vp, vp, i32, vp, vp, i64, vp,
                                     vp, vp, vp]
    lib.emu_sw_shape.argtypes = [i32, i64, vp, vp, vp]
    for fn in (lib.emu_local_align6, lib.emu_global_cigar, lib.emu_sw_shape):
        fn.restype = i32
    return lib


def _c(args):
    return [np.ascontiguousarray(a, np.int32) for a in args]


def _ptr(a):
    return a.ctypes.data


def emu_local(lib, args):
    q, qlen, t, tlen, mat, pens = _c(args)
    out = np.full((6, q.shape[0]), -77, np.int32)
    assert lib.emu_local_align6(_ptr(q), q.shape[1], _ptr(qlen), _ptr(t),
                                t.shape[1], _ptr(tlen), q.shape[0],
                                _ptr(mat), _ptr(pens), _ptr(out)) == 0
    return out


def emu_global(lib, args):
    q, qlen, t, tlen, w, mat, pens = _c(args)
    B = q.shape[0]
    score = np.full(B, -77, np.int32)
    steps = np.full((q.shape[1] + t.shape[1], B), -7, np.int8)
    assert lib.emu_global_cigar(_ptr(q), q.shape[1], _ptr(qlen), _ptr(t),
                                t.shape[1], _ptr(tlen), _ptr(w), B,
                                _ptr(mat), _ptr(pens), _ptr(score),
                                _ptr(steps)) == 0
    return score, steps


def plain_local(args):
    return local_torch.align6(*(torch.from_numpy(a)
                                for a in _c(args))).numpy()


def jax_local(args):
    q, qlen, t, tlen, mat, pens = _c(args)
    return np.asarray(local_jax._align6(
        jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t), jnp.asarray(tlen),
        jnp.asarray(mat), jnp.asarray(pens), qmax=q.shape[1],
        tmax=t.shape[1]))


def plain_global(args):
    s, st = global_torch.global_batch(*(torch.from_numpy(a)
                                        for a in _c(args)))
    return s.numpy(), st.numpy()


def jax_global(args):
    q, qlen, t, tlen, w, mat, pens = _c(args)
    s, st = global_jax._global_batch(
        jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t), jnp.asarray(tlen),
        jnp.asarray(w), jnp.asarray(mat), jnp.asarray(pens),
        qmax=q.shape[1], tmax=t.shape[1])
    return np.asarray(s), np.asarray(st)


def _same(got, want, what):
    bad = np.argwhere(got != want)
    assert bad.size == 0, (what, len(bad), bad[:8].tolist())


def check_local(lib, args, with_jax=True):
    got = emu_local(lib, args)
    want = plain_local(args)
    _same(got, want, "emulated kernel vs plain")
    if with_jax:
        _same(got, jax_local(args), "emulated kernel vs local_jax._align6")
    return want


def check_global(lib, args, with_jax=True):
    gs, gst = emu_global(lib, args)
    ws, wst = plain_global(args)
    _same(gs, ws, "score: emulated kernel vs plain")
    _same(gst, wst, "steps: emulated kernel vs plain")
    if with_jax:
        js, jst = jax_global(args)
        _same(gs, js, "score: emulated kernel vs global_jax._global_batch")
        _same(gst, jst.astype(np.int8),
              "steps: emulated kernel vs global_jax._global_batch")
    return ws, wst


def test_launch_table_covers_every_shape(emu):
    """The windows of WINDOWS take each row of the launch table (and the
    memory row), and a batch needs more than one block of every width."""
    g, c, blocks = (ctypes.c_int() for _ in range(3))
    for (G, C), (qmax, _) in WINDOWS.items():
        assert emu.emu_sw_shape(qmax, 40, ctypes.byref(g), ctypes.byref(c),
                                ctypes.byref(blocks)) == 0
        assert (g.value, c.value) == (G, C), qmax
        assert blocks.value >= 2
    assert emu.emu_sw_shape(5000, 40, ctypes.byref(g), ctypes.byref(c),
                            ctypes.byref(blocks)) == 0
    assert (g.value, c.value) == (32, 0)


@pytest.mark.parametrize("shape", list(WINDOWS), ids=str)
@pytest.mark.parametrize("arbitrary", [True, False],
                         ids=["arbitrary_matrix", "bwa_matrix"])
def test_local_body_matches_plain_and_jax(emu, shape, arbitrary):
    qmax, tmax = WINDOWS[shape]
    args = gate.local_sw_batch(qmax + tmax + arbitrary, 40, qmax, tmax,
                               arbitrary=arbitrary)
    want = check_local(emu, args)
    # not vacuous: scores, padding lanes and lanes whose best is 0
    assert (want[0] > 0).sum() >= 25 and (want[:, -3:] == 0).all()
    assert ((want[0] == 0) & (args[1] > 0)).sum() >= 2


@pytest.mark.parametrize("shape", list(WINDOWS), ids=str)
@pytest.mark.parametrize("arbitrary", [True, False],
                         ids=["arbitrary_matrix", "bwa_matrix"])
def test_global_body_matches_plain_and_jax(emu, shape, arbitrary):
    qmax, tmax = WINDOWS[shape]
    args = gate.global_sw_batch(qmax + tmax + arbitrary, 40, qmax, tmax,
                                arbitrary=arbitrary)
    _, steps = check_global(emu, args)
    q, qlen, t, tlen, w = args[:5]
    # not vacuous: bands narrower than |tlen - qlen|, tlen above and below
    # qlen, one-base lanes, CIGARs with D and with I, padding all 3s
    live = qlen > 0
    assert (live & (w < np.abs(tlen - qlen))).sum() >= 3
    assert (tlen > qlen).sum() >= 3 and (live & (tlen < qlen)).sum() >= 3
    assert (live & ((qlen == 1) | (tlen == 1))).sum() >= 2
    assert (steps == 1).any(0).sum() >= 3 and (steps == 2).any(0).sum() >= 3
    assert (steps[:, -3:] == 3).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_local_body_on_the_rand_tasks(emu, seed):
    """The tasks of tests/test_local_jax.py, at random scoring, packed as
    local_torch.ksw_align_batch packs them (power-of-two windows)."""
    rng = np.random.default_rng(seed)
    a, b = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    mat = MemOptions(a=a, b=b).mat.astype(np.int32)
    pens = rng.integers(1, 8, 4).astype(np.int32)
    tasks = [_rand_local(rng) for _ in range(48)]
    q, qlen, t, tlen = gate._pack_tasks(tasks, 48, 64, 128)
    check_local(emu, (q, qlen, t, tlen, mat, pens))


def test_local_body_on_ties(emu):
    """tests/test_torch_local.py's ties: one repeated unit against several
    copies under an arbitrary matrix, so the first row and the leftmost
    column decide."""
    rng = np.random.default_rng(11)
    mat = rng.integers(-6, 5, (5, 5)).astype(np.int32)
    mat[np.arange(4), np.arange(4)] = rng.integers(1, 4, 4)
    tasks = []
    for k in range(24):
        unit = rng.integers(0, 4, int(rng.integers(2, 6)))
        q = np.resize(unit, int(rng.integers(4, 20)))
        t = np.resize(unit, int(rng.integers(20, 60)))
        if k % 3 == 0:
            t[rng.integers(0, len(t))] = 4
        tasks.append((q, t))
    q, qlen, t, tlen = gate._pack_tasks(tasks, 24, 32, 64)
    want = check_local(emu, (q, qlen, t, tlen, mat,
                             np.array([3, 1, 2, 2], np.int32)))
    assert ((want[0] > 0) & (want[4] < tlen - qlen)).sum() >= 8


@pytest.mark.parametrize("seed", [0, 1])
def test_global_body_on_the_rand_tasks(emu, seed):
    """The tasks of tests/test_global_jax.py, at random scoring, packed as
    global_torch.ksw_global_batch packs them."""
    rng = np.random.default_rng(seed)
    a, b = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    mat = MemOptions(a=a, b=b).mat.astype(np.int32)
    pens = rng.integers(1, 8, 4).astype(np.int32)
    tasks = [_rand_global(rng) for _ in range(48)]
    q, qlen, t, tlen = gate._pack_tasks([x[:2] for x in tasks], 48, 64, 64)
    w = np.array([x[2] for x in tasks], np.int32)
    check_global(emu, (q, qlen, t, tlen, w, mat, pens))


def test_long_target_window(emu):
    """A few lanes at a long target window (rows past 2^11, z planes and
    row bests of 2^20 entries a slot), a padding lane beside them; the
    plain version alone (the JAX programs compile a scan a shape)."""
    args = gate.local_sw_batch(70, 5, 64, 4096, n_pad=1)
    args[2][0] = np.random.default_rng(70).integers(0, 4, 4096)
    args[0][0, :] = args[2][0, 4000:4064]   # the mate at the far end
    args[1][0], args[3][:2] = 64, 4096
    want = check_local(emu, args, with_jax=False)
    assert want[4][0] > 4000
    args = gate.global_sw_batch(71, 5, 256, 4096, n_pad=1)
    args[2][0] = np.random.default_rng(71).integers(0, 4, 4096)
    args[0][0, :] = args[2][0, 3800:4056]   # a full query at the far end
    args[1][0], args[3][0], args[4][0] = 256, 4096, 8
    check_global(emu, args, with_jax=False)
