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
beyond it, and on a few lanes at a long target window.  The CIGAR body
follows the band in a window sized from the round's widest band: it is
held at one band for every row of its launch table (read from
global_sw.cuh) and the memory row above it, with its z plane in the
blocks' shared memory and in global scratch, on rounds that mix w 19
with the band-doubling retries' widths, and with a band from the host
too narrow for a lane (the error word)."""

import ctypes
import functools
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

# the shared memory a block can have on an H100 (its opt-in limit,
# cudaDevAttrMaxSharedMemoryPerBlockOptin): the CIGAR kernel's slots go
# there when a block's fit
H100_SMEM = 227 * 1024
GLOBAL_TABLE = gate.global_launch_table(os.path.join(
    _ROOT, "bwamem_tpu_torch", "csrc", "global_sw.cuh"))

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
    lib.emu_global_cigar.argtypes = [vp, i32, vp, vp, i32, vp, vp, i64, i32,
                                     vp, vp, vp, vp, vp, i64]
    lib.emu_sw_shape.argtypes = [i32, i64, vp, vp, vp]
    lib.emu_global_last.argtypes = [vp]
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


def emu_global(lib, args, smem_cap=H100_SMEM, band=None):
    """The CIGAR launcher on the batch, its band as the callers give it
    (global_torch.band_width) unless `band` is given; returns (score,
    steps, (G, C, slots in shared memory, blocks, threads) of the launch,
    the error word)."""
    q, qlen, t, tlen, w, mat, pens = _c(args)
    B = q.shape[0]
    score = np.full(B, -77, np.int32)
    steps = np.full((q.shape[1] + t.shape[1], B), -7, np.int8)
    err = np.zeros(1, np.int32)
    if band is None:
        band = global_torch.band_width(qlen, tlen, w, q.shape[1])
    assert lib.emu_global_cigar(_ptr(q), q.shape[1], _ptr(qlen), _ptr(t),
                                t.shape[1], _ptr(tlen), _ptr(w), B, band,
                                _ptr(mat), _ptr(pens), _ptr(score),
                                _ptr(steps), _ptr(err), smem_cap) == 0
    shape = (ctypes.c_int * 5)()
    lib.emu_global_last(shape)
    return score, steps, tuple(shape), int(err[0])


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


def check_global(lib, args, with_jax=True, smem_cap=H100_SMEM,
                 want=None):
    """The emulated CIGAR kernel == the plain version (and the JAX
    program) on every lane; `want` = (plain, JAX) results made before.
    Returns the plain version's (score, steps) and the launch's shape."""
    gs, gst, shape, err = emu_global(lib, args, smem_cap)
    assert err == 0
    ws, wst = want[0] if want else plain_global(args)
    _same(gs, ws, "score: emulated kernel vs plain")
    _same(gst, wst, "steps: emulated kernel vs plain")
    if with_jax:
        js, jst = want[1] if want else jax_global(args)
        _same(gs, js, "score: emulated kernel vs global_jax._global_batch")
        _same(gst, jst.astype(np.int8),
              "steps: emulated kernel vs global_jax._global_batch")
    return (ws, wst), shape


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
    (_, steps), _ = check_global(emu, args)
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
    _, shape = check_global(emu, args, with_jax=False)
    assert shape[2] == 0     # 1 MB planes: in global scratch


def test_global_body_at_tmax_16384(emu):
    """The CIGAR body on a lane at the gates' longest target window (tmax
    16384, its query at the far end: the band is the whole query, the
    planes go to global scratch), beside a short lane and a padding lane;
    the plain version alone (the JAX program compiles a scan a shape)."""
    args = gate.global_sw_batch(72, 3, 160, 16384, n_pad=1)
    rng = np.random.default_rng(72)
    args[2][0] = rng.integers(0, 4, 16384)
    args[0][0, :] = args[2][0, 16200:16360]
    args[1][0], args[3][0], args[4][0] = 160, 16384, 19
    (_, steps), shape = check_global(emu, args, with_jax=False)
    assert shape[:3] == (32, 5, 0)
    assert (steps[:, 0] == 1).sum() >= 16000   # the long D run


def _table_rows():
    """(band, G, C, plane): a band for every row of the CIGAR kernel's
    launch table with the slots in shared memory and in global scratch,
    and one above the last row (the memory row, C 0, always in global
    scratch)."""
    out = [(band, g, c, plane) for band, g, c in GLOBAL_TABLE
           for plane in ("shared", "global")]
    out.append((GLOBAL_TABLE[-1][0] + 44, 32, 0, "global"))
    return out


def _band_round(band):
    """A round of global_band_batch at `band`: 64 lanes (48 live), windows
    shared by neighbouring rows (so the JAX program compiles a few
    shapes)."""
    qmax = next(w for w in (64, 128, 256, 320) if w >= band)
    return gate.global_band_batch(band, 64, qmax, qmax + 16, band,
                                  arbitrary=band % 2 == 0)


@functools.lru_cache(maxsize=None)
def _band_want(band):
    args = _band_round(band)
    return plain_global(args), jax_global(args)


@pytest.mark.parametrize("band,G,C,plane", _table_rows(),
                         ids=[f"{b}-{g}x{c}-{p}"
                              for b, g, c, p in _table_rows()])
def test_global_body_at_every_table_row(emu, band, G, C, plane):
    """The CIGAR body at a band in every row of its launch table, its
    slots in the blocks' shared memory (where a block of 128, 64 or 32
    threads has room) and in global scratch (as on a card with no room):
    == plain == JAX."""
    args = _band_round(band)
    assert global_torch.band_width(*(args[k] for k in (1, 3, 4)),
                                   args[0].shape[1]) == band - 1 + band % 2
    _, shape = check_global(emu, args, want=_band_want(band),
                            smem_cap=H100_SMEM if plane == "shared" else 0)
    assert shape[:3] == (G, C, plane == "shared")
    assert shape[3] >= 2


@pytest.mark.parametrize("lanes", [96, 1024])
def test_global_body_on_a_retry_round(emu, lanes):
    """A round that mixes w 19 with the band-doubling retries' widths (38,
    76, 152) on read-like lanes with indels, at 96 and 1,024 lanes; ==
    plain == JAX."""
    args = gate.global_retry_batch(lanes, lanes, n_pad=max(lanes - 96, 8))
    (_, steps), shape = check_global(emu, args)
    assert shape[2] == 1 and (args[4] == 152).sum() >= 8
    assert (steps == 1).any(0).sum() >= 3 and (steps == 2).any(0).sum() >= 3


@pytest.mark.parametrize("plane", ["shared", "global"])
@pytest.mark.parametrize("band,passed,flagged",
                         [(160, 31, True), (160, 130, False),
                          (33, 32, True), (300, 260, True)],
                         ids=["narrower-flagged", "within-window",
                              "one-column-over", "memory-row-flagged"])
def test_global_body_flags_a_band_too_narrow(emu, band, passed, flagged,
                                             plane):
    """A band from the host narrower than the round's widest (159, 33 or
    299): where the launch's window cannot hold a lane's band the kernel
    sets its error word (the wrapper then raises); where the window, sized
    up to its table row, still holds every lane's band, the result is
    exact and nothing is flagged."""
    args = _band_round(band)
    gs, gst, _, err = emu_global(
        emu, args, smem_cap=H100_SMEM if plane == "shared" else 0,
        band=passed)
    assert err == int(flagged)
    if not flagged:
        (ws, wst), _ = _band_want(band)
        _same(gs, ws, "score: emulated kernel vs plain")
        _same(gst, wst, "steps: emulated kernel vs plain")
