"""The packed 16-bit pass body (bwamem_tpu_torch/csrc/band_pass16.cuh) on
the CPU, row by row of its own launch table: csrc/band_pass.cuh compiled
by g++ against the stand-in cuda_runtime.h (tests/_simt/), both kernel
bodies (extend_t_body, extend_fused_body with int16_t cells, through the
same shape dispatch as the _i16 launchers), held exactly against the plain
PyTorch version with 16-bit cells and with 32-bit cells on every output
row and lane.

One query window per row of BWT_LAUNCH_TABLE16 (read from
csrc/launch_table.cuh, so the cases follow the table) and one in the
shared-memory row above it (the test checks that the dispatch took that
row).  Each window gets random batches
with zdrop on and off, the hard cases of tests/_torch_gate.py, the three
penalty sets, scores at the top of the 16-bit range, and band edges on
every pair boundary and on the half-strip seam (odd query lengths, bands
narrower than a strip)."""

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
_CSRC = os.path.join(_ROOT, "bwamem_tpu_torch", "csrc")
BLK = 128   # lanes of the hard-case and band-edge batches
SMALL = 64  # lanes of the random batches


TABLE16 = gate.launch_table16(
    os.path.join(_CSRC, "launch_table.cuh"))
# (query window, expected G * 1000 + C): the largest window of each row,
# then the smallest of the shared-memory row
WINDOWS = [(q, g * 1000 + c) for q, g, c in TABLE16]
WINDOWS += [(TABLE16[-1][0] + 1, 32000)]
# (ids as since the table's first version, whose rows also named a least
# number of lanes: BLK, the most that a case's batch has)
IDS = [f"q{q}-lanes{BLK}-shape{s}" for q, s in WINDOWS]
PENALTIES = [(1, 4, 6, 1, 6, 1), (1, 4, 5, 2, 7, 3), (2, 3, 2, 1, 2, 1)]


def _prm(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100):
    return np.array([a, b, o_del, e_del, o_ins, e_ins, zdrop, 0], np.int32)


@pytest.fixture(scope="module")
def simt(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("simt16") / "libsimt16.so")
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
           "-I", os.path.join(_HERE, "_simt"), "-I", _CSRC,
           "-o", so, os.path.join(_HERE, "_simt", "simt_emulate.cpp")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError:
        pytest.skip("no g++")
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.emu_extend_t_i16.restype = i32
    lib.emu_extend_t_i16.argtypes = [vp, i32, vp, i32, vp, i64] + [i32] * 7 \
        + [vp]
    lib.emu_extend_fused_i16.restype = i32
    lib.emu_extend_fused_i16.argtypes = ([vp, i32, vp, i32, vp, i32, vp, i32,
                                          vp, i64] + [i32] * 7 + [vp])
    lib.emu_last_shape.restype = i32
    return lib


def _emu(lib, batch, prm, shape):
    """The 16-bit body on `batch` (extend_t's 4-tuple or the fused
    6-tuple); checks that it ran the launch shape `shape`."""
    arrays = [np.ascontiguousarray(x) for x in batch[:-1]]
    fused = len(arrays) == 5
    out = np.full((32 if fused else 8, arrays[0].shape[1]), -77, np.int32)
    dims = [v for x in arrays[:-1] for v in (x.ctypes.data, x.shape[0])]
    fn = lib.emu_extend_fused_i16 if fused else lib.emu_extend_t_i16
    rc = fn(*dims, arrays[-1].ctypes.data, arrays[0].shape[1],
            *extend_torch.prm_ints(prm), out.ctypes.data)
    assert rc == 0
    assert lib.emu_last_shape() == shape, (lib.emu_last_shape(), shape)
    return out


def _plain(batch, prm, dt):
    plain = extend_torch.extend_fused if len(batch) == 6 \
        else extend_torch.extend_t
    return plain(*(torch.from_numpy(x) for x in batch), prm,
                 compute_dtype=dt).numpy()


def _check(lib, batch, prm, shape):
    """The 16-bit body == plain 16-bit == plain 32-bit, every row and
    lane."""
    got = _emu(lib, batch, prm, shape)
    want16 = _plain(batch, prm, torch.int16)
    want32 = _plain(batch, prm, torch.int32)
    for want in (want16, want32):
        bad = np.argwhere(got != want)
        assert bad.size == 0, (len(bad), bad[:8], got[tuple(bad[0])],
                               want[tuple(bad[0])])
    return got


def _fused_shape(qmax):
    """Fused windows (QL, TL, QR, TR) of query window qmax."""
    return (qmax, qmax + 30, max(qmax - 7, 1), qmax + 20)


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
@pytest.mark.parametrize("zdrop", [100, 0])
def test_simt16_t_random(simt, qmax, shape, zdrop):
    batch = gate.random_t_batch(qmax + zdrop, SMALL, qmax, qmax + 30,
                                n_pad=5, blk_l=SMALL)
    # a lane count that leaves groups of the last warp past the batch
    batch = tuple(x[:, :SMALL - 3] for x in batch[:3]) + batch[3:]
    _check(simt, batch, _prm(zdrop=zdrop), shape)


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
def test_simt16_fused_random(simt, qmax, shape):
    batch = gate.random_fused_batch(qmax, SMALL, _fused_shape(qmax),
                                    n_pad=5, blk_l=SMALL)
    _check(simt, batch, _prm(), shape)  # zdrop off: band_edges


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
def test_simt16_hard_cases(simt, qmax, shape):
    """Both bodies on the hard-case batches, zdrop on (and off for the
    per-phase body)."""
    t_batch = gate.hard_t_batch(5, qmax, blk_l=BLK)
    for zdrop in (100, 0):
        _check(simt, t_batch, _prm(zdrop=zdrop), shape)
    _check(simt, gate.hard_fused_batch(11, qmax, blk_l=BLK), _prm(), shape)


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
@pytest.mark.parametrize("pen", PENALTIES)
def test_simt16_penalties(simt, qmax, shape, pen):
    t_batch = gate.random_t_batch(sum(pen) + qmax, SMALL, qmax, qmax + 30,
                                  n_pad=3, blk_l=SMALL)
    f_batch = gate.random_fused_batch(sum(pen), SMALL // 2,
                                      _fused_shape(qmax), n_pad=3,
                                      blk_l=SMALL // 2)
    prm = _prm(*pen, zdrop=40)
    _check(simt, t_batch, prm, shape)
    _check(simt, f_batch, prm, shape)


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
def test_simt16_band_edges(simt, qmax, shape):
    """Band edges on every pair boundary and on the half-strip seam: the
    lanes' bands (0 to a strip and one wide) sweep across the strips as
    the rows go by, from every odd and even query length near a pair
    count, a strip and the window."""
    C = shape % 1000 or 2 * -(-qmax // 64)
    for zdrop in (100, 0):
        _check(simt, gate.edge_t_batch(qmax + zdrop, qmax, C),
               _prm(zdrop=zdrop), shape)
    # zdrop off: the lanes run every row of their targets
    _check(simt, gate.edge_fused_batch(qmax, qmax, C, SMALL), _prm(zdrop=0),
           shape)


@pytest.mark.parametrize("qmax,shape", WINDOWS, ids=IDS)
def test_simt16_top_of_range(simt, qmax, shape):
    """Scores that reach the top of the exact range, 2^14 - 1, in every
    window (tests/_torch_gate.top_of_range_t_batch)."""
    batch, prm = gate.top_of_range_t_batch(qmax, qmax, SMALL)
    got = _check(simt, batch, prm, shape)
    assert got[0].max() == (1 << 14) - 1


# the windows whose strips end exactly at the window (G * C == qmax; in
# the shared-memory row a multiple of 64 columns) and have a lane in
# TRIM_PAST_ROW
TRIM_WINDOWS = [(q, s) for q, s in WINDOWS
                if q == (s // 1000) * (s % 1000) and q in gate.TRIM_PAST_ROW]
TRIM_WINDOWS += [(q, 32000) for q in gate.TRIM_PAST_ROW
                 if q > TABLE16[-1][0] and q % 64 == 0]


@pytest.mark.parametrize("qmax,shape", TRIM_WINDOWS,
                         ids=[f"q{q}-shape{s}" for q, s in TRIM_WINDOWS])
def test_simt16_trim_past_the_row(simt, qmax, shape):
    """A lane whose trim must read column endc where it lies past the last
    strip (tests/_torch_gate.TRIM_PAST_ROW; a match score a >= 2): its
    gscore and max_ie depend on that read."""
    batch, prm = gate.trim_past_row_t_batch(qmax, SMALL)
    _check(simt, batch, prm, shape)
