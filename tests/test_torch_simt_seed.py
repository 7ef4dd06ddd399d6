"""The seeding kernels' CUDA source itself, on the CPU: bwamem_tpu_torch/
csrc/fm_seed.cu is compiled by g++ against the stand-in cuda_runtime.h of
tests/_simt/ through tests/_simt/simt_seed_emulate.cpp, which runs the
grid a real launch gives (a warp per read of bwt_smem_all / bwt_smem1 as
32 fibers, its collectives included), into output buffers that start as
garbage; the three launchers (bwt_smem_all, bwt_smem1, bwt_sa) are held
against the plain PyTorch version (ops/smem_torch.py) on the seeding gate
batch of tests/_torch_gate.py and on its hard reads at 150 bases: exact
equality, overflowing reads included.  The
kernel seeder's host flow over the g++-built launchers gives the C++
engine's seed rows.  The four launchers over block-range table shards
(bwt_rank4_sh, bwt_smem_all_sh, bwt_smem1_sh, bwt_sa_sh; the tables of
ops/smem_sharded.ShardedSeedTables on [cpu] * n, n in {1, 3, 8}) give the
plain version's outputs on the whole index, and rank4 holds at a block
origin of 2^26 (a 2^32-row offset)."""

import ctypes
import functools
import os
import subprocess

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.ops import _build, smem_cuda, smem_sharded, smem_torch

import _torch_gate as gate

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "bwamem_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("simt_seed") / "libfmseed.so")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
           "-Werror", "-I", os.path.join(_HERE, "_simt"), "-I", _CSRC,
           "-o", so, os.path.join(_HERE, "_simt", "simt_seed_emulate.cpp")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        pytest.skip("no g++")
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(so)
    _build.bind_seed(lib)
    return lib


def _contigs(rng):
    """The world's genome (a 600 bp repeat in it) and overflow contig."""
    genome = rng.integers(0, 4, 40000)
    genome[30000:30600] = genome[2000:2600]
    return (genome, *gate.overflow_contig(rng, n_rep=20))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(77)
    genome, hp, rep = _contigs(rng)
    fm = build_index(np.concatenate([genome, hp, rep]).astype(np.uint8))
    po = pack_occ(fm)
    reads = gate.seed_gate_reads(rng, genome, hp, rep, 72, 64)
    return fm, po, smem_torch.DeviceOcc(po, "cpu"), reads


def _garbage(shape):
    """An int64 output buffer that starts as garbage, as device memory
    from torch.empty may: a row the kernel leaves unwritten shows."""
    return np.full(shape, -0x5A5A5A5A5A5A5A5B, np.int64)


@pytest.fixture(scope="module")
def hard_reads():
    """The gate's hard reads at the main path's 150 bases over the world's
    index: all-A, homopolymer runs, the repeat, all-N, N runs, shorter
    than -k (seed_hard_reads)."""
    rng = np.random.default_rng(77)
    genome, hp, rep = _contigs(rng)
    return gate.seed_hard_reads(rng, genome, hp, rep, 150)


def _tables(d):
    return (d.occ.data_ptr(), d.pk.data_ptr(), d.va.data_ptr(),
            d.C.data_ptr(), d.primary, d.n_rows)


class EmuPrograms(smem_torch.Programs):
    """The seeder's host flow over the g++-built launchers."""

    def __init__(self, lib, d, ssa, sa_intv):
        super().__init__(d, ssa, sa_intv)
        self.lib = lib

    def all_fn(self, q, qlen, msl):
        B, L = q.shape
        out = _garbage((B, smem_torch.ALL_COLS))
        assert self.lib.bwt_smem_all(*_tables(self.d), q.data_ptr(), L,
                                     qlen.data_ptr(), B, msl,
                                     out.ctypes.data, None) == 0
        return out

    def smem1_fn(self, q, qlen, x, min_intv, mask):
        B, L = q.shape
        x, min_intv = (np.ascontiguousarray(a, np.int64) for a in (x, min_intv))
        mask = np.ascontiguousarray(mask, np.uint8)
        out = _garbage((B, smem_torch.SMEM1_COLS))
        assert self.lib.bwt_smem1(*_tables(self.d), q.data_ptr(), L,
                                  qlen.data_ptr(), x.ctypes.data,
                                  min_intv.ctypes.data, mask.ctypes.data, B,
                                  out.ctypes.data, None) == 0
        return out

    def sa_fn(self, rows):
        rows = np.ascontiguousarray(rows, np.int64)
        out = _garbage(len(rows))
        assert self.lib.bwt_sa(*_tables(self.d), self.ssa.data_ptr(),
                               len(self.ssa), self.sa_intv, rows.ctypes.data,
                               len(rows), self.d.n_rows + 1, out.ctypes.data,
                               None) == 0
        return out


def _progs(lib, world):
    fm, _po, d, _ = world
    return EmuPrograms(lib, d, fm.ssa, fm.sa_intv)


@pytest.mark.parametrize("msl", [19, 12])
def test_smem_all_body_matches_plain(lib, world, msl):
    _fm, _po, d, reads = world
    mat, qlen = gate.read_matrix(reads)
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    got = _progs(lib, world).all_fn(q, ql, msl)
    want = smem_torch.smem_all(d, q, ql, msl).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got[:, 1].sum()) >= 1 and int(got[:, 0].sum()) > 50


@pytest.mark.parametrize("seed", range(2))
def test_smem1_body_matches_plain(lib, world, seed):
    _fm, _po, d, reads = world
    rng = np.random.default_rng(seed)
    mat, qlen = gate.read_matrix(reads)
    x = rng.integers(0, np.maximum(qlen, 1))
    x[:2] = 0
    mi = rng.choice([1, 2, 5], len(qlen))
    mask = rng.random(len(qlen)) < 0.8
    mask[:2] = True
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    got = _progs(lib, world).smem1_fn(q, ql, x, mi, mask)
    want = smem_torch.pack_smem1(smem_torch.smem1(
        d, q, ql, torch.from_numpy(np.where(mask, x, qlen)),
        torch.from_numpy(mi))).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got[:, 1].sum()) >= 1 and int(got[:, 2].sum()) > 20


@pytest.mark.parametrize("kernel", ["smem_all", "smem1"])
def test_hard_reads_match_plain(lib, world, hard_reads, kernel):
    """Every column of bwt_smem_all (-k 19) and bwt_smem1 (a random x,
    min_intv 1/2/5, a few reads masked out) on the hard reads equals the
    plain version's, overflowing reads included; the all-A read overflows
    and reads that are all N or shorter than -k give nothing."""
    _fm, _po, d, _ = world
    mat, qlen = gate.read_matrix(hard_reads)
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    progs = _progs(lib, world)
    if kernel == "smem_all":
        got = progs.all_fn(q, ql, 19)
        want = smem_torch.smem_all(d, q, ql, 19).numpy()
        np.testing.assert_array_equal(got, want)
        nothing = (qlen < 19) | (mat == 4).all(1)
        assert got[0, 1] == 1 and not got[nothing, 0].any()
        assert int(got[:, 1].sum()) >= 2 and int(got[:, 0].sum()) > 100
        return
    rng = np.random.default_rng(4)
    x = rng.integers(0, np.maximum(qlen, 1))
    x[0] = 0
    mi = rng.choice([1, 2, 5], len(qlen))
    mask = rng.random(len(qlen)) < 0.9
    mask[0] = True
    got = progs.smem1_fn(q, ql, x, mi, mask)
    want = smem_torch.pack_smem1(smem_torch.smem1(
        d, q, ql, torch.from_numpy(np.where(mask, x, qlen)),
        torch.from_numpy(mi))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == 1 and int(got[:, 2].sum()) > 20


def test_sa_body_matches_plain(lib, world):
    fm, po, d, _ = world
    rows = np.random.default_rng(3).integers(0, po.n_rows, 2048)
    rows[:3] = [0, po.primary, po.n_rows - 1]
    progs = _progs(lib, world)
    want = smem_torch.sa_batch(d, progs.ssa, fm.sa_intv,
                               torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(progs.sa_fn(rows), want)


def test_kernel_seeder_rows_match_native(lib, world):
    from bwamem_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("the port's native host library is unavailable")
    fm, po, _d, reads = world
    opt = MemOptions()
    seed_fn = smem_torch.seeder(_progs(lib, world), fm, opt)
    got = seed_fn(reads)
    mat, qlen = gate.read_matrix(reads)
    n, want = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len,
        smem_torch.split_len_of(opt), opt.split_width, opt.max_occ)
    np.testing.assert_array_equal(got, want[:n])
    c = seed_fn.stats.counts
    assert c["ovf_reads"] >= 1 and c["split_rounds"] >= 1 and n > 200, c


def _narrowed(full, head, n_col, cap):
    """The full layout cut as smem_cuda.Programs cuts it: the head columns
    and the first C slots of each field, C the largest count (column
    n_col)."""
    C = int(full[:, n_col].max(initial=0))
    body = full[:, head:].reshape(len(full), 5, cap)[:, :, :C]
    return np.concatenate([full[:, :head], body.reshape(len(full), -1)], 1)


def test_narrowed_copies_match_the_full_layout(lib, world):
    """The kernel seeder's programs (smem_cuda.Programs; on the CPU their
    wrappers run the plain versions and the copies skip pinned memory)
    return the narrowed forms: bwt_smem_all's head and the slots up to
    the chunk's largest cnt, bwt_smem1's rows of the round's jobs only
    and their slots up to the largest n, equal to those parts of the
    emulated kernels' full layout; the host flow over either gives the
    same seed rows."""
    fm, _po, d, reads = world
    mat, qlen = gate.read_matrix(reads)
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    emu = _progs(lib, world)
    narrow = smem_cuda.Programs(d, fm.ssa, fm.sa_intv)
    full = emu.all_fn(q, ql, 19)
    got = narrow.all_fn(q, ql, 19)
    assert got.shape[1] < smem_torch.ALL_COLS
    np.testing.assert_array_equal(got, _narrowed(full, 2, 0,
                                                 smem_torch.ALL_CAP))
    rng = np.random.default_rng(2)
    x = rng.integers(0, np.maximum(qlen, 1))
    mi = rng.choice([1, 2, 5], len(qlen))
    mask = rng.random(len(qlen)) < 0.5
    mask[0] = True                      # the all-A read, which overflows
    full = emu.smem1_fn(q, ql, x, mi, mask)[mask]
    got = narrow.smem1_fn(q, ql, x, mi, mask)
    assert len(got) < len(qlen) and got.shape[1] < smem_torch.SMEM1_COLS
    np.testing.assert_array_equal(got, _narrowed(full, 3, 2,
                                                 smem_torch.M_CAP))
    opt = MemOptions()
    np.testing.assert_array_equal(smem_torch.seeder(narrow, fm, opt)(reads),
                                  smem_torch.seeder(emu, fm, opt)(reads))


@pytest.fixture(scope="module")
def plain(world):
    """The plain version's outputs on the whole index, for the _sh cases:
    {kernel: (inputs, output)}, computed once each."""
    fm, po, d, reads = world
    mat, qlen = gate.read_matrix(reads)
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    rng = np.random.default_rng(9)
    x = rng.integers(0, np.maximum(qlen, 1))
    mi = rng.choice([1, 2, 5], len(qlen))
    mask = (rng.random(len(qlen)) < 0.8).astype(np.uint8)
    rows = rng.integers(0, po.n_rows + 1, 2048)
    rows[:3] = [0, po.primary, po.n_rows]
    rows_t = torch.from_numpy(rows)
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64))

    @functools.cache
    def get(kernel):
        if kernel == "rank4":
            return rows, smem_torch.rank4(d, rows_t).numpy()
        if kernel == "smem_all":
            return (q, ql), smem_torch.smem_all(d, q, ql, 19).numpy()
        if kernel == "smem1":
            want = smem_torch.pack_smem1(smem_torch.smem1(
                d, q, ql, torch.from_numpy(np.where(mask, x, qlen)),
                torch.from_numpy(mi))).numpy()
            return (q, ql, x, mi, mask), want
        sa_rows = np.minimum(rows, po.n_rows - 1)     # rows of the SA
        return sa_rows, smem_torch.sa_batch(
            d, ssa, fm.sa_intv, torch.from_numpy(sa_rows)).numpy()

    return get


def _run_sh(lib, tab, kernel, ins):
    """The g++-built _sh launcher `kernel` over the shard table `tab`."""
    t = ctypes.byref(tab)
    if kernel in ("rank4", "sa"):
        rows = np.ascontiguousarray(ins, np.int64)
        out = _garbage((len(rows), 4) if kernel == "rank4" else len(rows))
        rc = (lib.bwt_rank4_sh(t, rows.ctypes.data, len(rows),
                               out.ctypes.data, None) if kernel == "rank4"
              else lib.bwt_sa_sh(t, rows.ctypes.data, len(rows),
                                 smem_torch.sa_max_it(tab.n_rows),
                                 out.ctypes.data, None))
    elif kernel == "smem_all":
        q, ql = ins
        B, L = q.shape
        out = _garbage((B, smem_torch.ALL_COLS))
        rc = lib.bwt_smem_all_sh(t, q.data_ptr(), L, ql.data_ptr(), B, 19,
                                 out.ctypes.data, None)
    else:
        q, ql, x, mi, mask = ins
        B, L = q.shape
        out = _garbage((B, smem_torch.SMEM1_COLS))
        rc = lib.bwt_smem1_sh(t, q.data_ptr(), L, ql.data_ptr(),
                              x.ctypes.data, mi.ctypes.data,
                              mask.ctypes.data, B, out.ctypes.data, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("kernel", ["rank4", "smem_all", "smem1", "sa"])
def test_sh_bodies_match_plain(lib, world, plain, kernel, n):
    fm, po, _d, _ = world
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv,
                                          [torch.device("cpu")] * n)
    ins, want = plain(kernel)
    got = _run_sh(lib, tabs.shard_table(), kernel, ins)
    np.testing.assert_array_equal(got, want)
    if kernel == "smem_all":
        assert int(got[:, 1].sum()) >= 1 and int(got[:, 0].sum()) > 50
    if kernel == "smem1":
        assert int(got[:, 1].sum()) >= 1 and int(got[:, 2].sum()) > 20


@pytest.mark.parametrize("n", [1, 3, 8])
def test_rank4_sh_body_at_a_2_32_row_origin(lib, world, plain, n):
    fm, po, _d, _ = world
    origin = 1 << 26
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv,
                                          [torch.device("cpu")] * n,
                                          blk_origin=origin)
    rows, want = plain("rank4")
    got = _run_sh(lib, tabs.shard_table(), "rank4", rows + (origin << 6))
    np.testing.assert_array_equal(got, want)
