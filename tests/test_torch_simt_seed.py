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
origin of 2^26 (a 2^32-row offset).

The SA walk on the block-record layout (csrc/fm_seed.cuh, lf_step and
sa_value_dev) is held on an index whose text has N runs, built at
sa_intv 8 and 32 (the mask-and-shift path) and 6 (the division path of
the one-table kernel): rows at block offsets 0 and 63, the primary row,
rows whose BWT symbol is N, walks cut at max_it; every position equals
smem_torch.sa_batch and the JAX package's _sa_kernel
(smem_jax.make_sa_batch_device).  The sharded twin runs at 1-4 shards at
a block origin of 2^26, the walks kept inside the table by C and the
primary row moved up by the origin and the sampled SA by 2^32, so rows
and positions lie above 2^32; there it equals the plain version over the
same shards."""

import ctypes
import dataclasses
import functools
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.ops import smem_jax
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
    return d.rec.data_ptr(), d.C.data_ptr(), d.primary, d.n_rows


class EmuPrograms(smem_torch.Programs):
    """The seeder's host flow over the g++-built launchers; its counter()
    is one int64 that all three launches add to."""

    def __init__(self, lib, d, ssa, sa_intv):
        super().__init__(d, ssa, sa_intv)
        self.lib = lib

    def counter(self):
        return np.zeros(1, np.int64)

    def records(self, rec):
        return int(rec[0])

    def all_fn(self, q, qlen, msl, rec=None):
        B, L = q.shape
        out = _garbage((B, smem_torch.ALL_COLS))
        assert self.lib.bwt_smem_all(*_tables(self.d), q.data_ptr(), L,
                                     qlen.data_ptr(), B, msl,
                                     out.ctypes.data, _ptr(rec), None) == 0
        return out

    def smem1_fn(self, q, qlen, x, min_intv, mask, rec=None):
        B, L = q.shape
        x, min_intv = (np.ascontiguousarray(a, np.int64) for a in (x, min_intv))
        mask = np.ascontiguousarray(mask, np.uint8)
        out = _garbage((B, smem_torch.SMEM1_COLS))
        assert self.lib.bwt_smem1(*_tables(self.d), q.data_ptr(), L,
                                  qlen.data_ptr(), x.ctypes.data,
                                  min_intv.ctypes.data, mask.ctypes.data, B,
                                  out.ctypes.data, _ptr(rec), None) == 0
        return out

    def sa_fn(self, rows, rec=None):
        rows = np.ascontiguousarray(rows, np.int64)
        out = _garbage(len(rows))
        assert self.lib.bwt_sa(*_tables(self.d), self.ssa.data_ptr(),
                               len(self.ssa), self.sa_intv, rows.ctypes.data,
                               len(rows), self.d.n_rows + 1, out.ctypes.data,
                               _ptr(rec), None) == 0
        return out


def _ptr(rec):
    return None if rec is None else rec.ctypes.data


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


def test_kernel_records_match_plain(lib, world):
    """Each launcher adds the block records its threads read to the
    counter it is given (a warp's sum in one atomic add, the SA walks'
    threads past n counting nothing), on top of what it held: bwt_smem_all
    and bwt_smem1 on the gate batch, bwt_sa on rows that include the
    primary row and a partial last warp, equal to the plain version's
    stats["records"]; the outputs are those of a launch without one."""
    fm, po, d, reads = world
    mat, qlen = gate.read_matrix(reads)
    q, ql = torch.from_numpy(mat), torch.from_numpy(qlen)
    B, L = mat.shape
    rng = np.random.default_rng(4)
    x = np.ascontiguousarray(rng.integers(0, np.maximum(qlen, 1)))
    mi = np.ascontiguousarray(rng.choice([1, 2, 5], B))
    mask = np.ascontiguousarray((rng.random(B) < 0.8).astype(np.uint8))
    rows = np.ascontiguousarray(rng.integers(0, po.n_rows, 1000))
    rows[:2] = [po.primary, 0]
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64))
    max_it = smem_torch.sa_max_it(po.n_rows)
    st = {n: {} for n in ("all", "smem1", "sa")}
    smem_torch.smem_all(d, q, ql, 19, st["all"])
    smem_torch.smem1(d, q, ql, torch.from_numpy(np.where(mask, x, qlen)),
                     torch.from_numpy(mi), st["smem1"])
    want_sa = smem_torch.sa_batch(d, ssa, fm.sa_intv, torch.from_numpy(rows),
                                  st["sa"]).numpy()
    for name, launch, width in (
            ("all", lambda out, rec: lib.bwt_smem_all(
                *_tables(d), q.data_ptr(), L, ql.data_ptr(), B, 19,
                out.ctypes.data, rec, None), (B, smem_torch.ALL_COLS)),
            ("smem1", lambda out, rec: lib.bwt_smem1(
                *_tables(d), q.data_ptr(), L, ql.data_ptr(), x.ctypes.data,
                mi.ctypes.data, mask.ctypes.data, B, out.ctypes.data, rec,
                None), (B, smem_torch.SMEM1_COLS)),
            ("sa", lambda out, rec: lib.bwt_sa(
                *_tables(d), ssa.data_ptr(), len(ssa), fm.sa_intv,
                rows.ctypes.data, len(rows), max_it, out.ctypes.data, rec,
                None), len(rows))):
        plain, counted = _garbage(width), _garbage(width)
        assert launch(plain, None) == 0
        rec = np.array([5], np.int64)
        assert launch(counted, rec.ctypes.data) == 0
        np.testing.assert_array_equal(counted, plain)
        assert int(rec[0]) - 5 == st[name]["records"] > 0, name
    np.testing.assert_array_equal(plain, want_sa)


def test_kernel_seeder_rows_match_native(lib, world):
    from bwamem_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("the port's native host library is unavailable")
    fm, po, _d, reads = world
    opt = MemOptions()
    seed_fn = smem_torch.seeder(_progs(lib, world),
                                smem_torch.exact_seeder(po, fm, opt), opt)
    got = seed_fn(*gate.read_matrix(reads))
    mat, qlen = gate.read_matrix(reads)
    n, want = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len,
        smem_torch.split_len_of(opt), opt.split_width, opt.max_occ)
    np.testing.assert_array_equal(got, want[:n])
    c = seed_fn.stats.counts
    assert c["ovf_reads"] >= 1 and c["split_rounds"] >= 1 and n > 200, c


class _SpyPrograms(EmuPrograms):
    """EmuPrograms that keeps whether each launch was given a counter."""

    def __init__(self, *a):
        super().__init__(*a)
        self.given = []

    def all_fn(self, q, qlen, msl, rec=None):
        self.given.append(rec is not None)
        return super().all_fn(q, qlen, msl, rec)

    def smem1_fn(self, q, qlen, x, min_intv, mask, rec=None):
        self.given.append(rec is not None)
        return super().smem1_fn(q, qlen, x, min_intv, mask, rec)

    def sa_fn(self, rows, rec=None):
        self.given.append(rec is not None)
        return super().sa_fn(rows, rec)


def test_kernel_seeder_counts_records_only_under_a_tracer(lib, world):
    """Untraced, no launch of the seeder is given a counter (each runs
    the build that counts nothing); under a tracer every launch is, the
    rows are the same, and the `seed.device` span's `records` (and the
    counters' seed_records) equal the plain seeder's count."""
    from bwamem_tpu_torch.utils.metrics import Tracer, span

    fm, po, d, reads = world
    opt = MemOptions()
    exact = smem_torch.exact_seeder(po, fm, opt)
    spy = _SpyPrograms(lib, d, fm.ssa, fm.sa_intv)
    seed_fn = smem_torch.seeder(spy, exact, opt)
    want = seed_fn(*gate.read_matrix(reads))
    assert len(spy.given) >= 3 and not any(spy.given), spy.given

    def traced(progs):
        tr = Tracer(None)
        fn = smem_torch.seeder(progs, exact, opt)
        with span(tr, "seed.device", n_reads=len(reads)):
            rows = fn(*gate.read_matrix(reads), tracer=tr)
        return rows, tr.counters

    spy.given.clear()
    got, c = traced(spy)
    assert spy.given and all(spy.given), spy.given
    np.testing.assert_array_equal(got, want)
    plain_rows, plain_c = traced(smem_torch.Programs(d, fm.ssa, fm.sa_intv))
    np.testing.assert_array_equal(plain_rows, want)
    assert c.seed_records == plain_c.seed_records > 0, (c, plain_c)
    assert c.seed_reads == len(reads) and c.seed_ovf_reads >= 1, c


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
    fm, po, d, reads = world
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
    exact = smem_torch.exact_seeder(po, fm, opt)
    q = gate.read_matrix(reads)
    np.testing.assert_array_equal(smem_torch.seeder(narrow, exact, opt)(*q),
                                  smem_torch.seeder(emu, exact, opt)(*q))


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


@functools.cache
def n_world(sa_intv):
    """An index of a 6 kbp text with N runs (so the BWT has N rows besides
    the primary) at `sa_intv`: (fm, po, d, ssa tensor)."""
    rng = np.random.default_rng(41)
    text = rng.integers(0, 4, 6000).astype(np.uint8)
    for at in (700, 2500, 2510, 4100):
        text[at:at + rng.integers(1, 30)] = 4
    fm = build_index(text, sa_intv=sa_intv)
    po = pack_occ(fm)
    return (fm, po, smem_torch.DeviceOcc(po, "cpu"),
            torch.from_numpy(np.asarray(fm.ssa, np.int64)))


def n_rows_of(po):
    """The rows whose BWT symbol is N (validity lane 0), the primary
    row's excluded."""
    r = np.arange(po.n_rows)
    word = po.va_rows[r >> 6, (r & 63) >> 4].astype(np.int64)
    ok = (word >> (2 * (r & 15))) & 1
    return r[(ok == 0) & (r != po.primary)]


def sa_rows(po, rng, n=1500):
    """Rows at block offsets 0 and 63, the primary row, every N row, the
    table's last row, and random rows."""
    blocks = rng.integers(0, po.n_rows >> 6, 60)
    edge = np.concatenate([blocks << 6, (blocks << 6) + 63])
    rows = np.concatenate([edge[edge < po.n_rows], [po.primary, 0,
                                                    po.n_rows - 1],
                           n_rows_of(po), rng.integers(0, po.n_rows, n)])
    return np.ascontiguousarray(rows, np.int64)


def emu_sa(lib, d, ssa, sa_intv, rows, max_it, records=None):
    out = _garbage(len(rows))
    assert lib.bwt_sa(*_tables(d), ssa.data_ptr(), len(ssa), sa_intv,
                      rows.ctypes.data, len(rows), max_it, out.ctypes.data,
                      None if records is None else records.ctypes.data,
                      None) == 0
    return out


@pytest.mark.parametrize("sa_intv", [8, 32, 6])
def test_sa_body_on_records_matches_plain_and_jax(lib, sa_intv):
    """The one-table walk on the record layout, shift path (8, 32) and
    division path (6): every row == plain == the JAX program, N rows and
    the primary row among them."""
    fm, po, d, ssa = n_world(sa_intv)
    rows = sa_rows(po, np.random.default_rng(sa_intv))
    assert len(n_rows_of(po)) >= 20
    got = emu_sa(lib, d, ssa, sa_intv, rows, smem_torch.sa_max_it(po.n_rows))
    want = smem_torch.sa_batch(d, ssa, sa_intv, torch.from_numpy(rows))
    np.testing.assert_array_equal(got, want.numpy())
    jax_out = smem_jax.make_sa_batch_device(
        smem_jax.DeviceOcc(po), fm.ssa, sa_intv)(
            jnp.asarray(rows.astype(np.int32)))
    np.testing.assert_array_equal(got, np.asarray(jax_out).astype(np.int64))
    assert got[rows == po.primary].tolist() == [0]
    assert len(np.unique(got)) > 1000


@pytest.mark.parametrize("max_it", [1, 3, 7])
def test_sa_body_gives_up_at_max_it(lib, max_it):
    """Walks cut at max_it steps give 0, as the plain version's."""
    _fm, po, d, ssa = n_world(32)
    rows = sa_rows(po, np.random.default_rng(max_it), 500)
    got = emu_sa(lib, d, ssa, 32, rows, max_it)
    want, done = smem_torch.sa_walk(d, ssa, 32, torch.from_numpy(rows),
                                    max_it=max_it)
    np.testing.assert_array_equal(got, want.numpy())
    assert (~done).sum() > 100 and done.sum() > 20


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("sa_intv", [8, 32])
def test_sa_sh_body_above_2_32(lib, n, sa_intv):
    """The sharded walk at a block origin of 2^26: C[0..3] and the primary
    row moved up by the origin's 2^32 rows (so an LF step from a row r +
    2^32 gives LF(r) + 2^32, an N row's step too) and the sampled SA by
    2^32; rows and positions above 2^32, every one == the plain version
    over the same shards (a sampled row's index, past n_ssa here, is
    reduced modulo n_ssa by both)."""
    fm, po, d, ssa = n_world(sa_intv)
    origin = 1 << 26
    O = origin << 6
    C = np.asarray(po.C, np.int64).copy()
    C[:4] += O
    hi = dataclasses.replace(po, C=C, primary=po.primary + O,
                             n_rows=po.n_rows + O)
    tabs = smem_sharded.ShardedSeedTables(
        hi, np.asarray(fm.ssa, np.int64) + (1 << 32), sa_intv,
        [torch.device("cpu")] * n, blk_origin=origin)
    rows = sa_rows(po, np.random.default_rng(n))
    max_it = smem_torch.sa_max_it(po.n_rows)
    out = _garbage(len(rows))
    assert lib.bwt_sa_sh(ctypes.byref(tabs.shard_table()),
                         (rows + O).ctypes.data, len(rows), max_it,
                         out.ctypes.data, None) == 0
    v = tabs.view(torch.device("cpu"))
    want = smem_torch.sa_batch(v, v.ssa, sa_intv,
                               torch.from_numpy(rows + O), max_it=max_it)
    np.testing.assert_array_equal(out, want.numpy())
    assert out.min() >= 0 and (out >= 1 << 32).sum() > len(rows) // 2
