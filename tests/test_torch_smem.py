"""Device seeding in plain PyTorch (bwamem_tpu_torch/ops/smem_torch.py)
against the JAX package's jitted programs (bwamem_tpu/ops/smem_jax.py) on
the same inputs, and against the C++ engine.

- rank4 / extend_backward4 / extend_forward4 == the port's numpy
  expressions (index/occ_packed.py);
- smem1 == make_smem1_device: all eight outputs, every read, overflowing
  reads included;
- smem_all == make_smem_all_device: cnt and ovf on every read, every slot
  where ovf is 0;
- sa_batch == make_sa_batch_device;
- the plain seeder's rows == the JAX collect_seeds_device's == the port's
  native collect_seeds_native (csrc/smem.cpp): every row, every field, in
  order, with reads that overflow and split re-seed rounds;
- the tables of a DeviceOcc and of ShardedSeedTables are column views of
  the kernels' block records, equal to the PackedOcc's arrays, and the
  three programs read through those views equal the JAX programs.

The world is a 60 kbp genome with a repeat plus the overflow contig of
tests/_torch_gate.py; the reads are its seeding gate batch.  Positions are
int32 in JAX and int64 here; the texts are far below 2^31."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.ops import smem_jax
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index import occ_packed
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.ops import smem_sharded, smem_torch

import _torch_gate as gate

torch.set_num_threads(1)

READ_LEN = 56
N_READS = 64            # 53 made to order, the rest plain genome reads


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1234)
    genome = rng.integers(0, 4, 60000)
    genome[40000:40900] = genome[1000:1900]     # a repeat: s > 1
    hp, rep = gate.overflow_contig(rng, n_rep=30)
    fm = build_index(np.concatenate([genome, hp, rep]).astype(np.uint8))
    po = pack_occ(fm)
    return fm, po, genome, hp, rep


def gate_batch(world, seed):
    _fm, _po, genome, hp, rep = world
    rng = np.random.default_rng(seed)
    reads = gate.seed_gate_reads(rng, genome, hp, rep, N_READS, READ_LEN)
    mat, qlen = gate.read_matrix(reads)
    return rng, reads, mat, qlen


def test_rank_and_extensions_match_numpy(world):
    """rank4 / extend_backward4 / extend_forward4 in torch == the port's
    numpy expressions (index/occ_packed.py) at every block offset and at
    the table's ends."""
    _fm, po, *_ = world
    rng = np.random.default_rng(5)
    i = np.r_[np.arange(130), po.n_rows - np.arange(70),
              rng.integers(0, po.n_rows, 300)]
    d = smem_torch.DeviceOcc(po, "cpu")
    np.testing.assert_array_equal(
        smem_torch.rank4(d, torch.from_numpy(i)).numpy(),
        occ_packed.rank4(po, i))
    x0 = rng.integers(0, po.n_rows - 64, 400)
    s = rng.integers(0, 64, 400)
    x1 = rng.integers(0, po.n_rows - 64, 400)
    for name in ("extend_backward4", "extend_forward4"):
        got = getattr(smem_torch, name)(
            d, *(torch.from_numpy(a) for a in (x0, x1, s)))
        want = getattr(occ_packed, name)(po, x0, x1, s)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", range(2))
def test_smem1_matches_jax(world, seed):
    _fm, po, *_ = world
    rng, _, mat, qlen = gate_batch(world, 10 + seed)
    x = rng.integers(0, np.maximum(qlen, 1))
    x[:2] = 0                                   # the all-A reads
    mi = rng.choice([1, 2, 5], len(qlen))
    got = smem_torch.smem1(smem_torch.DeviceOcc(po, "cpu"),
                           *(torch.from_numpy(a) for a in (mat, qlen, x, mi)))
    want = smem_jax.make_smem1_device(smem_jax.DeviceOcc(po))(
        *(a.astype(np.int32) for a in (mat, qlen, x, mi)))
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64), err_msg=f"output {k}")
    assert int(got[1].sum()) >= 1 and int(got[7].sum()) >= len(qlen) // 2


@pytest.mark.parametrize("seed", range(2))
def test_smem_all_matches_jax(world, seed):
    _fm, po, *_ = world
    _, _, mat, qlen = gate_batch(world, 20 + seed)
    msl = MemOptions().min_seed_len
    got = smem_torch.smem_all(smem_torch.DeviceOcc(po, "cpu"),
                              torch.from_numpy(mat),
                              torch.from_numpy(qlen), msl).numpy()
    want = np.asarray(smem_jax.make_smem_all_device(smem_jax.DeviceOcc(po))(
        jnp.asarray(mat.astype(np.int32)), jnp.asarray(qlen.astype(np.int32)),
        jnp.int32(msl))).astype(np.int64)
    assert got.shape == want.shape == (len(qlen), smem_torch.ALL_COLS)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    ok = got[:, 1] == 0
    np.testing.assert_array_equal(got[ok], want[ok])
    assert 1 <= int((~ok).sum()) < len(qlen) and int(got[:, 0].sum()) > 50


@pytest.mark.parametrize("seed", range(2))
def test_sa_batch_matches_jax(world, seed):
    fm, po, *_ = world
    rng = np.random.default_rng(30 + seed)
    rows = rng.integers(0, po.n_rows, 512)
    rows[:3] = [0, po.primary, po.n_rows - 1]
    got = smem_torch.sa_batch(
        smem_torch.DeviceOcc(po, "cpu"),
        torch.from_numpy(fm.ssa.astype(np.int64)), fm.sa_intv,
        torch.from_numpy(rows)).numpy()
    want = smem_jax.make_sa_batch_device(
        smem_jax.DeviceOcc(po), fm.ssa, fm.sa_intv)(
            jnp.asarray(rows.astype(np.int32)))
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    assert len(np.unique(got)) > 500


@pytest.mark.parametrize("seed", range(2))
def test_seed_rows_match_jax_and_native(world, seed):
    from bwamem_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("the port's native host library is unavailable")
    fm, po, *_ = world
    _, reads, mat, qlen = gate_batch(world, 40 + seed)
    opt = MemOptions()
    split_len = smem_torch.split_len_of(opt)
    seed_fn = smem_torch.make_device_seeder(po, fm, opt, "cpu")
    got = seed_fn(*gate.read_matrix(reads))
    n, want = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len, split_len,
        opt.split_width, opt.max_occ)
    np.testing.assert_array_equal(got, want[:n])
    jx = smem_jax.collect_seeds_device(
        smem_jax.DeviceOcc(po), fm, reads, opt.min_seed_len, split_len,
        opt.split_width, opt.max_occ)
    np.testing.assert_array_equal(got, jx)
    c = seed_fn.stats.counts
    assert c["ovf_reads"] >= 1 and c["split_rounds"] >= 1, c
    assert len(got) > 200 and len(np.unique(got[:, 0])) > 20


@pytest.mark.parametrize("factory", ["smem_torch", "smem_cuda"])
def test_seeders_refuse_2_31_rows(world, factory):
    """Both single-device seeders refuse an index of 2^31 rows, as the
    JAX package's make_device_seeder does (smem_jax.make_sa_batch_device:
    "device SA lookup requires n_rows < 2^31"), before any table is copied
    to the device."""
    import dataclasses

    from bwamem_tpu_torch.ops import smem_cuda

    fm, po, *_ = world
    make = {"smem_torch": smem_torch, "smem_cuda": smem_cuda}[factory]
    big = dataclasses.replace(po, n_rows=1 << 31)
    with pytest.raises(ValueError, match="2\\^31"):
        make.make_device_seeder(big, fm, MemOptions(), "cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        smem_jax.make_device_seeder(big, fm, MemOptions())
    make.make_device_seeder(po, fm, MemOptions(), "cpu")   # below: builds


def same_storage(view, base):
    return view.untyped_storage().data_ptr() == base.untyped_storage(
        ).data_ptr()


def test_device_occ_views_are_the_packed_tables(world):
    """DeviceOcc holds one (NB+1, 16) int32 tensor of block records;
    occ / pk / va are column views of it equal to the PackedOcc's arrays
    (uint32 words as int32), and the padding words are 0."""
    _fm, po, *_ = world
    d = smem_torch.DeviceOcc(po, "cpu")
    assert d.rec.shape == (len(po.occ_rows), smem_torch.REC_WORDS)
    assert d.rec.dtype == torch.int32 and d.rec.is_contiguous()
    for view, table in ((d.occ, po.occ_rows), (d.pk, po.pk_rows),
                        (d.va, po.va_rows)):
        assert same_storage(view, d.rec)
        np.testing.assert_array_equal(
            view.numpy(), np.asarray(table).view(np.int32))
    assert not d.rec[:, 12:].any()
    assert not d.rec[len(po.pk_rows):, 4:].any()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_views_are_the_packed_tables(world, n):
    """ShardedSeedTables: shard k's nb_loc records, its occ / pk / va
    views of them; the shards' views joined equal the PackedOcc's arrays,
    zero past their end, and each shard table pointer is its record's."""
    fm, po, *_ = world
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv,
                                          [torch.device("cpu")] * n)
    for k in range(n):
        assert tabs.rec[k].shape == (tabs.nb_loc, smem_torch.REC_WORDS)
        assert all(same_storage(p[k], tabs.rec[k])
                   for p in (tabs.occ, tabs.pk, tabs.va))
        assert tabs.shard_table().rec[k] == tabs.rec[k].data_ptr()
    for parts, table in ((tabs.occ, po.occ_rows), (tabs.pk, po.pk_rows),
                         (tabs.va, po.va_rows)):
        whole = torch.cat(parts).numpy()
        np.testing.assert_array_equal(whole[:len(table)],
                                      np.asarray(table).view(np.int32))
        assert not whole[len(table):].any()


@pytest.mark.parametrize("program", ["smem1", "smem_all", "sa"])
def test_plain_programs_on_records_match_jax(world, program):
    """The plain programs reading the tables through the record views
    (every gather a strided row of the records) == the JAX programs."""
    fm, po, *_ = world
    d = smem_torch.DeviceOcc(po, "cpu")
    assert not d.pk.is_contiguous() and same_storage(d.pk, d.rec)
    rng, _, mat, qlen = gate_batch(world, 40)
    jd = smem_jax.DeviceOcc(po)
    if program == "smem1":
        x = rng.integers(0, np.maximum(qlen, 1))
        mi = rng.choice([1, 2, 5], len(qlen))
        got = smem_torch.smem1(d, *(torch.from_numpy(a)
                                    for a in (mat, qlen, x, mi)))
        want = smem_jax.make_smem1_device(jd)(
            *(a.astype(np.int32) for a in (mat, qlen, x, mi)))
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
                np.int64), err_msg=f"output {k}")
        assert int(got[7].sum()) >= len(qlen) // 2
    elif program == "smem_all":
        msl = MemOptions().min_seed_len
        got = smem_torch.smem_all(d, torch.from_numpy(mat),
                                  torch.from_numpy(qlen), msl).numpy()
        want = np.asarray(smem_jax.make_smem_all_device(jd)(
            jnp.asarray(mat.astype(np.int32)),
            jnp.asarray(qlen.astype(np.int32)), jnp.int32(msl))
        ).astype(np.int64)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        ok = got[:, 1] == 0
        np.testing.assert_array_equal(got[ok], want[ok])
        assert int(got[:, 0].sum()) > 50
    else:
        rows = rng.integers(0, po.n_rows, 512)
        rows[:2] = [po.primary, po.n_rows - 1]
        got = smem_torch.sa_batch(
            d, torch.from_numpy(fm.ssa.astype(np.int64)), fm.sa_intv,
            torch.from_numpy(rows)).numpy()
        want = smem_jax.make_sa_batch_device(jd, fm.ssa, fm.sa_intv)(
            jnp.asarray(rows.astype(np.int32)))
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


def test_block_records_hand_counted(world):
    """The plain version's count of the 64-byte block records the
    kernels read (stats["records"], one a rank4 query or an LF step).
    A read of n genome bases takes one smem1 call, whose forward pass
    makes n - 1 steps of two queries (every extension stays in the text)
    and whose backward pass ends at once past the read's start: 2 (n - 1)
    records.  An SA walk with only row 0 sampled runs from a row of
    position p down to the primary row in p LF steps: p records."""
    fm, po, genome, *_ = world
    d = smem_torch.DeviceOcc(po, "cpu")
    for start, n in ((1000, 40), (23456, 19), (59000, 150)):
        q = torch.from_numpy(genome[start:start + n].astype(np.uint8))[None]
        st = {}
        out = smem_torch.smem_all(d, q, torch.tensor([n]), 19, st)
        assert int(out[0, 0]) == 1 and not int(out[0, 1])
        assert st["records"] == 2 * (n - 1) == st["rank4"]
    rows = torch.arange(0, po.n_rows, 5, dtype=torch.int64)
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64))
    pos = smem_torch.sa_batch(d, ssa, fm.sa_intv, rows)
    near = (pos > 0) & (pos < 300)
    rows, pos = rows[near], pos[near]
    assert len(rows) >= 20
    st = {}
    got = smem_torch.sa_batch(d, torch.zeros(1, dtype=torch.int64),
                              po.n_rows + 1, rows, st)
    assert torch.equal(got, pos)
    assert st["records"] == int(pos.sum()) == st["lf"]
