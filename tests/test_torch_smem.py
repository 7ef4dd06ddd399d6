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
  order, with reads that overflow and split re-seed rounds.

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
from bwamem_tpu_torch.ops import smem_torch

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
    got = seed_fn(reads)
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
