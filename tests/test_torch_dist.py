"""The port's multi-device layer (bwamem_tpu_torch/parallel/dist.py) on
lists of CPU devices, where every shard runs the plain PyTorch version:

- every sharded factory on `[cpu] * n`, n in {1, 2, 8}, gives exactly what
  the port's single-device factory gives on the same call, every row and
  lane (the single-device factories are held to the JAX package by the
  other test_torch_* files); the extension, rescue and CIGAR calls are
  recorded from NativePipeline runs or made from a numpy seed, the seeder
  runs on a read count that is no multiple of n;
- the sharded fused_idx backend and the sharded seeder against the JAX
  package's dist.py on its 8-device CPU mesh (a subprocess, as
  tests/test_dist.py runs it), exactly;
- the dry run `dryrun_multi_device([cpu] * 4)` passes, and its SE and PE
  SAM equal the JAX package's single-device SAM on the same reads;
- the seeder's regimes: a reads-sharded regime forced at 2^31 rows or
  more raises ValueError; 2^31 rows or more, or table_sharded=True,
  route to the table-sharded seeder (ops/smem_sharded.py, held to the
  JAX package by tests/test_torch_smem_sharded.py)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.ops import global_torch, local_torch, smem_torch, types
from bwamem_tpu_torch.parallel import dist, dryrun
from bwamem_tpu_torch.pipeline import native_driver, resident

import _torch_gate as gate

torch.set_num_threads(1)

CPU = torch.device("cpu")
BLK = 16
NDEV = [1, 2, 8]
needs_native = pytest.mark.skipif(not native_driver.available(),
                                  reason="native library unavailable")


def _params():
    return types.params_from_options(MemOptions())


def _cpus(n):
    return [CPU] * n


def _recording(fn, calls):
    """fn noting (args, result) of each call in `calls`; keeps the
    protocol attributes."""
    def wrapped(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    wrapped.__dict__.update(fn.__dict__)
    return wrapped


def _equal(got, want):
    """Exact equality of two results: arrays or tuples of arrays, values
    and dtypes."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def world():
    pac, reads, pairs = dryrun.make_world(5)
    ref = Reference(contigs=[Contig("c1", 0, len(pac))], pac=pac)
    fm = build_index(pac)
    return pac, ref, fm, pack_occ(fm), reads, pairs


@pytest.fixture(scope="module")
def recorded(world):
    """The calls NativePipeline makes of the single-device resident
    backends on one PE chunk: {name: [(args, result), ...]}."""
    if not native_driver.available():
        pytest.skip("native library unavailable")
    pac, ref, fm, po, _, (r1s, r2s) = world
    calls = {"fused_idx": [], "rescue_idx": [], "cigar_idx": []}
    text = resident.make_resident_text(pac, CPU)
    pipe = native_driver.NativePipeline(MemOptions(), ref, fm, po,
                                        blk_l=BLK)
    pipe.align_pairs_chunk(
        r1s, r2s,
        _recording(resident.make_fused_idx_backend(
            _params(), pac, CPU, BLK, text_dev=text), calls["fused_idx"]),
        rescue_fn=_recording(resident.make_rescue_idx_backend(
            pac, CPU, text_dev=text), calls["rescue_idx"]),
        cigar_fn=_recording(resident.make_cigar_idx_backend(
            pac, CPU, text_dev=text), calls["cigar_idx"]))
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


def test_device_list(monkeypatch):
    got = dist.device_list(["cpu", CPU, torch.device("cpu")])
    assert got == [CPU] * 3
    assert dist.distinct(got) == [CPU]
    with pytest.raises(ValueError):
        dist.device_list([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.device_list()
    with pytest.raises(RuntimeError):
        dist.device_list(["cuda:0"])     # no silent CPU fallback


@pytest.mark.parametrize("n", NDEV)
def test_raw_t_equals_single(n):
    params = _params()
    q, t, scal, bounds = gate.random_t_batch(1, BLK * 8 * 2, 48, 96,
                                             n_pad=9, blk_l=BLK)
    want = native_driver.make_raw_t_backend(params, CPU, BLK)(q, t, scal,
                                                              bounds)
    fn = dist.make_sharded_raw_t_backend(_cpus(n), params, blk_l=BLK)
    assert fn.bp_quantum == BLK * n
    _equal(fn(q, t, scal, bounds), want)
    assert fn.dispatches == 1


@pytest.mark.parametrize("n", NDEV)
def test_fused_equals_single(n):
    params = _params()
    batch = gate.random_fused_batch(2, BLK * 8 * 2, (48, 96, 40, 80),
                                    n_pad=7, blk_l=BLK)
    want = native_driver.make_fused_backend(params, CPU, BLK)(*batch)
    fn = dist.make_sharded_fused_backend(_cpus(n), params, blk_l=BLK)
    assert fn.fused and fn.bp_quantum == BLK * n
    _equal(fn(*batch), want)
    assert fn.dispatches == 1


@pytest.mark.parametrize("n", NDEV)
def test_fused_idx_equals_single(world, recorded, n):
    pac = world[0]
    fn = dist.make_sharded_fused_idx_backend(_cpus(n), _params(), pac,
                                             blk_l=BLK)
    assert fn.fused and fn.idx and fn.bp_quantum == BLK * n
    for args, want in recorded["fused_idx"]:
        _equal(fn(*args), want)
    assert fn.dispatches == len(recorded["fused_idx"])


@pytest.mark.parametrize("n", NDEV)
def test_rescue_idx_equals_single(world, recorded, n):
    fn = dist.make_sharded_rescue_idx_backend(
        _cpus(n), text_dev=dist.replicate_text(_cpus(n), world[0]))
    assert fn.idx and fn.b_quantum == n
    for args, want in recorded["rescue_idx"]:
        _equal(fn(*args), want)


@pytest.mark.parametrize("n", NDEV)
def test_cigar_idx_equals_single(world, recorded, n):
    fn = dist.make_sharded_cigar_idx_backend(_cpus(n), pac=world[0])
    assert fn.idx and fn.b_quantum == n
    for args, want in recorded["cigar_idx"]:
        _equal(fn(*args), want)


def _global_tasks(seed, B=32, gq=32, gt=40):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, gq)).astype(np.int8)
    t = rng.integers(0, 5, (B, gt)).astype(np.int8)
    t[:, :gq] = np.where(rng.random((B, gq)) < 0.9, q, t[:, :gq])
    meta = np.stack([rng.integers(1, gq + 1, B), rng.integers(1, gt + 1, B),
                     rng.integers(1, 12, B)]).astype(np.int32)
    return q, t, meta


@pytest.mark.parametrize("n", NDEV)
def test_global_batch_equals_single(n):
    opt = MemOptions()
    q, t, meta = _global_tasks(3)
    pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)
    mat = opt.mat.astype(np.int32)
    args = (q, meta[0], t, meta[1], meta[2], mat, pens)
    ws, wst = global_torch._global_batch_host(CPU, *args)
    fn = dist.make_sharded_global_batch(_cpus(n), qmax=32, tmax=40)
    assert fn.b_quantum == n
    _equal(fn(*args), (ws.numpy(), wst.numpy()))
    with pytest.raises(ValueError):
        dist.make_sharded_global_batch(_cpus(n), qmax=32, tmax=64)(*args)


@pytest.mark.parametrize("n", NDEV)
def test_cigar_equals_single(n):
    opt = MemOptions()
    q, t, meta = _global_tasks(4)
    args = (q, t, meta, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins)
    want = global_torch.make_cigar_backend(CPU)(*args)
    fn = dist.make_sharded_cigar_backend(_cpus(n))
    assert fn.b_quantum == n
    _equal(fn(*args), want)
    assert int(want[1].sum()) > len(q)        # CIGARs of several ops


@pytest.mark.parametrize("n", NDEV)
def test_rescue_equals_single(n):
    opt = MemOptions()
    rng = np.random.default_rng(5)
    B, rq, rt = 32, 32, 96
    seq = rng.integers(0, 5, (B, rq)).astype(np.int8)
    win = rng.integers(0, 5, (B, rt)).astype(np.int8)
    win[:, 20:20 + rq] = np.where(rng.random((B, rq)) < 0.9, seq,
                                  win[:, 20:20 + rq])
    lens = np.stack([rng.integers(0, rq + 1, B),
                     rng.integers(10, rt + 1, B)]).astype(np.int32)
    args = (seq, win, lens, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins)
    want = local_torch.make_rescue_backend(CPU)(*args)
    fn = dist.make_sharded_rescue_backend(_cpus(n))
    assert fn.b_quantum == n
    _equal(fn(*args), want)
    assert int(want[0].max()) > 10


def test_lane_counts_must_divide():
    params = _params()
    q, t, scal, bounds = gate.random_t_batch(1, BLK * 4, 16, 32, blk_l=BLK)
    with pytest.raises(ValueError, match="not a multiple"):
        dist.make_sharded_raw_t_backend(_cpus(8), params, blk_l=BLK)(
            q, t, scal, bounds)
    opt = MemOptions()
    with pytest.raises(ValueError, match="not a multiple"):
        dist.make_sharded_rescue_backend(_cpus(8))(
            q.T[:12], t.T[:12], scal[:2, :12], opt.mat, 6, 1, 6, 1)
    with pytest.raises(ValueError, match="pac or text_dev"):
        dist.make_sharded_cigar_idx_backend(_cpus(2))
    with pytest.raises(ValueError, match="no text"):
        dist.make_sharded_rescue_idx_backend(_cpus(2), text_dev={})


def test_shard_batch():
    a = np.arange(24).reshape(8, 3)
    b = np.arange(8, dtype=np.int8)
    parts = dist.shard_batch(_cpus(4), (a, b))
    assert len(parts) == 4
    for k, (pa, pb) in enumerate(parts):
        assert torch.equal(pa, torch.from_numpy(a[2 * k:2 * k + 2]))
        assert torch.equal(pb, torch.from_numpy(b[2 * k:2 * k + 2]))
    parts = dist.shard_batch(_cpus(2), {"a": a, "b": b})
    assert [sorted(p) for p in parts] == [["a", "b"]] * 2
    assert torch.equal(parts[1]["a"], torch.from_numpy(a[4:]))
    with pytest.raises(ValueError):
        dist.shard_batch(_cpus(3), (a,))


@pytest.fixture(scope="module")
def seed_world():
    """A genome with a repeat plus the overflow contig of
    tests/_torch_gate.py, and 59 seeding gate reads over it (no multiple
    of 2 or 8; reads that overflow the slots among them)."""
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, 30000)
    genome[20000:20900] = genome[1000:1900]
    hp, rep = gate.overflow_contig(rng, n_rep=30)
    fm = build_index(np.concatenate([genome, hp, rep]).astype(np.uint8))
    return fm, pack_occ(fm), gate.seed_gate_reads(rng, genome, hp, rep, 59,
                                                  56)


@pytest.mark.parametrize("n", NDEV)
def test_seeder_rows_equal_single(seed_world, n):
    fm, po, reads = seed_world
    opt = MemOptions()
    single = smem_torch.make_device_seeder(po, fm, opt, CPU)
    q = gate.read_matrix(reads)
    want = single(*q)
    seed_fn = dist.make_sharded_device_seeder(_cpus(n), po, fm, opt)
    _equal(seed_fn(*q), want)
    c = seed_fn.stats.counts
    assert c == single.stats.counts
    assert c["split_rounds"] >= 1 and c["ovf_reads"] >= 1 and len(want) > 200


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_programs_copy_narrowed_rows(seed_world, n):
    """ShardedPrograms copies back smem_cuda.Programs' narrowed form: the
    plain full-width rows cut to one width, the largest count over every
    shard, equal to the one-device seeder's rows.  n = 3 splits 59 reads
    unevenly; the re-seed round leaves one shard without a job while
    another holds the widest job row."""
    from bwamem_tpu_torch.ops import smem_cuda

    fm, po, reads = seed_world
    progs = dist.ShardedPrograms(_cpus(n), po, fm.ssa, fm.sa_intv)
    d = smem_torch.DeviceOcc(po, CPU)
    own = gate.check_narrowed_rows(
        progs, smem_cuda.Programs(d, fm.ssa, fm.sa_intv),
        smem_torch.Programs(d, fm.ssa, fm.sa_intv), reads,
        dist.split_rows(len(reads), n))
    if n > 1:
        assert own.count(None) == 1, own


def test_seeder_regimes(world, monkeypatch):
    """A reads-sharded regime forced at 2^31 rows or more raises; an index
    of 2^31 rows or more (a stub: n_rows = 2^31 + 7) and table_sharded=
    True route to the table-sharded seeder, which seeds the world's reads
    as the single-device seeder does."""
    from bwamem_tpu_torch.ops import smem_sharded

    _, _, fm, po, reads, _ = world
    opt = MemOptions()
    big = dataclasses.replace(po, n_rows=(1 << 31) + 7)
    with pytest.raises(ValueError, match="2\\^31"):
        dist.make_sharded_device_seeder(_cpus(2), big, fm, opt,
                                        table_sharded=False)
    routed = []
    real = smem_sharded.make_table_sharded_seeder

    def spy(devices, p, fm_, opt_):
        routed.append(int(p.n_rows))
        return real(devices, po, fm_, opt_)

    monkeypatch.setattr(smem_sharded, "make_table_sharded_seeder", spy)
    want = smem_torch.make_device_seeder(po, fm, opt, CPU)(
        *gate.read_matrix(reads))
    for p, forced in ((big, None), (po, True)):
        seed_fn = dist.make_sharded_device_seeder(_cpus(2), p, fm, opt,
                                                  table_sharded=forced)
        _equal(seed_fn(*gate.read_matrix(reads)), want)
    assert routed == [(1 << 31) + 7, po.n_rows]


def _jax_lines(world, pe):
    """The JAX package's single-device SAM of the dry run's reads (its
    NativePipeline, the extension through the extend_jax twin, host
    rescue and CIGAR)."""
    import jax.numpy as jnp

    from bwamem_tpu.config import MemOptions as JMemOptions
    from bwamem_tpu.index.build import build_index as jbuild
    from bwamem_tpu.index.occ_packed import pack_occ as jpack
    from bwamem_tpu.io.fasta import Contig as JContig
    from bwamem_tpu.io.fasta import Reference as JReference
    from bwamem_tpu.ops.extend_jax import ExtendParams
    from bwamem_tpu.pipeline import native_driver as jnative

    pac, reads, (r1s, r2s) = world
    opt = JMemOptions()
    fm = jbuild(pac)
    pipe = jnative.NativePipeline(
        opt, JReference(contigs=[JContig("c1", 0, len(pac))], pac=pac), fm,
        jpack(fm))
    fn = jnative.make_jax_raw_t_backend(ExtendParams(
        mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        zdrop=opt.zdrop))
    recs = (pipe.align_pairs_chunk(r1s, r2s, fn) if pe
            else pipe.align_chunk(reads, fn))
    return [[r.line() for r in rr] for rr in recs]


@needs_native
def test_dryrun_matches_jax_single_device():
    got = dryrun.dryrun_multi_device(_cpus(4))
    assert got["se"] == _jax_lines(got["world"], False)
    assert got["pe"] == _jax_lines(got["world"], True)
    assert any("D" in l.split("\t")[5] for rr in got["pe"] for l in rr)


_JAX_MESH_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, jax.devices()
torch.set_num_threads(1)

from bwamem_tpu.config import MemOptions as JOpt
from bwamem_tpu.index.build import build_index as jbuild
from bwamem_tpu.index.occ_packed import pack_occ as jpack
from bwamem_tpu.ops.extend_jax import ExtendParams
from bwamem_tpu.parallel import dist as jdist
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.ops.types import params_from_options
from bwamem_tpu_torch.parallel import dist
from bwamem_tpu_torch.pipeline import native_driver

BLK = 16
rng = np.random.default_rng(11)
pac = rng.integers(0, 4, 20000).astype(np.uint8)
reads = []
for i in range(8):
    p = int(rng.integers(0, 19800))
    r = pac[p:p + 100].astype(np.int64).copy()
    r[int(rng.integers(0, 100))] = (r[0] + 1) % 4
    reads.append(r)
opt, jopt = MemOptions(), JOpt()
fm, jfm = build_index(pac), jbuild(pac)
po, jpo = pack_occ(fm), jpack(jfm)
cpus = [torch.device("cpu")] * 8
mesh = jdist.make_mesh(jax.devices())

# the resident fused backend: the calls of one chunk, both packages
calls = []
port = dist.make_sharded_fused_idx_backend(cpus, params_from_options(opt),
                                           pac, blk_l=BLK)


def rec(*args):
    out = port(*args)
    calls.append((args, out))
    return out


rec.__dict__.update(port.__dict__)
pipe = native_driver.NativePipeline(
    opt, Reference(contigs=[Contig("c", 0, 20000)], pac=pac), fm, po,
    blk_l=BLK)
pipe.align_chunk(reads, rec)
jfn = jdist.make_sharded_fused_idx_backend(
    mesh, ExtendParams(mat_flat=jnp.asarray(jopt.mat.astype(np.int32).ravel()),
                       m=5, o_del=jopt.o_del, e_del=jopt.e_del,
                       o_ins=jopt.o_ins, e_ins=jopt.e_ins, zdrop=jopt.zdrop),
    pac, blk_l=BLK, interpret=True)
assert calls
for args, out in calls:
    want = np.asarray(jfn(*args))
    assert want.dtype == out.dtype and np.array_equal(want, out), args[3]
print("FUSED_IDX_OK", len(calls), out.shape)

# the reads-sharded seeder: rows, both packages
qlen = np.array([len(r) for r in reads], np.int64)
mat = np.full((len(reads), int(qlen.max())), 4, np.uint8)
for b, r in enumerate(reads):
    mat[b, :len(r)] = r
got = dist.make_sharded_device_seeder(cpus, po, fm, opt)(mat, qlen)
want = np.asarray(jdist.make_sharded_device_seeder(mesh, jpo, jfm, jopt)(
    reads)).astype(np.int64)
assert got.shape == want.shape and np.array_equal(got, want)
print("SEEDER_OK", len(got))
"""


@needs_native
def test_against_jax_8_device_mesh():
    """make_sharded_fused_idx_backend (the Pallas kernel in interpret mode
    on the JAX side) and make_sharded_device_seeder against the JAX
    package's dist.py on its 8-device CPU mesh: the same calls, exactly."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _JAX_MESH_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + "\n" + r.stderr[-3000:]
    assert "FUSED_IDX_OK" in r.stdout and "SEEDER_OK" in r.stdout
