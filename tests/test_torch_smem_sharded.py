"""The port's table-sharded device seeding (bwamem_tpu_torch/ops/
smem_sharded.py) on lists of CPU devices, where every shard runs the plain
PyTorch version, against the JAX package's ops/smem_sharded.py on its
8-device CPU mesh (a subprocess, as tests/test_smem_sharded.py runs it),
on that test's world (a 60 kbp random contig with a 900 bp repeat, 24
reads, 6 of them on the repeat):

- make_table_sharded_seeder over [cpu] * n, n in {1, 3, 8} (3 splits the
  blocks and the reads unevenly), gives the JAX make_table_sharded_seeder's
  rows exactly, values and order;
- make_sharded_rank4 at block origin 0 and 2^26 (a 2^32-row offset)
  equals the JAX make_sharded_rank4 and the host rank4 on 999 rows;
- the three constructor guards raise what the JAX module raises;
- at 2^31 index rows or more (the threshold cut to the world's rows),
  reads whose slots overflow are seeded exactly without the C++ engine;
- the port's own limits: more than 8 shards, a sampled SA that is not the
  tables' own, peer access on the CPU (nothing to do)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ, rank4
from bwamem_tpu_torch.ops import smem_sharded, smem_torch
from bwamem_tpu_torch.parallel import dist
from bwamem_tpu_torch.pipeline.align import revcomp_read

import _torch_gate as gate

torch.set_num_threads(1)

CPU = torch.device("cpu")
ORIGIN = 1 << 26
# (n_rows of a stub PackedOcc, sa_intv) for each constructor guard
GUARDS = {"blocks": (1 << 37, 32), "sa_intv": (None, 24),
          "ssa_index": (1 << 36, 32)}

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, jax.devices()

import dataclasses
from bwamem_tpu.config import MemOptions
from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.occ_packed import pack_occ
from bwamem_tpu.ops.smem_sharded import (
    ShardedSeedTables, make_sharded_rank4, make_table_sharded_seeder)
from bwamem_tpu.parallel.dist import make_mesh

z = np.load(sys.argv[1])
fm = build_index(z["pac"])
po = pack_occ(fm)
mesh = make_mesh()
seed_fn = make_table_sharded_seeder(mesh, po, fm, MemOptions())
out = {"rows": np.asarray(seed_fn(list(z["reads"])), np.int64)}
for origin in (0, %(origin)d):
    tabs = ShardedSeedTables(po, fm.ssa, fm.sa_intv, 8, blk_origin=origin)
    out[f"rank4_{origin}"] = np.asarray(make_sharded_rank4(mesh, tabs)(
        z["query"] + (origin << 6)))
raised = {}
for name, (n_rows, sa_intv) in json.loads(sys.argv[3]).items():
    p = po if n_rows is None else dataclasses.replace(po, n_rows=n_rows)
    try:
        ShardedSeedTables(p, fm.ssa, sa_intv, 8)
    except Exception as e:
        raised[name] = [type(e).__name__, str(e)]
np.savez(sys.argv[2], **out)
print("RAISED", json.dumps(raised))
""" % {"origin": ORIGIN}


@pytest.fixture(scope="module")
def world():
    """tests/test_smem_sharded.py's world, made with the port's modules:
    (fm, po, reads, 999 query rows)."""
    rng = np.random.default_rng(1234)
    pac = rng.integers(0, 4, 60000).astype(np.uint8)
    pac[40000:40900] = pac[1000:1900]
    fm = build_index(pac)
    po = pack_occ(fm)
    query = rng.integers(0, po.n_rows + 1, 999).astype(np.int64)
    reads = []
    for i in range(24):
        pos = int(rng.integers(0, fm.l_pac - 105))
        if i < 6:
            pos = 40000 + int(rng.integers(0, 800))
        r = fm.pac[pos:pos + 100].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
        if rng.random() < 0.4:
            r = revcomp_read(r)
        reads.append(r)
    return fm, po, reads, query


@pytest.fixture(scope="module")
def jax_out(world, tmp_path_factory):
    """The JAX package's table-sharded rows, rank4 answers and guard
    exceptions on its 8-device CPU mesh, in one subprocess."""
    fm, _po, reads, query = world
    tmp = tmp_path_factory.mktemp("smem_sharded")
    src, dst = str(tmp / "world.npz"), str(tmp / "jax.npz")
    np.savez(src, pac=fm.pac, reads=np.stack(reads), query=query)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, src, dst,
                        json.dumps(GUARDS)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + "\n" + r.stderr[-3000:]
    line = next(l for l in r.stdout.splitlines() if l.startswith("RAISED"))
    with np.load(dst) as z:
        out = {k: z[k] for k in z.files}
    out["raised"] = json.loads(line.split(" ", 1)[1])
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
def test_seeder_rows_match_jax(world, jax_out, n):
    fm, po, reads, _ = world
    opt = MemOptions()
    seed_fn = smem_sharded.make_table_sharded_seeder([CPU] * n, po, fm, opt)
    got = seed_fn(*gate.read_matrix(reads))
    want = jax_out["rows"]
    assert got.dtype == np.int64 and len(want) > 0
    np.testing.assert_array_equal(got, want)
    c = seed_fn.stats.counts
    assert c["chunks"] == 1 and c["split_rounds"] >= 1, c
    np.testing.assert_array_equal(
        got, smem_torch.make_device_seeder(po, fm, opt, CPU)(
            *gate.read_matrix(reads)))


def _refused(*a, **k):
    raise AssertionError("the C++ seeding engine ran")


@pytest.mark.parametrize("n", [1, 3])
def test_overflowed_reads_at_2_31_rows_seeded_exactly(world, jax_out, n,
                                                      monkeypatch):
    """The table-sharded regime at 2^31 index rows or more, which the C++
    engine's int32 checkpoints cannot hold (EXACT_MAX_ROWS cut to this
    index's rows): with M_CAP cut to 6, first rounds and re-seed jobs
    overflow, the Python scalar search seeds those reads whole, the C++
    engine never runs, and the rows equal the JAX table-sharded seeder's
    at full caps, values and order."""
    from bwamem_tpu_torch import native

    fm, po, reads, _ = world
    monkeypatch.setattr(smem_torch, "EXACT_MAX_ROWS", int(po.n_rows))
    monkeypatch.setattr(smem_torch, "M_CAP", 6)
    monkeypatch.setattr(native, "collect_seeds_native", _refused)
    seed_fn = smem_sharded.make_table_sharded_seeder([CPU] * n, po, fm,
                                                     MemOptions())
    np.testing.assert_array_equal(seed_fn(*gate.read_matrix(reads)),
                                  jax_out["rows"])
    c = seed_fn.stats.counts
    assert c["ovf_reads"] > 0 and c["ovf_jobs"] > 0, c
    assert c["ovf_reads"] < c["exact_reads"] < len(reads), c


@pytest.mark.parametrize("n", [1, 2, 3])
def test_programs_copy_narrowed_rows(world, n):
    """TableShardedPrograms copies back smem_cuda.Programs' narrowed form
    through dist.ShardedPrograms: the plain full-width rows cut to the
    largest count over every shard, equal to the one-device seeder's rows;
    the re-seed round leaves one shard without a job."""
    from bwamem_tpu_torch.ops import smem_cuda

    fm, po, reads, _ = world
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, [CPU] * n)
    d = smem_torch.DeviceOcc(po, CPU)
    own = gate.check_narrowed_rows(
        smem_sharded.TableShardedPrograms(tabs),
        smem_cuda.Programs(d, fm.ssa, fm.sa_intv),
        smem_torch.Programs(d, fm.ssa, fm.sa_intv), reads,
        dist.split_rows(len(reads), n))
    if n > 1:
        assert own.count(None) == 1, own


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("origin", [0, ORIGIN])
def test_rank4_matches_jax_and_host(world, jax_out, origin, n):
    fm, po, _, query = world
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, [CPU] * n,
                                          blk_origin=origin)
    got = smem_sharded.make_sharded_rank4([CPU] * n, tabs)(
        query + (origin << 6))
    np.testing.assert_array_equal(got, rank4(po, query))
    np.testing.assert_array_equal(got, jax_out[f"rank4_{origin}"])
    assert smem_sharded.launches["bwt_rank4_sh"] == 0   # the CPU: plain


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guards_raise_what_jax_raises(world, jax_out, guard):
    fm, po, _, _ = world
    n_rows, sa_intv = GUARDS[guard]
    p = po if n_rows is None else dataclasses.replace(po, n_rows=n_rows)
    kind, msg = jax_out["raised"][guard]
    with pytest.raises(Exception) as e:
        smem_sharded.ShardedSeedTables(p, fm.ssa, sa_intv, [CPU] * 8)
    assert [type(e.value).__name__, str(e.value)] == [kind, msg]


def test_port_limits(world):
    fm, po, reads, query = world
    with pytest.raises(ValueError, match="at most 8"):
        smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, [CPU] * 9)
    smem_sharded.enable_peer_access([CPU] * 4)      # nothing to do
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, [CPU] * 3)
    d = tabs.view(CPU)
    rows = torch.from_numpy(query)
    with pytest.raises(ValueError, match="its own"):
        smem_sharded.sa(d, torch.from_numpy(fm.ssa), fm.sa_intv, rows)
    whole = smem_torch.DeviceOcc(po, CPU)
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64))
    sa_rows = rows.clamp(max=po.n_rows - 1)         # rows of the SA
    assert torch.equal(smem_sharded.sa(d, d.ssa, fm.sa_intv, sa_rows),
                       smem_torch.sa_batch(whole, ssa, fm.sa_intv, sa_rows))
    assert torch.equal(smem_sharded.rank4(d, rows),
                       smem_torch.rank4(whole, rows))
    # every shard a tensor of its own, zero past the tables' end
    assert len({t.data_ptr() for t in tabs.occ + tabs.pk + tabs.va}) == 9
    assert int(tabs.pk[-1][po.pk_rows.shape[0] - 2 * tabs.nb_loc:].abs(
        ).sum()) == 0
