"""`--device-seed` in the port, end to end on the CPU (plain seeder):

- NativePipeline with the port's seeder as seed_fn (mp_chunk_start_seeded)
  gives SAM byte-identical to host seeding (the C++ engine inside
  mp_chunk_start), SE and PE, on reads that overflow the seeding slots,
  need split re-seed rounds, and on the degenerate reads of
  tests/test_device_seed.py (all N, shorter than -k, junk, N runs);
- `python -m bwamem_tpu_torch mem --backend torch --device-seed` gives the
  SAM of `python -m bwamem_tpu mem --backend jax --device-seed`, SE and PE;
- the Python host and `--backend scalar` say the flag is ignored there, as
  the JAX package's CLI does."""

import contextlib
import io
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.ops import smem_torch
from bwamem_tpu_torch.ops.types import params_from_options

import _torch_gate as gate
from test_torch_pipeline import _env, _fastq

torch.set_num_threads(1)

ACGT = np.array(list("ACGT"))


@pytest.fixture(scope="module")
def native_driver():
    from bwamem_tpu_torch.pipeline import native_driver

    if not native_driver.available():
        pytest.skip("the port's native host library is unavailable")
    return native_driver


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(4321)
    genome = rng.integers(0, 4, 50000)
    genome[35000:35800] = genome[5000:5800]
    hp, rep = gate.overflow_contig(rng, n_rep=25)
    pac = np.concatenate([genome, hp, rep]).astype(np.uint8)
    ref = Reference(contigs=[Contig("g", 0, len(genome)),
                             Contig("ovf", len(genome), len(hp) + len(rep))],
                    pac=pac)
    fm = build_index(pac)
    return ref, fm, pack_occ(fm), genome, hp, rep


def _reads(world, seed, n):
    ref, fm, _po, genome, hp, rep = world
    rng = np.random.default_rng(seed)
    reads = gate.seed_gate_reads(rng, genome, hp, rep, n, 56)
    mid_n = fm.pac[800:950].astype(np.int64).copy()
    mid_n[40:70] = 4
    tail_n = fm.pac[200:350].astype(np.int64).copy()
    tail_n[120:] = 4
    return reads + [np.full(80, 4, np.int64), np.array([0, 1, 2, 3]),
                    rng.integers(0, 4, 120), fm.pac[500:650].astype(np.int64),
                    mid_n, tail_n]


def _pipes(native_driver, world):
    ref, fm, po, *_ = world
    opt = MemOptions()
    host = native_driver.NativePipeline(opt, ref, fm, po)
    dev = native_driver.NativePipeline(opt, ref, fm, po)
    dev.seed_fn = smem_torch.make_device_seeder(po, fm, opt, "cpu")
    from bwamem_tpu_torch.pipeline import resident

    ext = resident.make_fused_idx_backend(params_from_options(opt), ref.pac,
                                          torch.device("cpu"), blk_l=128)
    return host, dev, ext


def test_native_pipeline_seeded_se_sam_parity(native_driver, world):
    host, dev, ext = _pipes(native_driver, world)
    reads = _reads(world, 1, 64)
    names = [f"r{i}" for i in range(len(reads))]
    want = host.align_chunk_text(reads, ext, names=names)
    got = dev.align_chunk_text(reads, ext, names=names)
    assert got == want
    c = dev.seed_fn.stats.counts
    assert c["ovf_reads"] >= 1 and c["split_rounds"] >= 1, c
    recs = [l for l in got[0].splitlines() if not l.startswith("@")]
    assert sum(not int(l.split("\t")[1]) & 4 for l in recs) >= 30


def test_native_pipeline_seeded_pe_sam_parity(native_driver, world):
    ref, *_ = world
    host, dev, ext = _pipes(native_driver, world)
    rng = np.random.default_rng(2)
    r1, r2 = [], []
    for i in range(20):
        p = int(rng.integers(0, 49000 - 400))
        r1.append(ref.pac[p:p + 100].astype(np.int64))
        r2.append(3 - ref.pac[p + 250:p + 350][::-1].astype(np.int64))
    r1[0] = np.zeros(60, np.int64)           # overflows
    r2[1] = np.full(100, 4, np.int64)
    want = host.align_pairs_chunk_text(r1, r2, ext)
    got = dev.align_pairs_chunk_text(r1, r2, ext)
    assert got == want and got[1] >= 40
    c = dev.seed_fn.stats.counts
    assert c["ovf_reads"] >= 1 and c["split_rounds"] >= 1, c


def _write_inputs(tmp, world):
    ref, fm, _po, *_ = world
    fa = tmp / "ref.fa"
    fa.write_text(">g\n" + "".join(ACGT[ref.pac[:50000]]) + "\n>ovf\n"
                  + "".join(ACGT[ref.pac[50000:]]) + "\n")
    reads = [r for r in _reads(world, 3, 56) if len(r)]
    seqs = ["".join(np.array(list("ACGTN"))[r]) for r in reads]
    mates = []
    rng = np.random.default_rng(8)
    for _ in reads:
        p = int(rng.integers(0, 49000 - 400))
        mates.append("".join(ACGT[3 - ref.pac[p + 250:p + 330][::-1]]))
    names = [f"q{i}" for i in range(len(reads))]
    _fastq(tmp / "r1.fq", names, seqs)
    _fastq(tmp / "r2.fq", names, mates)
    return [str(fa), str(tmp / "r1.fq"), str(tmp / "r2.fq")]


def _body(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.mark.parametrize("ends", ["SE", "PE"])
def test_cli_device_seed_matches_jax_package(native_driver, world, tmp_path,
                                             ends):
    fa, r1, r2 = _write_inputs(tmp_path, world)
    reads = [r1] if ends == "SE" else [r1, r2]
    env = _env()
    env["OMP_NUM_THREADS"] = "1"
    run = dict(env=env, capture_output=True, text=True, timeout=900)
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                        fa], **run)
    assert r.returncode == 0, r.stderr[-2000:]
    flags = ["--device-seed", "-b", "64", fa, *reads]
    want = subprocess.run([sys.executable, "-m", "bwamem_tpu", "mem",
                           "--backend", "jax", *flags], **run)
    got = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "mem",
                          "--backend", "torch", *flags], **run)
    assert want.returncode == 0, want.stderr[-2000:]
    assert got.returncode == 0, got.stderr[-2000:]
    assert _body(got.stdout) == _body(want.stdout)
    assert "reads seeded whole by the C++ engine" in got.stderr
    n_ovf = int(got.stderr.split("slot overflow in ")[1].split()[0])
    assert n_ovf >= 1 and sum(not l.startswith("@")
                              for l in _body(got.stdout)) >= 56


@pytest.mark.parametrize("flags", [["--backend", "scalar"],
                                   ["--host", "python", "--backend",
                                    "torch"]])
def test_device_seed_ignored_off_the_native_host(native_driver, world,
                                                 tmp_path, flags):
    from bwamem_tpu_torch.__main__ import main

    fa, r1, _ = _write_inputs(tmp_path, world)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["index", fa]) == 0
    head = tmp_path / "head.fq"
    head.write_text("".join(open(r1).readlines()[-16:]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(["mem", *flags, "--device-seed", fa, str(head)]) == 0
    assert ("[mem] --device-seed needs the native host and a device "
            "backend; ignored here") in err.getvalue()
    assert "device seeding:" not in err.getvalue()
    assert sum(not l.startswith("@") for l in out.getvalue().splitlines()) \
        >= 4


def _refused(*a, **k):
    raise AssertionError("the Python scalar search ran")


@pytest.mark.parametrize("caps", [(24, 4), (10, 3)], ids=["m4", "p10_m3"])
def test_overflowed_reads_seeded_by_the_cpp_engine(native_driver, world,
                                                   caps, monkeypatch):
    """The plain version's slot caps cut small (P_CAP, M_CAP), so that
    first rounds and re-seed jobs overflow: every such read is seeded
    whole by the C++ engine on three threads, and the seed rows equal
    collect_seeds_native's, values and order, and the SAM host seeding's,
    byte for byte; the Python scalar search never runs."""
    from bwamem_tpu_torch import native
    from bwamem_tpu_torch.index import fmindex

    monkeypatch.setattr(smem_torch, "P_CAP", caps[0])
    monkeypatch.setattr(smem_torch, "M_CAP", caps[1])
    monkeypatch.setattr(fmindex, "smem1", _refused)
    ref, fm, po, genome, hp, rep = world
    reads = gate.seed_gate_reads(np.random.default_rng(1), genome, hp, rep,
                                 64, 150)
    opt = MemOptions()
    seed_fn = smem_torch.make_device_seeder(po, fm, opt, "cpu", threads=3)
    mat, qlen = gate.read_matrix(reads)
    n, want = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len,
        smem_torch.split_len_of(opt), opt.split_width, opt.max_occ)
    np.testing.assert_array_equal(seed_fn(*gate.read_matrix(reads)),
                                  want[:n])
    c = seed_fn.stats.counts
    assert c["ovf_reads"] > 0 and c["ovf_jobs"] > 0, c
    assert c["ovf_reads"] < c["exact_reads"] < len(reads), c
    host, dev, ext = _pipes(native_driver, world)
    dev.seed_fn = seed_fn
    names = [f"r{i}" for i in range(len(reads))]
    assert dev.align_chunk_text(reads, ext, names=names) == \
        host.align_chunk_text(reads, ext, names=names)


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_exact_seeder_runs_keep_read_order(native_driver, world, threads):
    """The C++ engine's reads cut in PIECES runs a thread (more runs than
    reads at 16 threads) give collect_seeds_native's rows over all the
    reads at once, values and order, read_idx into the whole batch."""
    from bwamem_tpu_torch import native

    ref, fm, po, genome, hp, rep = world
    reads = gate.seed_gate_reads(np.random.default_rng(3), genome, hp, rep,
                                 64, 150)
    opt = MemOptions()
    mat, qlen = gate.read_matrix(reads)
    n, want = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len,
        smem_torch.split_len_of(opt), opt.split_width, opt.max_occ)
    exact = smem_torch.exact_seeder(po, fm, opt, threads)
    got = exact(mat, qlen)
    assert len(np.unique(got[:, 0])) > 32
    np.testing.assert_array_equal(got, want[:n])


def test_cli_all_device_flags_match_the_host_path(native_driver, world,
                                                  tmp_path):
    """`mem --backend torch --device-seed --device-cigar --device-rescue`
    on pairs over a genome with a repeated segment and the overflow
    contig (first rounds overflow, re-seed rounds run) gives the SAM of
    the same run without the three flags, byte for byte; the C++ engine
    seeds the overflowed reads."""
    from bwamem_tpu_torch.__main__ import main

    fa, r1, r2 = _write_inputs(tmp_path, world)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["index", fa]) == 0

    def run(flags):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            assert main(["mem", "--backend", "torch", "-b", "16", "-t", "2",
                         *flags, fa, r1, r2]) == 0
        return _body(out.getvalue()), err.getvalue()

    want, _ = run([])
    got, log = run(["--device-seed", "--device-cigar", "--device-rescue"])
    assert got == want and sum(not l.startswith("@") for l in got) >= 100
    n = int(log.split(" reads seeded whole by the C++ engine")[0]
            .rsplit(" ", 1)[1])
    assert n >= 1, log
