"""The port's resident-reference fused backend (bwamem_tpu_torch/pipeline/
resident.py, plain PyTorch on the CPU) driven by the native C++ host
pipeline gives SAM byte-identical to the JAX package's backend
(native_driver.make_fused_idx_backend, Pallas in interpret mode) — the
cases of tests/test_native_pipe.py's fused_idx tests — and the port's
CLI matches the JAX package's CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.occ_packed import pack_occ
from bwamem_tpu.io.fasta import Contig, Reference
from bwamem_tpu.ops.extend_jax import ExtendParams
from bwamem_tpu.pipeline import native_driver
from bwamem_tpu.pipeline.align import revcomp_read
from bwamem_tpu_torch.ops import types
from bwamem_tpu_torch.pipeline import resident

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")

torch.set_num_threads(1)

BLK = 128


def _jax_params(opt):
    return ExtendParams(
        mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
        e_ins=opt.e_ins, zdrop=opt.zdrop)


def _backends(opt, pac):
    """(JAX interpret-mode backend, the port's CPU backend)."""
    jp = _jax_params(opt)
    want = native_driver.make_fused_idx_backend(jp, pac, blk_l=BLK,
                                                interpret=True)
    got = resident.make_fused_idx_backend(types.params_from_jax(jp), pac,
                                          torch.device("cpu"), blk_l=BLK)
    return want, got


def _lines(recs):
    return [[r.line() for r in rr] for rr in recs]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    # two contigs to exercise rid resolution and junction logic
    pac = rng.integers(0, 4, 120000).astype(np.uint8)
    ref = Reference(contigs=[Contig("chrA", 0, 70000),
                             Contig("chrB", 70000, 50000)], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    return ref, fm, po, rng


def make_reads(rng, ref, n, read_len=120):
    """Exact, substituted, deleted, inserted and junk/N-heavy reads on
    both strands (tests/test_native_pipe.py make_reads)."""
    reads = []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - read_len - 20))
        r = ref.pac[pos:pos + read_len].astype(np.int64).copy()
        kind = i % 5
        if kind == 1:
            for _ in range(4):
                p = int(rng.integers(0, read_len))
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:
            d = int(rng.integers(1, 6))
            p = int(rng.integers(10, read_len - 10 - d))
            r = np.concatenate([r[:p], r[p + d:]])
        elif kind == 3:
            ins = rng.integers(0, 4, int(rng.integers(1, 5)))
            p = int(rng.integers(10, read_len - 10))
            r = np.concatenate([r[:p], ins, r[p:]])
        elif kind == 4:
            if i % 10 == 4:
                r = rng.integers(0, 4, read_len).astype(np.int64)
            else:
                r[::3] = 4
        if rng.random() < 0.5:
            r = revcomp_read(r)
        reads.append(r)
    names = [f"r{i}" for i in range(n)]
    quals = ["".join(chr(33 + int(x)) for x in rng.integers(20, 40, len(r)))
             for r in reads]
    return reads, names, quals


def _pe_reads(rng, ref, n):
    r1s, r2s = [], []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - 500))
        isize = 300 + int(rng.integers(-30, 30))
        r1 = ref.pac[pos:pos + 100].astype(np.int64).copy()
        m = ref.pac[pos + isize - 100:pos + isize].astype(np.int64).copy()
        kind = i % 6
        if kind == 1:  # substitutions on read 1
            for _ in range(4):
                p = int(rng.integers(0, 100))
                r1[p] = (r1[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # heavily mutated mate -> rescue path
            for p in range(4, 100, 9):
                m[p] = (m[p] + 1 + rng.integers(0, 3)) % 4
        r2 = revcomp_read(m)
        if kind == 3:  # unmappable mate (all N)
            r2 = np.full(100, 4, np.int64)
        r1s.append(r1)
        r2s.append(r2)
    return r1s, r2s


def test_params_from_jax_round_trips_params_vector():
    from bwamem_tpu.ops.extend_pallas import params_vector as jax_vector

    for opt in (MemOptions(), MemOptions(a=2, b=3, o_del=5, e_del=2,
                                         o_ins=7, e_ins=3, zdrop=0)):
        jp = _jax_params(opt)
        p = types.params_from_jax(jp)
        assert isinstance(p.mat_flat, np.ndarray)
        assert np.array_equal(types.params_vector(p), jax_vector(jp))
        assert types.params_from_options(opt)[1:] == p[1:]
        assert np.array_equal(types.params_from_options(opt).mat_flat,
                              p.mat_flat)


def test_fused_idx_sam_identical(world):
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 32)
    want_fn, got_fn = _backends(opt, ref.pac)
    outs = [_lines(native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_chunk(reads, fn, names=names,
                                                 quals=quals))
        for fn in (want_fn, got_fn)]
    assert outs[0] == outs[1]
    assert got_fn.dispatches == 1


def test_fused_idx_pe_sam_identical(world):
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_reads(rng, ref, 18)
    want_fn, got_fn = _backends(opt, ref.pac)
    outs = [_lines(native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_pairs_chunk(r1s, r2s, fn))
        for fn in (want_fn, got_fn)]
    assert outs[0] == outs[1]


def test_fused_idx_n_bases_reference():
    """N runs in the reference reach the windows through the resident
    text (the strand fold keeps code 4)."""
    opt = MemOptions()
    rng = np.random.default_rng(7)
    pac = rng.integers(0, 4, 50000).astype(np.uint8)
    for p in range(0, 50000, 4000):
        pac[p:p + int(rng.integers(5, 40))] = 4
    ref = Reference(contigs=[Contig("cN", 0, 50000)], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    reads = []
    for i in range(24):
        pos = int(rng.integers(0, 50000 - 140))
        r = pac[pos:pos + 120].astype(np.int64).copy()
        for _ in range(3):
            q = int(rng.integers(0, 120))
            r[q] = (r[q] + 1) % 4
        reads.append(revcomp_read(r) if i % 2 else r)
    want_fn, got_fn = _backends(opt, pac)
    outs = [_lines(native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_chunk(reads, fn))
        for fn in (want_fn, got_fn)]
    assert outs[0] == outs[1]


def test_fused_idx_boundary_positions(world):
    """Reads at the very start/end of the reference: left target walks
    reach two-strand positions 0 and 2*l_pac-1."""
    opt = MemOptions()
    ref, fm, po, _ = world
    pac = ref.pac
    L = len(pac)
    reads = [pac[0:100].astype(np.int64),
             revcomp_read(pac[0:100].astype(np.int64)),
             pac[L - 100:L].astype(np.int64),
             revcomp_read(pac[L - 100:L].astype(np.int64))]
    for i, r in enumerate(reads):
        r = r.copy()
        r[50] = (r[50] + 1) % 4
        reads[i] = r
    want_fn, got_fn = _backends(opt, pac)
    outs = [_lines(native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_chunk(reads, fn))
        for fn in (want_fn, got_fn)]
    assert outs[0] == outs[1]


def test_fused_idx_bucket_split_sam_identical(world):
    """The two-dispatch shape-bucketed chunk (--bucket-split) through
    the port == the JAX backend's single dispatch."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 16)
    r2, n2, q2 = make_reads(rng, ref, 16, read_len=60)
    reads += r2
    names += [s + "b" for s in n2]
    quals += q2
    want_fn, got_fn = _backends(opt, ref.pac)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, blk_l=BLK).align_chunk(reads, want_fn,
                                                 names=names, quals=quals)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, blk_l=BLK,
                                        bucket_split=True)
    pipe.split_min = 4
    got = pipe.align_chunk(reads, got_fn, names=names, quals=quals)
    assert got_fn.dispatches == 2, "split did not fire"
    assert _lines(want) == _lines(got)


def test_backend_concurrent_calls(world):
    """`--inflight N` calls the backend from N threads at once: every
    call is counted and every result equals the single-threaded one
    (the resident text is shared and read-only)."""
    import threading

    import _torch_gate as gate

    ref, _, _, _ = world
    rng = np.random.default_rng(3)
    dims = (32, 48, 32, 48)
    scal = gate.random_fused_batch(4, BLK, dims, blk_l=BLK)[4]
    n_reads = 40
    scal[10] = rng.integers(0, n_reads, BLK)
    scal[11] = rng.integers(0, 60, BLK)
    n2 = 2 * ref.l_pac
    scal[12] = rng.integers(48, n2 - 48, BLK)   # hi = 0: lo is the start
    scal[13] = rng.integers(0, n2 - 48, BLK)
    nib = rng.integers(0, 0x45, (64, 64)).astype(np.int8)
    tmax2 = np.array([[48, 48]], np.int32)
    fn = resident.make_fused_idx_backend(
        types.params_from_options(MemOptions()), ref.pac,
        torch.device("cpu"), blk_l=BLK)
    want = fn(nib, scal, tmax2, dims)
    n_threads = 16
    got = [None] * n_threads

    def call(k):
        got[k] = fn(nib, scal, tmax2, dims)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=call, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fn.dispatches == n_threads + 1
    assert all(np.array_equal(g, want) for g in got)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _fastq(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")


def test_cli_mem_matches_jax_package(tmp_path):
    """`python -m bwamem_tpu_torch mem --backend torch` == `python -m
    bwamem_tpu mem --backend jax` on one tiny index, SE and PE, apart
    from the @PG header line."""
    rng = np.random.default_rng(5)
    acgt = np.array(list("ACGT"))
    genome = rng.integers(0, 4, 30000)
    fa = tmp_path / "ref.fa"
    fa.write_text(">c1\n" + "".join(acgt[genome]) + "\n")
    r1, r2 = [], []
    for i in range(24):
        p = int(rng.integers(0, 29000))
        a = genome[p:p + 100].copy()
        a[rng.integers(0, 100, 2)] = rng.integers(0, 4, 2)
        b = 3 - genome[p + 250:p + 350][::-1]
        r1.append("".join(acgt[a]))
        r2.append("".join(acgt[b]))
    names = [f"q{i}" for i in range(24)]
    _fastq(tmp_path / "r1.fq", names, r1)
    _fastq(tmp_path / "r2.fq", names, r2)
    env = _env()
    run = dict(env=env, capture_output=True, text=True, timeout=600)
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                        str(fa)], **run)
    assert r.returncode == 0, r.stderr

    def body(r):
        assert r.returncode == 0, r.stderr
        return [l for l in r.stdout.splitlines()
                if not l.startswith("@PG")]

    for mates in ([], [str(tmp_path / "r2.fq")]):
        args = ["-b", "16", str(fa), str(tmp_path / "r1.fq"), *mates]
        want = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu", "mem", "--backend", "jax",
             "--host", "native"] + args, **run)
        got = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu_torch", "mem", "--backend",
             "torch", "--inflight", "2"] + args, **run)
        w, g = body(want), body(got)
        assert sum(not l.startswith("@") for l in w) >= 24
        assert w == g


def test_cli_refuses_unported_paths(tmp_path):
    """Flags whose device paths are not ported exit non-zero naming the
    ROADMAP item; nothing is silently ignored.  The ported paths are
    accepted, and the JAX package's backends name their counterparts."""
    from bwamem_tpu_torch.__main__ import (
        bad_combination,
        build_parser,
        not_ported,
    )

    base = ["mem", "ref.fa", "r.fq"]
    ap = build_parser()
    for extra in (["--backend", "torch"], ["--ship-ref"], ["--phased"],
                  ["--backend", "scalar"], ["--host", "python"],
                  ["--host", "python", "--backend", "cuda"]):
        args = ap.parse_args(base + extra)
        assert not_ported(args) is None and not bad_combination(args), extra
    for extra in (["--device-cigar"], ["--device-rescue"],
                  ["--device-seed"], ["--backend", "jax"],
                  ["--backend", "pallas"],
                  ["--host", "python", "--device-cigar"]):
        why = not_ported(ap.parse_args(base + extra))
        assert why and "ROADMAP" in why, extra
    assert "slice 4" in not_ported(
        ap.parse_args(base + ["--host", "python", "--device-cigar"]))
    assert "--backend torch" in not_ported(
        ap.parse_args(base + ["--backend", "jax"]))
    assert "--backend cuda" in not_ported(
        ap.parse_args(base + ["--backend", "pallas"]))
    for extra in (["--phased", "--ship-ref"], ["--host", "python",
                                               "--phased"],
                  ["--backend", "scalar", "--ship-ref"]):
        assert bad_combination(ap.parse_args(base + extra)), extra
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "mem",
                        "--device-rescue", str(tmp_path / "x.fa"),
                        str(tmp_path / "x.fq")], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "ROADMAP" in r.stderr
