"""`python -m bwamem_tpu_torch mem` against `python -m bwamem_tpu mem` on
the bwa flags of tests/test_cli_flags.py and the tracing and resume of
tests/test_cli_trace_resume.py, on that file's world (48 FR pairs of a
50 kbp contig, two substitutions a read, a BC:Z: comment on every read),
SAM byte-identical apart from the @PG line:

- `-p` interleaved pairs (also == the two-file run), `-C` (SE and PE),
  `-P`, `-I` (a right and a mis-specified window), the scoring flags
  `-A/-B/-O/-E/-L`, gzipped reads and a gzipped reference, `-R` (native
  text and object paths, Python host, PE), `-v 0` / `-v 3` (and the
  `[mem] wrote` line that only the second prints);
- `--trace` and `--resume` (utils/checkpoint.py): the trace has
  the JAX run's row kinds and per-chunk host rows, the manifest the
  three chunks; a resumed run re-aligns nothing, and after a kill
  (the last range dropped) exactly the missing reads, whose records
  equal the uninterrupted run's.

The JAX package runs once per flag set in a subprocess (`--backend jax
--host native` unless the case names the host); the port runs in this
process with `--backend torch` (its plain PyTorch version on the CPU)."""

import collections
import contextlib
import gzip
import io
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu.pipeline import native_driver
from bwamem_tpu_torch.__main__ import main

from test_torch_pipeline import _env

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")

N = 48
BATCH = "16"
RG = r"@RG\tID:grp1\tSM:s1"
NATIVE = ("--host", "native")
PYTHON = ("--host", "python")
# case: (host flags, `mem` arguments with {name} for a file of the world)
CASES = {
    "interleaved": (NATIVE, ("-p", "{fa}", "{ilv}")),
    "comment-se": (NATIVE, ("-C", "{fa}", "{fq1}")),
    "comment-pe": (NATIVE, ("-C", "{fa}", "{fq1}", "{fq2}")),
    "no-pairing": (NATIVE, ("-P", "{fa}", "{fq1}", "{fq2}")),
    "isize": (NATIVE, ("-I", "300,30", "{fa}", "{fq1}", "{fq2}")),
    "isize-off": (NATIVE, ("-I", "50,1,60,40", "{fa}", "{fq1}", "{fq2}")),
    "B9-O16": (NATIVE, ("-B", "9", "-O", "16", "{fa}", "{fq1}", "{fq2}")),
    "A2-E2-L10": (NATIVE, ("-A", "2", "-E", "2", "-L", "10", "{fa}",
                           "{fq1}", "{fq2}")),
    "gz-reads": (NATIVE, ("{fa}", "{gz1}")),
    "gz-ref": (NATIVE, ("{fagz}", "{fq1}")),
    "rg": (NATIVE, ("-R", RG, "{fa}", "{fq1}")),
    "rg-C": (NATIVE, ("-R", RG, "-C", "{fa}", "{fq1}")),
    "rg-python": (PYTHON, ("-R", RG, "{fa}", "{fq1}")),
    "rg-pe": (NATIVE, ("-R", RG, "{fa}", "{fq1}", "{fq2}")),
    "v0": (NATIVE, ("-v", "0", "{fa}", "{fq1}")),
    "v3": (NATIVE, ("-v", "3", "{fa}", "{fq1}")),
    "trace": (NATIVE, ("--trace", "{jax_trace}", "{fa}", "{fq1}")),
}


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_cli_flags.py's world: ref.fa, r1.fq / r2.fq, the
    interleaved file, gzipped copies of r1.fq and of the reference, all
    indexed by the port: (directory, {name: path})."""
    d = tmp_path_factory.mktemp("cliflags")
    rng = np.random.default_rng(11)
    bases = "ACGT"
    seq = "".join(bases[i] for i in rng.integers(0, 4, 50000))
    fa = d / "ref.fa"
    with open(fa, "w") as f:
        f.write(">c1\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    r1s, r2s = [], []
    for _ in range(N):
        pos = int(rng.integers(0, 50000 - 400))
        isz = int(rng.integers(250, 350))
        a = list(seq[pos:pos + 100])
        b = list(seq[pos + isz - 100:pos + isz])
        for p in (7, 55):
            a[p] = bases[int(rng.integers(0, 4))]
            b[p] = bases[int(rng.integers(0, 4))]
        r1s.append("".join(a))
        r2s.append(_revcomp("".join(b)))
    fq1, fq2, ilv = d / "r1.fq", d / "r2.fq", d / "interleaved.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2, open(ilv, "w") as fi:
        for i in range(N):
            one = f"@p{i} BC:Z:AAC{i}\n{r1s[i]}\n+\n{'I' * 100}\n"
            two = f"@p{i} BC:Z:GGT{i}\n{r2s[i]}\n+\n{'I' * 100}\n"
            f1.write(one)
            f2.write(two)
            fi.write(one + two)
    gz1, fagz = d / "r1.fq.gz", d / "ref2.fa.gz"
    for src, dst in ((fq1, gz1), (fa, fagz)):
        with open(src, "rb") as a, gzip.open(dst, "wb") as b:
            shutil.copyfileobj(a, b)
    for ref in (fa, fagz):
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["index", str(ref)]) == 0
    paths = {k: str(v) for k, v in (
        ("fa", fa), ("fq1", fq1), ("fq2", fq2), ("ilv", ilv), ("gz1", gz1),
        ("fagz", fagz), ("jax_trace", d / "jax_trace.jsonl"))}
    return d, paths


def _args(world, case):
    host, args = CASES[case]
    return host, [a.format(**world[1]) for a in args]


def _body(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


def _records(lines):
    return [l for l in lines if not l.startswith("@")]


@pytest.fixture(scope="module")
def jax_runs(world):
    """The JAX package's `mem --backend jax` on every case, one subprocess
    a case, four at a time: {case: (SAM body, standard error)}."""
    env, out, running = _env(), {}, {}
    todo = list(CASES)
    while todo or running:
        while todo and len(running) < 4:
            case = todo.pop(0)
            host, args = _args(world, case)
            running[case] = subprocess.Popen(
                [sys.executable, "-m", "bwamem_tpu", "mem", "--backend",
                 "jax", *host, "-b", BATCH, *args], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        case = next(iter(running))
        stdout, stderr = running.pop(case).communicate(timeout=600)
        assert "[mem] wrote" in stderr or case == "v0", stderr[-3000:]
        out[case] = (_body(stdout), stderr)
    return out


def _port(*args, host=()):
    """The port's `mem --backend torch` in this process: (SAM body,
    standard error)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["mem", "--backend", "torch", *host, "-b", BATCH, *args])
    assert rc == 0, err.getvalue()[-3000:]
    return _body(out.getvalue()), err.getvalue()


def _same(world, jax_runs, case, *extra):
    """The port's SAM (with `extra` flags) == the JAX package's on the
    case's arguments; returns the port's (records, standard error)."""
    host, args = _args(world, case)
    got, err = _port(*extra, *args, host=() if host == NATIVE else host)
    assert got == jax_runs[case][0]
    return _records(got), err


@pytest.fixture(scope="module")
def plain(world):
    """The port's records without flags: (SE, PE)."""
    p = world[1]
    return (_records(_port(p["fa"], p["fq1"])[0]),
            _records(_port(p["fa"], p["fq1"], p["fq2"])[0]))


def test_interleaved_pairs(world, jax_runs, plain):
    recs, _ = _same(world, jax_runs, "interleaved")
    assert len(recs) >= 2 * N and recs == plain[1]


@pytest.mark.parametrize("case", ["comment-se", "comment-pe"])
def test_comment_passthrough(world, jax_runs, case):
    recs, _ = _same(world, jax_runs, case)
    for l in recs:
        want = "BC:Z:GGT" if int(l.split("\t")[1]) & 0x80 else "BC:Z:AAC"
        assert l.split("\t")[-1].startswith(want), l


def test_skip_pairing(world, jax_runs):
    recs, _ = _same(world, jax_runs, "no-pairing")
    flags = [int(l.split("\t")[1]) for l in recs]
    assert all(f & 0x1 for f in flags)
    assert sum(bool(f & 0x40) for f in flags) >= N
    assert sum(bool(f & 0x80) for f in flags) >= N


@pytest.mark.parametrize("case", ["isize", "isize-off"])
def test_explicit_insert_size(world, jax_runs, case):
    recs, _ = _same(world, jax_runs, case)
    n_proper = sum(1 for l in recs if int(l.split("\t")[1]) & 0x2)
    assert n_proper >= 0.9 * 2 * N if case == "isize" else n_proper == 0


@pytest.mark.parametrize("case", ["B9-O16", "A2-E2-L10"])
def test_scoring_flags(world, jax_runs, plain, case):
    recs, _ = _same(world, jax_runs, case)

    def as_sum(rr):
        return sum(int(c[5:]) for l in rr for c in l.split("\t")[11:]
                   if c.startswith("AS:i:"))

    assert as_sum(recs) != as_sum(plain[1])


def test_gzipped_inputs(world, jax_runs, plain):
    gzed, _ = _same(world, jax_runs, "gz-reads")
    via_gz, _ = _same(world, jax_runs, "gz-ref")
    assert gzed == plain[0]
    assert [l.split("\t")[1:] for l in via_gz] == \
        [l.split("\t")[1:] for l in plain[0]]


@pytest.mark.parametrize("case", ["rg", "rg-C", "rg-python", "rg-pe"])
def test_read_group(world, jax_runs, case):
    recs, _ = _same(world, jax_runs, case)
    assert [l for l in jax_runs[case][0] if l.startswith("@RG")] == \
        ["@RG\tID:grp1\tSM:s1"]
    assert recs and all(l.count("\tRG:Z:grp1") == 1 for l in recs)


@pytest.mark.parametrize("case,wrote", [("v0", False), ("v3", True)])
def test_verbosity(world, jax_runs, case, wrote):
    _, err = _same(world, jax_runs, case)
    assert ("[mem] wrote" in err) == ("[mem] wrote" in jax_runs[case][1]) \
        == wrote


def _jsonl(path):
    with open(path) as f:
        return [json.loads(l) for l in f]


def _kinds(path):
    return collections.Counter(r["kind"] for r in _jsonl(path))


def test_trace_and_resume(world, jax_runs):
    """The four-pass protocol (`--phased`, the JAX CLI's native device
    protocol) with --trace and --resume, three chunks of 16 reads."""
    d, p = world
    trace, manifest = d / "trace.jsonl", d / "manifest.jsonl"
    got, err = _port("--phased", "--trace", str(trace), "--resume",
                     str(manifest), p["fa"], p["fq1"])
    recs1 = _records(got)
    assert recs1 == _records(jax_runs["trace"][0]) and len(recs1) == N
    ctr = json.loads(err.split("[mem] counters: ")[1].splitlines()[0])
    assert ctr["reads"] == N

    kinds, jkinds = _kinds(trace), _kinds(p["jax_trace"])
    assert set(jkinds) <= set(kinds)   # the port's spans add kinds
    assert kinds["host_chunk"] == jkinds["host_chunk"]
    assert any(k.startswith("extend_L") for k in kinds)
    assert any(k.startswith("extend_R") for k in kinds)
    rows = _jsonl(trace)
    assert sum(r["reads"] for r in rows if r["kind"] == "host_chunk") == N
    assert sum(r.get("cells", 0) for r in rows) > 0

    ranges = _jsonl(manifest)
    assert [(x["start"], x["end"]) for x in ranges] == \
        [(0, 16), (16, 32), (32, 48)]
    assert _records(_port("--resume", str(manifest), p["fa"],
                          p["fq1"])[0]) == []
    # a kill after two chunks: the resumed run aligns the last 16 reads
    with open(manifest, "w") as f:
        for x in ranges[:2]:
            f.write(json.dumps(x) + "\n")
    got, _ = _port("--resume", str(manifest), p["fa"], p["fq1"])
    assert _records(got) == recs1[32:]
    assert [(x["start"], x["end"]) for x in _jsonl(manifest)] == \
        [(0, 16), (16, 32), (32, 48)]
