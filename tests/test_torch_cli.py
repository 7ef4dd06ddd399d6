"""`python -m bwamem_tpu_torch mem` on the paths this port adds, against
`python -m bwamem_tpu mem` on one tiny index, SE and PE, with a read
group (`-R`), apart from the @PG header line:

- `--host python --backend torch` == `--host python --backend jax`;
- `--phased --backend torch` and `--ship-ref --backend torch` ==
  `--backend jax --host native`;
- `--backend scalar` == `--backend scalar`;
- `--device-rescue`, `--device-cigar`, both, with and without
  `--ship-ref`, and `--host python --device-cigar` == the JAX package's
  CLI with the same flags, on pairs that need rescue and reads that carry
  indels, with the port's `--trace` showing that waves and rounds ran.

The JAX package runs in a subprocess; the port runs in this process
(its CLI takes argv)."""

import contextlib
import io
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu.pipeline import native_driver
from bwamem_tpu_torch.__main__ import main

from test_torch_pipeline import _env, _fastq

torch.set_num_threads(1)

RG = "@RG\\tID:x"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    acgt = np.array(list("ACGT"))
    genome = rng.integers(0, 4, 30000)
    fa = tmp / "ref.fa"
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
    _fastq(tmp / "r1.fq", names, r1)
    _fastq(tmp / "r2.fq", names, r2)
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["index", str(fa)]) == 0
    return [str(fa), str(tmp / "r1.fq")], [str(tmp / "r2.fq")], {}


def _body(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


def _want(files, jax_flags, mates, batch="16"):
    """The JAX package's SAM body, computed once per flags and ends."""
    args, mate_file, cache = files
    key = (tuple(jax_flags), mates)
    if key not in cache:
        r = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu", "mem", *jax_flags, "-b",
             batch, "-R", RG, *args, *(mate_file if mates else [])],
            env=_env(), capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        cache[key] = _body(r.stdout)
    return cache[key]


def _got(files, port_flags, mates, batch="16", stderr=None):
    args, mate_file, _ = files
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["mem", *port_flags, "-b", batch, "-R", RG, *args,
                   *(mate_file if mates else [])])
    assert rc == 0, err.getvalue()[-3000:]
    if stderr is not None:
        stderr.append(err.getvalue())
    return _body(out.getvalue())


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
@pytest.mark.parametrize("port_flags,jax_flags", [
    (["--host", "python", "--backend", "torch"],
     ["--host", "python", "--backend", "jax"]),
    (["--phased", "--backend", "torch", "--inflight", "2"],
     ["--backend", "jax", "--host", "native"]),
    (["--ship-ref", "--backend", "torch", "--inflight", "2"],
     ["--backend", "jax", "--host", "native"]),
    (["--backend", "scalar"], ["--backend", "scalar"]),
], ids=["python_host", "phased", "ship_ref", "scalar"])
def test_cli_new_paths_match_jax_package(files, port_flags, jax_flags):
    for mates in (False, True):
        want = _want(files, jax_flags, mates)
        got = _got(files, port_flags, mates)
        recs = [l for l in want if not l.startswith("@")]
        assert len(recs) >= (48 if mates else 24)
        assert all(l.endswith("\tRG:Z:x") for l in recs)
        assert got == want


@pytest.mark.parametrize("backend", ["torch", "cuda", "scalar"])
@pytest.mark.parametrize("flag", [("-A", "128"), ("-B", "128"),
                                  ("-A", "-1")])
def test_cli_refuses_scores_outside_a_signed_byte(files, backend, flag):
    """-A / -B that the CUDA kernels cannot hold are refused when the
    arguments are read, alike on every backend."""
    args, _, _ = files
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(["mem", "--backend", backend, *flag, *args])
    assert rc == 2 and "outside 0..127" in err.getvalue()


@pytest.fixture(scope="module")
def hard_files(tmp_path_factory):
    """64 pairs on a 40 kb genome: a third of the reads carry a short
    insertion or deletion (so the CIGAR rounds have real work), every
    sixth mate is substituted every 9 bases and every seventh lies on the
    wrong strand (so the seeder cannot place it and rescue fires)."""
    tmp = tmp_path_factory.mktemp("cli_pe")
    rng = np.random.default_rng(8)
    acgt = np.array(list("ACGT"))
    genome = rng.integers(0, 4, 40000)
    fa = tmp / "ref.fa"
    fa.write_text(">c1\n" + "".join(acgt[genome]) + "\n")
    r1, r2 = [], []
    for i in range(64):
        p = int(rng.integers(0, 39000))
        a = genome[p:p + 100].copy()
        m = genome[p + 250:p + 350].copy()
        if i % 3 == 0:
            cut = int(rng.integers(20, 80))
            a = (np.concatenate([a[:cut], a[cut + 2:]]) if i % 2 else
                 np.concatenate([a[:cut], rng.integers(0, 4, 3), a[cut:]]))
        if i % 6 == 1:
            m[4::9] = (m[4::9] + 1 + rng.integers(0, 3, len(m[4::9]))) % 4
        b = 3 - m[::-1]
        if i % 7 == 2:
            b = 3 - b[::-1]
        r1.append("".join(acgt[a]))
        r2.append("".join(acgt[b]))
    names = [f"q{i}" for i in range(64)]
    _fastq(tmp / "r1.fq", names, r1)
    _fastq(tmp / "r2.fq", names, r2)
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["index", str(fa)]) == 0
    return ([str(fa), str(tmp / "r1.fq")], [str(tmp / "r2.fq")], {},
            str(tmp))


def _trace_kinds(path):
    import collections
    import json

    with open(path) as f:
        return collections.Counter(
            json.loads(l)["kind"].rstrip("0123456789") for l in f)


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
@pytest.mark.parametrize("flags,ends", [
    (["--device-rescue"], "pe"),
    (["--device-cigar"], "se"),
    (["--device-cigar"], "pe"),
    (["--device-rescue", "--device-cigar"], "pe"),
    (["--ship-ref", "--device-rescue"], "pe"),
    (["--ship-ref", "--device-cigar"], "se"),
    (["--ship-ref", "--device-rescue", "--device-cigar"], "pe"),
], ids=lambda v: "+".join(x.strip("-") for x in v)
    if isinstance(v, list) else v)
def test_cli_device_rescue_and_cigar_match_jax_package(hard_files, flags,
                                                       ends):
    """Native host: SAM byte-identical (apart from @PG) to the JAX
    package's CLI with the same flags and to the port's own run without
    them (host rescue, host CIGAR); the trace holds rescue_w* rows for
    --device-rescue and cigar_r* rows for --device-cigar."""
    *files, tmp = hard_files
    mates = ends == "pe"
    trace = f"{tmp}/{'_'.join(flags)}_{ends}.jsonl".replace("--", "")
    got = _got(files, ["--backend", "torch", "--inflight", "2", "--trace",
                       trace, *flags], mates, batch="64")
    kinds = _trace_kinds(trace)
    assert ("--device-rescue" in flags) == (kinds["rescue_w"] > 0), kinds
    assert ("--device-cigar" in flags) == (kinds["cigar_r"] > 0), kinds
    want = _want(files, ["--backend", "jax", "--host", "native", *flags],
                 mates, batch="64")
    assert got == want
    plain = [f for f in flags if f == "--ship-ref"]
    assert got == _got(files, ["--backend", "torch", *plain], mates,
                       batch="64")
    cigars = [l.split("\t")[5] for l in got if not l.startswith("@")]
    assert any("I" in c for c in cigars) and any("D" in c for c in cigars)
    assert len(cigars) >= (128 if mates else 64)


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
def test_cli_python_host_device_cigar_matches_jax_package(hard_files):
    """--host python --device-cigar: SE runs the global realignments
    through ops/global_torch; PE says that it is ignored there, as the JAX
    package's CLI does; a SE --device-rescue is ignored with its message.
    All byte-identical to the JAX package with the same flags."""
    *files, _ = hard_files
    flags = ["--host", "python", "--device-cigar"]
    for mates in (False, True):
        err = []
        got = _got(files, ["--backend", "torch", *flags], mates, batch="64",
                   stderr=err)
        assert got == _want(files, ["--backend", "jax", *flags], mates,
                            batch="64")
        assert ("--device-cigar for PE needs the native host; ignored here"
                in err[0]) == mates
        cigars = [l.split("\t")[5] for l in got if not l.startswith("@")]
        assert any("I" in c or "D" in c for c in cigars)
    err = []
    got = _got(files, ["--backend", "torch", "--device-rescue"], False,
               batch="64", stderr=err)
    assert "--device-rescue applies to the native PE path; ignored" in err[0]
    assert got == _got(files, ["--backend", "torch"], False, batch="64")
