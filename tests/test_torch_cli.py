"""`python -m bwamem_tpu_torch mem` on the paths this port adds, against
`python -m bwamem_tpu mem` on one tiny index, SE and PE, with a read
group (`-R`), apart from the @PG header line:

- `--host python --backend torch` == `--host python --backend jax`;
- `--phased --backend torch` and `--ship-ref --backend torch` ==
  `--backend jax --host native`;
- `--backend scalar` == `--backend scalar`.

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


def _want(files, jax_flags, mates):
    """The JAX package's SAM body, computed once per flags and ends."""
    args, mate_file, cache = files
    key = (tuple(jax_flags), mates)
    if key not in cache:
        r = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu", "mem", *jax_flags, "-b",
             "16", "-R", RG, *args, *(mate_file if mates else [])],
            env=_env(), capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        cache[key] = _body(r.stdout)
    return cache[key]


def _got(files, port_flags, mates):
    args, mate_file, _ = files
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["mem", *port_flags, "-b", "16", "-R", RG, *args,
                   *(mate_file if mates else [])])
    assert rc == 0, err.getvalue()[-3000:]
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
