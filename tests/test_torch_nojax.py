"""The port runs with `import jax` and the JAX package blocked: a
subprocess (this test process has JAX loaded through tests/conftest.py)
installs an import hook that refuses jax, jaxlib and bwamem_tpu, imports
every module of the port and aligns one single-end chunk through the
native host pipeline with the port's plain backend on the CPU, seeded by
the C++ engine and by the plain device seeder (--device-seed); a second
one runs `mem` SE and PE through the Python host and through the
four-pass protocol; a third runs `mem --device-rescue --device-cigar` (from
the resident reference and with --ship-ref, and --host python
--device-cigar) on pairs that need rescue and reads with indels, and reads
the waves and rounds off the trace; a fourth runs the multi-device dry
run (parallel/dryrun.py) over two CPU devices."""

import os
import subprocess
import sys

import pytest

from bwamem_tpu_torch.pipeline import native_driver

from test_torch_selfcontained import BLOCK_IMPORTS as _NOJAX

_SCRIPT = _NOJAX + r"""
import numpy as np
import torch

torch.set_num_threads(1)

import importlib
import pkgutil

import bwamem_tpu_torch

n_mod = 0
for m in pkgutil.walk_packages(bwamem_tpu_torch.__path__, "bwamem_tpu_torch."):
    importlib.import_module(m.name)     # every module of the port
    n_mod += 1
assert n_mod > 30, n_mod
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.ops.types import params_from_options
from bwamem_tpu_torch.pipeline import native_driver, resident

rng = np.random.default_rng(3)
pac = rng.integers(0, 4, 20000).astype(np.uint8)
ref = Reference(contigs=[Contig("c", 0, 20000)], pac=pac)
fm = build_index(pac)
po = pack_occ(fm)
opt = MemOptions()
reads = []
for i in range(16):
    p = int(rng.integers(0, 19000))
    r = pac[p:p + 100].astype(np.int64).copy()
    r[int(rng.integers(0, 100))] = 4
    reads.append(r)
fn = resident.make_fused_idx_backend(params_from_options(opt), pac,
                                     torch.device("cpu"), blk_l=128)
pipe = native_driver.NativePipeline(opt, ref, fm, po, blk_l=128)
text, nrec = pipe.align_chunk_text(reads, fn)
assert nrec >= 16 and fn.dispatches == 1, (nrec, fn.dispatches)
mapped = sum(1 for l in text.splitlines()
             if not int(l.split("\t")[1]) & 4)
assert mapped >= 16, mapped
# the same chunk seeded by the plain device seeder (--device-seed)
from bwamem_tpu_torch.ops import smem_torch

pipe.seed_fn = smem_torch.make_device_seeder(po, fm, opt, "cpu")
assert pipe.align_chunk_text(reads, fn) == (text, nrec)
assert pipe.seed_fn.stats.counts["split_rounds"] >= 1
assert_none_loaded()
print("NOJAX_OK", nrec)
"""


# `mem` SE and PE (one chunk each) through the Python host and through
# the four-pass protocol, all on the CPU
_CLI_SCRIPT = _NOJAX + r"""
import contextlib
import io
import os
import tempfile

import numpy as np
import torch

torch.set_num_threads(1)

from bwamem_tpu_torch.__main__ import main
from bwamem_tpu_torch.ops import extend_cuda

tmp = tempfile.mkdtemp()
rng = np.random.default_rng(8)
acgt = np.array(list("ACGT"))
genome = rng.integers(0, 4, 20000)
fa = os.path.join(tmp, "ref.fa")
with open(fa, "w") as f:
    f.write(">c\n" + "".join(acgt[genome]) + "\n")
fq = [os.path.join(tmp, f"r{k}.fq") for k in (1, 2)]
with open(fq[0], "w") as f1, open(fq[1], "w") as f2:
    for i in range(12):
        p = int(rng.integers(0, 19500))
        a = "".join(acgt[genome[p:p + 100]])
        b = "".join(acgt[3 - genome[p + 250:p + 350][::-1]])
        f1.write(f"@p{i}\n{a}\n+\n{'I' * 100}\n")
        f2.write(f"@p{i}\n{b}\n+\n{'I' * 100}\n")


def run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return [l for l in out.getvalue().splitlines() if not l.startswith("@")]


run(["index", fa])
for flags in (["--host", "python"], ["--phased"]):
    for reads in (fq[:1], fq):
        recs = run(["mem", "--backend", "torch", *flags, fa, *reads])
        mapped = sum(not int(l.split("\t")[1]) & 4 for l in recs)
        assert mapped == 12 * len(reads), (flags, reads, mapped)
assert_none_loaded()
print("NOJAX_CLI_OK")
"""


# `mem` with the device rescue and device CIGAR protocols on pairs of
# which some mates lie on the wrong strand and some reads carry an indel
_DEVICE_SCRIPT = _NOJAX + r"""
import collections
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import torch

torch.set_num_threads(1)

from bwamem_tpu_torch.__main__ import main

tmp = tempfile.mkdtemp()
rng = np.random.default_rng(9)
acgt = np.array(list("ACGT"))
genome = rng.integers(0, 4, 30000)
fa = os.path.join(tmp, "ref.fa")
with open(fa, "w") as f:
    f.write(">c\n" + "".join(acgt[genome]) + "\n")
fq = [os.path.join(tmp, f"r{k}.fq") for k in (1, 2)]
with open(fq[0], "w") as f1, open(fq[1], "w") as f2:
    for i in range(40):
        p = int(rng.integers(0, 29500))
        a = genome[p:p + 100]
        if i % 3 == 0:
            a = np.concatenate([a[:40], a[43:]])
        b = 3 - genome[p + 250:p + 350][::-1]
        if i % 5 == 1:
            b = 3 - b[::-1]
        for f, r in ((f1, a), (f2, b)):
            f.write(f"@p{i}\n{''.join(acgt[r])}\n+\n{'I' * len(r)}\n")


def run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return [l for l in out.getvalue().splitlines() if not l.startswith("@PG")]


run(["index", fa])
want = run(["mem", "--backend", "torch", "-b", "64", fa, *fq])
assert any("D" in l.split("\t")[5] for l in want if l[0] != "@")
for flags in ([], ["--ship-ref"]):
    trace = os.path.join(tmp, "trace%d.jsonl" % len(flags))
    got = run(["mem", "--backend", "torch", "--device-rescue",
               "--device-cigar", *flags, "--trace", trace, "-b", "64", fa,
               *fq])
    assert got == want, flags
    with open(trace) as f:
        kinds = collections.Counter(
            json.loads(l)["kind"].rstrip("0123456789") for l in f)
    assert kinds["rescue_w"] > 0 and kinds["cigar_r"] > 0, kinds
se = run(["mem", "--backend", "torch", "-b", "64", fa, fq[0]])
assert run(["mem", "--backend", "torch", "--host", "python", "--device-cigar",
            "-b", "64", fa, fq[0]]) == se
assert_none_loaded()
print("NOJAX_DEVICE_OK")
"""


# the multi-device dry run (parallel/dryrun.py) over two CPU devices
_DRYRUN_SCRIPT = _NOJAX + r"""
import torch

torch.set_num_threads(1)

from bwamem_tpu_torch.parallel.dryrun import dryrun_multi_device

got = dryrun_multi_device([torch.device("cpu")] * 2)
assert len(got["se"]) == 16 and len(got["pe"]) == 24
assert_none_loaded()
print("NOJAX_DRYRUN_OK")
"""


def _run_blocked(script, token):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert token in r.stdout


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
def test_port_runs_with_jax_blocked():
    _run_blocked(_SCRIPT, "NOJAX_OK")


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
def test_python_host_and_phased_run_with_jax_blocked():
    """The Python host (`--host python`) and the four-pass protocol
    (`--phased`) reach neither JAX nor the JAX package: the port
    carries its own drivers."""
    _run_blocked(_CLI_SCRIPT, "NOJAX_CLI_OK")


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
def test_device_rescue_and_cigar_run_with_jax_blocked():
    """`--device-rescue` and `--device-cigar` (resident reference and
    --ship-ref; --host python --device-cigar) reach neither JAX nor the JAX
    package, give the SAM of the host paths, and their waves and rounds
    really run."""
    _run_blocked(_DEVICE_SCRIPT, "NOJAX_DEVICE_OK")


@pytest.mark.skipif(not native_driver.available(),
                    reason="native library unavailable")
def test_multi_device_dryrun_runs_with_jax_blocked():
    """The multi-device layer (parallel/dist.py, its dry run, the sharded
    seeder) reaches neither JAX nor the JAX package."""
    _run_blocked(_DRYRUN_SCRIPT, "NOJAX_DRYRUN_OK")
