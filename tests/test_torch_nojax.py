"""The port runs with `import jax` and the JAX package blocked: a
subprocess (this test process has JAX loaded through tests/conftest.py)
installs an import hook that refuses jax, jaxlib and bwamem_tpu, imports
every module of the port and aligns one single-end chunk through the
native host pipeline with the port's plain backend on the CPU; a second
one runs `mem` SE and PE through the Python host and through the
four-pass protocol."""

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
