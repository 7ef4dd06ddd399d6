"""The port is a package of its own: no file of bwamem_tpu_torch/, nor
chip_smoke.py, nor tests/_torch_gate.py imports jax, jaxlib or the JAX
package (bwamem_tpu), at import time or at call time.

- statically: the AST of every such file holds no such import, at top
  level or nested;
- by running: a subprocess whose import machinery refuses the three
  builds an index and runs `mem --backend torch` SE and PE through the
  default (resident), `--phased`, `--ship-ref` and `--host python` paths,
  with `--device-rescue --device-cigar` from the resident reference
  and from shipped windows, and with `--device-seed` (the plain seeder);
  each SAM is byte-identical (apart from @PG)
  to `python -m bwamem_tpu mem --backend jax` with the same device flags
  on the same files and the same (port-built) index;
- the index cache file has one format: built by either package it holds
  the same arrays and loads in the other;
- the C++ host library is built under bwamem_tpu_torch/build/ and the run
  leaves bwamem_tpu/native/ as it was; the two packages' libraries are
  separate images in one process, so no `mp_*` state is shared."""

import ast
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_pipeline import _env, _fastq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "bwamem_tpu")

# a prelude for `python -c` scripts: importing any of REFUSED raises
BLOCK_IMPORTS = r"""
import importlib.abc
import sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Refuse())


def assert_none_loaded():
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu")]
    assert not bad, bad
"""

PATHS = {"resident": [], "phased": ["--phased"], "ship_ref": ["--ship-ref"],
         "python_host": ["--host", "python"],
         "device": ["--device-rescue", "--device-cigar"],
         "device_ship_ref": ["--ship-ref", "--device-rescue",
                             "--device-cigar"],
         "device_seed": ["--device-seed"]}

_RUN_ALL = BLOCK_IMPORTS + r"""
import contextlib
import io

import torch

torch.set_num_threads(1)

from bwamem_tpu_torch.__main__ import main

fa, r1, r2, out_dir = sys.argv[1:5]
paths = eval(sys.argv[5])


def run(argv, sam=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, (argv, err.getvalue()[-3000:])
    if sam:
        with open(sam, "w") as f:
            f.write(out.getvalue())


run(["index", fa])
for name, flags in paths.items():
    for ends, reads in (("SE", [r1]), ("PE", [r1, r2])):
        run(["mem", "--backend", "torch", *flags, "-b", "16", fa, *reads],
            f"{out_dir}/{name}_{ends}.sam")
assert_none_loaded()
print("SELFCONTAINED_OK")
"""


def run_blocked(script, token, *argv):
    """Run `script` (which starts with BLOCK_IMPORTS) in a subprocess."""
    r = subprocess.run([sys.executable, "-c", script, *argv], env=_env(),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert token in r.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "_torch_gate.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "bwamem_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree):
    """Every module name an AST imports, wherever the statement stands,
    and every literal handed to __import__ / import_module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    for mod in ("local_cuda.py", "global_cuda.py", "smem_cuda.py"):
        assert os.path.join(ROOT, "bwamem_tpu_torch", "ops", mod) in files
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += [(os.path.relpath(path, ROOT), m) for m in _imports(tree)
                if m.split(".")[0] in REFUSED]
    assert bad == []


def _native_dir_state():
    d = os.path.join(ROOT, "bwamem_tpu", "native")
    return sorted((n, os.path.getmtime(os.path.join(d, n)),
                   os.path.getsize(os.path.join(d, n)))
                  for n in os.listdir(d) if n != "__pycache__")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A small genome with SE/PE reads, indexed and aligned through every
    path of the port with the JAX package's imports refused."""
    tmp = tmp_path_factory.mktemp("selfcontained")
    rng = np.random.default_rng(21)
    acgt = np.array(list("ACGT"))
    genome = rng.integers(0, 4, 30000)
    fa = tmp / "ref.fa"
    fa.write_text(">c1\n" + "".join(acgt[genome[:18000]]) + "\n>c2\n"
                  + "".join(acgt[genome[18000:]]) + "\n")
    r1, r2 = [], []
    for i in range(24):
        p = int(rng.integers(0, 17000 if i % 2 else 11000)) \
            + (0 if i % 2 else 18000)
        a = genome[p:p + 100].copy()
        a[rng.integers(0, 100, 2)] = rng.integers(0, 4, 2)
        b = 3 - genome[p + 250:p + 350][::-1]
        r1.append("".join(acgt[a]))
        r2.append("".join(acgt[b]))
    names = [f"q{i}" for i in range(24)]
    _fastq(tmp / "r1.fq", names, r1)
    _fastq(tmp / "r2.fq", names, r2)
    before = _native_dir_state()
    run_blocked(_RUN_ALL, "SELFCONTAINED_OK", str(fa), str(tmp / "r1.fq"),
                str(tmp / "r2.fq"), str(tmp), repr(PATHS))
    return tmp, before


def _body(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.fixture(scope="module")
def jax_sam(run_dir):
    """The JAX package's SAM body per (host, ends, device flags),
    computed once."""
    tmp, _ = run_dir
    cache = {}

    def get(host, ends, flags=()):
        if (host, ends, flags) not in cache:
            reads = [str(tmp / "r1.fq")] + ([str(tmp / "r2.fq")]
                                            if ends == "PE" else [])
            r = subprocess.run(
                [sys.executable, "-m", "bwamem_tpu", "mem", "--backend",
                 "jax", "--host", host, *flags, "-b", "16",
                 str(tmp / "ref.fa"), *reads], env=_env(),
                capture_output=True, text=True, timeout=900)
            assert r.returncode == 0, r.stderr[-3000:]
            cache[host, ends, flags] = _body(r.stdout)
        return cache[host, ends, flags]

    return get


@pytest.mark.parametrize("ends", ["SE", "PE"])
@pytest.mark.parametrize("path", list(PATHS))
def test_blocked_run_matches_jax_package(run_dir, jax_sam, path, ends):
    tmp, _ = run_dir
    got = _body((tmp / f"{path}_{ends}.sam").read_text())
    want = jax_sam("python" if path == "python_host" else "native", ends,
                   tuple(f for f in PATHS[path] if f.startswith("--device")))
    recs = [l for l in want if not l.startswith("@")]
    assert len(recs) >= (48 if ends == "PE" else 24)
    assert sum(not int(l.split("\t")[1]) & 4 for l in recs) >= len(recs) - 2
    assert got == want


def test_host_library_is_the_ports_own(run_dir):
    """Built under bwamem_tpu_torch/build/; bwamem_tpu/native/ untouched."""
    _, before = run_dir
    assert os.path.exists(os.path.join(ROOT, "bwamem_tpu_torch", "build",
                                       "libbwamem_host.so"))
    assert _native_dir_state() == before


def test_two_host_libraries_share_no_state():
    """Both packages' loaders in one process give two images of the C++
    host: every function, and so every static behind the `mp_*` handles,
    has its own address."""
    import bwamem_tpu.native as ref_native
    import bwamem_tpu_torch.native as port_native

    a, b = ref_native.get_lib(), port_native.get_lib()
    if a is None or b is None:
        pytest.skip("native library unavailable")
    assert a._name != b._name and a._handle != b._handle
    assert os.path.normpath(b._name) == os.path.join(
        ROOT, "bwamem_tpu_torch", "build", "libbwamem_host.so")
    for fn in ("mp_chunk_start", "mp_finalize", "bwamem_sais_u8"):
        pa = ctypes.cast(getattr(a, fn), ctypes.c_void_p).value
        pb = ctypes.cast(getattr(b, fn), ctypes.c_void_p).value
        assert pa and pb and pa != pb, fn


def test_index_files_are_interchangeable(run_dir, tmp_path):
    """An index built by the JAX package equals the port's array by
    array, and each package loads the other's."""
    from bwamem_tpu.__main__ import load_index as ref_load
    from bwamem_tpu_torch.__main__ import load_index as port_load

    tmp, _ = run_dir
    fa2 = tmp_path / "ref.fa"
    shutil.copy(tmp / "ref.fa", fa2)
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu", "index",
                        str(fa2)], env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    mine = np.load(str(tmp / "ref.fa") + ".bwt.npz")
    theirs = np.load(str(fa2) + ".bwt.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in mine.files:
        assert mine[k].dtype == theirs[k].dtype, k
        assert np.array_equal(mine[k], theirs[k]), k
    # the port's index in the JAX package's loader and the reverse
    for load, fasta in ((ref_load, tmp / "ref.fa"), (port_load, fa2)):
        ref, fm = load(str(fasta))
        assert [c.name for c in ref.contigs] == ["c1", "c2"]
        assert fm.l_pac == 30000 and fm.seq_len2 == 60000


def test_wide_int_of_the_ports_packed_occ():
    """The port's occ_packed has no JAX branch: numpy and torch both get
    their 64-bit integer, anything else is refused."""
    from bwamem_tpu_torch.index import occ_packed

    assert occ_packed._wide_int(np) is np.int64
    assert occ_packed._wide_int(torch) is torch.int64
    with pytest.raises(TypeError):
        occ_packed._wide_int(ast)
