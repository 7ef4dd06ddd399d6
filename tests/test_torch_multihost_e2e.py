"""Scale-out across processes through the port's CLI, with real
processes: the counterparts of tests/test_multihost_e2e.py.  Two or three
`python -m bwamem_tpu_torch mem --backend torch` processes run at once,
each on its strided shard of the reads (`--shard K/N`, or the shard that
`init_distributed` derives from the torch.distributed environment:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), then `merge` restores input
order; the merged SAM must equal the single-process run's, record for
record."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bwamem_tpu_torch.pipeline import native_driver

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")

_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK")


def _env():
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    return env


def _body(text: str) -> list[str]:
    return [l for l in text.splitlines() if not l.startswith("@")]


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mhost_torch")
    rng = np.random.default_rng(23)
    bases = "ACGT"
    seq = "".join(bases[i] for i in rng.integers(0, 4, 60000))
    fa = d / "ref.fa"
    with open(fa, "w") as f:
        f.write(">c1\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    n = 70  # deliberately not a multiple of the shard counts
    r1s, r2s = [], []
    for i in range(n):
        pos = int(rng.integers(0, 60000 - 400))
        isz = int(rng.integers(250, 350))
        a = list(seq[pos:pos + 100])
        b = list(seq[pos + isz - 100:pos + isz])
        for p in (13, 61):
            a[p] = bases[int(rng.integers(0, 4))]
            b[p] = bases[int(rng.integers(0, 4))]
        r1s.append("".join(a))
        r2s.append(_revcomp("".join(b)))
    fq1, fq2 = d / "r1.fq", d / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(n):
            f1.write(f"@p{i}\n{r1s[i]}\n+\n{'I' * 100}\n")
            f2.write(f"@p{i}\n{r2s[i]}\n+\n{'I' * 100}\n")
    # every read carries the SAME name: unit grouping by QNAME runs alone
    # cannot keep them apart
    fqdup = d / "dup.fq"
    with open(fqdup, "w") as f:
        for i in range(n):
            f.write(f"@dup\n{r1s[i]}\n+\n{'I' * 100}\n")
    env = _env()
    subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                    str(fa)], env=env, check=True, capture_output=True,
                   timeout=300)
    return d, fa, fq1, fq2, fqdup, env, n


_BASE = ["-m", "bwamem_tpu_torch", "mem", "--backend", "torch",
         "--host", "native", "-b", "32"]


def _single(env, *extra) -> str:
    r = subprocess.run([sys.executable, *_BASE, *extra], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _sharded(env, d, n_shards, *extra, shard_env=None) -> str:
    """Start n_shards mem processes at once, then merge their SAMs."""
    procs, paths = [], []
    for k in range(n_shards):
        out = d / f"shard{k}.sam"
        paths.append(str(out))
        e = dict(env)
        if shard_env is not None:
            e.update(shard_env(k, n_shards))
            args = list(extra)
        else:
            args = ["--shard", f"{k}/{n_shards}", *extra]
        with open(out, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, *_BASE, *args], env=e, stdout=f,
                stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    merged = d / "merged.sam"
    r = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "merge", str(merged),
         *paths], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    for k, err in enumerate(errs):
        assert f"[mem] shard {k}/{n_shards} (strided)" in err
    return open(merged).read()


def test_shard_merge_se_identical(world):
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1)))
    got = _body(_sharded(env, d, 3, str(fa), str(fq1)))
    assert got == want
    assert len(got) >= n


def test_shard_merge_pe_identical(world):
    """A pair's whole lifecycle (insert-size inference, rescue, pairing)
    stays in one process; the merged stream is record for record the
    single-process PE run."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1), str(fq2)))
    got = _body(_sharded(env, d, 2, str(fa), str(fq1), str(fq2)))
    assert got == want
    assert len(got) >= 2 * n


def test_shard_merge_duplicate_qnames(world):
    """Adjacent reads sharing one QNAME: the flag-structure unit grouping
    (multihost.sam_units) keeps them apart."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fqdup)))
    got = _body(_sharded(env, d, 2, str(fa), str(fqdup)))
    assert got == want


def test_shard_from_torch_distributed_env(world):
    """Two processes under the torch.distributed environment and no
    --shard: each derives its shard from init_distributed (a gloo
    rendezvous at MASTER_ADDR:MASTER_PORT), and the merged SAM is the
    single run's."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def shard_env(k, n_shards):
        return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "WORLD_SIZE": str(n_shards), "RANK": str(k)}

    got = _body(_sharded(env, d, 2, str(fa), str(fq1),
                         shard_env=shard_env))
    assert got == want
