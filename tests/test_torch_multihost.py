"""The port's copy of the multi-process helpers
(bwamem_tpu_torch/parallel/multihost.py): the three unit tests of
tests/test_multihost.py on the port's sharding and ordered merge; the
shard from the torch.distributed environment (`init_distributed`); and
the rule that gives a process its card (`local_cuda_device`, and `mem`'s
device through it)."""

import argparse
import socket

import pytest

from bwamem_tpu_torch.__main__ import mem_device
from bwamem_tpu_torch.parallel import multihost
from bwamem_tpu_torch.parallel.multihost import (
    local_cuda_device,
    merge_sam_files,
    merge_sams,
    shard_reads,
)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_shard_reads_partition():
    n, k = 103, 4
    all_idx = sorted(i for s in range(k) for i in shard_reads(n, s, k))
    assert all_idx == list(range(n))


def test_merge_sams_restores_order():
    n, k = 10, 3
    groups = [[[f"r{i}\tline1\n", f"r{i}\tline2\n"]
               for i in shard_reads(n, s, k)] for s in range(k)]
    merged = list(merge_sams([iter(g) for g in groups]))
    names = [g[0].split("\t")[0] for g in merged]
    assert names == [f"r{i}" for i in range(n)]


def test_merge_sam_files(tmp_path):
    n, k = 12, 3
    hdr = "@HD\tVN:1.5\n@SQ\tSN:c\tLN:100\n"
    paths = []
    for s in range(k):
        p = tmp_path / f"shard{s}.sam"
        with open(p, "w") as f:
            f.write(hdr)
            for i in shard_reads(n, s, k):
                f.write(f"q{i}\t0\tc\t{i+1}\t60\t5M\t*\t0\t0\tACGTA\t*\n")
                if i % 2:  # a supplementary record (flag 0x800) of the unit
                    f.write(f"q{i}\t2064\tc\t{i+5}\t60\t5M\t*\t0\t0"
                            f"\tACGTA\t*\n")
        paths.append(str(p))
    out = tmp_path / "merged.sam"
    nrec = merge_sam_files(paths, str(out))
    lines = open(out).read().splitlines()
    assert lines[0].startswith("@HD")
    body = [l for l in lines if not l.startswith("@")]
    assert nrec == len(body) == 12 + 6
    names = []
    for l in body:
        nm = l.split("\t")[0]
        if not names or names[-1] != nm:
            names.append(nm)
    assert names == [f"q{i}" for i in range(n)]


def test_init_distributed_without_environment(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")     # no MASTER_ADDR: no group
    assert multihost.init_distributed() == (0, 1)
    multihost.destroy()                        # nothing to leave


def test_init_distributed_world_of_one(monkeypatch):
    """The environment path itself: a gloo group of one process on a
    local rendezvous, left by destroy()."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    try:
        assert multihost.init_distributed() == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert multihost.init_distributed() == (0, 1)   # joined once
    finally:
        multihost.destroy()
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank,n_cuda,want", [
    (None, 0, "cuda"), ("", 2, "cuda"), ("0", 1, "cuda:0"),
    ("1", 2, "cuda:1"), ("3", 4, "cuda:3"),
    ("2", 2, ValueError), ("0", 0, ValueError), ("-1", 2, ValueError)])
def test_local_cuda_device(local_rank, n_cuda, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="names no card"):
            local_cuda_device(local_rank, n_cuda)
    else:
        assert local_cuda_device(local_rank, n_cuda) == want


def test_mem_device(monkeypatch):
    """`mem`'s device: the CPU for --backend torch whatever LOCAL_RANK
    says; for --backend cuda the card of LOCAL_RANK, never a wrap-around
    (this machine sees no card, so any LOCAL_RANK is beyond them), and
    no CPU fallback without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mem_device(argparse.Namespace(backend="torch")) == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="names no card"):
        mem_device(argparse.Namespace(backend="cuda"))
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError):
        mem_device(argparse.Namespace(backend="cuda"))
