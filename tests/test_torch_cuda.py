"""The hand-written CUDA kernels (bwamem_tpu_torch/csrc/extend_fused.cu,
extend_t.cu; 32-bit cells and packed 16-bit cells; local_sw.cu and
global_sw.cu) against their plain PyTorch versions on the same CUDA
tensors, exact on every row and lane, the 16-bit kernels against the
32-bit ones, and the port's backend on the GPU against the same backend on
the CPU; a kernel library that fails to build raises.  The tests marked `cuda` need an NVIDIA
GPU and skip without one; run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -q` (this file
needs no JAX; tests/conftest.py imports it)."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import (extend_cuda, extend_torch, global_cuda,
                                  global_torch, local_cuda, local_torch)

import _torch_gate as gate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _prm(zdrop=100):
    return np.array([1, 4, 6, 1, 6, 1, zdrop, 0], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,zdrop", [((160, 320, 160, 320), 100),
                                        ((160, 320, 160, 320), 0),
                                        ((1024, 64, 1024, 64), 100)])
def test_kernel_matches_plain(cuda, dims, zdrop):
    batch = gate.random_fused_batch(17, 2048, dims, n_pad=37)
    t = [torch.from_numpy(x).to(cuda) for x in batch]
    before = extend_cuda.launches["extend_fused"]
    got = extend_cuda.extend_batch_raw_fused(*t, _prm(zdrop))
    torch.cuda.synchronize()
    assert extend_cuda.launches["extend_fused"] == before + 1
    want = extend_torch.extend_fused(*t, _prm(zdrop))
    assert torch.equal(got, want)
    lanes = gate.valid_l0_lanes(batch[4])[:96]
    assert gate.l0_scalar_mismatches(got.cpu().numpy(), batch[0], batch[1],
                                     batch[4], _prm(zdrop), lanes) == []


@pytest.mark.cuda
@pytest.mark.parametrize("qmax,tmax,zdrop", [(160, 320, 100), (160, 320, 0),
                                             (1024, 64, 100)])
def test_extend_t_kernel_matches_plain(cuda, qmax, tmax, zdrop):
    batch = gate.random_t_batch(18, 2048, qmax, tmax, n_pad=41)
    t = [torch.from_numpy(x).to(cuda) for x in batch[:3]] + [batch[3]]
    before = extend_cuda.launches["extend_t"]
    got = extend_cuda.extend_batch_raw_t(*t, _prm(zdrop))
    torch.cuda.synchronize()
    assert extend_cuda.launches["extend_t"] == before + 1
    want = extend_torch.extend_t(*t, _prm(zdrop))
    assert torch.equal(got, want)
    lanes = gate.valid_l0_lanes(batch[2])[:96]
    assert gate.l0_scalar_mismatches(got.cpu().numpy(), batch[0], batch[1],
                                     batch[2], _prm(zdrop), lanes) == []


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(160, 320, 160, 320), (64, 128, 32, 128),
                                  (1024, 64, 1024, 64)])
def test_i16_kernels_match_plain_and_i32_kernels(cuda, dims):
    """extend_fused_i16 and extend_t_i16 == the plain 16-bit version ==
    the 32-bit kernels, and count their own launches; a failed range check
    raises and launches nothing (no fallback to the 32-bit kernel)."""
    i16 = torch.int16
    batch = gate.random_fused_batch(19, 2048, dims, n_pad=37)
    t = [torch.from_numpy(x).to(cuda) for x in batch]
    extend_cuda.reset_launches()
    got = extend_cuda.extend_batch_raw_fused(*t, _prm(), compute_dtype=i16)
    torch.cuda.synchronize()
    assert torch.equal(got, extend_torch.extend_fused(*t, _prm(),
                                                      compute_dtype=i16))
    assert torch.equal(got, extend_cuda.extend_batch_raw_fused(*t, _prm()))
    batch = gate.random_t_batch(20, 2048, dims[0], dims[1], n_pad=41)
    t = [torch.from_numpy(x).to(cuda) for x in batch[:3]] + [batch[3]]
    got = extend_cuda.extend_batch_raw_t(*t, _prm(), compute_dtype=i16)
    torch.cuda.synchronize()
    assert torch.equal(got, extend_torch.extend_t(*t, _prm(),
                                                  compute_dtype=i16))
    assert torch.equal(got, extend_cuda.extend_batch_raw_t(*t, _prm()))
    assert extend_cuda.launches == {"extend_fused": 1, "extend_t": 1,
                                    "extend_fused_i16": 1, "extend_t_i16": 1}
    bad = _prm()
    bad[0] = 127                        # a*qmax >= 2^14 at 160 columns up
    if dims[0] >= 160:
        with pytest.raises(ValueError, match="16-bit"):
            extend_cuda.extend_batch_raw_t(*t, bad, compute_dtype=i16)
        assert extend_cuda.launches["extend_t_i16"] == 1
        assert extend_cuda.launches["extend_t"] == 1


@pytest.mark.cuda
def test_backend_cuda_matches_cpu(cuda):
    """The resident-reference backend on the GPU == on the CPU, SAM
    byte for byte, through the native host pipeline."""
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.io.fasta import Contig, Reference
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.pipeline import native_driver, resident

    rng = np.random.default_rng(1)
    pac = rng.integers(0, 4, 60000).astype(np.uint8)
    ref = Reference(contigs=[Contig("c", 0, 60000)], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    opt = MemOptions()
    reads = []
    for i in range(64):
        p = int(rng.integers(0, 59000))
        r = pac[p:p + 150].astype(np.int64).copy()
        r[rng.integers(0, 150, 3)] = rng.integers(0, 4, 3)
        reads.append(r if i % 2 else 3 - r[::-1])
    texts = []
    for dev in (cuda, torch.device("cpu")):
        fn = resident.make_fused_idx_backend(params_from_options(opt), pac,
                                             dev, blk_l=128)
        pipe = native_driver.NativePipeline(opt, ref, fm, po, blk_l=128)
        texts.append(pipe.align_chunk_text(reads, fn)[0])
    assert texts[0] == texts[1]


def test_cuda_backend_without_gpu_exits_nonzero(tmp_path):
    """No fallback: --backend cuda on a machine without a GPU fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bwamem_tpu_torch.device import resolve

    with pytest.raises(RuntimeError):
        resolve("cuda")
    fa = tmp_path / "ref.fa"
    rng = np.random.default_rng(0)
    fa.write_text(">c\n" + "".join(np.array(list("ACGT"))[
        rng.integers(0, 4, 5000)]) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@r\n" + "ACGT" * 25 + "\n+\n" + "I" * 100 + "\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    run = dict(env=env, capture_output=True, text=True, timeout=300)
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                        str(fa)], **run)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "mem",
                        "--backend", "cuda", str(fa), str(fq)], **run)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    # the other paths with a device backend fail the same way
    from bwamem_tpu_torch.__main__ import main

    for flags in (["--host", "python"], ["--phased"], ["--ship-ref"]):
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = main(["mem", "--backend", "cuda", *flags, str(fa), str(fq)])
        assert rc != 0, flags
        assert "torch.cuda.is_available() is False" in err.getvalue(), flags


@pytest.mark.parametrize("nvcc", ["missing", "fails"])
def test_failed_build_raises(tmp_path, monkeypatch, nvcc):
    """No fallback: a kernel build that cannot run nvcc, or whose nvcc
    fails, raises instead of leaving a path without its kernel."""
    from bwamem_tpu_torch.ops import _build

    tool = str(tmp_path / "nvcc") if nvcc == "missing" else "false"
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: tool)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert _build._loaded is None
    assert os.listdir(tmp_path / "build") == []


def _sw_call(kind, dev):
    """(dispatcher, plain version, its launches dict and key, the CUDA
    arguments) of the mate-rescue ("local") or CIGAR ("global") kernel at
    the dev-fn shapes, on the hard-case batch of tests/_torch_gate.py."""
    if kind == "local":
        args = gate.local_sw_batch(23, 8192, 160, 512, n_pad=64)
        return (local_cuda.align6, local_torch.align6, local_cuda.launches,
                "local_align6",
                [torch.from_numpy(a).to(dev) for a in args])
    args = gate.global_sw_batch(24, 2048, 160, 160, n_pad=64)
    return (global_cuda.global_batch, global_torch.global_batch,
            global_cuda.launches, "global_cigar",
            [torch.from_numpy(a).to(dev) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["local", "global"])
def test_sw_kernel_matches_plain(cuda, kind):
    """bwt_local_align6 / bwt_global_cigar == the plain version at the
    dev-fn shapes, in one launch; tensors on two devices raise."""
    fn, plain, launches, key, args = _sw_call(kind, cuda)
    before = launches[key]
    got = fn(*args)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    want = plain(*args)
    for g, w in zip(got if kind == "global" else [got],
                    want if kind == "global" else [want]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        fn(*args[:-2], args[-2].cpu(), args[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["local", "global"])
def test_sw_failed_build_raises(cuda, tmp_path, monkeypatch, kind):
    """No fallback: with a kernel library that cannot be built, a CUDA call
    of either dispatcher raises and launches nothing."""
    from bwamem_tpu_torch.ops import _build

    fn, _, launches, key, args = _sw_call(kind, cuda)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    before = launches[key]
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args)
    assert launches[key] == before
