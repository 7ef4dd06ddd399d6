"""Build and load the port's CUDA kernels.

The sources in bwamem_tpu_torch/csrc/*.cu (the extension kernels, the
seeding kernels of fm_seed.cu, and the mate-rescue and CIGAR kernels of
local_sw.cu and global_sw.cu) have a plain C interface and include the
device code of csrc/*.cuh.  At first use each source is
compiled by hand with nvcc for sm_90a, all at once (one nvcc process per
source), and the objects are linked into one shared library under
bwamem_tpu_torch/build/ (named by a hash of the sources and headers, so
an edit rebuilds) and loaded with ctypes.  Nothing is built when a
module is imported.  A failed build raises: there is no fallback."""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, os.pardir, "csrc")
BUILD_DIR = os.path.join(_HERE, os.pardir, "build")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_loaded = None


@dataclasses.dataclass
class KernelLib:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when a cached library was loaded
    log: str              # nvcc / ptxas output of the build


def _sources(csrc, exts=(".cu",)) -> list[str]:
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith(exts))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.bwt_extend_fused, lib.bwt_extend_fused_i16):
        fn.restype = i32
        fn.argtypes = ([vp, i32, vp, i32, vp, i32, vp, i32, vp, i64]
                       + [i32] * 7 + [vp, vp])
    for fn in (lib.bwt_extend_t, lib.bwt_extend_t_i16):
        fn.restype = i32
        fn.argtypes = [vp, i32, vp, i32, vp, i64] + [i32] * 7 + [vp, vp]
    bind_seed(lib)
    bind_sw(lib)
    lib.bwt_error_string.restype = ctypes.c_char_p
    lib.bwt_error_string.argtypes = [i32]
    lib.bwt_enable_peer_access.restype = i32
    lib.bwt_enable_peer_access.argtypes = [i32, i32]


MAX_SHARDS = 8     # fmseed::kMaxShards


class ShardTable(ctypes.Structure):
    """The ctypes mirror of fmseed::ShardedOcc (csrc/fm_seed.cuh): the
    device pointers of every shard's block records and sampled SA, then
    the shared scalars; every member is 8 bytes wide."""

    _fields_ = ([(name, ctypes.c_void_p * MAX_SHARDS)
                 for name in ("rec", "ssa")]
                + [("C", ctypes.c_int64 * 6)]
                + [(name, ctypes.c_int64)
                   for name in ("primary", "n_rows", "nb_loc", "ns_loc",
                                "blk_origin", "n_ssa", "sa_intv",
                                "n_shards")])


def bind_seed(lib: ctypes.CDLL) -> None:
    """The launchers of csrc/fm_seed.cu (also built by the tests with g++)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = [vp, vp, i64, i64]              # rec, C, primary, n_rows
    lib.bwt_smem_all.argtypes = tables + [vp, i32, vp, i64, i64, vp, vp]
    lib.bwt_smem1.argtypes = tables + [vp, i32, vp, vp, vp, vp, i64, vp, vp]
    lib.bwt_sa.argtypes = tables + [vp, i64, i64, vp, i64, i64, vp, vp]
    tab = ctypes.POINTER(ShardTable)
    lib.bwt_rank4_sh.argtypes = [tab, vp, i64, vp, vp]
    lib.bwt_smem_all_sh.argtypes = [tab, vp, i32, vp, i64, i64, vp, vp]
    lib.bwt_smem1_sh.argtypes = [tab, vp, i32, vp, vp, vp, vp, i64, vp, vp]
    lib.bwt_sa_sh.argtypes = [tab, vp, i64, i64, vp, vp]
    for fn in (lib.bwt_smem_all, lib.bwt_smem1, lib.bwt_sa, lib.bwt_rank4_sh,
               lib.bwt_smem_all_sh, lib.bwt_smem1_sh, lib.bwt_sa_sh):
        fn.restype = i32


def bind_sw(lib: ctypes.CDLL) -> None:
    """The launchers of csrc/local_sw.cu and csrc/global_sw.cu, and the
    functions that give the bytes of device scratch each needs."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bwt_local_align6_scratch.restype = i64
    lib.bwt_local_align6_scratch.argtypes = [i32, i32, i64]
    lib.bwt_global_cigar_scratch.restype = i64
    lib.bwt_global_cigar_scratch.argtypes = [i32, i32, i32, i64]
    lib.bwt_local_align6.restype = i32
    lib.bwt_local_align6.argtypes = [vp, i32, vp, vp, i32, vp, i64, vp, vp,
                                     vp, vp, vp]
    lib.bwt_global_cigar.restype = i32
    lib.bwt_global_cigar.argtypes = [vp, i32, vp, vp, i32, vp, vp, i64, i32,
                                     vp, vp, vp, vp, vp, vp, vp]


def launch(dev, fn: str, *args) -> None:
    """Call the C launcher `fn` of the kernel library with `args` and dev's
    current stream; raise if the launch failed."""
    import torch

    kl = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(kl.lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {kl.lib.bwt_error_string(rc)}")


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    log, failed = "", None
    for cmd, p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed = failed or (cmd, "timed out")
        log += out
        if p.returncode and failed is None:
            failed = (cmd, p.returncode)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[1]}): {' '.join(failed[0])}"
                           f"\n{log}")
    return log


def _compile(srcs, so) -> str:
    """Compile every source at once, then link `so`; returns the log."""
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    procs = []
    try:
        for src, obj in zip(srcs, objs):
            cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    except FileNotFoundError as e:
        for _, p in procs:
            p.kill()
        raise RuntimeError(f"nvcc not found: {e}") from e
    try:
        log = _run(procs)
        cmd = [_nvcc(), *flags, "-shared", "-o", f"{tmp}.tmp", *objs]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
        os.replace(f"{tmp}.tmp", so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def build(csrc, build_dir, bind) -> KernelLib:
    """Compile the *.cu of `csrc` into one library under `build_dir`
    (unless the library of these very sources is there), load it and
    give it to `bind` to declare its functions' types."""
    h = hashlib.sha256()
    for s in _sources(csrc, (".cu", ".cuh")):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(build_dir, f"libbwt_kernels_{h.hexdigest()[:16]}.so")
    log, secs = "", 0.0
    if not os.path.exists(so):
        t0 = time.time()
        log = _compile(_sources(csrc), so)
        secs = time.time() - t0
    lib = ctypes.CDLL(so)
    bind(lib)
    return KernelLib(lib, so, secs, log)


def load() -> KernelLib:
    """The loaded kernel library of the port, built on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = build(CSRC, BUILD_DIR, _bind)
        return _loaded
