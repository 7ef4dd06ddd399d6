"""Native (C++) host components of the port, loaded via ctypes.

The host sources are csrc/*.cpp at the repository's root (they belong to
neither Python package: they are read and compiled, not imported), each
replaced by the port's own copy where this directory holds a .cpp of the
same name: mempipe.cpp, which adds the phase stamps of `mem --trace`
(mp_phase_stamps), and fastq.cpp, which adds the packed parse of the
port's chunk loop (bwamem_fastq_pack, bwamem_fastq_cut).  The library
builds lazily with g++ on first use into the port's own gitignored
build directory, bwamem_tpu_torch/build/libbwamem_host.so,
and rebuilds when a source is newer.  The build writes a temporary file
and renames it, so processes that start together never load a half
written library.  A process that also loads the JAX package's copy of
the same sources gets two independent libraries (two files, each opened
with RTLD_LOCAL): no state is shared between them.

Every native path has a pure-numpy fallback so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, os.pardir, os.pardir, "csrc")
_BUILD = os.path.join(_HERE, os.pardir, "build")
_SO = os.path.join(_BUILD, "libbwamem_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _sources() -> list[str]:
    """csrc/*.cpp, each from this directory where the port has a copy."""
    own = set(os.listdir(_HERE))
    return [os.path.join(_HERE if f in own else _CSRC, f)
            for f in sorted(os.listdir(_CSRC)) if f.endswith(".cpp")]


def _build() -> bool:
    srcs = _sources()
    if not srcs:
        return False
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp] + srcs
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, _SO)
        return True
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        # the failure names itself: g++'s own words, else the exception
        why = getattr(e, "stderr", None) or repr(e)
        sys.stderr.write(f"[native] g++ build of {_SO} failed:\n"
                         f"{str(why)[-2000:]}\n")
        return False


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or _newer_sources():
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.bwamem_sais_u8.restype = ctypes.c_int
            lib.bwamem_sais_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64]
            lib.bwamem_sais_bwt_u8.restype = ctypes.c_int
            lib.bwamem_sais_bwt_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwamem_fastq_scan.restype = ctypes.c_int64
            lib.bwamem_fastq_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            _bind_fastq(lib)
            _bind_smem(lib)
            _bind_ksw(lib)
            _bind_mempipe(lib)
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def _newer_sources() -> bool:
    try:
        so_mtime = os.path.getmtime(_SO)
        return any(os.path.getmtime(f) > so_mtime for f in _sources())
    except OSError:
        return True


def sais_u8(s: np.ndarray) -> np.ndarray | None:
    """Linear-time suffix array of uint8 codes via the C++ SA-IS, or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, np.uint8)
    n = len(s)
    sa = np.empty(n, np.int64)
    rc = lib.bwamem_sais_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, int(s.max(initial=0)) + 1)
    return sa if rc == 0 else None


def sais_bwt_u8(s: np.ndarray, sa_intv: int):
    """Memory-bounded BWT construction: packed 40-bit SA-IS emitting
    (bwt, ssa, primary) directly — ~8.3 bytes/symbol peak vs ~17 for
    the int64 SA path, which is what makes a GRCh38-scale two-strand
    build (6.2 Gsym) fit this host.  Returns None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, np.uint8)
    n = len(s)
    bwt = np.empty(n + 1, np.uint8)
    ssa = np.empty(n // sa_intv + 1, np.int64)
    primary = ctypes.c_int64(-1)
    rc = lib.bwamem_sais_bwt_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ssa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sa_intv, ctypes.byref(primary))
    if rc != 0:
        return None
    return bwt, ssa, int(primary.value)


def fastq_scan(buf: bytes, max_rec: int = 1 << 22):
    """Native record scan: returns (n, offsets (n,5) int64) or None."""
    lib = get_lib()
    if lib is None:
        return None
    off = np.empty((max_rec, 5), np.int64)
    n = lib.bwamem_fastq_scan(
        buf, len(buf), max_rec,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        return None
    return int(n), off[:n]


def _bind_fastq(lib):
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p64 = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.bwamem_fastq_cut.restype = i64
    lib.bwamem_fastq_cut.argtypes = [ctypes.c_char_p, i64, p64]
    lib.bwamem_fastq_pack.restype = i64
    lib.bwamem_fastq_pack.argtypes = [ctypes.c_char_p, i64, i64] + \
        [p8, p64] * 4 + [p8]


def fastq_cut(buf: bytes):
    """(cut, lines): the byte just past the last newline that closes a
    whole 4-line FASTQ record (0 if none), and the newlines before it;
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lines = ctypes.c_int64()
    cut = lib.bwamem_fastq_cut(buf, len(buf), ctypes.byref(lines))
    return int(cut), int(lines.value)


def fastq_pack(buf: bytes, n: int, max_rec: int):
    """The records of buf[:n] as columns in one native pass: (codes,
    seq_off, names, name_off, quals, qual_off, comments, comment_off,
    has_qual), uint8 blobs with int64 offsets from 0 (see
    native/fastq.cpp); None when the library is unavailable, the buffer
    is malformed or holds more than max_rec records."""
    lib = get_lib()
    if lib is None:
        return None
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p64 = ctypes.POINTER(ctypes.c_int64)
    cols = []
    for _ in range(4):
        cols += [np.empty(n, np.uint8), np.empty(max_rec + 1, np.int64)]
    has_qual = np.empty(max_rec, np.uint8)
    got = lib.bwamem_fastq_pack(
        buf, n, max_rec,
        *(c.ctypes.data_as(p8 if c.dtype == np.uint8 else p64)
          for c in cols), has_qual.ctypes.data_as(p8))
    if got < 0:
        return None
    out = []
    for blob, off in zip(cols[0::2], cols[1::2]):
        off = off[:got + 1]
        out += [blob[:off[-1]], off]
    return (*out, has_qual[:got].view(np.bool_))


def _bind_ksw(lib):
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.bwamem_ksw_global.restype = ctypes.c_int64
    lib.bwamem_ksw_global.argtypes = [
        p8, ctypes.c_int64, p8, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, p32, ctypes.c_int64, p64]
    lib.bwamem_cigar_nm_md.restype = ctypes.c_int64
    lib.bwamem_cigar_nm_md.argtypes = [
        p8, p8, p32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, p64]
    lib.bwamem_ksw_align.restype = None
    lib.bwamem_ksw_align.argtypes = [
        p8, ctypes.c_int64, p8, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        p64]


def ksw_global_native(query: np.ndarray, target: np.ndarray,
                      mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                      e_ins: int, w: int):
    """Native banded global alignment; returns (score, cigar) with the
    exact cigar.py ksw_global semantics, or None if unavailable.
    Caller guarantees len(query) > 0 and len(target) > 0."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    t = np.ascontiguousarray(target, np.uint8)
    m8 = np.ascontiguousarray(mat, np.int8)
    cap = len(q) + len(t) + 2
    cig = np.empty(2 * cap, np.int32)
    score = ctypes.c_int64()
    n = lib.bwamem_ksw_global(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), m8.shape[0],
        o_del, e_del, o_ins, e_ins, int(w),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        ctypes.byref(score))
    if n < 0:
        return None
    pairs = cig[:2 * n].reshape(n, 2)
    return int(score.value), [(int(op), int(ln)) for op, ln in pairs]


def ksw_align_native(query: np.ndarray, target: np.ndarray,
                     mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                     e_ins: int):
    """Native local SW (bwa ksw_align twin); returns the 6-tuple
    (score, qb, qe, tb, te, score2) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    t = np.ascontiguousarray(target, np.uint8)
    m8 = np.ascontiguousarray(mat, np.int8)
    out = np.empty(6, np.int64)
    lib.bwamem_ksw_align(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), m8.shape[0],
        o_del, e_del, o_ins, e_ins,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return tuple(int(x) for x in out)


def cigar_nm_md_native(query: np.ndarray, rseq: np.ndarray, cigar):
    """Native NM/MD computation; returns (nm, md) or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    r = np.ascontiguousarray(rseq, np.uint8)
    flat = np.asarray([x for p in cigar for x in p], np.int32)
    cap = 16 + 5 * (len(q) + len(r))
    buf = ctypes.create_string_buffer(cap)
    nm = ctypes.c_int64()
    ln = lib.bwamem_cigar_nm_md(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(cigar),
        buf, cap, ctypes.byref(nm))
    if ln < 0:
        return None
    return int(nm.value), buf.raw[:ln].decode("ascii")


def _bind_mempipe(lib):
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.mp_new.restype = ctypes.c_void_p
    lib.mp_new.argtypes = [
        p64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int8), p8, i64, p64, p64, i64,
        ctypes.c_char_p, p64, i64, i64, p32, pu32, pu32, p64, i64, i64]
    lib.mp_free.restype = None
    lib.mp_free.argtypes = [ctypes.c_void_p]
    lib.mp_chunk_start.restype = i64
    lib.mp_chunk_start.argtypes = [ctypes.c_void_p, p8, p64, i64, i64, i64]
    lib.mp_chunk_start_seeded.restype = i64
    lib.mp_chunk_start_seeded.argtypes = [ctypes.c_void_p, p8, p64, i64,
                                          i64, p64, i64, i64]
    lib.mp_task_count.restype = i64
    lib.mp_task_count.argtypes = [ctypes.c_void_p]
    lib.mp_task_dims.restype = None
    lib.mp_task_dims.argtypes = [ctypes.c_void_p, p64, p64]
    pi8 = ctypes.POINTER(ctypes.c_int8)
    lib.mp_fill_tasks.restype = None
    lib.mp_fill_tasks.argtypes = [ctypes.c_void_p, i64, pi8, i64, pi8,
                                  i64, p32, i64]
    lib.mp_pass_done.restype = i64
    lib.mp_pass_done.argtypes = [ctypes.c_void_p, i64, p32, i64]
    lib.mp_prepare_right.restype = i64
    lib.mp_prepare_right.argtypes = [ctypes.c_void_p]
    lib.mp_prepare_fused.restype = i64
    lib.mp_prepare_fused.argtypes = [ctypes.c_void_p]
    lib.mp_fused_dims.restype = None
    lib.mp_fused_dims.argtypes = [ctypes.c_void_p, p64, p64, p64, p64]
    lib.mp_fill_fused.restype = None
    lib.mp_fill_fused.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                  pi8, i64, pi8, i64, p32, i64]
    lib.mp_fill_fused_idx.restype = None
    lib.mp_fill_fused_idx.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_fused_done.restype = None
    lib.mp_fused_done.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_finalize.restype = i64
    lib.mp_finalize.argtypes = [ctypes.c_void_p, i64]
    lib.mp_finalize_pe.restype = i64
    lib.mp_finalize_pe.argtypes = [ctypes.c_void_p, i64, i64]
    # device-rescue protocol (mem_matesw's tasks batched on-device)
    lib.mp_pe_prepare.restype = None
    lib.mp_pe_prepare.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mp_rescue_begin.restype = i64
    lib.mp_rescue_begin.argtypes = [ctypes.c_void_p, p64, p64]
    lib.mp_rescue_fill.restype = None
    lib.mp_rescue_fill.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                   p32, i64, i64]
    lib.mp_rescue_fill_idx.restype = None
    lib.mp_rescue_fill_idx.argtypes = [ctypes.c_void_p, p32, i64, i64]
    lib.mp_rescue_apply.restype = None
    lib.mp_rescue_apply.argtypes = [ctypes.c_void_p, p32, i64, i64]
    lib.mp_rescue_replay.restype = None
    lib.mp_rescue_replay.argtypes = [ctypes.c_void_p, i64]
    lib.mp_rescue_used.restype = i64
    lib.mp_rescue_used.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mp_finalize_pe_tail.restype = i64
    lib.mp_finalize_pe_tail.argtypes = [ctypes.c_void_p, i64, i64]
    # device-CIGAR round protocol (reg2aln globals batched on-device)
    lib.mp_cigar_begin.restype = i64
    lib.mp_cigar_begin.argtypes = [ctypes.c_void_p, i64]
    lib.mp_cigar_dims.restype = None
    lib.mp_cigar_dims.argtypes = [ctypes.c_void_p, p64, p64]
    lib.mp_cigar_fill.restype = None
    lib.mp_cigar_fill.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                  p32, i64]
    lib.mp_cigar_fill_idx.restype = None
    lib.mp_cigar_fill_idx.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_cigar_apply.restype = i64
    lib.mp_cigar_apply.argtypes = [ctypes.c_void_p, p32, p32, p32, i64]
    lib.mp_finalize_records.restype = i64
    lib.mp_finalize_records.argtypes = [ctypes.c_void_p, i64]
    lib.mp_cigar_collect_pe.restype = i64
    lib.mp_cigar_collect_pe.argtypes = [ctypes.c_void_p]
    lib.mp_rescue_host.restype = None
    lib.mp_rescue_host.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mp_blob_size.restype = i64
    lib.mp_blob_size.argtypes = [ctypes.c_void_p]
    lib.mp_get_records.restype = None
    lib.mp_get_records.argtypes = [ctypes.c_void_p, p64, ctypes.c_char_p]
    lib.mp_sam_size.restype = i64
    lib.mp_sam_size.argtypes = [ctypes.c_void_p, p64]
    lib.mp_emit_sam.restype = None
    lib.mp_emit_sam.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p64,
                                ctypes.c_char_p, p64, ctypes.c_char_p,
                                p64, p64, i64, i64]
    lib.mp_region_count.restype = i64
    lib.mp_region_count.argtypes = [ctypes.c_void_p, i64]
    lib.mp_export_regions.restype = None
    lib.mp_export_regions.argtypes = [ctypes.c_void_p, p64]
    lib.mp_set_rg.restype = None
    lib.mp_set_rg.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mp_chunk_end.restype = None
    lib.mp_chunk_end.argtypes = [ctypes.c_void_p]
    lib.mp_phase_stamps.restype = i64
    lib.mp_phase_stamps.argtypes = [ctypes.c_void_p, p64, i64]


def _bind_smem(lib):
    lib.bwamem_collect_seeds.restype = ctypes.c_int64
    lib.bwamem_collect_seeds.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]


def collect_seeds_native(po, ssa, sa_intv, reads_mat, qlen,
                         min_seed_len, split_len, split_width, max_occ):
    """Native seeding over a (n_reads, L) u8 read matrix.
    Returns (n, seeds (n,4) int64 rows {read_idx, rbeg, qbeg, len}) or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    C = np.ascontiguousarray(po.C, np.int64)
    occ = np.ascontiguousarray(po.occ_rows, np.int32)
    pk = np.ascontiguousarray(po.pk_rows, np.uint32)
    va = np.ascontiguousarray(po.va_rows, np.uint32)
    ssa = np.ascontiguousarray(ssa, np.int64)
    reads_mat = np.ascontiguousarray(reads_mat, np.uint8)
    qlen = np.ascontiguousarray(qlen, np.int64)
    cap = max(1 << 16, int(qlen.sum()) * 4)
    out = np.empty((cap, 4), np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.bwamem_collect_seeds(
        C.ctypes.data_as(p64), int(po.primary), int(po.n_rows),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        va.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ssa.ctypes.data_as(p64), len(ssa), int(sa_intv),
        reads_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qlen.ctypes.data_as(p64), reads_mat.shape[0], reads_mat.shape[1],
        int(min_seed_len), int(split_len), int(split_width), int(max_occ),
        out.ctypes.data_as(p64), cap)
    if n < 0:
        return None
    return int(n), out[:n]
