#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (bwamem_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):
  1. build   the CUDA kernels from bwamem_tpu_torch/csrc with nvcc (one
             process per source, all at once) and, beside them, the
             one-thread-per-alignment kernels they replaced
             (tests/_baseline_kernels, loaded by this script only, as the
             yardstick of the timings);
  2. kernel  the fused extension kernel against its plain PyTorch version
             on the same CUDA tensors (all 32 rows, every lane) at the
             main path's shapes and on the hard-case batch of
             tests/_torch_gate.py, its L0 group against the scalar
             bwa-0.7.8 oracle on 96 lanes, and kernel, baseline kernel
             and plain version timed with CUDA events;
  3. kernel_t the per-phase kernel (extend_t) against its plain version
             (all 8 rows, every lane) at (qmax, tmax) = (160, 320) and
             (1024, 64) and on the hard-case batch in a query window for
             every group width and strip length of the launch table,
             fields 0-5 against the scalar oracle on 96 lanes, and the
             three timed at bench.py's shape;
  4. gather  the resident-reference gathers on the GPU against the same
             gathers on the CPU at their edge cases;
  5. main    `python -m bwamem_tpu_torch index|mem` (in this process) on
             a simulated 4,641,652 bp genome: 32,768 single-end reads
             and 8,192 FR pairs through `--backend cuda`; mapping
             accuracy, kernel launches == fused dispatches, and the SAM
             of a subset byte-identical to `--backend torch` on the CPU.
             The port's C++ host library builds at the first `mem`, which
             exits non-zero if it cannot;
  6. phased  the same reads through the four-pass protocol (`--phased`,
             extend_t launches == the extend_{L,R}{0,1} trace rows) and
  7. ship-ref through host-shipped windows (`--ship-ref`, extend_fused
             launches == extend_fused trace rows): SAM byte-identical to
             the resident run of phase 5 over all reads;
  8. python  the Python host (`--host python --backend cuda`) on the
             first 4,096 reads and 2,048 pairs: SAM byte-identical to
             the native resident run on the same files.
Each path's launch counts are set to 0 just before it and read just
after.  Each kernel's bound is the larger of its band cells (counted by
the plain version on this run's inputs) times INT_OPS_PER_CELL over
PEAK_INT_OPS and its bytes (inputs read once, outputs written once) over
PEAK_BYTES.  The last line of standard output is {"ok": true, "device":
{...}}.

`python3 chip_smoke.py --kernels-only` stops after phase 3.

This script and everything it loads (the port, tests/_torch_gate.py)
import neither JAX nor the JAX package; the run fails if either is among
the loaded modules at its end.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

GENOME_BP = 4_641_652      # E. coli K-12 MG1655 chromosome length
READ_LEN = 150
N_SE = 32_768
N_PE = 8_192
SUB_SE, SUB_PE = 2_048, 1_024
PY_SE, PY_PE = 4_096, 2_048        # the Python host's subset (it is slow)
GATE_B = 8192
GATE_DIMS = (160, 320, 160, 320)   # the main path's (QL, TL, QR, TR)
WIDE_DIMS = (1024, 64, 1024, 64)   # the widest query window
T_GATE_DIMS = ((160, 320), (1024, 64))   # extend_t (qmax, tmax)
T_HARD_QMAX = (24, 33, 104, 160, 180, 250, 300, 1024)  # one per launch shape
PRM = np.array([1, 4, 6, 1, 6, 1, 100, 0], np.int32)  # bwa -Ma, zdrop on
# The roofline of the pass on an H100 SXM.  A cell of the recurrence costs
# about 18 integer operations (score select 3, M 2, two maxima for H,
# the row maximum with its column 3, E 4, F 4); the card does 64 int32
# operations per SM and clock: 132 SMs x 64 x 1.98 GHz.
INT_OPS_PER_CELL = 18
PEAK_INT_OPS = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_summary(log_text):
    """`nvcc -Xptxas -v` output as one entry per kernel: its name (with
    the <group, strip> template arguments), registers, and spill bytes
    where there are any."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"^_Z\w*?\d+(extend_\w+?_kernel)(?:ILi(\d+)ELi"
                          r"(\d+)EE)?.*", r"\1<\2,\3>", m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out.append(f"{name} SPILLS {m.group(1)}+{m.group(2)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name} {m.group(1)} regs")
    return "; ".join(out)


def bind_baseline(lib):
    """Argument types of the baseline kernels' launchers: the port's,
    with the two global (qmax + 2, B) H/E scratch rows before the
    stream."""
    import ctypes

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bwt_extend_fused.restype = i32
    lib.bwt_extend_fused.argtypes = (
        [vp, i32, vp, i32, vp, i32, vp, i32, vp, i64]
        + [i32] * 7 + [vp, vp, vp, vp])
    lib.bwt_extend_t.restype = i32
    lib.bwt_extend_t.argtypes = (
        [vp, i32, vp, i32, vp, i64] + [i32] * 7 + [vp, vp, vp, vp])


def baseline_call(lib, fn, windows, scal, out_rows, prm):
    """Launch baseline kernel `fn` on the (rows, B) int8 `windows` and
    `scal`; returns its (out_rows, B) result."""
    import torch

    from bwamem_tpu_torch.ops.extend_torch import prm_ints

    B = scal.shape[1]
    qmax = max(w.shape[0] for w in windows[::2])
    out = torch.empty((out_rows, B), dtype=torch.int32, device=scal.device)
    eh_h = torch.empty((qmax + 2, B), dtype=torch.int32, device=scal.device)
    eh_e = torch.empty_like(eh_h)
    dims = [x for w in windows for x in (w.data_ptr(), w.shape[0])]
    rc = getattr(lib, fn)(*dims, scal.data_ptr(), B, *prm_ints(prm),
                          out.data_ptr(), eh_h.data_ptr(), eh_e.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"baseline {fn} launch failed: {rc}")
    return out


def time_kernel(name, kernel, baseline, plain, cells, tensors, n_out):
    """Times of `kernel`, the baseline kernel and the plain version
    (baseline, kernel, kernel, baseline in turns) and the bound of the
    work: `cells` band cells, `tensors` read once, n_out int32 written."""
    if not bool((kernel() == baseline()).all()):
        fail(f"{name}: baseline kernel != kernel on the timed batch")
    p1, k1 = cuda_ms(baseline, 10), cuda_ms(kernel, 20)
    k2, p2 = cuda_ms(kernel, 20), cuda_ms(baseline, 10)
    plain_ms = cuda_ms(plain, 2)
    ms, parent_ms = (k1 + k2) / 2, (p1 + p2) / 2
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) + 4 * n_out
    ops_ms = 1e3 * cells * INT_OPS_PER_CELL / PEAK_INT_OPS
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES
    bound_ms = max(ops_ms, bytes_ms)
    log(f"{name}: kernel {k1:.3f}, {k2:.3f} ms; baseline kernel (one "
        f"thread per alignment, global H/E scratch) {p1:.3f}, {p2:.3f} ms; "
        f"plain PyTorch {plain_ms:.3f} ms (CUDA events); {cells} band "
        f"cells -> {cells / ms / 1e6:.3f} Gcell/s; bound {bound_ms:.4f} ms "
        f"(operations {ops_ms:.4f} ms at {INT_OPS_PER_CELL} int32 a cell "
        f"over {PEAK_INT_OPS / 1e12:.2f} TOP/s, bytes {bytes_ms:.4f} ms for "
        f"{n_bytes} B) = {100 * bound_ms / ms:.1f}% of the kernel's time "
        f"(baseline {100 * bound_ms / parent_ms:.1f}%)")
    return {"max_abs_err": 0, "ms": ms, "parent_ms": parent_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "cells": cells}


def phase_kernel(dev, base):
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import extend_cuda, extend_torch

    prm = PRM
    result = {}
    for dims, seed in ((GATE_DIMS, 1), (WIDE_DIMS, 2)):
        batch = gate.random_fused_batch(seed, GATE_B, dims, n_pad=100)
        t = [torch.from_numpy(x).to(dev) for x in batch]
        got = extend_cuda.extend_batch_raw_fused(*t, prm)
        torch.cuda.synchronize()
        want = extend_torch.extend_fused(*t, prm)
        err = int((got.long() - want.long()).abs().max())
        if err:
            bad = (got != want).nonzero()[:5].tolist()
            fail(f"kernel != plain at {dims}: first (row, lane) {bad}")
        s = batch[4]
        thr = (s[9] >> 1) + (s[9] >> 2)
        out = got.cpu().numpy()
        n_retry = int(((s[0] > 0) & (out[5] >= thr)).sum()
                      + ((s[5] > 0) & (out[21] >= thr)).sum())
        lanes = gate.valid_l0_lanes(s)[:96]
        bad = gate.l0_scalar_mismatches(out, batch[0], batch[1], s, prm,
                                        lanes)
        if len(lanes) != 96 or bad:
            fail(f"L0 != ksw_extend_core at {dims}: {bad[:3]}")
        log(f"kernel == plain on all 32 rows x {GATE_B} lanes at "
            f"(QL,TL,QR,TR)={dims} (max_abs_err 0, {n_retry} retry "
            f"passes, {int((s[0] == 0).sum())} lanes without a left "
            f"task); L0 == ksw_extend_core on 96 lanes")
        if dims == GATE_DIMS:
            cells = [0]
            extend_torch.extend_fused(*t, prm, cells=cells)
            result = time_kernel(
                f"extend_fused at B={GATE_B} {dims}",
                lambda: extend_cuda.extend_batch_raw_fused(*t, prm),
                lambda: baseline_call(base, "bwt_extend_fused", t[:4], t[4],
                                      32, prm),
                lambda: extend_torch.extend_fused(*t, prm), cells[0], t[:5],
                32 * GATE_B)
    for qmax in GATE_DIMS[0], WIDE_DIMS[0]:
        batch = gate.hard_fused_batch(11, qmax)
        t = [torch.from_numpy(x).to(dev) for x in batch]
        for zdrop in (100, 0):
            prm = PRM.copy()
            prm[6] = zdrop
            got = extend_cuda.extend_batch_raw_fused(*t, prm)
            torch.cuda.synchronize()
            want = extend_torch.extend_fused(*t, prm)
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                fail(f"kernel != plain on the hard cases at qmax {qmax}, "
                     f"zdrop {zdrop}: first (row, lane) {bad}")
        log(f"kernel == plain on all 32 rows x {batch[4].shape[1]} lanes of "
            f"the hard-case batch at qmax {qmax} (zdrop 100 and 0)")
    return result


def bench_t_batch():
    """bench.py's timed per-phase batch (bench.py:55-67): B = 16384
    lanes, qlen 100 in a 104 window, tlen 200 in a 256 window (the
    target is the query with 6 substitutions and a random tail), w 100,
    h0 19.  Returns the (qmax, B) / (tmax, B) int8 windows, the (8, B)
    scalars and the row bounds."""
    from bwamem_tpu_torch.ops.extend import pack_scal

    B, QMAX, TMAX, QLEN, TLEN, W = 16384, 104, 256, 100, 200, 100
    rng = np.random.default_rng(0)
    query = rng.integers(0, 4, (B, QMAX)).astype(np.int32)
    target = rng.integers(0, 4, (B, TMAX)).astype(np.int32)
    target[:, :QLEN] = query[:, :QLEN]
    muts = rng.integers(0, QLEN, (B, 6))
    target[np.arange(B)[:, None], muts] = rng.integers(0, 4, (B, 6))
    scal, tmax = pack_scal(np.full(B, QLEN), np.full(B, TLEN),
                           np.full(B, W), np.full(B, 19), blk_b=128)
    return (np.ascontiguousarray(query.T, np.int8),
            np.ascontiguousarray(target.T, np.int8),
            np.ascontiguousarray(scal.T), tmax)


def phase_kernel_t(dev, base):
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import extend_cuda, extend_torch

    for (qmax, tmax), seed in zip(T_GATE_DIMS, (3, 4)):
        q, t, scal, bounds = gate.random_t_batch(seed, GATE_B, qmax, tmax,
                                                 n_pad=100)
        args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
        got = extend_cuda.extend_batch_raw_t(*args, bounds, PRM)
        torch.cuda.synchronize()
        want = extend_torch.extend_t(*args, bounds, PRM)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            fail(f"extend_t kernel != plain at ({qmax}, {tmax}): first "
                 f"(row, lane) {bad}")
        lanes = gate.valid_l0_lanes(scal)[:96]
        bad = gate.l0_scalar_mismatches(got.cpu().numpy(), q, t, scal, PRM,
                                        lanes)
        if len(lanes) != 96 or bad:
            fail(f"extend_t != ksw_extend_core at ({qmax}, {tmax}): "
                 f"{bad[:3]}")
        log(f"extend_t kernel == plain on all 8 rows x {GATE_B} lanes at "
            f"(qmax, tmax)=({qmax}, {tmax}) (max_abs_err 0, "
            f"{int((scal[0] == 0).sum())} lanes without a task); fields "
            f"0-5 == ksw_extend_core on 96 lanes")

    for qmax in T_HARD_QMAX:
        q, t, scal, bounds = gate.hard_t_batch(5, qmax)
        args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
        for zdrop in (100, 0):
            prm = PRM.copy()
            prm[6] = zdrop
            got = extend_cuda.extend_batch_raw_t(*args, bounds, prm)
            torch.cuda.synchronize()
            want = extend_torch.extend_t(*args, bounds, prm)
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                fail(f"extend_t kernel != plain on the hard cases at qmax "
                     f"{qmax}, zdrop {zdrop}: first (row, lane) {bad}")
        lanes = gate.valid_l0_lanes(scal)[:96]
        bad = gate.l0_scalar_mismatches(got.cpu().numpy(), q, t, scal, prm,
                                        lanes)
        if bad:
            fail(f"extend_t != ksw_extend_core on the hard cases at qmax "
                 f"{qmax}: {bad[:3]}")
        log(f"extend_t kernel == plain on all 8 rows x {scal.shape[1]} lanes "
            f"of the hard-case batch at qmax {qmax} (zdrop 100 and 0); "
            f"fields 0-5 == ksw_extend_core on {len(lanes)} lanes")

    q, t, scal, bounds = bench_t_batch()
    prm = PRM.copy()
    prm[6] = 0  # bench.py's zdrop
    args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
    got = extend_cuda.extend_batch_raw_t(*args, bounds, prm)
    torch.cuda.synchronize()
    cells = [0]
    if not torch.equal(got, extend_torch.extend_t(*args, bounds, prm,
                                                  cells=cells)):
        fail("extend_t kernel != plain at bench.py's shape")
    return time_kernel(
        "extend_t at bench.py's shape (B=16384, qmax 104, tmax 256, qlen "
        "100, tlen 200, w 100, zdrop 0; lanes stop at row_max == 0, unlike "
        "bench.py's early_exit=False: not comparable with any bench.py "
        "figure)",
        lambda: extend_cuda.extend_batch_raw_t(*args, bounds, prm),
        lambda: baseline_call(base, "bwt_extend_t", args[:2], args[2], 8,
                              prm),
        lambda: extend_torch.extend_t(*args, bounds, prm), cells[0], args,
        8 * scal.shape[1])


def phase_gather(dev):
    import torch

    from bwamem_tpu_torch.pipeline import resident

    rng = np.random.default_rng(11)
    pac = rng.integers(0, 5, (1 << 20) + 1237).astype(np.uint8)
    n = 2 * len(pac)
    text_c = resident.make_resident_text(pac, "cpu")
    text_g = text_c.to(dev)
    for length in (17, 64, 129, 320):
        pos = rng.integers(0, n - length, 128).astype(np.int64)
        pos[:6] = [0, 8, n - length, 7, (1 << 20) - 3,
                   (1 << 21) - length // 2]
        hi = (pos >> 20).astype(np.int32)
        lo = (pos & 0xFFFFF).astype(np.int32)
        lo[6] -= 1 << 20     # borrow absorbed into lo
        hi[6] += 1
        lo[7], hi[7] = -5, 0  # negative start (padded lane)
        for sign in (1, -1):
            los = lo if sign > 0 else lo + length - 1
            a = resident.text_gather_window(
                text_c, torch.from_numpy(los), torch.from_numpy(hi),
                length, sign)
            b = resident.text_gather_window(
                text_g, torch.from_numpy(los).to(dev),
                torch.from_numpy(hi).to(dev), length, sign)
            if not torch.equal(a, b.cpu()):
                fail(f"text_gather_window GPU != CPU ({length}, {sign})")
    nib = rng.integers(-128, 128, (300, 80)).astype(np.int8)
    rows = rng.integers(0, 300, (1, 4096)).astype(np.int32)
    cols = rng.integers(-20, 180, (160, 4096)).astype(np.int32)
    a = resident.nib_gather(*(torch.from_numpy(x) for x in (nib, rows, cols)))
    b = resident.nib_gather(*(torch.from_numpy(x).to(dev)
                              for x in (nib, rows, cols)))
    if not torch.equal(a, b.cpu()):
        fail("nib_gather GPU != CPU")
    log("gathers GPU == CPU (window lengths 17/64/129/320, both signs, "
        "off==0, hi/lo split, negative starts, tail pad; nibble reads)")


def simulate(tmp, n_se=N_SE, n_pe=N_PE):
    """Genome FASTA, SE FASTQ of n_se reads and PE FASTQ pair of n_pe
    pairs, read names carrying the true leftmost position(s)."""
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, GENOME_BP).astype(np.uint8)
    fa = os.path.join(tmp, "ecoli_sim.fa")
    seq = acgt[genome].tobytes()
    with open(fa, "wb") as f:
        f.write(b">ecoli_sim\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + b"\n")
    span = np.arange(READ_LEN)

    def mutate(R):
        mut = rng.random(R.shape) < 0.01
        R[mut] = rng.integers(0, 4, int(mut.sum()))
        return R

    def fastq(path, names, R):
        qual = "I" * READ_LEN
        with open(path, "w") as f:
            for nm, r in zip(names, acgt[R]):
                f.write(f"@{nm}\n{r.tobytes().decode()}\n+\n{qual}\n")

    pos = rng.integers(0, GENOME_BP - 600, n_se)
    R = mutate(genome[pos[:, None] + span].astype(np.int64))
    R[1::2] = 3 - R[1::2, ::-1]               # half on the reverse strand
    se = os.path.join(tmp, "se.fq")
    fastq(se, [f"se{i}_{p}" for i, p in enumerate(pos)], R)

    # FR library: left end forward, right end reverse-complemented;
    # alternate which end is read 1
    pos = rng.integers(0, GENOME_BP - 600, n_pe)
    isize = rng.normal(350, 30, n_pe).astype(np.int64)
    L = mutate(genome[pos[:, None] + span].astype(np.int64))
    M = mutate(genome[(pos + isize - READ_LEN)[:, None] + span]
               .astype(np.int64))
    M = 3 - M[:, ::-1]
    p1, p2 = pos.copy(), pos + isize - READ_LEN
    L[1::2], M[1::2] = M[1::2].copy(), L[1::2].copy()
    p1[1::2], p2[1::2] = p2[1::2].copy(), p1[1::2].copy()
    names = [f"pe{i}_{a}_{b}" for i, (a, b) in enumerate(zip(p1, p2))]
    pe1, pe2 = os.path.join(tmp, "pe1.fq"), os.path.join(tmp, "pe2.fq")
    fastq(pe1, names, L)
    fastq(pe2, names, M)
    return fa, se, pe1, pe2


def head_fastq(src, dst, n):
    with open(src) as f, open(dst, "w") as g:
        for _ in range(4 * n):
            g.write(f.readline())
    return dst


def run_cli(argv, sam_path):
    """`python -m bwamem_tpu_torch <argv>` in this process, standard
    output to `sam_path`; returns the captured standard error."""
    from bwamem_tpu_torch.__main__ import main

    err = io.StringIO()
    with open(sam_path, "w") as out, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    text = err.getvalue()
    if rc != 0:
        fail(f"{' '.join(argv)} exited {rc}:\n{text[-3000:]}")
    return text


def mapping_accuracy(sam_path):
    """(ends within 10 bp of their simulated position, ends seen)."""
    good = seen = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.split("\t", 4)
            flag = int(fld[1])
            if flag & 0x900:
                continue
            seen += 1
            parts = fld[0].split("_")
            true = int(parts[2] if flag & 0x80 else parts[1])
            if not flag & 4 and abs(int(fld[3]) - 1 - true) <= 10:
                good += 1
    return good, seen


def sam_body(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("@PG")]


def same_sam(path_a, path_b, what):
    """Fail unless the two SAM files are byte-identical apart from @PG."""
    a, b = sam_body(path_a), sam_body(path_b)
    if a != b:
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        fail(f"{what}: SAM differs at line {diff} ({len(a)} vs {len(b)} "
             f"lines):\n{a[diff:diff + 1]}\n{b[diff:diff + 1]}")
    return len(a)


def run_mem(tmp, tag, fa, reads, flags):
    """`mem` with `flags` on `reads` and its per-batch trace; returns the
    SAM path, the trace rows counted by kind, the align rate and the
    captured standard error."""
    trace = os.path.join(tmp, f"{tag}.trace.jsonl")
    sam = os.path.join(tmp, f"{tag}.sam")
    text = run_cli(["mem", *flags, "--trace", trace, fa, *reads], sam)
    with open(trace) as f:
        kinds = collections.Counter(json.loads(l)["kind"] for l in f)
    m = re.search(r"\[mem\] align: .*", text)
    if not m:
        fail(f"{tag}: no [mem] align: line")
    rate = float(re.search(r"= ([0-9.]+) reads/s", m.group(0)).group(1))
    log(f"{tag}: {m.group(0)}")
    return sam, kinds, rate, text


def phase_main(tmp, threads):
    from bwamem_tpu_torch.__main__ import main
    from bwamem_tpu_torch.ops import extend_cuda

    t0 = time.time()
    fa, se, pe1, pe2 = simulate(tmp)
    log(f"simulated {GENOME_BP} bp genome, {N_SE} SE reads, {N_PE} pairs "
        f"({time.time() - t0:.1f}s)")
    t0 = time.time()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["index", fa])
    if rc != 0:
        fail(f"index exited {rc}: {err.getvalue()}")
    log(f"index built ({time.time() - t0:.1f}s)")

    common = ["-b", "2048", "--inflight", "3", "-t", str(threads)]
    inputs = {"SE": [se], "PE": [pe1, pe2]}
    rates, sams = {}, {}
    dispatches = 0
    extend_cuda.reset_launches()
    for label, reads in inputs.items():
        sam, kinds, rates[label], text = run_mem(
            tmp, label, fa, reads, ["--backend", "cuda", *common])
        sams[label] = sam
        dispatches += kinds["extend_fused"]
        for line in text.splitlines():
            if line.startswith("[mem] counters:"):
                log(f"{label} {line}")
        good, seen = mapping_accuracy(sam)
        want = N_SE if label == "SE" else 2 * N_PE
        if seen != want or good < 0.95 * want:
            fail(f"{label}: {good}/{seen} ends within 10 bp of their "
                 f"simulated position (need >= 95% of {want})")
        log(f"{label}: {good}/{seen} = {100.0 * good / seen:.2f}% of ends "
            f"map within 10 bp of their simulated position")
    counts = dict(extend_cuda.launches)
    launches = counts["extend_fused"]
    if launches != dispatches or launches == 0 or counts["extend_t"]:
        fail(f"kernel launches {counts} != fused dispatches {dispatches}")
    log(f"main path: extend_fused kernel launches {launches} == fused "
        f"dispatches {dispatches}")

    # the subset through the kernel and through the plain CPU version
    sub = [("SE", [head_fastq(se, os.path.join(tmp, "se_sub.fq"), SUB_SE)]),
           ("PE", [head_fastq(pe1, os.path.join(tmp, "pe1_sub.fq"), SUB_PE),
                   head_fastq(pe2, os.path.join(tmp, "pe2_sub.fq"),
                              SUB_PE)])]
    for label, reads in sub:
        paths = []
        for backend in ("cuda", "torch"):
            paths.append(os.path.join(tmp, f"{label}_sub_{backend}.sam"))
            t0 = time.time()
            run_cli(["mem", "--backend", backend, *common, fa, *reads],
                    paths[-1])
            log(f"{label} subset --backend {backend}: "
                f"{len(sam_body(paths[-1]))} lines ({time.time() - t0:.1f}s)")
        same_sam(*paths, f"{label} subset cuda vs torch")
        log(f"{label} subset SAM byte-identical (apart from @PG): cuda == "
            f"torch on the CPU")
    return launches, rates, dict(fa=fa, inputs=inputs, sams=sams,
                                 common=common)


def phase_native_path(tmp, run, name, flag, kernel, row_kinds):
    """`mem --backend cuda <flag>` over all SE reads and pairs: SAM
    byte-identical to the resident run, and `kernel`'s launches (the
    only kernel launched) == the trace rows of `row_kinds`."""
    from bwamem_tpu_torch.ops import extend_cuda

    rates = {}
    dispatches = 0
    extend_cuda.reset_launches()
    for label, reads in run["inputs"].items():
        sam, kinds, rates[label], _ = run_mem(
            tmp, f"{label}_{name}", run["fa"], reads,
            ["--backend", "cuda", flag, *run["common"]])
        dispatches += sum(kinds[k] for k in row_kinds)
        n = same_sam(run["sams"][label], sam, f"{label} {flag} vs resident")
        log(f"{label} {flag} SAM byte-identical to the resident run "
            f"(apart from @PG; {n} lines)")
    counts = dict(extend_cuda.launches)
    launches = counts[kernel]
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if launches != dispatches or launches == 0 or others:
        fail(f"{flag}: kernel launches {counts} != {kernel} dispatches "
             f"{dispatches} (trace rows {row_kinds})")
    log(f"{flag}: {kernel} kernel launches {launches} == trace rows "
        f"{'+'.join(row_kinds)} {dispatches}")
    return launches, rates


def phase_python_host(tmp, run):
    """`mem --host python --backend cuda` on the first PY_SE reads and
    PY_PE pairs (whole -b 2048 chunks, so PE insert-size inference sees
    the same pairs) against the native resident run on the same files."""
    from bwamem_tpu_torch.ops import extend_cuda

    se, (pe1, pe2) = run["inputs"]["SE"], run["inputs"]["PE"]
    sub = {"SE": [head_fastq(se[0], os.path.join(tmp, "se_py.fq"), PY_SE)],
           "PE": [head_fastq(pe1, os.path.join(tmp, "pe1_py.fq"), PY_PE),
                  head_fastq(pe2, os.path.join(tmp, "pe2_py.fq"), PY_PE)]}
    native = {}
    for label, reads in sub.items():
        native[label], _, _, _ = run_mem(
            tmp, f"{label}_py_native", run["fa"], reads,
            ["--backend", "cuda", *run["common"]])
    rates = {}
    extend_cuda.reset_launches()
    for label, reads in sub.items():
        sam, _, rates[label], _ = run_mem(
            tmp, f"{label}_py", run["fa"], reads,
            ["--host", "python", "--backend", "cuda", *run["common"]])
        n = same_sam(native[label], sam, f"{label} --host python vs native")
        log(f"{label} --host python SAM byte-identical to the native "
            f"resident run (apart from @PG; {n} lines)")
    counts = dict(extend_cuda.launches)
    if counts["extend_t"] == 0 or counts["extend_fused"]:
        fail(f"--host python: kernel launches {counts}")
    log(f"--host python: extend_t kernel launches {counts['extend_t']}")
    return counts["extend_t"], rates


def main() -> int:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    for need in ("bwamem_tpu_torch", os.path.join("tests", "_torch_gate.py")):
        if not os.path.exists(os.path.join(root, need)):
            fail(f"no {need} beside {__file__}")
    # the port, and the kernel gate's inputs and scalar-oracle check
    sys.path[:0] = [root, os.path.join(root, "tests")]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")

    from bwamem_tpu_torch.ops import _build

    # both builds at once: every nvcc process starts together
    built = {}
    side = threading.Thread(target=lambda: built.update(base=_build.build(
        os.path.join(root, "tests", "_baseline_kernels"),
        os.path.join(_build.BUILD_DIR, "baseline"), bind_baseline)))
    side.start()
    kl = _build.load()
    side.join()
    if "base" not in built:
        fail("the baseline kernels did not build")
    for what, lib in (("CUDA kernels", kl), ("baseline kernels",
                                             built["base"])):
        log(f"{what} built in {lib.build_seconds:.1f}s -> "
            f"{os.path.relpath(lib.path, root)}; ptxas: "
            f"{ptxas_summary(lib.log)}")

    timing = phase_kernel(dev, built["base"].lib)
    timing_t = phase_kernel_t(dev, built["base"].lib)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": [timing, timing_t]}), flush=True)
        return 0
    phase_gather(dev)
    tmp = tempfile.mkdtemp(prefix="bwamem_smoke_")
    try:
        launches, rates, run = phase_main(tmp, min(os.cpu_count() or 1, 8))
        launches_t, rates_phased = phase_native_path(
            tmp, run, "phased", "--phased", "extend_t",
            ("extend_L0", "extend_L1", "extend_R0", "extend_R1"))
        _, rates_ship = phase_native_path(
            tmp, run, "ship_ref", "--ship-ref", "extend_fused",
            ("extend_fused",))
        _, rates_py = phase_python_host(tmp, run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, r in (("resident (default)", rates), ("--phased", rates_phased),
                    ("--ship-ref", rates_ship),
                    (f"--host python ({PY_SE} reads, {PY_PE} pairs)",
                     rates_py)):
        log(f"{name}: SE {r['SE']:.1f} reads/s, PE {r['PE']:.1f} reads/s "
            f"(--backend cuda, -b 2048 --inflight 3) on {smi}")
    log(f"total wall {time.time() - t_start:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "extend_fused", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/extend_fused.cu",
         "replaces": "bwamem_tpu/ops/extend_pallas.py:292",
         "launches": launches, **timing},
        {"name": "extend_t", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/extend_t.cu",
         "replaces": "bwamem_tpu/ops/extend_pallas.py:255",
         "launches": launches_t, **timing_t}]}), flush=True)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was loaded: {loaded[:5]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
