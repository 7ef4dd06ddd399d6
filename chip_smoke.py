#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (bwamem_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):
  1. build   the seven CUDA kernels from bwamem_tpu_torch/csrc with nvcc
             (one process per source, all at once);
  2. kernel  the fused extension kernel, with 32-bit cells (extend_fused)
             and with packed 16-bit cells (extend_fused_i16), each against
             its plain PyTorch version on the same CUDA tensors (all 32
             rows, every lane) at the main path's shapes and on the
             hard-case batch of tests/_torch_gate.py, the 16-bit kernel
             against the 32-bit kernel, the L0 group against the scalar
             bwa-0.7.8 oracle on 96 lanes, and both kernels (in turns) and
             both plain versions timed with CUDA events;
  3. kernel_t the per-phase kernels (extend_t, extend_t_i16) the same way
             (all 8 rows, every lane) at (qmax, tmax) = (160, 320) and
             (1024, 64) and on the hard-case batch in a query window for
             every group width and strip length of the launch table,
             fields 0-5 against the scalar oracle on 96 lanes, and timed
             at bench.py's shape;
  4. seed    the seeding kernels (bwt_smem_all, bwt_smem1, bwt_sa) against
             their plain PyTorch versions on the card, exactly, on 2,048
             reads over the smoke genome plus a contig made to overflow the
             slots (homopolymer runs of every length 1..40, a repeated
             segment; all-N reads, N runs, reads shorter than -k); at least
             one read must overflow; the kernel seeder's rows against the
             C++ engine's (collect_seeds_native), values and order; each
             kernel timed with its bytes bound;
  5. gather  the resident-reference gathers on the GPU against the same
             gathers on the CPU at their edge cases;
  6. main    `python -m bwamem_tpu_torch index|mem` (in this process) on
             a simulated 4,641,652 bp genome: 32,768 single-end reads
             and 8,192 FR pairs through `--backend cuda`; mapping
             accuracy, kernel launches == fused dispatches, and the SAM
             of a subset byte-identical to `--backend torch` on the CPU.
             The port's C++ host library builds at the first `mem`, which
             exits non-zero if it cannot;
  7. phased  the same reads through the four-pass protocol (`--phased`,
             extend_t launches == the extend_{L,R}{0,1} trace rows) and
  8. ship-ref through host-shipped windows (`--ship-ref`, extend_fused
             launches == extend_fused trace rows): SAM byte-identical to
             the resident run of phase 6 over all reads;
  9. python  the Python host (`--host python --backend cuda`) on the
             first 4,096 reads and 2,048 pairs: SAM byte-identical to
             the native resident run on the same files;
 10. i16     the first 8,192 SE reads through NativePipeline with the
             16-bit cell backends (compute_dtype=torch.int16, a library
             argument with no CLI flag): the resident fused backend
             (make_fused_idx_backend) and the four-pass backend
             (make_raw_t_backend); records byte-identical to the
             resident run's, each kernel's launches == its dispatches
             and no other kernel launched;
 11. pe-dev  a second PE set made for the device protocols (2,048 pairs:
             an eighth of the mates on the wrong strand and an eighth
             substituted every 9 bases, so the seeder cannot place them
             and rescue fires; a quarter of the reads with 1-3 indels of
             1-4 bases) through `mem --backend cuda` with
             --device-rescue, --device-cigar and both, each also under
             --ship-ref, and its first ends SE with --device-cigar: every
             SAM byte-identical to the plain `mem --backend cuda` run on
             the same files (host rescue, host CIGAR), rescue_w* and
             cigar_r* trace rows present where asked for, some CIGAR
             with an I and some with a D;
 12. dev-seed all SE reads and pairs of phase 6 through `mem --backend cuda
             --device-seed`: SAM byte-identical to the host-seeded run,
             bwt_smem_all launches == chunks, bwt_smem1 == re-seed rounds,
             0 < bwt_sa <= chunks; the rates beside the host-seeded run's
             and the reads that took the exact host search;
 13. dev-fn  the plain PyTorch functions behind a wave and a round
             (local_torch.align6, global_torch.global_batch) once each at
             those runs' largest shapes: GPU == CPU, wall time, Python
             iterations, kernel launches and device time.
Each path's launch counts are set to 0 just before it and read just
after.  Each extension kernel's bound is the larger of its band cells
(counted by the plain version on this run's inputs) times INT_OPS_PER_CELL
over PEAK_INT_OPS (with 16-bit cells: two cells an operation) and its
bytes (inputs read once, outputs written once) over PEAK_BYTES; a seeding
kernel's is bytes: 48 B a rank4 query and 8 B an LF step (counted by the
plain version) with its inputs and outputs.  The last line of standard
output is {"ok": true, "device": {...}}.

`python3 chip_smoke.py --kernels-only` stops after phase 4.

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
import time

import numpy as np

GENOME_BP = 4_641_652      # E. coli K-12 MG1655 chromosome length
READ_LEN = 150
N_SE = 32_768
N_PE = 8_192
SUB_SE, SUB_PE = 2_048, 1_024
PY_SE, PY_PE = 4_096, 2_048        # the Python host's subset (it is slow)
I16_SE = 8_192                     # reads of the 16-bit resident run
DEV_PE = 2_048                     # pairs of the device-protocol PE set
SEED_B = 2048                      # reads of the seeding kernels' gate
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


def ops_bound_ms(cells, per_op):
    """The operations bound of `cells` band cells in ms, `per_op` cells an
    operation (1 with 32-bit cells, 2 with the packed 16-bit pairs)."""
    return 1e3 * cells * INT_OPS_PER_CELL / per_op / PEAK_INT_OPS


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
    the <group, strip, cell type> template arguments: i = int32_t, s =
    int16_t), registers, and spill bytes where there are any."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"^_Z\w*?\d+(extend_\w+?_kernel)(?:ILi(\d+)ELi"
                          r"(\d+)E(\w)E)?.*", r"\1<\2,\3,\4>", m.group(1))
            seed = re.search(r"\d((?:smem_all|smem1|sa)_kernel)", name)
            name = seed.group(1) if seed else name
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and int(m.group(1)):
            out.append(f"{name} {m.group(1)} B stack")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out.append(f"{name} SPILLS {m.group(1)}+{m.group(2)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name} {m.group(1)} regs")
    return "; ".join(out)


def time_kernels(name, k32, k16, plain32, plain16, cells, tensors, n_out):
    """Times of the 32-bit kernel and the 16-bit one on the same batch, in
    turns (32, 16, 16, 32), and of their plain versions, with the bound
    of the work: `cells` band cells, `tensors` read once, n_out int32
    written.  The 16-bit cells are packed two an operation, so their
    operations bound is half the 32-bit one.  Returns the two entries
    for the `kernels` line."""
    if not bool((k32() == k16()).all()):
        fail(f"{name}: 16-bit kernel != 32-bit kernel on the timed batch")
    a1, b1 = cuda_ms(k32, 20), cuda_ms(k16, 20)
    b2, a2 = cuda_ms(k16, 20), cuda_ms(k32, 20)
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) + 4 * n_out
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES
    out = []
    for what, (t1, t2), plain, per_op in (
            ("32-bit cells", (a1, a2), plain32, 1),
            ("16-bit cells, packed", (b1, b2), plain16, 2)):
        ms, plain_ms = (t1 + t2) / 2, cuda_ms(plain, 2)
        ops_ms = ops_bound_ms(cells, per_op)
        bound_ms = max(ops_ms, bytes_ms)
        log(f"{name}, {what}: kernel {t1:.3f}, {t2:.3f} ms; plain PyTorch "
            f"{plain_ms:.3f} ms (CUDA events); {cells} band cells -> "
            f"{cells / ms / 1e6:.3f} Gcell/s; bound {bound_ms:.4f} ms "
            f"(operations {ops_ms:.4f} ms at {INT_OPS_PER_CELL} integer "
            f"operations a cell, {per_op} cell(s) an operation, over "
            f"{PEAK_INT_OPS / 1e12:.2f} TOP/s; bytes {bytes_ms:.4f} ms for "
            f"{n_bytes} B) = {100 * bound_ms / ms:.1f}% of the kernel's time")
        out.append({"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes",
                    "library_ms": None, "cells": cells,
                    "cells_per_operation": per_op})
    return out


CELL_TYPES = (("32-bit", "int32"), ("16-bit", "int16"))


def phase_kernel(dev):
    """The fused kernel with 32-bit and with 16-bit cells: each against
    its own plain version, the 16-bit one against the 32-bit kernel, and
    L0 against the scalar oracle; then both timed."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import extend_cuda, extend_torch

    def kernel(t, prm, dt):
        return extend_cuda.extend_batch_raw_fused(*t, prm, compute_dtype=dt)

    prm = PRM
    result = None
    for dims, seed in ((GATE_DIMS, 1), (WIDE_DIMS, 2)):
        batch = gate.random_fused_batch(seed, GATE_B, dims, n_pad=100)
        t = [torch.from_numpy(x).to(dev) for x in batch]
        got32 = None
        for cells_name, dt_name in CELL_TYPES:
            dt = getattr(torch, dt_name)
            got = kernel(t, prm, dt)
            torch.cuda.synchronize()
            want = extend_torch.extend_fused(*t, prm, compute_dtype=dt)
            err = int((got.long() - want.long()).abs().max())
            if err:
                bad = (got != want).nonzero()[:5].tolist()
                fail(f"{cells_name} kernel != plain at {dims}: first (row, "
                     f"lane) {bad}")
            if got32 is None:
                got32 = got
            elif not torch.equal(got, got32):
                fail(f"16-bit kernel != 32-bit kernel at {dims}")
            s = batch[4]
            thr = (s[9] >> 1) + (s[9] >> 2)
            out = got.cpu().numpy()
            n_retry = int(((s[0] > 0) & (out[5] >= thr)).sum()
                          + ((s[5] > 0) & (out[21] >= thr)).sum())
            lanes = gate.valid_l0_lanes(s)[:96]
            bad = gate.l0_scalar_mismatches(out, batch[0], batch[1], s, prm,
                                            lanes)
            if len(lanes) != 96 or bad:
                fail(f"{cells_name} L0 != ksw_extend_core at {dims}: "
                     f"{bad[:3]}")
            log(f"{cells_name} kernel == plain on all 32 rows x {GATE_B} "
                f"lanes at (QL,TL,QR,TR)={dims} (max_abs_err 0, {n_retry} "
                f"retry passes, {int((s[0] == 0).sum())} lanes without a "
                f"left task); L0 == ksw_extend_core on 96 lanes")
        if dims == GATE_DIMS:
            cells = [0]
            extend_torch.extend_fused(*t, prm, cells=cells)
            result = time_kernels(
                f"extend_fused at B={GATE_B} {dims}",
                lambda: kernel(t, prm, torch.int32),
                lambda: kernel(t, prm, torch.int16),
                lambda: extend_torch.extend_fused(*t, prm),
                lambda: extend_torch.extend_fused(
                    *t, prm, compute_dtype=torch.int16),
                cells[0], t[:5], 32 * GATE_B)
    for qmax in GATE_DIMS[0], WIDE_DIMS[0]:
        batch = gate.hard_fused_batch(11, qmax)
        t = [torch.from_numpy(x).to(dev) for x in batch]
        for zdrop in (100, 0):
            prm = PRM.copy()
            prm[6] = zdrop
            for cells_name, dt_name in CELL_TYPES:
                dt = getattr(torch, dt_name)
                got = kernel(t, prm, dt)
                torch.cuda.synchronize()
                want = extend_torch.extend_fused(*t, prm, compute_dtype=dt)
                if not torch.equal(got, want):
                    bad = (got != want).nonzero()[:5].tolist()
                    fail(f"{cells_name} kernel != plain on the hard cases at "
                         f"qmax {qmax}, zdrop {zdrop}: first (row, lane) "
                         f"{bad}")
        log(f"32-bit and 16-bit kernels == plain on all 32 rows x "
            f"{batch[4].shape[1]} lanes of the hard-case batch at qmax "
            f"{qmax} (zdrop 100 and 0)")
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


def phase_kernel_t(dev):
    """The per-phase kernel with 32-bit and with 16-bit cells, as
    phase_kernel."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import extend_cuda, extend_torch

    def check(args, bounds, q, t, scal, prm, where, need_lanes):
        """Both kernels against their plain versions and each other, and
        fields 0-5 against the scalar oracle; returns the oracle's lanes."""
        got32 = None
        for cells_name, dt_name in CELL_TYPES:
            dt = getattr(torch, dt_name)
            got = extend_cuda.extend_batch_raw_t(*args, bounds, prm,
                                                 compute_dtype=dt)
            torch.cuda.synchronize()
            want = extend_torch.extend_t(*args, bounds, prm,
                                         compute_dtype=dt)
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                fail(f"extend_t {cells_name} kernel != plain {where}: first "
                     f"(row, lane) {bad}")
            if got32 is None:
                got32 = got
            elif not torch.equal(got, got32):
                fail(f"extend_t 16-bit kernel != 32-bit kernel {where}")
        lanes = gate.valid_l0_lanes(scal)[:96]
        bad = gate.l0_scalar_mismatches(got32.cpu().numpy(), q, t, scal, prm,
                                        lanes)
        if len(lanes) < need_lanes or bad:
            fail(f"extend_t != ksw_extend_core {where}: {bad[:3]}")
        return len(lanes)

    for (qmax, tmax), seed in zip(T_GATE_DIMS, (3, 4)):
        q, t, scal, bounds = gate.random_t_batch(seed, GATE_B, qmax, tmax,
                                                 n_pad=100)
        args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
        check(args, bounds, q, t, scal, PRM, f"at ({qmax}, {tmax})", 96)
        log(f"extend_t 32-bit and 16-bit kernels == plain on all 8 rows x "
            f"{GATE_B} lanes at (qmax, tmax)=({qmax}, {tmax}) (max_abs_err "
            f"0, {int((scal[0] == 0).sum())} lanes without a task) and == "
            f"each other; fields 0-5 == ksw_extend_core on 96 lanes")

    for qmax in T_HARD_QMAX:
        q, t, scal, bounds = gate.hard_t_batch(5, qmax)
        args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
        for zdrop in (100, 0):
            prm = PRM.copy()
            prm[6] = zdrop
            n = check(args, bounds, q, t, scal, prm,
                      f"on the hard cases at qmax {qmax}, zdrop {zdrop}", 1)
        log(f"extend_t 32-bit and 16-bit kernels == plain on all 8 rows x "
            f"{scal.shape[1]} lanes of the hard-case batch at qmax {qmax} "
            f"(zdrop 100 and 0); fields 0-5 == ksw_extend_core on {n} lanes")

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
    return time_kernels(
        "extend_t at bench.py's shape (B=16384, qmax 104, tmax 256, qlen "
        "100, tlen 200, w 100, zdrop 0; lanes stop at row_max == 0, unlike "
        "bench.py's early_exit=False: not comparable with any bench.py "
        "figure)",
        lambda: extend_cuda.extend_batch_raw_t(*args, bounds, prm),
        lambda: extend_cuda.extend_batch_raw_t(
            *args, bounds, prm, compute_dtype=torch.int16),
        lambda: extend_torch.extend_t(*args, bounds, prm),
        lambda: extend_torch.extend_t(*args, bounds, prm,
                                      compute_dtype=torch.int16),
        cells[0], args, 8 * scal.shape[1])


def seed_bound(stats, n_bytes):
    """The bytes bound of a seeding kernel in ms: 48 B a rank4 query and
    8 B more an LF step (counted by the plain version on the timed
    inputs), plus the inputs read and the outputs written once."""
    total = (stats.get("rank4", 0) * 48 + stats.get("lf", 0) * 8
             + n_bytes)
    return 1e3 * total / PEAK_BYTES, total


def phase_seed_kernels(dev):
    """The seeding kernels (bwt_smem_all, bwt_smem1, bwt_sa) against their
    plain versions on the card, exactly, on the gate batch over the smoke
    genome plus the overflow contig; the kernel seeder's rows against the
    C++ engine's; each kernel timed with its bound."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch import native
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.ops import smem_cuda, smem_torch

    t0 = time.time()
    genome = np.random.default_rng(0).integers(0, 4, GENOME_BP)  # simulate's
    rng = np.random.default_rng(5)
    hp, rep = gate.overflow_contig(rng)
    fm = build_index(np.concatenate([genome, hp, rep]).astype(np.uint8))
    po = pack_occ(fm)
    reads = gate.seed_gate_reads(rng, genome, hp, rep, SEED_B, READ_LEN)
    B = len(reads)
    mat, qlen = gate.read_matrix(reads)
    log(f"seed gate: index of {len(genome) + len(hp) + len(rep)} bp "
        f"(genome + overflow contig), {B} reads ({time.time() - t0:.1f}s)")
    opt = MemOptions()
    d = smem_torch.DeviceOcc(po, dev)
    q, ql = (torch.from_numpy(a).to(dev) for a in (mat, qlen))
    timing = {}

    def timed(name, kernel, plain, stats, n_bytes):
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 1)
        bound_ms, total = seed_bound(stats, n_bytes)
        log(f"{name}: kernel {ms:.4f} ms, plain PyTorch {plain_ms:.1f} ms "
            f"(CUDA events); {stats.get('rank4', 0)} rank4 queries, "
            f"{stats.get('lf', 0)} LF steps, {total} B -> bound "
            f"{bound_ms:.4f} ms = {100 * bound_ms / ms:.2f}% of the kernel's "
            f"time (the chain of dependent gathers bounds it)")
        timing[name] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": None}

    # the first round
    got = smem_cuda.smem_all(d, q, ql, opt.min_seed_len)
    torch.cuda.synchronize()
    st = {}
    want = smem_torch.smem_all(d, q, ql, opt.min_seed_len, st)
    if not torch.equal(got[:, :2], want[:, :2]):
        fail("bwt_smem_all: cnt or ovf != plain")
    ok = want[:, 1] == 0
    if not torch.equal(got[ok], want[ok]):
        fail("bwt_smem_all: slots != plain on a read without overflow")
    n_ovf = int((~ok).sum())
    if n_ovf < 1:
        fail("seed gate: no read overflowed its slots")
    log(f"bwt_smem_all == plain on {B} reads (cnt and ovf everywhere, all "
        f"{smem_torch.ALL_COLS} columns on {int(ok.sum())} reads without "
        f"overflow; {n_ovf} reads overflow; {int(want[:, 0].sum())} SMEMs)")
    timed("bwt_smem_all",
          lambda: smem_cuda.smem_all(d, q, ql, opt.min_seed_len),
          lambda: smem_torch.smem_all(d, q, ql, opt.min_seed_len), st,
          mat.nbytes + qlen.nbytes + 8 * got.numel())

    # one call a read at a random x, min_intv and mask
    x = rng.integers(0, np.maximum(qlen, 1))
    x[:2] = 0                                   # the all-A reads
    mi = rng.choice([1, 2, 5], B)
    mask = (rng.random(B) < 0.9).astype(np.uint8)
    x_d, mi_d, mask_d = (torch.from_numpy(a).to(dev) for a in (x, mi, mask))
    got = smem_cuda.smem1(d, q, ql, x_d, mi_d, mask_d)
    torch.cuda.synchronize()
    st = {}
    x_eff = torch.where(mask_d.bool(), x_d, ql)
    want = smem_torch.pack_smem1(smem_torch.smem1(d, q, ql, x_eff, mi_d, st))
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        fail(f"bwt_smem1 != plain: first (read, column) {bad}")
    log(f"bwt_smem1 == plain: all eight outputs of {B} reads "
        f"({int(want[:, 1].sum())} overflow, {int(want[:, 2].sum())} SMEMs)")
    timed("bwt_smem1", lambda: smem_cuda.smem1(d, q, ql, x_d, mi_d, mask_d),
          lambda: smem_torch.smem1(d, q, ql, x_eff, mi_d), st,
          mat.nbytes + 4 * qlen.nbytes + mask.nbytes + 8 * got.numel())

    # the seeder's rows against the C++ engine's, and the SA walks of
    # the gate's seeds
    seed_fn = smem_cuda.make_device_seeder(po, fm, opt, dev)
    rows = seed_fn(reads)
    n, want_rows = native.collect_seeds_native(
        po, fm.ssa, fm.sa_intv, mat, qlen, opt.min_seed_len,
        smem_torch.split_len_of(opt), opt.split_width, opt.max_occ)
    if not np.array_equal(rows, want_rows[:n]):
        fail(f"kernel seeder rows ({len(rows)}) != collect_seeds_native "
             f"({n})")
    c = seed_fn.stats.counts
    log(f"kernel seeder == collect_seeds_native: {n} seed rows, values and "
        f"order; {c['split_rounds']} re-seed rounds ({c['split_jobs']} "
        f"jobs); exact host search for {c['ovf_reads']} reads and "
        f"{c['ovf_jobs']} jobs")
    progs = smem_cuda.Programs(d, fm.ssa, fm.sa_intv)
    mems = smem_torch.collect_smems_device(
        progs, fm, reads, opt.min_seed_len, smem_torch.split_len_of(opt),
        opt.split_width)
    _, sa_rows = smem_torch.occurrences(mems, opt.max_occ)
    r_d = torch.from_numpy(sa_rows).to(dev)
    got = smem_cuda.sa(d, progs.ssa, fm.sa_intv, r_d)
    torch.cuda.synchronize()
    st = {}
    want = smem_torch.sa_batch(d, progs.ssa, fm.sa_intv, r_d, st)
    if not torch.equal(got, want) or not np.array_equal(
            got.cpu().numpy(), rows[:, 1]):
        fail("bwt_sa != plain or != the C++ engine's positions")
    log(f"bwt_sa == plain == C++ on the gate's {len(sa_rows)} seed rows")
    timed("bwt_sa", lambda: smem_cuda.sa(d, progs.ssa, fm.sa_intv, r_d),
          lambda: smem_torch.sa_batch(d, progs.ssa, fm.sa_intv, r_d), st,
          16 * len(sa_rows))
    return timing


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
                                 common=common, threads=threads)


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


def phase_i16_path(run, dev):
    """The first I16_SE reads of the SE set through NativePipeline with
    the 16-bit cell backends (a library argument: there is no CLI flag),
    in -b 2048 chunks: the resident fused backend, then the four-pass
    backend; records byte-identical to the resident CLI run's, and each
    run launches its 16-bit kernel once a dispatch and no other kernel."""
    import torch

    from bwamem_tpu_torch.__main__ import load_index
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.io.fastq import iter_fastq_chunks
    from bwamem_tpu_torch.ops import extend_cuda
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.pipeline import native_driver, resident

    opt = MemOptions()      # the CLI's defaults
    params = params_from_options(opt)
    ref, fm = load_index(run["fa"])
    pipe = native_driver.NativePipeline(opt, ref, fm, pack_occ(fm),
                                        nthreads=run["threads"])
    chunks = []
    for chunk in iter_fastq_chunks(run["inputs"]["SE"][0], 2048):
        chunks.append(chunk)
        if sum(len(c) for c in chunks) >= I16_SE:
            break
    n_reads = sum(len(c) for c in chunks)
    want = [l for l in sam_body(run["sams"]["SE"]) if not l.startswith("@")]
    # the resident run's records of the same reads: one or more per read
    want = want[:next((k for k, l in enumerate(want)
                       if l.startswith(f"se{n_reads}_")), len(want))]
    launches = {}
    for kernel, fn in (
            ("extend_fused_i16", resident.make_fused_idx_backend(
                params, ref.pac, dev, compute_dtype=torch.int16)),
            ("extend_t_i16", native_driver.make_raw_t_backend(
                params, dev, compute_dtype=torch.int16))):
        extend_cuda.reset_launches()
        t0 = time.time()
        got = "".join(pipe.align_chunk_text(
            [r.seq.astype(np.int64) for r in chunk], fn,
            names=[r.name for r in chunk],
            quals=[r.qual for r in chunk])[0] for chunk in chunks)
        secs = time.time() - t0
        counts = dict(extend_cuda.launches)
        got = got.splitlines(keepends=True)
        if got != want:
            diff = next((k for k, (x, y) in enumerate(zip(got, want))
                         if x != y), min(len(got), len(want)))
            fail(f"{kernel} path: records differ at line {diff} ({len(got)} "
                 f"vs {len(want)} lines):\n{got[diff:diff + 1]}\n"
                 f"{want[diff:diff + 1]}")
        others = {k: v for k, v in counts.items() if k != kernel and v}
        if counts[kernel] != fn.dispatches or not fn.dispatches or others:
            fail(f"{kernel} path: kernel launches {counts} != dispatches "
                 f"{fn.dispatches}")
        launches[kernel] = counts[kernel]
        log(f"{kernel} path: {n_reads} SE reads through NativePipeline with "
            f"the 16-bit cell backend, {len(got)} records byte-identical to "
            f"the resident run's; {kernel} launches {counts[kernel]} == "
            f"dispatches {fn.dispatches}, no other kernel ({secs:.1f}s, one "
            f"chunk at a time)")
    return launches["extend_fused_i16"], launches["extend_t_i16"]


def simulate_device_pairs(tmp, fa, n):
    """A PE set for the device protocols on the genome of `fa`: FR pairs,
    insert N(350, 30), 1% substitutions; pair i has its mate on the wrong
    strand when i % 8 == 1 and substituted every 9 bases when i % 8 == 5
    (the seeder cannot place either: rescue fires), and when i % 4 == 2
    read 1 carries 1-3 insertions or deletions of 1-4 bases."""
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(fa) as f:
        f.readline()
        genome = np.frombuffer(f.read().replace("\n", "").encode(), np.uint8)
    genome = np.searchsorted(acgt, genome).astype(np.int64)
    span = np.arange(READ_LEN)
    pos = rng.integers(0, GENOME_BP - 600, n)
    isize = rng.normal(350, 30, n).astype(np.int64)
    paths = [os.path.join(tmp, f"dev{k}.fq") for k in (1, 2)]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for i in range(n):
            a = genome[pos[i] + span].copy()
            m = genome[pos[i] + isize[i] - READ_LEN + span].copy()
            for r in (a, m):
                mut = rng.random(READ_LEN) < 0.01
                r[mut] = rng.integers(0, 4, int(mut.sum()))
            if i % 4 == 2:
                for _ in range(int(rng.integers(1, 4))):
                    cut = int(rng.integers(15, len(a) - 15))
                    k = int(rng.integers(1, 5))
                    a = (np.concatenate([a[:cut], a[cut + k:]])
                         if rng.random() < 0.5 else
                         np.concatenate([a[:cut], rng.integers(0, 4, k),
                                         a[cut:]]))
            if i % 8 == 5:
                m[4::9] = (m[4::9] + 1 + rng.integers(0, 3, len(m[4::9]))) % 4
            b = 3 - m[::-1]
            if i % 8 == 1:
                b = 3 - b[::-1]
            for f, r in ((f1, a), (f2, b)):
                f.write(f"@dev{i}\n{acgt[r].tobytes().decode()}\n+\n"
                        f"{'I' * len(r)}\n")
    return paths


def trace_sums(path):
    """{kind without its number: (rows, seconds, largest (Bp, qmax, tmax))}
    of a --trace file; host_chunk rows split into `host_start` (seeding,
    chaining, planning: reads > 0) and `host_finish` (rescue, CIGAR,
    pairing, SAM: reads == 0)."""
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            kind = row["kind"].rstrip("0123456789")
            if kind == "host_chunk":
                kind = "host_start" if row["reads"] else "host_finish"
            n, sec, shape = out.get(kind, (0, 0.0, (0, 0, 0)))
            out[kind] = (n + 1, sec + row["sec"], max(
                shape, (row.get("Bp", 0), row.get("qmax", 0),
                        row.get("tmax", 0))))
    return out


def phase_pe_device(tmp, run):
    """--device-rescue and --device-cigar (resident reference and
    --ship-ref) on the device-protocol PE set, and SE --device-cigar, each
    against the plain `mem --backend cuda` run on the same files."""
    from bwamem_tpu_torch.ops import extend_cuda

    pe = simulate_device_pairs(tmp, run["fa"], DEV_PE)
    common = ["--backend", "cuda", *run["common"]]
    plain, sums = {}, {}
    for label, reads in (("PE", pe), ("SE", pe[:1])):
        plain[label], _, _, _ = run_mem(tmp, f"dev_{label}_plain", run["fa"],
                                        reads, common)
        sums[label] = trace_sums(os.path.join(
            tmp, f"dev_{label}_plain.trace.jsonl"))
        cigars = [l.split("\t")[5] for l in sam_body(plain[label])
                  if not l.startswith("@")]
        n_i, n_d = (sum(op in c for c in cigars) for op in "ID")
        if not n_i or not n_d:
            fail(f"device-protocol {label} set: {n_i} CIGARs with I, {n_d} "
                 f"with D")
        log(f"device-protocol {label} set: {len(cigars)} records, {n_i} "
            f"CIGARs with an I, {n_d} with a D; host finish (rescue, CIGAR, "
            f"pairing, SAM in C++) {sums[label]['host_finish'][1]:.3f}s")
    runs = [("PE", pe, ship + flags)
            for ship in ([], ["--ship-ref"])
            for flags in (["--device-rescue"], ["--device-cigar"],
                          ["--device-rescue", "--device-cigar"])]
    runs.append(("SE", pe[:1], ["--device-cigar"]))
    extend_cuda.reset_launches()
    n_waves = n_rounds = 0
    for label, reads, flags in runs:
        tag = f"dev_{label}_" + "_".join(x.strip("-") for x in flags)
        sam, kinds, _, _ = run_mem(tmp, tag, run["fa"], reads,
                                   [*common, *flags])
        t = trace_sums(os.path.join(tmp, f"{tag}.trace.jsonl"))
        for flag, kind in (("--device-rescue", "rescue_w"),
                           ("--device-cigar", "cigar_r")):
            if (flag in flags) != (kind in t):
                fail(f"{label} {' '.join(flags)}: trace rows {sorted(t)}")
        n = same_sam(plain[label], sam, f"{label} {' '.join(flags)} vs plain")
        n_waves += t.get("rescue_w", (0,))[0]
        n_rounds += t.get("cigar_r", (0,))[0]
        log(f"{label} {' '.join(flags)}: SAM byte-identical to the plain run "
            f"(apart from @PG; {n} lines); "
            + "; ".join(f"{k} {t[k][0]} rows {1e3 * t[k][1]:.1f} ms, largest "
                        f"(Bp, qmax, tmax) {t[k][2]}"
                        for k in ("rescue_w", "cigar_r") if k in t)
            + f"; host finish {t['host_finish'][1]:.3f}s (plain "
              f"{sums[label]['host_finish'][1]:.3f}s)")
    log(f"device protocols: {n_waves} rescue waves and {n_rounds} CIGAR "
        f"rounds over {len(runs)} runs; extension launches "
        f"{dict(extend_cuda.launches)}")


def phase_device_seed(tmp, run, host_rates):
    """`mem --backend cuda --device-seed` over all SE reads and pairs: SAM
    byte-identical to the host-seeded resident run, one bwt_smem_all
    launch a chunk, one bwt_smem1 launch a re-seed round, at most one
    bwt_sa launch a chunk, and no other seeding kernel."""
    from bwamem_tpu_torch.ops import smem_cuda

    rates, seeded = {}, collections.Counter()
    smem_cuda.reset_launches()
    for label, reads in run["inputs"].items():
        sam, _, rates[label], text = run_mem(
            tmp, f"{label}_seed", run["fa"], reads,
            ["--backend", "cuda", "--device-seed", *run["common"]])
        n = same_sam(run["sams"][label], sam, f"{label} --device-seed vs "
                     f"host seeding")
        m = re.search(r"\[mem\] device seeding: (\d+) chunks, (\d+) reads, "
                      r"(\d+) re-seed rounds \((\d+) jobs\); exact host "
                      r"search for (\d+) reads and (\d+) re-seed jobs", text)
        if not m:
            fail(f"{label} --device-seed: no [mem] device seeding: line")
        c = dict(zip(("chunks", "reads", "rounds", "jobs", "ovf_reads",
                      "ovf_jobs"), map(int, m.groups())))
        seeded.update(c)
        host = {k: trace_sums(os.path.join(tmp, f"{t}.trace.jsonl"))[
            "host_start"] for k, t in (("host", label),
                                       ("device", f"{label}_seed"))}
        log(f"{label} --device-seed SAM byte-identical to host seeding "
            f"(apart from @PG; {n} lines); {c['chunks']} chunks, "
            f"{c['rounds']} re-seed rounds, exact host search for "
            f"{c['ovf_reads']} reads and {c['ovf_jobs']} jobs; chunk starts "
            f"(seeding, chaining, planning) {host['device'][1]:.3f}s over "
            f"{host['device'][0]} rows against {host['host'][1]:.3f}s with "
            f"host seeding")
    counts = dict(smem_cuda.launches)
    if (counts["bwt_smem_all"] != seeded["chunks"]
            or counts["bwt_smem1"] != seeded["rounds"]
            or not 0 < counts["bwt_sa"] <= seeded["chunks"]):
        fail(f"--device-seed: seeding launches {counts} against "
             f"{seeded['chunks']} chunks and {seeded['rounds']} re-seed "
             f"rounds")
    log(f"--device-seed: bwt_smem_all launches {counts['bwt_smem_all']} == "
        f"chunks, bwt_smem1 {counts['bwt_smem1']} == re-seed rounds, bwt_sa "
        f"{counts['bwt_sa']} <= chunks; {seeded['ovf_reads']} reads and "
        f"{seeded['ovf_jobs']} re-seed jobs took the exact host search")
    for label in rates:
        log(f"--device-seed {label}: {rates[label]:.1f} reads/s against "
            f"{host_rates[label]:.1f} with host seeding (same reads, "
            f"--backend cuda, -b 2048 --inflight 3, tracing on)")
    return counts, rates


def phase_device_functions(dev):
    """The device functions of the rescue waves and CIGAR rounds that are
    plain PyTorch (no TPU kernel stands behind them): one call each at
    the shapes phase_pe_device's largest wave and round have, against the
    same call on the CPU, with its wall time and, from torch.profiler,
    the kernels it launches and their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.ops import global_torch, local_torch

    rng = np.random.default_rng(4)
    opt = MemOptions()
    pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)

    def tasks(B, qmax, tmax, qlen):
        """Queries of qlen bases planted with 2% substitutions at a
        random place of their (tmax) target; the last 8th of the lanes
        padding (lengths 0, or 1 for the global alignment)."""
        t = rng.integers(0, 4, (B, tmax)).astype(np.int32)
        off = rng.integers(0, tmax - qlen + 1, B)
        q = np.full((B, qmax), 4, np.int32)
        q[:, :qlen] = t[np.arange(B)[:, None], off[:, None]
                        + np.arange(qlen)]
        mut = rng.random((B, qlen)) < 0.02
        q[:, :qlen][mut] = rng.integers(0, 4, int(mut.sum()))
        return q, t

    def timed(name, fn, shape, loops):
        want = fn("cpu") if shape[0] <= 2048 else None
        got = fn(dev)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        got = fn(dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if want is not None:
            for g, w in zip(got, want):
                if not torch.equal(g.cpu(), w):
                    fail(f"{name}: GPU != CPU at {shape}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(dev)
            torch.cuda.synchronize()
        rows = [(e.count, getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0)))
                for e in prof.key_averages()]
        rows = [(n, us) for n, us in rows if us > 0]
        log(f"{name} at (B, qmax, tmax)={shape}: {1e3 * wall:.1f} ms wall a "
            f"call (host clock around a synchronize), {loops} Python "
            f"iterations, {sum(n for n, _ in rows)} kernel launches, "
            f"{sum(us for _, us in rows) / 1e3:.1f} ms of device time "
            f"(torch.profiler)"
            + ("" if want is None else "; GPU == CPU"))

    def on(device, *arrays):
        return [torch.from_numpy(x).to(device) for x in arrays]

    B, qmax, tmax = 8192, 160, 512
    q, t = tasks(B, qmax, tmax, 150)
    qlen = np.where(np.arange(B) < B - B // 8, 150, 0).astype(np.int32)
    tlen = np.where(qlen > 0, tmax, 0).astype(np.int32)
    timed("local_torch.align6 (a rescue wave)",
          lambda d: (local_torch.align6(*on(d, q, qlen, t, tlen,
                                            opt.mat.astype(np.int32),
                                            pens)),),
          (B, qmax, tmax), 2 * tmax)
    B, qmax, tmax = 2048, 160, 160
    q, t = tasks(B, qmax, tmax, 150)
    t = np.ascontiguousarray(t[:, :tmax])
    qlen = np.where(np.arange(B) < B - B // 8, 150, 1).astype(np.int32)
    tlen = np.where(qlen > 1, 156, 1).astype(np.int32)
    w = np.full(B, 19, np.int32)
    timed("global_torch.global_batch (a CIGAR round)",
          lambda d: global_torch.global_batch(
              *on(d, q, qlen, t, tlen, w, opt.mat.astype(np.int32), pens)),
          (B, qmax, tmax), tmax + qmax + tmax)


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

    kl = _build.load()
    log(f"CUDA kernels built in {kl.build_seconds:.1f}s -> "
        f"{os.path.relpath(kl.path, root)}; ptxas: {ptxas_summary(kl.log)}")

    timing, timing_i16 = phase_kernel(dev)
    timing_t, timing_t_i16 = phase_kernel_t(dev)
    timing_seed = phase_seed_kernels(dev)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": [timing, timing_t, timing_i16,
                                      timing_t_i16, timing_seed]}),
              flush=True)
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
        launches_i16, launches_t_i16 = phase_i16_path(run, dev)
        phase_pe_device(tmp, run)
        seed_launches, rates_seed = phase_device_seed(tmp, run, rates)
        phase_device_functions(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, r in (("resident (default)", rates), ("--phased", rates_phased),
                    ("--ship-ref", rates_ship), ("--device-seed", rates_seed),
                    (f"--host python ({PY_SE} reads, {PY_PE} pairs)",
                     rates_py)):
        log(f"{name}: SE {r['SE']:.1f} reads/s, PE {r['PE']:.1f} reads/s "
            f"(--backend cuda, -b 2048 --inflight 3) on {smi}")
    log(f"total wall {time.time() - t_start:.1f}s")
    print(smi, flush=True)
    fused_src = "bwamem_tpu_torch/csrc/extend_fused.cu"
    t_src = "bwamem_tpu_torch/csrc/extend_t.cu"
    print(json.dumps({"kernels": [
        {"name": "extend_fused", "route": "cuda", "source": fused_src,
         "replaces": "bwamem_tpu/ops/extend_pallas.py:292",
         "launches": launches, **timing},
        {"name": "extend_t", "route": "cuda", "source": t_src,
         "replaces": "bwamem_tpu/ops/extend_pallas.py:255",
         "launches": launches_t, **timing_t},
        {"name": "extend_fused_i16", "route": "cuda", "source": fused_src,
         "replaces": "bwamem_tpu/ops/extend_pallas.py:432",
         "launches": launches_i16, **timing_i16},
        {"name": "extend_t_i16", "route": "cuda", "source": t_src,
         "replaces": "bwamem_tpu/ops/extend_pallas.py:383",
         "launches": launches_t_i16, **timing_t_i16}]
        + [{"name": name, "route": "cuda",
            "source": "bwamem_tpu_torch/csrc/fm_seed.cu",
            "replaces": f"bwamem_tpu/ops/smem_jax.py:{line}",
            "launches": seed_launches[name], **timing_seed[name]}
           for name, line in (("bwt_smem_all", 312), ("bwt_smem1", 130),
                              ("bwt_sa", 583))]}), flush=True)
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
