#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (bwamem_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):
  1. build   the thirteen CUDA kernels from bwamem_tpu_torch/csrc with nvcc
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
             (1024, 64), on the hard-case batch in a query window for
             every group width and strip length of the launch table and
             at the reference hardware's caps (qlen 255, tlen 2047, 8
             lanes), fields 0-5 against the scalar oracle on 96 lanes,
             and timed at bench.py's shape;
  3b. kernel16 both 16-bit kernels at one query window per row of their
             own launch table (BWT_LAUNCH_TABLE16) and one in the
             shared-memory row above it, each with enough lanes that the
             dispatch takes that row: random, hard-case and band-edge
             batches (band edges on every pair boundary and on the
             half-strip seam), zdrop 100 and 0, against the plain 16-bit
             version and the 32-bit kernel;
  4. seed    the seeding kernels (bwt_smem_all, bwt_smem1, bwt_sa) against
             their plain PyTorch versions on the card, exactly, on 2,048
             reads over the smoke genome plus a contig made to overflow the
             slots (homopolymer runs of every length 1..40, a repeated
             segment; all-N reads, N runs, reads shorter than -k); at least
             one read must overflow; the kernel seeder's rows against the
             C++ engine's (collect_seeds_native), values and order; each
             kernel timed with its bytes bound and its dependence bound
             (the longest chain of dependent gather rounds of any read or
             row, as the plain version counts them, times the card's time
             for one step, from one-row bwt_sa walks);
  4b. seed-sh the table-sharded seeding kernels (bwt_rank4_sh,
             bwt_smem_all_sh, bwt_smem1_sh, bwt_sa_sh; ops/smem_sharded.py)
             at two scales.  Smoke scale, on phase 4's gate: over
             [cuda:0] * n, n = 1 and 4 (and over every card when there are
             several with peer access; without it the factory must
             refuse), each kernel == its plain version over the same
             shards and == the unsharded kernel, every row and field,
             timed with its bytes and dependence bounds (bwt_rank4_sh as
             its bare launch, shorter than the wrapper's host time: the
             output made once, a sleep kernel queued first); the path (its
             launch counts set to 0 just before it and read just after):
             rank4 through
             make_sharded_rank4 at a block origin of 2^26 == host rank4,
             and the first 4,096 SE reads of phase 6 through
             NativePipeline with the table-sharded seeder at n_dev 1 and
             4, SAM byte-identical to host seeding.  Human scale: a
             synthetic index of 6,200,000,001 rows (GRCh38 two-strand) at
             sa_intv 32 made on the card; rank4 on 1,000,000 rows across
             2^31, 2^32 and n_rows, the SMEM search on 2,048 LF-walk reads
             (some SMEM at a row >= 2^31) and 100,000 SA walks: the
             unsharded kernels and the _sh kernels at n_dev 1 and 4
             against the plain version; peak device memory logged;
  4c. sw     the mate-rescue kernel (bwt_local_align6) and the CIGAR
             kernel (bwt_global_cigar) against their plain versions
             (local_torch.align6, global_torch.global_batch) on the same
             CUDA tensors, every field of every lane: at the dev-fn shapes
             (8192, 160, 512) and (2048, 160, 160), and on the hard-case
             batches of tests/_torch_gate.py (an arbitrary 5x5 matrix,
             ties, N codes, padding and best-0 lanes, narrow bands) at
             those shapes, in a window for every group width of the
             rescue kernel's launch table and the memory row beyond it,
             and on lanes at tmax 16384; the CIGAR kernel also at a band
             in every row of its launch table (global_sw.cuh) and
             the memory row, each with its slots in shared memory and
             (a target window too long for a block) in global scratch,
             the placement checked, and on rounds that mix w 19 with the
             band-doubling retries' widths; a band narrower than a
             lane's must raise; registers, shared memory, stack and
             spills of every CIGAR instantiation logged (a spill or
             stack fails the run); both timed at the dev-fn shapes with
             their bound (the CIGAR kernel's launch alone, with a
             dependence term: its longest traceback walk times one walk
             step, timed from two launches whose walks differ);
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
             and no other kernel launched; then each kernel timed on the
             inputs of its widest launch there (path_* in its entry of
             the `kernels` line: the shape its counted launches take,
             beside bench.py's and the gate's);
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
             with an I and some with a D; in each run bwt_local_align6
             launches == rescue_w* rows and bwt_global_cigar launches ==
             cigar_r* rows, ms a wave and a round beside the host finish;
             the first CIGAR round the resident PE run handed the kernel
             kept, then gated against the plain version and timed
             (path_ms in the CIGAR kernel's entry of the `kernels` line);
 12. dev-seed all SE reads and pairs of phase 6 through `mem --backend cuda
             --device-seed`: SAM byte-identical to the host-seeded run,
             bwt_smem_all launches == chunks, bwt_smem1 == re-seed rounds,
             0 < bwt_sa <= chunks; the rates beside the host-seeded run's
             and the reads that took the exact host search;
 13. dev-fn  the plain PyTorch functions behind a wave and a round
             (local_torch.align6, global_torch.global_batch) and their
             kernels once each at those runs' largest shapes: plain GPU ==
             CPU (the round), kernel == plain, wall time, Python
             iterations, kernel launches and device time;
 14. multi   the multi-device layer (parallel/dist.py): its dry run
             (parallel/dryrun.py, its table-sharded half included) over
             [cuda:0] * 4, and over every visible card when there are
             several; the first 4,096 SE
             reads and 1,024 pairs through NativePipeline with the
             sharded fused_idx, raw_t and fused backends and the sharded
             seeder at n_dev = 1 and 4, and the first 512 pairs of the
             device-protocol set through the sharded resident rescue and
             CIGAR backends and their host-shipped twins: every SAM
             byte-identical to the single-device run's, each kernel
             (bwt_local_align6 and bwt_global_cigar too) launched n_dev
             times a call, each call's wall time logged;
             two `mem` processes under the torch.distributed environment
             (WORLD_SIZE=2, LOCAL_RANK=0: two one-card hosts sharing the
             card), merged, byte-identical to the single run.
Each path's launch counts are set to 0 just before it and read just
after.  Each extension kernel's bound is the larger of its band cells
(counted by the plain version on this run's inputs) times INT_OPS_PER_CELL
over PEAK_INT_OPS (with 16-bit cells: two cells an operation) and its
bytes (inputs read once, outputs written once) over PEAK_BYTES; a seeding
kernel's is bytes: 48 B a rank4 query and 8 B an LF step (counted by the
plain version) with its inputs and outputs (its dependence bound beside
it, as dep_bound_ms); the mate-rescue and CIGAR
kernels' is that of their cells (both fills' qlen x tlen, the second from
the plain version's qe, te; the band cells of the fill) at
INT_OPS_PER_CELL, or their bytes.  The `kernels` line gives the
_sh kernels' smoke-scale times at n_dev 4.  The last line of standard
output is {"ok": true, "device": {...}}.

`python3 chip_smoke.py --kernels-only` stops after phase 4c.

This script and everything it loads (the port, tests/_torch_gate.py)
import neither JAX nor the JAX package; the run fails if either is among
the loaded modules at its end.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import io
import json
import os
import re
import shutil
import socket
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
MD_SE, MD_PE, MD_DEV_PE = 4_096, 1_024, 512   # the multi-device phase's
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


def cuda_ms(fn, reps: int, sleep_cycles: int = 0) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events.  With
    sleep_cycles, a sleep kernel of that many cycles queued first keeps
    the card busy while the host queues the runs, so they run back to back
    and the host's time between launches does not count (for launches
    shorter than it)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# the SMEM kernels, a warp per read (bwt_smem_all, bwt_smem1 and the _sh
# twins), by their names in ptxas_summary
SMEM_KERNELS = ("smem_all_kernel", "smem1_kernel")


def ptxas_summary(log_text):
    """`nvcc -Xptxas -v` output as one entry per kernel: its name (with
    the <group, strip, cell type> template arguments: i = int32_t, s =
    int16_t; <group, strip> for the rescue kernel, <group, strip, smem or
    global> for the CIGAR kernel, by where its slots are), registers, and
    stack and spill bytes where there are any (for the SMEM kernels, the
    16-bit instantiations and the CIGAR kernel always, with the CIGAR
    kernel's static shared memory)."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"^_Z\w*?\d+(extend_\w+?_kernel)(?:ILi(\d+)ELi"
                          r"(\d+)E(\w)E)?.*", r"\1<\2,\3,\4>", m.group(1))
            sw = re.search(r"((?:local_align6|global_cigar)_kernel)ILi(\d+)"
                           r"ELi(\d+)E(?:Lb([01])E)?", name)
            if sw:     # <group, strip>; strip 0 is the memory row
                name = f"{sw.group(1)}<{sw.group(2)},{sw.group(3)}" + (
                    "" if sw.group(4) is None else
                    ",smem" if sw.group(4) == "1" else ",global") + ">"
            seed = re.search(r"\d((?:smem_all|smem1|sa|rank4)_kernel)",
                             name)
            if seed:   # the _sh instantiations read a ShardedOcc
                name = seed.group(1) + ("<sh>" if "ShardedOcc" in name
                                        or "rank4" in name else "")
        # stack and spills, even 0: the SMEM kernels, the 16-bit pass and
        # the CIGAR kernel
        warp = name.startswith(SMEM_KERNELS + ("global_cigar",)) \
            or name.endswith(",s>")
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and (int(m.group(1)) or warp):
            out.append(f"{name} {m.group(1)} B stack")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out.append(f"{name} SPILLS {m.group(1)}+{m.group(2)} B")
        elif m and warp:
            out.append(f"{name} no spills")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name} {m.group(1)} regs")
            m = re.search(r"(\d+) bytes smem", line)
            if m and name.startswith("global_cigar"):
                out.append(f"{name} {m.group(1)} B static smem")
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

    q, t, scal, bounds = gate.capacity_t_batch()
    args = [torch.from_numpy(x).to(dev) for x in (q, t, scal)]
    n = check(args, bounds, q, t, scal, PRM,
              "at the capacity limits (qlen 255, tlen 2047)", 8)
    log(f"extend_t 32-bit and 16-bit kernels == plain on all 8 rows x {n} "
        f"lanes at the reference hardware's caps (qlen 255 in a 256 window, "
        f"tlen 2047 in a 2048 window); fields 0-5 == ksw_extend_core")

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


def phase_kernel_i16_rows(dev):
    """Both 16-bit kernels (extend_t_i16, extend_fused_i16) at one query
    window per row of their own launch table (BWT_LAUNCH_TABLE16) and one
    in the shared-memory row above it (and at 320 columns there, a
    multiple of 64), 1,024 lanes a batch: a random
    batch, the hard-case batch and a band-edge batch (lanes repeated up to
    that number), zdrop on and off, and where the row's strips end at the
    window the lanes whose trim reads past the last strip
    (_torch_gate.TRIM_PAST_ROW), every output row and lane against the
    plain 16-bit version and against the 32-bit kernel."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import _build, extend_cuda, extend_torch

    table = gate.launch_table16(os.path.join(_build.CSRC,
                                             "launch_table.cuh"))
    windows = list(table) + [(table[-1][0] + 1, 32, 0)] + [
        (q, 32, 0) for q in sorted(gate.TRIM_PAST_ROW) if q > table[-1][0]]
    B = 1024
    for qmax, g, c in windows:
        C = c or 2 * -(-qmax // 64)
        dims = (qmax, qmax + 64, max(qmax - 9, 1), qmax + 40)
        batches = [
            ("random", gate.random_t_batch(qmax, B, qmax, qmax + 64,
                                           n_pad=100)),
            ("hard cases", gate.tile_lanes(gate.hard_t_batch(5, qmax), B)),
            ("band edges", gate.tile_lanes(
                gate.edge_t_batch(qmax, qmax, C), B)),
            ("random", gate.random_fused_batch(qmax, B, dims, n_pad=100)),
            ("hard cases", gate.tile_lanes(gate.hard_fused_batch(11, qmax),
                                           B)),
            ("band edges", gate.tile_lanes(
                gate.edge_fused_batch(qmax, qmax, C), B))]
        prms = []
        for zdrop in (100, 0):
            prm = PRM.copy()
            prm[6] = zdrop
            prms.append(prm)
        batches = [(what, batch, prms) for what, batch in batches]
        if qmax in gate.TRIM_PAST_ROW and qmax == g * C:
            # the strips end at the window: lanes whose trim reads column
            # endc past the last strip, under their own scoring
            batch, prm = gate.trim_past_row_t_batch(qmax, B)
            batches.append(("trim past the row", batch, [prm]))
        for what, batch, prms in batches:
            t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in batch[:-1]]
            fused = len(t) == 5
            name = "extend_fused" if fused else "extend_t"
            kernel = (extend_cuda.extend_batch_raw_fused if fused
                      else extend_cuda.extend_batch_raw_t)
            plain = (extend_torch.extend_fused if fused
                     else extend_torch.extend_t)
            for prm in prms:
                got = kernel(*t, batch[-1], prm, compute_dtype=torch.int16)
                got32 = kernel(*t, batch[-1], prm)
                torch.cuda.synchronize()
                want = plain(*t, batch[-1], prm, compute_dtype=torch.int16)
                for other, against in ((want, "plain 16-bit version"),
                                       (got32, "32-bit kernel")):
                    if not torch.equal(got, other):
                        bad = (got != other).nonzero()[:5].tolist()
                        fail(f"{name}_i16 != {against} on the {what} batch at "
                             f"qmax {qmax}, {t[0].shape[1]} lanes (table row "
                             f"<{g},{c}>), scoring {prm.tolist()}: first "
                             f"(row, lane) {bad}")
        log(f"extend_t_i16 and extend_fused_i16 == plain 16-bit == 32-bit "
            f"kernel at qmax {qmax}, >= {B} lanes (16-bit table row "
            f"ROW({qmax}, {g}, {c})): "
            + ", ".join(dict.fromkeys(w for w, _, _ in batches))
            + " batches, zdrop 100 and 0, every row and lane")


def seed_bound(stats, n_bytes):
    """The bytes bound of a seeding kernel in ms: 48 B a rank4 query and
    8 B more an LF step (counted by the plain version on the timed
    inputs), plus the inputs read and the outputs written once."""
    total = (stats.get("rank4", 0) * 48 + stats.get("lf", 0) * 8
             + n_bytes)
    return 1e3 * total / PEAK_BYTES, total


def step_ms(walk_one, rounds, what):
    """The card's time for one dependent gather step: walk_one(k) launches
    the SA walk of row k alone (bwt_sa or bwt_sa_sh, one thread); rounds
    (N,) are the rows' LF steps as the plain version counts them.  The
    longest walk's time less that of a walk of no step, over its steps."""
    k_long = int(rounds.argmax())
    k_zero = int((rounds == 0).nonzero()[0, 0])
    n = int(rounds[k_long])
    t_long = cuda_ms(lambda: walk_one(k_long), 20, 20_000_000)
    t_zero = cuda_ms(lambda: walk_one(k_zero), 20, 20_000_000)
    step = (t_long - t_zero) / n
    log(f"{what}: one SA row's walk of {n} LF steps {t_long * 1e3:.3f} us, "
        f"of none {t_zero * 1e3:.3f} us (CUDA events, launches back to "
        f"back) -> {step * 1e6:.1f} ns a dependent step")
    return step


def dep_bound(entry, name, rounds, step):
    """The dependence bound of a seeding kernel into its `kernels` entry:
    the longest chain of dependent gather rounds of any read or row
    (rounds (B,), the plain version's count on the timed inputs) times
    the card's time for one step; logged with its share of the kernel's
    time."""
    chain = int(rounds.max())
    entry["dep_bound_ms"] = chain * step
    entry["dep_chain"] = chain
    log(f"{name}: longest chain {chain} dependent gather rounds x "
        f"{step * 1e6:.1f} ns = dependence bound {chain * step:.4f} ms = "
        f"{100 * chain * step / entry['ms']:.1f}% of the kernel's "
        f"{entry['ms']:.4f} ms")


def phase_seed_kernels(dev):
    """The seeding kernels (bwt_smem_all, bwt_smem1, bwt_sa) against their
    plain versions on the card, exactly, on the gate batch over the smoke
    genome plus the overflow contig; the kernel seeder's rows against the
    C++ engine's; each kernel timed with its bytes bound and its
    dependence bound."""
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
    rounds = {"bwt_smem_all": st["rounds"]}

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
    rounds["bwt_smem1"] = st["rounds"]

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
    rounds["bwt_sa"] = st["rounds"]
    step = step_ms(lambda k: smem_cuda.sa(d, progs.ssa, fm.sa_intv,
                                          r_d[k:k + 1]),
                   st["rounds"], "bwt_sa on the gate's seed rows")
    for name, r in rounds.items():
        dep_bound(timing[name], name, r, step)
    return timing, (fm, po, reads, sa_rows)


SH_N_ROWS = 6_200_000_001    # GRCh38 two-strand: 6.2 G index rows
SH_PRIMARY = 5_000_000_011   # the synthetic index's primary row, > 2^32
SH_SA_INTV = 32
SH_SE = 4096                     # SE reads of phase 6 seeded table-sharded


def timed_once(fn):
    """fn() once between CUDA events: (its result, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def clear_lanes(words, lanes):
    """Set to 0 the 2-bit lanes {block: [(word, lane), ...]} of the
    (blocks, 4) int32 word table `words` (a few rows, on the host)."""
    import torch

    for blk, where in lanes.items():
        w = words[blk].cpu().numpy().view(np.uint32).copy()
        for word, lane in where:
            w[word] &= np.uint32(~(3 << (2 * lane)) & 0xFFFFFFFF)
        words[blk] = torch.from_numpy(w.view(np.int32)).to(words.device)


def human_scale_tables(dev, seed=8):
    """A synthetic packed index of SH_N_ROWS rows made on the card from a
    seeded torch.Generator: random 2-bit symbols, every lane valid but the
    primary row's (placed above 2^32) and the padding past n_rows, the
    checkpoints by an int64 cumulative sum of per-block counts (each
    per-symbol count checked under 2^31 before it becomes int32, as
    pack_occ checks), C from the totals, symbols 0 and 3 swapped where
    needed so that count(0) <= count(3) (a two-strand index has them equal;
    the bi-intervals of the search then stay inside the table), and a
    random sampled SA every SH_SA_INTV rows.  It is not the BWT of a text,
    but an LF walk from any row is a path of the table.  Returns (a
    PackedOcc-like namespace of the tables, the sampled SA)."""
    import types

    import torch

    n = SH_N_ROWS
    nb = -(-n // 64)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    primary = SH_PRIMARY
    pk = torch.empty((nb + 1, 4), dtype=torch.int32, device=dev)
    raw = pk.view(torch.uint8).view(-1)
    step = 1 << 28
    for a in range(0, raw.numel(), step):
        b = min(a + step, raw.numel())
        raw[a:b] = torch.randint(0, 256, (b - a,), dtype=torch.uint8,
                                 generator=g, device=dev)
    va = torch.full((nb + 1, 4), 0x55555555, dtype=torch.int32, device=dev)
    # the invalid lanes: the primary row and every row from n on
    bad = {}
    for r in [primary] + list(range(n, (nb + 1) * 64)):
        bad.setdefault(r >> 6, []).append(((r & 63) >> 4, r & 15))
    clear_lanes(pk, bad)
    clear_lanes(va, bad)

    def counts(lo, hi):
        w = pk[lo:hi].long() & 0xFFFFFFFF
        v = va[lo:hi].long() & 0xFFFFFFFF
        out = []
        for c in range(4):
            t = ~(w ^ (c * 0x55555555)) & 0xFFFFFFFF
            x = t & (t >> 1) & 0x55555555 & v
            x = x - ((x >> 1) & 0x55555555)
            x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
            x = (x + (x >> 4)) & 0x0F0F0F0F
            out.append((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(1))
        return torch.stack(out, 1)

    occ = torch.empty((nb + 1, 4), dtype=torch.int32, device=dev)
    occ[0] = 0
    carry = torch.zeros(4, dtype=torch.int64, device=dev)
    step = 1 << 22
    for a in range(0, nb, step):
        b = min(a + step, nb)
        cum = counts(a, b).cumsum(0) + carry
        if int(cum[-1].max()) >= 1 << 31:
            fail("synthetic index: a per-symbol count reaches 2^31")
        occ[a + 1:b + 1] = cum.to(torch.int32)
        carry = cum[-1]
    tot = carry.cpu().numpy()
    if tot[0] > tot[3]:                # code c -> 3 - c, counts reversed
        torch.bitwise_not(pk, out=pk)
        clear_lanes(pk, bad)
        occ = occ.flip(1).contiguous()
        tot = tot[::-1].copy()
    if int(tot.sum()) != n - 1:
        fail(f"synthetic index: {int(tot.sum())} valid rows, want {n - 1}")
    C = np.zeros(6, np.int64)
    C[0] = 1
    C[1:5] = 1 + np.cumsum(tot)
    C[5] = C[4]
    n_ssa = -(-n // SH_SA_INTV)
    ssa = torch.randint(0, n, (n_ssa,), dtype=torch.int64, generator=g,
                        device=dev)
    po = types.SimpleNamespace(occ_rows=occ, pk_rows=pk, va_rows=va, C=C,
                               primary=primary, n_rows=n)
    return po, ssa


def lf_walk_reads(d, n_reads, length, rng):
    """n_reads reads of `length` bases spelled by LF walks from random rows
    of the table d (the reversed walk, so that backward search along the
    read follows the walk), with 1% substitutions; walks that reach the
    primary row are dropped.  Returns (B, L) uint8 codes and (B,) int64
    lengths on the host."""
    import torch

    from bwamem_tpu_torch.ops import smem_torch

    m = int(n_reads * 1.05) + 8
    r = torch.from_numpy(rng.integers(0, d.n_rows, m)).to(d.device)
    syms = torch.empty((m, length), dtype=torch.int64, device=d.device)
    ok = torch.ones(m, dtype=torch.bool, device=d.device)
    for k in range(length):
        blk, off = r >> 6, r & 63
        word = (off >> 4)[:, None]
        lane = 2 * (off & 15)
        sym = ((d.pk[blk].gather(1, word)[:, 0].long() & 0xFFFFFFFF)
               >> lane) & 3
        ok &= (((d.va[blk].gather(1, word)[:, 0].long() & 0xFFFFFFFF)
                >> lane) & 1) == 1
        syms[:, k] = sym
        rk = smem_torch.rank4(d, r)
        r = torch.where(ok, d.C[sym] + rk.gather(1, sym[:, None])[:, 0], 0)
    keep = ok.nonzero()[:, 0][:n_reads]
    if len(keep) < n_reads:
        fail(f"only {len(keep)} LF walks of {m} avoided the primary row")
    reads = syms[keep].flip(1).cpu().numpy().astype(np.uint8)
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    return reads, np.full(n_reads, length, np.int64)


def rank4_bare_ms(v, rows, want):
    """The bare bwt_rank4_sh launch over the shards of the view v at the
    int64 rows: its output made once (== want), a sleep kernel queued
    before the timed launches so that the host's ctypes call between them
    does not count; mean ms of 20 launches by CUDA events."""
    import ctypes

    import torch

    from bwamem_tpu_torch.ops import _build

    lib = _build.load().lib
    n = rows.shape[0]
    out = torch.full((n, 4), -1, dtype=torch.int64, device=rows.device)
    sh = ctypes.byref(v.tabs.shard_table())
    stream = torch.cuda.current_stream(rows.device).cuda_stream

    def launch():
        if lib.bwt_rank4_sh(sh, rows.data_ptr(), n, out.data_ptr(),
                            stream) != 0:
            fail("bwt_rank4_sh launch failed")

    launch()
    if not torch.equal(out, want):
        fail("bwt_rank4_sh (bare launch) != the wrapper's result")
    return cuda_ms(launch, 20, sleep_cycles=4_000_000)


def phase_seed_sharded(dev, seed_gate):
    """The table-sharded seeding kernels (bwt_rank4_sh, bwt_smem_all_sh,
    bwt_smem1_sh, bwt_sa_sh) at two scales.  Smoke scale, phase 4's gate:
    at n_dev 1 and 4 over [dev] * n (and over every card when there are
    several with peer access; without it the factory must refuse) each
    kernel == its plain version over the same shards and == the
    unsharded kernel, every row and field; then the path: rank4 through
    make_sharded_rank4 at a block origin of 2^26 == the host rank4, and
    phase 6's first SH_SE SE reads through NativePipeline with the
    table-sharded seeder at n_dev 1 and 4: SAM == the host-seeded run.
    Human scale: a synthetic index of SH_N_ROWS rows made on the card,
    rank4 across 2^31, 2^32 and n_rows, the SMEM search on LF-walk reads
    (some x0 >= 2^31) and the SA walks, the unsharded kernels and the
    _sh twins at n_dev 1 and 4 against the plain version.  Returns the
    `kernels` line's timings (smoke scale, n_dev 4) and the path's
    launches."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.__main__ import load_index, main
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.occ_packed import pack_occ, rank4
    from bwamem_tpu_torch.io.fastq import iter_fastq_chunks
    from bwamem_tpu_torch.ops import smem_cuda, smem_sharded, smem_torch
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.parallel import dist
    from bwamem_tpu_torch.pipeline import native_driver, resident

    t_phase = time.time()
    opt = MemOptions()
    msl = opt.min_seed_len
    fm, po, reads, sa_rows = seed_gate
    B = len(reads)
    mat, qlen = gate.read_matrix(reads)
    rng = np.random.default_rng(6)
    x = rng.integers(0, np.maximum(qlen, 1))
    mi = rng.choice([1, 2, 5], B)
    mask = (rng.random(B) < 0.9).astype(np.uint8)
    rows4 = np.concatenate([rng.integers(0, po.n_rows + 1, 100_000),
                            [0, po.primary, po.n_rows]]).astype(np.int64)

    def inputs(device):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in (("q", mat), ("ql", qlen), ("x", x), ("mi", mi),
                             ("mask", mask), ("rows4", rows4),
                             ("sa", sa_rows))}

    t = inputs(dev)
    d = smem_torch.DeviceOcc(po, dev)
    ssa = torch.from_numpy(np.asarray(fm.ssa, np.int64)).to(dev)
    unsharded = {
        "bwt_rank4_sh": smem_torch.rank4(d, t["rows4"]),
        "bwt_smem_all_sh": smem_cuda.smem_all(d, t["q"], t["ql"], msl),
        "bwt_smem1_sh": smem_cuda.smem1(d, t["q"], t["ql"], t["x"], t["mi"],
                                        t["mask"]),
        "bwt_sa_sh": smem_cuda.sa(d, ssa, fm.sa_intv, t["sa"])}
    torch.cuda.synchronize()

    def calls(v, t):
        """Each _sh kernel and its plain version over the view v."""
        x_eff = torch.where(t["mask"].bool(), t["x"], t["ql"])
        return {
            "bwt_rank4_sh": (
                lambda: smem_sharded.rank4(v, t["rows4"]),
                lambda st: smem_torch.rank4(v, t["rows4"])),
            "bwt_smem_all_sh": (
                lambda: smem_sharded.smem_all(v, t["q"], t["ql"], msl),
                lambda st: smem_torch.smem_all(v, t["q"], t["ql"], msl, st)),
            "bwt_smem1_sh": (
                lambda: smem_sharded.smem1(v, t["q"], t["ql"], t["x"],
                                           t["mi"], t["mask"]),
                lambda st: smem_torch.pack_smem1(smem_torch.smem1(
                    v, t["q"], t["ql"], x_eff, t["mi"], st))),
            "bwt_sa_sh": (
                lambda: smem_sharded.sa(v, v.ssa, fm.sa_intv, t["sa"]),
                lambda st: smem_torch.sa_batch(v, v.ssa, fm.sa_intv,
                                               t["sa"], st))}

    def same(name, got, want, what):
        """Every row and field; for bwt_smem_all_sh against the plain
        version, the slots of reads that overflowed are not compared (as
        in phase 4)."""
        if name == "bwt_smem_all_sh" and what.startswith("plain"):
            ok = want[:, 1] == 0
            good = torch.equal(got[:, :2], want[:, :2]) and torch.equal(
                got[ok], want[ok])
        else:
            good = torch.equal(got, want)
        if not good:
            bad = (got != want).nonzero()[:5].tolist()
            fail(f"{name} != {what}: first (row, column) {bad}")

    def sh_gate(devs, t, timing=None):
        """The four kernels over [dev] * n or a list of cards, each
        against its plain version and the unsharded kernel; with `timing`
        they are timed too."""
        tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, devs)
        smem_sharded.enable_peer_access(devs)
        v = tabs.view(devs[0])
        sts = {}
        for name, (kernel, plain) in calls(v, t).items():
            got = kernel()
            torch.cuda.synchronize()
            st = sts[name] = {}
            want, plain_ms = timed_once(lambda: plain(st))
            same(name, got, want, "plain")
            same(name, got, unsharded[name].to(devs[0]),
                 "the unsharded kernel (rank4: plain, the whole index)")
            if timing is not None:
                n_bytes = sum(a.nbytes for a in {
                    "bwt_rank4_sh": (rows4,), "bwt_smem_all_sh": (mat, qlen),
                    "bwt_smem1_sh": (mat, qlen, x, mi, mask),
                    "bwt_sa_sh": (sa_rows,)}[name]) + 8 * got.numel()
                if name == "bwt_rank4_sh":
                    st = {"rank4": len(rows4)}
                    # the bare launch: its launch is shorter than the
                    # wrapper's host time
                    ms = rank4_bare_ms(v, t["rows4"], got)
                else:
                    ms = cuda_ms(kernel, 20)
                bound_ms, total = seed_bound(st, n_bytes)
                log(f"{name} at n_dev {len(devs)} (smoke scale): kernel "
                    f"{ms:.4f} ms, plain PyTorch {plain_ms:.1f} ms (one call, "
                    f"CUDA events); {st.get('rank4', 0)} rank4 queries, "
                    f"{st.get('lf', 0)} LF steps, {total} B -> bound "
                    f"{bound_ms:.4f} ms = {100 * bound_ms / ms:.2f}% of the "
                    f"kernel's time")
                timing[name] = {"max_abs_err": 0, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": "bytes", "library_ms": None}
        if timing is not None:
            step = step_ms(lambda k: smem_sharded.sa(
                v, v.ssa, fm.sa_intv, t["sa"][k:k + 1]),
                sts["bwt_sa_sh"]["rounds"], f"bwt_sa_sh at n_dev {len(devs)}")
            for name in ("bwt_smem_all_sh", "bwt_smem1_sh", "bwt_sa_sh"):
                dep_bound(timing[name], name, sts[name]["rounds"], step)
        log(f"_sh kernels over {[str(x) for x in devs]} == plain == the "
            f"unsharded kernels on the {B}-read gate (rank4 on "
            f"{len(rows4)} rows, SA walks on {len(sa_rows)} rows)")

    timing = {}
    sh_gate([dev], t)
    sh_gate([dev] * 4, t, timing)
    cards = dist.device_list()
    if len(cards) > 1:
        peers = all(torch.cuda.can_device_access_peer(a.index, b.index)
                    for a in cards for b in cards if a != b)
        if peers:
            sh_gate(cards, inputs(cards[0]))
        else:
            try:
                smem_sharded.make_table_sharded_seeder(cards, po, fm, opt)
            except RuntimeError as e:
                log(f"{len(cards)} cards without peer access: the factory "
                    f"refuses ({e})")
            else:
                fail("make_table_sharded_seeder accepted cards without "
                     "peer access")

    # the path: the rank routing at a 2^32-row origin, then phase 6's
    # first SE reads seeded through the table-sharded seeder
    tmp = tempfile.mkdtemp(prefix="bwamem_sh_")
    try:
        fa, se, _, _ = simulate(tmp, N_SE, 0)
        with contextlib.redirect_stderr(io.StringIO()):
            if main(["index", fa]) != 0:
                fail("index of the smoke genome failed")
        ref, gfm = load_index(fa)
        chunks = []
        for chunk in iter_fastq_chunks(se, 2048):
            chunks.append(chunk)
            if sum(len(c) for c in chunks) >= SH_SE:
                break
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gpo = pack_occ(gfm)
    pipe = native_driver.NativePipeline(opt, ref, gfm, gpo,
                                        nthreads=min(os.cpu_count() or 1, 8))
    ext = resident.make_fused_idx_backend(params_from_options(opt), ref.pac,
                                          dev)

    def sam():
        return "".join(pipe.align_chunk_text(
            [r.seq.astype(np.int64) for r in c], ext,
            names=[r.name for r in c], quals=[r.qual for r in c])[0]
            for c in chunks)

    want_sam = sam()
    origin = 1 << 26
    o_rows = rng.integers(0, gpo.n_rows + 1, 100_000).astype(np.int64)
    smem_sharded.reset_launches()
    smem_cuda.reset_launches()
    t0 = time.time()
    otabs = smem_sharded.ShardedSeedTables(gpo, gfm.ssa, gfm.sa_intv,
                                           [dev] * 4, blk_origin=origin)
    got = smem_sharded.make_sharded_rank4([dev] * 4, otabs)(
        o_rows + (origin << 6))
    if not np.array_equal(got, rank4(gpo, o_rows)):
        fail("bwt_rank4_sh at a 2^32-row block origin != host rank4")
    del otabs
    seeders = []
    for n in (1, 4):
        seed_fn = dist.make_sharded_device_seeder([dev] * n, gpo, gfm, opt,
                                                  table_sharded=True)
        pipe.seed_fn = seed_fn
        try:
            got_sam = sam()
        finally:
            pipe.seed_fn = None
        if got_sam != want_sam:
            w, g = want_sam.splitlines(), got_sam.splitlines()
            i = next((k for k, (a, b) in enumerate(zip(w, g)) if a != b),
                     min(len(w), len(g)))
            fail(f"table-sharded seeding at n_dev {n}: SAM differs from "
                 f"host seeding at line {i}:\n{g[i:i + 1]}\n{w[i:i + 1]}")
        seeders.append((n, seed_fn.stats.counts))
    launches = dict(smem_sharded.launches)
    want = {"bwt_smem_all_sh": sum(n * c["chunks"] for n, c in seeders),
            "bwt_smem1_sh": sum(n * c["split_rounds"] for n, c in seeders),
            "bwt_sa_sh": sum(n * c["chunks"] for n, c in seeders)}
    if any(launches[k] != v for k, v in want.items()) \
            or not all(launches.values()) or any(smem_cuda.launches.values()):
        fail(f"table-sharded path: launches {launches}, want {want} and "
             f"bwt_rank4_sh > 0; unsharded {dict(smem_cuda.launches)}")
    log(f"table-sharded path: rank4 at a block origin of 2^26 == host "
        f"rank4 on {len(o_rows)} rows; {sum(len(c) for c in chunks)} SE "
        f"reads of phase 6 seeded at n_dev 1 and 4: SAM byte-identical to "
        f"host seeding ({want_sam.count(chr(10))} lines); launches "
        f"{launches}; seeder counts {seeders} ({time.time() - t0:.1f}s)")

    # human scale: a synthetic 6.2 G-row index made on the card
    del d, ssa, unsharded
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    hpo, hssa = human_scale_tables(dev)
    torch.cuda.synchronize()
    hd = smem_torch.DeviceOcc(hpo, dev)
    gib = torch.cuda.memory_allocated(dev) / 2**30
    log(f"human-scale index: {SH_N_ROWS} rows, sa_intv {SH_SA_INTV}, primary "
        f"row {hpo.primary}, C {hpo.C.tolist()}; tables {gib:.2f} GiB on the "
        f"card, made in {time.time() - t0:.1f}s")
    hr = rng.integers(0, SH_N_ROWS + 1, 1_000_000)
    edges = [np.arange(max(p - 64, 0), min(p + 65, SH_N_ROWS + 1))
             for p in (1 << 31, 1 << 32, SH_N_ROWS)]
    hrows = torch.from_numpy(np.concatenate([*edges, hr])[:1_000_000]
                             .astype(np.int64)).to(dev)
    hq, hql = lf_walk_reads(hd, SEED_B, READ_LEN, rng)
    hx = rng.integers(0, READ_LEN, SEED_B)
    hmi = rng.choice([1, 2, 5], SEED_B)
    hmask = (rng.random(SEED_B) < 0.9).astype(np.uint8)
    ht = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
          for k, v in (("q", hq), ("ql", hql), ("x", hx), ("mi", hmi),
                       ("mask", hmask))}
    cand = torch.from_numpy(rng.integers(0, SH_N_ROWS, 120_000)).to(dev)
    _, done = smem_torch.sa_walk(hd, hssa, SH_SA_INTV, cand, max_it=256)
    hsa = cand[done][:100_000].contiguous()
    if len(hsa) < 100_000:
        fail(f"only {len(hsa)} of {len(cand)} SA walks end within 256 steps")
    x_eff = torch.where(ht["mask"].bool(), ht["x"], ht["ql"])
    plain = {}
    st = {}
    plain["bwt_rank4_sh"], ms_r = timed_once(
        lambda: smem_torch.rank4(hd, hrows))
    plain["bwt_smem_all_sh"], ms_a = timed_once(
        lambda: smem_torch.smem_all(hd, ht["q"], ht["ql"], msl, st))
    st_all, st = st, {}
    plain["bwt_smem1_sh"], ms_1 = timed_once(
        lambda: smem_torch.pack_smem1(smem_torch.smem1(
            hd, ht["q"], ht["ql"], x_eff, ht["mi"], st)))
    st_1, st = st, {}
    plain["bwt_sa_sh"], ms_s = timed_once(
        lambda: smem_torch.sa_batch(hd, hssa, SH_SA_INTV, hsa, st))
    st_sa = st
    pa = plain["bwt_smem_all_sh"]
    x0 = pa[:, 2 + 2 * smem_torch.ALL_CAP:2 + 3 * smem_torch.ALL_CAP]
    filled = torch.arange(smem_torch.ALL_CAP, device=dev) < pa[:, :1]
    n_hi = int(((x0 >= 1 << 31) & filled).sum())
    if n_hi == 0:
        fail("human scale: no SMEM emitted at a row >= 2^31")
    log(f"human-scale plain version (one call each, CUDA events): rank4 "
        f"{ms_r:.1f} ms, smem_all {ms_a:.1f} ms ({int(pa[:, 0].sum())} "
        f"SMEMs, {n_hi} with x0 >= 2^31, {int(pa[:, 1].sum())} reads "
        f"overflow), smem1 {ms_1:.1f} ms, sa_batch {ms_s:.1f} ms "
        f"({st_sa.get('lf', 0)} LF steps)")
    unsh = {
        "bwt_smem_all_sh": lambda: smem_cuda.smem_all(hd, ht["q"], ht["ql"],
                                                      msl),
        "bwt_smem1_sh": lambda: smem_cuda.smem1(hd, ht["q"], ht["ql"],
                                                ht["x"], ht["mi"],
                                                ht["mask"]),
        "bwt_sa_sh": lambda: smem_cuda.sa(hd, hssa, SH_SA_INTV, hsa)}
    for name, fn in unsh.items():
        got = fn()
        torch.cuda.synchronize()
        same(name, got, plain[name], "plain (unsharded kernel, human scale)")
        log(f"{name[:-3]} (unsharded kernel on the 6.2 G-row table) == "
            f"plain: {cuda_ms(fn, 5):.3f} ms")
    stats = {"bwt_rank4_sh": {"rank4": len(hrows)},
             "bwt_smem_all_sh": st_all, "bwt_smem1_sh": st_1,
             "bwt_sa_sh": st_sa}
    step_h = step_ms(lambda k: smem_cuda.sa(hd, hssa, SH_SA_INTV,
                                            hsa[k:k + 1]),
                     st_sa["rounds"], "bwt_sa on the 6.2 G-row table")
    in_bytes = {"bwt_rank4_sh": 8 * len(hrows),
                "bwt_smem_all_sh": hq.nbytes + hql.nbytes,
                "bwt_smem1_sh": hq.nbytes + hql.nbytes + hx.nbytes
                + hmi.nbytes + hmask.nbytes,
                "bwt_sa_sh": 8 * len(hsa)}
    for n in (1, 4):
        tabs = smem_sharded.ShardedSeedTables(hpo, hssa, SH_SA_INTV,
                                              [dev] * n)
        v = tabs.view(dev)
        kernels = {
            "bwt_rank4_sh": lambda: smem_sharded.rank4(v, hrows),
            "bwt_smem_all_sh": lambda: smem_sharded.smem_all(
                v, ht["q"], ht["ql"], msl),
            "bwt_smem1_sh": lambda: smem_sharded.smem1(
                v, ht["q"], ht["ql"], ht["x"], ht["mi"], ht["mask"]),
            "bwt_sa_sh": lambda: smem_sharded.sa(v, v.ssa, SH_SA_INTV, hsa)}
        for name, fn in kernels.items():
            got = fn()
            torch.cuda.synchronize()
            same(name, got, plain[name], f"plain (human scale, n_dev {n})")
            ms = (rank4_bare_ms(v, hrows, got) if name == "bwt_rank4_sh"
                  else cuda_ms(fn, 5))
            bound_ms, total = seed_bound(stats[name],
                                         in_bytes[name] + 8 * got.numel())
            log(f"{name} at n_dev {n} on the 6.2 G-row table == plain: "
                f"{ms:.3f} ms; {stats[name].get('rank4', 0)} rank4 queries, "
                f"{stats[name].get('lf', 0)} LF steps, {total} B -> bound "
                f"{bound_ms:.4f} ms = {100 * bound_ms / ms:.2f}%")
            if "rounds" in stats[name]:
                dep_bound({"ms": ms}, f"{name} at n_dev {n}, 6.2 G rows",
                          stats[name]["rounds"], step_h)
        del tabs, v, kernels
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"human scale: every kernel == plain on rank4 ({len(hrows)} rows "
        f"across 2^31, 2^32 and n_rows), the SMEM search ({SEED_B} LF-walk "
        f"reads) and the SA walks ({len(hsa)} rows); peak device memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    del hpo, hssa, hd, plain, hrows, ht, cand, hsa
    torch.cuda.empty_cache()
    log(f"seed-sh phase: {time.time() - t_phase:.1f}s")
    return timing, launches


SW_LOCAL_SHAPE = (8192, 160, 512)   # a rescue wave's (Bp, qmax, tmax)
SW_GLOBAL_SHAPE = (2048, 160, 160)  # a CIGAR round's
# one window per group width and strip of sw_rows.cuh's launch table, the
# memory row beyond it, and lanes at the wave protocol's largest window
SW_HARD = ((24, 60), (50, 100), (100, 130), (160, 512), (180, 200),
           (250, 90), (300, 200), (1100, 300))
SW_LONG = (48, 160, 16384)         # (B, qmax, tmax)


def dev_fn_batches(seed=4):
    """The rescue wave and the CIGAR round of the dev-fn shapes (numpy,
    the arguments of local_torch.align6 and global_torch.global_batch) at
    bwa's defaults: 150-base queries planted with 2% substitutions at a
    random place of their target; the last eighth of the lanes padding
    (lengths 0; for the round qlen and tlen 1)."""
    from bwamem_tpu_torch.config import MemOptions

    rng = np.random.default_rng(seed)
    opt = MemOptions()
    mat = opt.mat.astype(np.int32)
    pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)

    def tasks(B, qmax, tmax, qlen):
        t = rng.integers(0, 4, (B, tmax)).astype(np.int32)
        off = rng.integers(0, tmax - qlen + 1, B)
        q = np.full((B, qmax), 4, np.int32)
        q[:, :qlen] = t[np.arange(B)[:, None], off[:, None]
                        + np.arange(qlen)]
        mut = rng.random((B, qlen)) < 0.02
        q[:, :qlen][mut] = rng.integers(0, 4, int(mut.sum()))
        return q, t

    B, qmax, tmax = SW_LOCAL_SHAPE
    q, t = tasks(B, qmax, tmax, 150)
    qlen = np.where(np.arange(B) < B - B // 8, 150, 0).astype(np.int32)
    tlen = np.where(qlen > 0, tmax, 0).astype(np.int32)
    local = (q, qlen, t, tlen, mat, pens)
    B, qmax, tmax = SW_GLOBAL_SHAPE
    q, t = tasks(B, qmax, tmax, 150)
    qlen = np.where(np.arange(B) < B - B // 8, 150, 1).astype(np.int32)
    tlen = np.where(qlen > 1, 156, 1).astype(np.int32)
    w = np.full(B, 19, np.int32)
    return local, (q, qlen, t, tlen, w, mat, pens)


def local_cells(args, out):
    """Cells of the two fills of bwt_local_align6 (qlen x tlen, then qe x
    te of the plain version's result `out`)."""
    q, qlen, t, tlen = (np.asarray(a) for a in args[:4])
    qn = np.clip(qlen, 0, q.shape[1]).astype(np.int64)
    tn = np.clip(tlen, 0, t.shape[1]).astype(np.int64)
    out = np.asarray(out).astype(np.int64)
    return int(qn @ tn + out[2] @ out[4])


def global_cells(args):
    """Band cells of bwt_global_cigar's fill: per lane and row i < tlen,
    min(i + w + 1, qlen) - max(i - w, 0) with w = max(w, |tlen - qlen|)."""
    qlen, tlen, w = (np.asarray(args[k]).astype(np.int64) for k in (1, 3, 4))
    w = np.maximum(w, np.abs(tlen - qlen))
    cells = 0
    for i in range(int(tlen.max(initial=0))):
        span = np.minimum(i + w + 1, qlen) - np.maximum(i - w, 0)
        cells += int(np.where(i < tlen, np.maximum(span, 0), 0).sum())
    return cells


def sw_entry(name, ms, plain_ms, cells, tensors, n_out_bytes,
             chain=None):
    """The `kernels` entry of a mate-rescue or CIGAR kernel, logged: its
    bound is the larger of the cells' operations (INT_OPS_PER_CELL a cell,
    over PEAK_INT_OPS) and the bytes of `tensors` read once and
    n_out_bytes written once (over PEAK_BYTES).  Where `chain` = (steps,
    ns a step) is given, the longest chain of dependent steps (the CIGAR
    kernel's traceback walk) times one step is a third term, logged with
    its share and kept as dependence_ms, and the log names the largest of
    the three."""
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) \
        + n_out_bytes
    terms = {"operations": ops_bound_ms(cells, 1),
             "bytes": 1e3 * n_bytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    bound_ms = terms[bound_by]
    extra = {}
    if chain is not None:
        extra["dependence_ms"] = chain[0] * chain[1] / 1e6
        terms["dependence"] = extra["dependence_ms"]
    largest = max(terms, key=terms.get)
    log(f"{name}: kernel {ms:.4f} ms, plain PyTorch {plain_ms:.3f} ms (CUDA "
        f"events); {cells} cells; bound {bound_ms:.4f} ms (operations "
        f"{terms['operations']:.4f} ms at {INT_OPS_PER_CELL} integer "
        f"operations a cell over {PEAK_INT_OPS / 1e12:.2f} TOP/s; bytes "
        f"{terms['bytes']:.4f} ms for {n_bytes} B) = "
        f"{100 * bound_ms / ms:.1f}% of the kernel's time"
        + ("" if chain is None else
           f"; dependence {terms['dependence']:.4f} ms (a walk of "
           f"{chain[0]} steps x {chain[1]:.2f} ns) = "
           f"{100 * terms['dependence'] / ms:.1f}%")
        + f"; the largest term: {largest}")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "cells": cells, **extra}


def global_launcher(dev, t, band):
    """A bare launch of bwt_global_cigar on the tensors t (the arguments of
    ops/global_cuda.global_batch) into outputs, scratch and an error word
    made once: the kernel alone, for timing (the wrapper also reads the
    error word back, a host sync).  Returns (launch, (score, steps,
    err))."""
    import torch

    from bwamem_tpu_torch.ops import _build

    q, qlen, tt, tlen, w, mat, pens = t
    B, qmax, tmax = q.shape[0], q.shape[1], tt.shape[1]
    lib = _build.load().lib
    with torch.cuda.device(dev):
        n = int(lib.bwt_global_cigar_scratch(qmax, tmax, band, B))
    score = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty((qmax + tmax, B), dtype=torch.int8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)

    def launch():
        _build.launch(dev, "bwt_global_cigar", q.data_ptr(), qmax,
                      qlen.data_ptr(), tt.data_ptr(), tmax, tlen.data_ptr(),
                      w.data_ptr(), B, band, mat.data_ptr(), pens.data_ptr(),
                      score.data_ptr(), steps.data_ptr(), err.data_ptr(),
                      scratch.data_ptr())

    return launch, (score, steps, err)


def walked_steps(ops, qn, tn):
    """The steps of a traceback walked in the matrix (before the D/I tail
    that follows an edge), from a lane's step-ops back to front."""
    i, k, n = tn - 1, qn - 1, 0
    for op in ops:
        if i < 0 or k < 0:
            break
        n += 1
        i -= op != 2
        k -= op != 1
    return n


def walk_step_ns(dev):
    """The card's time for one step of the CIGAR kernel's traceback walk
    (a dependent shared-memory load and its bookkeeping), from two
    launches of bwt_global_cigar that differ only in their walks: one lane,
    a 256-base query against a 1,280-base target (w' 1,024: the band is the
    whole query, the plane in shared memory), the rest of the target N
    codes, the query at the target's end (its 256 matches walked, the
    1,024 deletions the tail) or at its start (the deletions walked too).
    The fills do the same work; the difference of the times (CUDA events)
    over the difference of the steps walked is the step."""
    import torch

    from bwamem_tpu_torch.config import MemOptions

    rng = np.random.default_rng(9)
    opt = MemOptions()
    qs = rng.integers(0, 4, 256).astype(np.int32)
    junk = np.full(1024, 4, np.int32)
    mat = torch.from_numpy(opt.mat.astype(np.int32)).to(dev)
    pens = torch.tensor([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins],
                        dtype=torch.int32, device=dev)
    ms, n = {}, {}
    for name, target in (("query last", np.concatenate([junk, qs])),
                         ("query first", np.concatenate([qs, junk]))):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            qs[None], [256], target[None], [len(target)], [19])]
        t = [x.to(torch.int32).contiguous() for x in t] + [mat, pens]
        launch, (_, steps, err) = global_launcher(dev, t, 256)
        ms[name] = cuda_ms(launch, 20, sleep_cycles=4_000_000)
        if int(err.item()):
            fail("walk step: bwt_global_cigar flagged its band")
        n[name] = walked_steps(steps[:, 0].tolist(), 256, len(target))
    a, b = "query last", "query first"
    if n[b] <= n[a]:
        fail(f"walk step: walks of {n[a]} and {n[b]} steps")
    ns = 1e6 * (ms[b] - ms[a]) / (n[b] - n[a])
    log(f"traceback walk step: {ns:.2f} ns (one lane's launches with walks "
        f"of {n[a]} and {n[b]} steps: {ms[a]:.4f} and {ms[b]:.4f} ms)")
    return ns


def global_band_rounds():
    """The CIGAR kernel's gate rounds at every row of its launch table
    (tests/_torch_gate.global_band_batch; the rows read from
    csrc/global_sw.cuh) and the memory row above it: [(name, args, the
    slots in shared memory)].  Each row twice: at a target window that
    puts its slots in the blocks' shared memory, and at one just long
    enough that even a 32-thread block's slots pass the card's limit (227
    KB on an H100), so they go to global scratch."""
    import _torch_gate as gate
    from bwamem_tpu_torch.ops import _build

    rows = gate.global_launch_table(os.path.join(_build.CSRC,
                                                 "global_sw.cuh"))
    cap = 227 * 1024
    out = []
    for k, (band, g, c) in enumerate(rows + [(rows[-1][0] + 44, 32, 0)]):
        qmax = next(w for w in (64, 128, 256, 320) if w >= band)
        # a plane row is the window, g * c bytes, for a pair of rows
        tmaxes = [qmax + 16] if c == 0 else [
            qmax + 16, 2 * (cap * g // (32 * g * c)) + 2]
        for tmax in tmaxes:
            out.append((f"row ({band}, {g}, {c}) at (64, {qmax}, {tmax})",
                        gate.global_band_batch(70 + k, 64, qmax, tmax, band),
                        c > 0 and tmax == qmax + 16))
    return out


def phase_sw_kernels(dev):
    """4c: the mate-rescue kernel (bwt_local_align6) and the CIGAR kernel
    (bwt_global_cigar) against their plain versions (local_torch.align6,
    global_torch.global_batch) on the same CUDA tensors, every field of
    every lane: at the dev-fn shapes (bwa's matrix), on the hard-case
    batches of tests/_torch_gate.py (an arbitrary 5x5 matrix, ties, N
    codes, padding and best-0 lanes, bands narrower than |tlen - qlen|)
    in a window for every group width of the launch table and the memory
    row beyond it, and on lanes at tmax 16384; then both timed at the
    dev-fn shapes with their bound.  Returns {name: kernels entry}."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import (_build, global_cuda, global_torch,
                                      local_cuda, local_torch)

    def on(args):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in args]

    def check_local(name, args):
        t = on(args)
        got = local_cuda.align6(*t)
        torch.cuda.synchronize()
        want = local_torch.align6(*t)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            fail(f"bwt_local_align6 != local_torch.align6 on {name}: first "
                 f"(row, lane) {bad}")
        w = want.cpu().numpy()
        log(f"bwt_local_align6 == plain on all 6 rows x {w.shape[1]} lanes "
            f"of {name} ({int((w[0] > 0).sum())} lanes with a score, "
            f"{int((np.asarray(args[1]) == 0).sum())} padding)")
        return t, w

    lib = _build.load().lib

    def check_global(name, args, shared_want=None):
        """The kernel == plain on every field, with the band the callers
        pass; `shared_want`: whether the launch's slots must be in shared
        memory (True) or global scratch (False).  Returns (tensors, band,
        the plain steps)."""
        t = on(args)
        q, qlen, tt, tlen, w = args[:5]
        band = global_torch.band_width(qlen, tlen, w, q.shape[1])
        got = global_cuda.global_batch(*t, band=band)
        torch.cuda.synchronize()
        want = global_torch.global_batch(*t)
        for g, w, what in zip(got, want, ("score", "steps")):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                fail(f"bwt_global_cigar != global_torch.global_batch on "
                     f"{name}: {what} differs at {bad}")
        with torch.cuda.device(dev):
            shared = lib.bwt_global_cigar_scratch(
                q.shape[1], tt.shape[1], band, q.shape[0]) == 0
        if shared_want is not None and shared != shared_want:
            fail(f"bwt_global_cigar on {name}: slots in "
                 f"{'shared memory' if shared else 'global scratch'}")
        st = want[1].cpu().numpy()
        log(f"bwt_global_cigar == plain on the score and all "
            f"{st.shape[0]} step rows x {st.shape[1]} lanes of {name} "
            f"(band {band}, slots in "
            f"{'shared memory' if shared else 'global scratch'}; "
            f"{int((st == 1).any(0).sum())} lanes with a D, "
            f"{int((st == 2).any(0).sum())} with an I)")
        return t, band, st

    t0 = time.time()
    local, glob = dev_fn_batches()
    tl, wl = check_local(f"the dev-fn wave {SW_LOCAL_SHAPE}", local)
    tg, band_g, st_g = check_global(f"the dev-fn round {SW_GLOBAL_SHAPE}",
                                    glob)
    B = SW_LOCAL_SHAPE[0]
    check_local(f"the hard cases at {SW_LOCAL_SHAPE}",
                gate.local_sw_batch(31, *SW_LOCAL_SHAPE, n_pad=64))
    check_global(f"the hard cases at {SW_GLOBAL_SHAPE}",
                 gate.global_sw_batch(32, *SW_GLOBAL_SHAPE, n_pad=64))
    for k, (qmax, tmax) in enumerate(SW_HARD):
        check_local(f"the hard cases at (256, {qmax}, {tmax})",
                    gate.local_sw_batch(40 + k, 256, qmax, tmax))
        check_global(f"the hard cases at (256, {qmax}, {tmax})",
                     gate.global_sw_batch(50 + k, 256, qmax, tmax))
    args = gate.local_sw_batch(60, *SW_LONG)
    args[3][:4] = SW_LONG[2]
    check_local(f"lanes at tmax {SW_LONG[2]} (4 at tlen {SW_LONG[2]})", args)
    args = gate.global_sw_batch(61, *SW_LONG)
    check_global(f"lanes at tmax {SW_LONG[2]}", args, False)
    for name, args, shared in global_band_rounds():
        check_global(name, args, shared)
    for lanes in (96, 2048):
        check_global(f"a retry round ({lanes} lanes, w 19 to 152)",
                     gate.global_retry_batch(lanes, lanes))
    # a band narrower than the round's widest (the dev-fn round's 39)
    try:
        global_cuda.global_batch(*tg, band=8)
    except ValueError as e:
        log(f"bwt_global_cigar with band 8 on the dev-fn round raises: {e}")
    else:
        fail("bwt_global_cigar: a band too narrow for the lanes did not "
             "raise")
    log(f"sw gates: {time.time() - t0:.1f}s")

    out = {"local_align6": sw_entry(
        f"bwt_local_align6 at {SW_LOCAL_SHAPE}",
        cuda_ms(lambda: local_cuda.align6(*tl), 20),
        cuda_ms(lambda: local_torch.align6(*tl), 1), local_cells(local, wl),
        tl, 4 * 6 * B)}
    B, qmax, tmax = SW_GLOBAL_SHAPE
    chain = int((st_g != 3).sum(0).max())
    launch, _ = global_launcher(dev, tg, band_g)
    out["global_cigar"] = sw_entry(
        f"bwt_global_cigar at {SW_GLOBAL_SHAPE}, band {band_g}",
        cuda_ms(launch, 20, sleep_cycles=4_000_000),
        cuda_ms(lambda: global_torch.global_batch(*tg), 1),
        global_cells(glob), tg, 4 * B + (qmax + tmax) * B,
        chain=(chain, walk_step_ns(dev)))
    return out


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
    run launches its 16-bit kernel once a dispatch and no other kernel.
    Returns each kernel's launches and its times on the widest launch's
    inputs (time_path_batch), by kernel name."""
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
    launches, timing = {}, {}
    for kernel, wrapper, make in (
            ("extend_fused_i16", "extend_batch_raw_fused",
             lambda: resident.make_fused_idx_backend(
                 params, ref.pac, dev, compute_dtype=torch.int16)),
            ("extend_t_i16", "extend_batch_raw_t",
             lambda: native_driver.make_raw_t_backend(
                 params, dev, compute_dtype=torch.int16))):
        # the widest launch's inputs, kept for timing the kernel at a shape
        # the path gives it
        orig, kept = getattr(extend_cuda, wrapper), []

        def keep(*args, _orig=orig, _kept=kept, **kw):
            if not _kept or args[0].shape[1] > _kept[0][0].shape[1]:
                _kept[:] = [[x.clone() if torch.is_tensor(x) else x
                             for x in args]]
            return _orig(*args, **kw)

        setattr(extend_cuda, wrapper, keep)
        try:
            fn = make()
            extend_cuda.reset_launches()
            t0 = time.time()
            got = "".join(pipe.align_chunk_text(
                [r.seq.astype(np.int64) for r in chunk], fn,
                names=[r.name for r in chunk],
                quals=[r.qual for r in chunk])[0] for chunk in chunks)
            secs = time.time() - t0
            counts = dict(extend_cuda.launches)
        finally:
            setattr(extend_cuda, wrapper, orig)
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
        timing[kernel] = time_path_batch(kernel, orig, kept[0])
    return launches, timing


def time_path_batch(kernel, wrapper, args):
    """The 16-bit kernel and the 32-bit one on the inputs of the widest
    launch that the 16-bit path made (the same lanes, windows and table
    row as its counted launches), as time_kernels times them; returns the
    16-bit kernel's entries under path_* keys for the `kernels` line."""
    import torch

    from bwamem_tpu_torch.ops import extend_torch

    *tensors, prm = args
    plain = (extend_torch.extend_fused if kernel.startswith("extend_fused")
             else extend_torch.extend_t)
    want = plain(*tensors, prm, compute_dtype=torch.int16)
    if not torch.equal(wrapper(*tensors, prm, compute_dtype=torch.int16),
                       want):
        fail(f"{kernel} != plain 16-bit on the 16-bit path's widest launch")
    cells = [0]
    plain(*tensors, prm, cells=cells)
    windows = tensors[:-2]
    shape = (f"B={windows[0].shape[1]}, windows "
             f"{tuple(w.shape[0] for w in windows)}")
    _, t16 = time_kernels(
        f"{kernel[:-4]} on the 16-bit path's widest launch ({shape})",
        lambda: wrapper(*tensors, prm),
        lambda: wrapper(*tensors, prm, compute_dtype=torch.int16),
        lambda: plain(*tensors, prm),
        lambda: plain(*tensors, prm, compute_dtype=torch.int16),
        cells[0], tensors[:-1], want.numel())
    return {"path_shape": shape, "path_ms": t16["ms"],
            "path_plain_ms": t16["plain_ms"],
            "path_bound_ms": t16["bound_ms"]}


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
    against the plain `mem --backend cuda` run on the same files; in each
    run (counts set to 0 just before it) one bwt_local_align6 launch a
    rescue_w* trace row and one bwt_global_cigar launch a cigar_r* row.
    Returns the PE files and the launches of each kernel over the runs."""
    from bwamem_tpu_torch.ops import extend_cuda, global_cuda, local_cuda

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
    # the first CIGAR round of the resident PE run, as it reaches the
    # kernel's wrapper (gated and timed after the runs)
    kept, wrapper = [], global_cuda.global_batch

    def keep(*args, **kw):
        if not kept:
            kept.append(([x.clone() for x in args], kw.get("band")))
        return wrapper(*args, **kw)

    for label, reads, flags in runs:
        tag = f"dev_{label}_" + "_".join(x.strip("-") for x in flags)
        local_cuda.reset_launches()
        global_cuda.reset_launches()
        global_cuda.global_batch = keep if flags == ["--device-cigar"] \
            and label == "PE" else wrapper
        try:
            sam, kinds, _, _ = run_mem(tmp, tag, run["fa"], reads,
                                       [*common, *flags])
        finally:
            global_cuda.global_batch = wrapper
        got = {"rescue_w": local_cuda.launches["local_align6"],
               "cigar_r": global_cuda.launches["global_cigar"]}
        t = trace_sums(os.path.join(tmp, f"{tag}.trace.jsonl"))
        for flag, kind in (("--device-rescue", "rescue_w"),
                           ("--device-cigar", "cigar_r")):
            if (flag in flags) != (kind in t):
                fail(f"{label} {' '.join(flags)}: trace rows {sorted(t)}")
            if got[kind] != t.get(kind, (0,))[0]:
                fail(f"{label} {' '.join(flags)}: {got[kind]} kernel "
                     f"launches against {t.get(kind, (0,))[0]} {kind}* "
                     f"trace rows")
        n = same_sam(plain[label], sam, f"{label} {' '.join(flags)} vs plain")
        n_waves += got["rescue_w"]
        n_rounds += got["cigar_r"]
        log(f"{label} {' '.join(flags)}: SAM byte-identical to the plain run "
            f"(apart from @PG; {n} lines); "
            + "; ".join(f"{k} {t[k][0]} rows == kernel launches, "
                        f"{1e3 * t[k][1] / t[k][0]:.1f} ms a "
                        f"{'wave' if k == 'rescue_w' else 'round'} "
                        f"({1e3 * t[k][1]:.1f} ms in all), largest "
                        f"(Bp, qmax, tmax) {t[k][2]}"
                        for k in ("rescue_w", "cigar_r") if k in t)
            + f"; host finish {t['host_finish'][1]:.3f}s (plain "
              f"{sums[label]['host_finish'][1]:.3f}s)")
    log(f"device protocols: {n_waves} rescue waves (bwt_local_align6 "
        f"launches) and {n_rounds} CIGAR rounds (bwt_global_cigar launches) "
        f"over {len(runs)} runs; extension launches "
        f"{dict(extend_cuda.launches)}")
    return pe, {"local_align6": n_waves, "global_cigar": n_rounds}, \
        cigar_path_round(kept)


def cigar_path_round(kept):
    """The CIGAR kernel on the first round that `mem --device-cigar`
    handed it (kept by phase_pe_device): == the plain version on every
    field, then timed with the band the caller passed.  Returns the
    path_* keys of its `kernels` entry."""
    import torch

    from bwamem_tpu_torch.ops import global_cuda, global_torch

    if not kept:
        fail("pe-dev: no CIGAR round reached ops/global_cuda.global_batch")
    t, band = kept[0]
    got = global_cuda.global_batch(*t, band=band)
    want = global_torch.global_batch(*t)
    for g, w, what in zip(got, want, ("score", "steps")):
        if not torch.equal(g, w):
            fail(f"bwt_global_cigar != plain on mem's first CIGAR round: "
                 f"{what}")
    B, qmax, tmax = t[0].shape[0], t[0].shape[1], t[2].shape[1]
    ms = cuda_ms(global_launcher(t[0].device, t, band)[0], 20,
                 sleep_cycles=4_000_000)
    live = int((t[1] > 0).sum())
    log(f"bwt_global_cigar on mem's first CIGAR round (B {B}, {live} live "
        f"lanes, (qmax, tmax) ({qmax}, {tmax}), band {band}) == plain: "
        f"{ms:.4f} ms")
    return {"path_ms": ms, "path_shape": [B, qmax, tmax, band]}


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
    """The device functions behind a rescue wave and a CIGAR round, at the
    shapes of phase_pe_device's largest wave and round: the plain PyTorch
    function (local_torch.align6, global_torch.global_batch; on the card
    against the same call on the CPU) and its kernel (bwt_local_align6,
    bwt_global_cigar through ops/local_cuda and ops/global_cuda; against
    the plain function on the card), each with its wall time and, from
    torch.profiler, the kernels it launches and their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwamem_tpu_torch.ops import (global_cuda, global_torch, local_cuda,
                                      local_torch)

    def timed(name, fn, shape, loops, want=None):
        got = fn(dev)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        got = fn(dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if want is not None:
            for g, w in zip(got, want):
                if not torch.equal(g.cpu(), w.cpu()):
                    fail(f"{name}: != the reference at {shape}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(dev)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, getattr(e, "self_device_time_total",
                                         getattr(e, "self_cuda_time_total",
                                                 0)))
                for e in prof.key_averages()]
        rows = [r for r in rows if r[2] > 0]
        top = max(rows, key=lambda r: r[2], default=("none", 0, 0))
        log(f"{name} at (B, qmax, tmax)={shape}: {1e3 * wall:.1f} ms wall a "
            f"call (host clock around a synchronize), {loops} Python "
            f"iterations, {sum(n for _, n, _ in rows)} kernel launches, "
            f"{sum(us for _, _, us in rows) / 1e3:.3f} ms of device time "
            f"(torch.profiler; the longest: {top[0][:60]}, {top[1]} "
            f"launches, {top[2] / 1e3:.3f} ms)"
            + ("" if want is None else "; == the reference"))
        return got

    def on(device, arrays):
        return [torch.from_numpy(x).to(device) for x in arrays]

    local, glob = dev_fn_batches()
    shape = SW_LOCAL_SHAPE
    want = (local_torch.align6(*on("cpu", local)),) if shape[0] <= 2048 \
        else None
    plain = timed("local_torch.align6 (a rescue wave)",
                  lambda d: (local_torch.align6(*on(d, local)),), shape,
                  2 * shape[2], want)
    timed("bwt_local_align6 (ops/local_cuda.align6)",
          lambda d: (local_cuda.align6(*on(d, local)),), shape, 0, plain)
    shape = SW_GLOBAL_SHAPE
    want = global_torch.global_batch(*on("cpu", glob))
    plain = timed("global_torch.global_batch (a CIGAR round)",
                  lambda d: global_torch.global_batch(*on(d, glob)), shape,
                  2 * shape[2] + shape[1], want)
    timed("bwt_global_cigar (ops/global_cuda.global_batch)",
          lambda d: global_cuda.global_batch(*on(d, glob)), shape, 0, plain)


def timed_calls(fn):
    """fn with the wall time of each call (host clock; the backends
    return host arrays, so a call ends when its results are back) noted
    in .walls; keeps the protocol attributes (.fused, .idx, quanta)."""
    def wrapped(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        wrapped.walls.append(time.perf_counter() - t0)
        return out

    wrapped.__dict__.update(fn.__dict__)
    wrapped.walls = []
    return wrapped


def wall_summary(walls):
    return (f"{len(walls)} calls, {1e3 * sum(walls) / len(walls):.1f} ms a "
            f"call ({1e3 * min(walls):.1f}-{1e3 * max(walls):.1f})"
            if walls else "no calls")


def phase_multi_device(tmp, run, dev_pe, dev):
    """The multi-device layer on the card: the dry run over [dev] * 4 (and
    over every visible card when there are several), the sharded
    extension backends and seeder at n_dev = 1 and 4 on the first MD_SE SE
    reads and MD_PE pairs of the main set, the sharded rescue and CIGAR
    backends (resident and host-shipped) on the first MD_DEV_PE pairs of
    the device-protocol set: records byte-identical to the single-device
    resident run's, each kernel launched n_dev times a backend call; and
    two `mem` processes under the torch.distributed environment, merged,
    against the single run."""
    from bwamem_tpu_torch.__main__ import load_index
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.io.fastq import iter_fastq_chunks
    from bwamem_tpu_torch.ops import (extend_cuda, global_cuda, local_cuda,
                                      smem_cuda)
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.parallel import dist
    from bwamem_tpu_torch.parallel.dryrun import dryrun_multi_device
    from bwamem_tpu_torch.parallel.multihost import merge_sam_files
    from bwamem_tpu_torch.pipeline import native_driver, resident

    t_phase = time.time()
    cards = dist.device_list()
    for devs in [[dev] * 4] + ([cards] if len(cards) > 1 else []):
        t0 = time.time()
        got = dryrun_multi_device(devs)
        log(f"dry run over {[str(d) for d in devs]}: sharded raw_t kernel "
            f"step, SE chunk through the sharded raw_t, fused and fused_idx "
            f"backends, PE chunk through the sharded extension, rescue and "
            f"CIGAR backends (shipped and resident), sharded seeder, "
            f"table-sharded rank4 at a 2^32-row origin and table-sharded "
            f"seeder: every SAM == the single-device run's "
            f"({len(got['se'])} reads, "
            f"{len(got['pe'])} pairs; {time.time() - t0:.1f}s)")

    opt = MemOptions()      # the CLI's defaults
    params = params_from_options(opt)
    ref, fm = load_index(run["fa"])
    po = pack_occ(fm)
    pipe = native_driver.NativePipeline(opt, ref, fm, po,
                                        nthreads=run["threads"])
    text = {dev: resident.make_resident_text(ref.pac, dev)}

    def first(path, n, b):
        got = []
        for chunk in iter_fastq_chunks(path, b):
            got.append(chunk)
            if sum(len(c) for c in got) >= n:
                return got
        return got

    def seqs(chunk):
        return [r.seq.astype(np.int64) for r in chunk]

    se_chunks = first(run["inputs"]["SE"][0], MD_SE, 2048)
    pe = [first(p, MD_PE, MD_PE)[0] for p in run["inputs"]["PE"]]
    dpe = [first(p, MD_DEV_PE, MD_DEV_PE)[0] for p in dev_pe]

    def se_text(fn):
        return "".join(pipe.align_chunk_text(
            seqs(c), fn, names=[r.name for r in c],
            quals=[r.qual for r in c])[0] for c in se_chunks)

    def pe_text(pair, fn, rescue=None, cigar=None):
        a, b = pair
        return pipe.align_pairs_chunk_text(
            seqs(a), seqs(b), fn, names=[r.name for r in a],
            quals1=[r.qual for r in a], quals2=[r.qual for r in b],
            rescue_fn=rescue, cigar_fn=cigar)[0]

    def same(want, got, what):
        if want != got:
            w, g = want.splitlines(), got.splitlines()
            i = next((k for k, (x, y) in enumerate(zip(w, g)) if x != y),
                     min(len(w), len(g)))
            fail(f"{what}: records differ at line {i} ({len(g)} vs {len(w)} "
                 f"lines):\n{g[i:i + 1]}\n{w[i:i + 1]}")

    single = resident.make_fused_idx_backend(params, ref.pac, dev,
                                             text_dev=text[dev])
    want_se, want_pe = se_text(single), pe_text(pe, single)
    want_dpe = pe_text(dpe, single, resident.make_rescue_idx_backend(
        ref.pac, dev, text_dev=text[dev]), resident.make_cigar_idx_backend(
        ref.pac, dev, text_dev=text[dev]))
    log(f"multi-device sets: {sum(len(c) for c in se_chunks)} SE reads in "
        f"{len(se_chunks)} chunks, {len(pe[0])} pairs (one chunk), "
        f"{len(dpe[0])} device-protocol pairs; single-device resident "
        f"records {want_se.count(chr(10))}, {want_pe.count(chr(10))}, "
        f"{want_dpe.count(chr(10))}")

    for n in (1, 4):
        devs = [dev] * n
        for name, make, kernel in (
                ("fused_idx", lambda: dist.make_sharded_fused_idx_backend(
                    devs, params, ref.pac, text_dev=text), "extend_fused"),
                ("raw_t", lambda: dist.make_sharded_raw_t_backend(
                    devs, params), "extend_t"),
                ("fused", lambda: dist.make_sharded_fused_backend(
                    devs, params), "extend_fused")):
            fn = make()
            timed = timed_calls(fn)
            extend_cuda.reset_launches()
            same(want_se, se_text(timed), f"SE, sharded {name} at n_dev {n}")
            same(want_pe, pe_text(pe, timed),
                 f"PE, sharded {name} at n_dev {n}")
            counts = dict(extend_cuda.launches)
            others = {k: v for k, v in counts.items() if k != kernel and v}
            if counts[kernel] != n * fn.dispatches or not fn.dispatches \
                    or others:
                fail(f"sharded {name} at n_dev {n}: launches {counts}, "
                     f"{fn.dispatches} backend calls")
            log(f"sharded {name} at n_dev {n}: SE and PE records == the "
                f"single-device run's; {kernel} launches {counts[kernel]} == "
                f"{n} x {fn.dispatches} calls; wall "
                f"{wall_summary(timed.walls)}")

        seed_fn = dist.make_sharded_device_seeder(devs, po, fm, opt)
        timed = timed_calls(seed_fn)
        smem_cuda.reset_launches()
        pipe.seed_fn = timed
        try:
            same(want_se, se_text(single), f"SE, sharded seeder at n_dev {n}")
            same(want_pe, pe_text(pe, single),
                 f"PE, sharded seeder at n_dev {n}")
        finally:
            pipe.seed_fn = None
        c, counts = seed_fn.stats.counts, dict(smem_cuda.launches)
        want = {"bwt_smem_all": n * c["chunks"],
                "bwt_smem1": n * c["split_rounds"], "bwt_sa": n * c["chunks"]}
        if counts != want or not c["chunks"]:
            fail(f"sharded seeder at n_dev {n}: launches {counts}, want "
                 f"{want}")
        log(f"sharded seeder at n_dev {n}: SE and PE records == host "
            f"seeding's; launches {counts} == {n} x ({c['chunks']} chunks, "
            f"{c['split_rounds']} re-seed rounds); wall "
            f"{wall_summary(timed.walls)}")

        for name, ext, rescue, cigar in (
                ("resident", dist.make_sharded_fused_idx_backend(
                    devs, params, ref.pac, text_dev=text),
                 dist.make_sharded_rescue_idx_backend(devs, text_dev=text),
                 dist.make_sharded_cigar_idx_backend(devs, text_dev=text)),
                ("shipped", dist.make_sharded_fused_backend(devs, params),
                 dist.make_sharded_rescue_backend(devs),
                 dist.make_sharded_cigar_backend(devs))):
            rescue, cigar = timed_calls(rescue), timed_calls(cigar)
            local_cuda.reset_launches()
            global_cuda.reset_launches()
            same(want_dpe, pe_text(dpe, ext, rescue, cigar),
                 f"device-protocol PE, sharded {name} rescue and CIGAR at "
                 f"n_dev {n}")
            got = (local_cuda.launches["local_align6"],
                   global_cuda.launches["global_cigar"])
            if (not rescue.walls or not cigar.walls
                    or got != (n * len(rescue.walls), n * len(cigar.walls))):
                fail(f"sharded {name} rescue and CIGAR at n_dev {n}: "
                     f"{len(rescue.walls)} waves, {len(cigar.walls)} rounds, "
                     f"launches (local_align6, global_cigar) {got}")
            log(f"sharded {name} rescue and CIGAR at n_dev {n}: records == "
                f"the single-device run's; bwt_local_align6 launches "
                f"{got[0]} == {n} x {len(rescue.walls)} waves, "
                f"bwt_global_cigar {got[1]} == {n} x {len(cigar.walls)} "
                f"rounds; rescue waves {wall_summary(rescue.walls)}; CIGAR "
                f"rounds {wall_summary(cigar.walls)}")

    # two processes, each its shard from the torch.distributed environment
    sub = os.path.join(tmp, "se_sub.fq")
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", LOCAL_RANK="0")
    procs, paths = [], []
    t0 = time.time()
    for k in range(2):
        paths.append(os.path.join(tmp, f"dist{k}.sam"))
        with open(paths[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bwamem_tpu_torch", "mem",
                 "--backend", "cuda", *run["common"], run["fa"], sub],
                env=dict(env, RANK=str(k)), cwd=root, stdout=f,
                stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0 or f"[mem] shard {k}/2 (strided)" not in err:
            fail(f"mem under RANK={k} WORLD_SIZE=2 exited {p.returncode}:\n"
                 f"{err[-2000:]}")
    merged = os.path.join(tmp, "dist_merged.sam")
    merge_sam_files(paths, merged)
    n = same_sam(os.path.join(tmp, "SE_sub_cuda.sam"), merged,
                 "two processes (torch.distributed environment), merged, vs "
                 "the single run")
    log(f"two mem processes under RANK=0|1 WORLD_SIZE=2 LOCAL_RANK=0, "
        f"merged: SAM byte-identical to the single run (apart from @PG; "
        f"{n} lines; {time.time() - t0:.1f}s)")
    log(f"multi-device phase: {time.time() - t_phase:.1f}s")


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

    # built here from the checkout's sources, never a library cached by an
    # earlier run: ptxas's registers, stack and spills come with the build
    for name in glob.glob(os.path.join(_build.BUILD_DIR,
                                       "libbwt_kernels_*.so")):
        os.remove(name)
    kl = _build.load()
    ptxas = ptxas_summary(kl.log)
    log(f"CUDA kernels built in {kl.build_seconds:.1f}s -> "
        f"{os.path.relpath(kl.path, root)}; ptxas: {ptxas}")
    log("SMEM kernels, a warp per read (registers, stack, spills): "
        + "; ".join(e for e in ptxas.split("; ")
                    if e.startswith(SMEM_KERNELS)))
    packed = [e for e in ptxas.split("; ") if ",s>" in e]
    log("16-bit pass instantiations (registers, stack, spills): "
        + "; ".join(packed))
    if not packed:
        fail("no 16-bit pass instantiation in the build log")
    if any("SPILLS" in e or (" B stack" in e and not e.endswith(" 0 B stack"))
           for e in packed):
        fail("a 16-bit pass instantiation spills or uses stack")
    cigar = [e for e in ptxas.split("; ") if e.startswith("global_cigar")]
    log("CIGAR kernel instantiations (registers, static shared memory, "
        "stack, spills): " + "; ".join(cigar))
    if not cigar:
        fail("no CIGAR kernel instantiation in the build log")
    if any("SPILLS" in e or (" B stack" in e and not e.endswith(" 0 B stack"))
           for e in cigar):
        fail("a CIGAR kernel instantiation spills or uses stack")

    timing, timing_i16 = phase_kernel(dev)
    timing_t, timing_t_i16 = phase_kernel_t(dev)
    phase_kernel_i16_rows(dev)
    timing_seed, seed_gate = phase_seed_kernels(dev)
    timing_sh, sh_launches = phase_seed_sharded(dev, seed_gate)
    timing_sw = phase_sw_kernels(dev)
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": [timing, timing_t, timing_i16,
                                      timing_t_i16, timing_seed,
                                      timing_sh, timing_sw]}), flush=True)
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
        launches_i16, path_i16 = phase_i16_path(run, dev)
        dev_pe, sw_launches, cigar_path = phase_pe_device(tmp, run)
        seed_launches, rates_seed = phase_device_seed(tmp, run, rates)
        phase_device_functions(dev)
        phase_multi_device(tmp, run, dev_pe, dev)
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
         "launches": launches_i16["extend_fused_i16"], **timing_i16,
         **path_i16["extend_fused_i16"]},
        {"name": "extend_t_i16", "route": "cuda", "source": t_src,
         "replaces": "bwamem_tpu/ops/extend_pallas.py:383",
         "launches": launches_i16["extend_t_i16"], **timing_t_i16,
         **path_i16["extend_t_i16"]}]
        + [{"name": name, "route": "cuda",
            "source": "bwamem_tpu_torch/csrc/fm_seed.cu",
            "replaces": f"bwamem_tpu/ops/smem_jax.py:{line}",
            "launches": seed_launches[name], **timing_seed[name]}
           for name, line in (("bwt_smem_all", 312), ("bwt_smem1", 130),
                              ("bwt_sa", 583))]
        + [{"name": name, "route": "cuda",
            "source": "bwamem_tpu_torch/csrc/fm_seed.cu",
            "replaces": f"bwamem_tpu/ops/smem_sharded.py:{line}",
            "launches": sh_launches[name], **timing_sh[name]}
           for name, line in (("bwt_rank4_sh", 579), ("bwt_smem_all_sh", 436),
                              ("bwt_smem1_sh", 254), ("bwt_sa_sh", 506))]
        + [{"name": name, "route": "cuda",
            "source": f"bwamem_tpu_torch/csrc/{src}",
            "replaces": f"bwamem_tpu/ops/{ref}",
            "launches": sw_launches[name], **timing_sw[name],
            **(cigar_path if name == "global_cigar" else {})}
           for name, src, ref in (
               ("local_align6", "local_sw.cu", "local_jax.py:90"),
               ("global_cigar", "global_sw.cu", "global_jax.py:53"))]}),
        flush=True)
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
