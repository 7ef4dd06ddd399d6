#!/usr/bin/env python3
"""Launch-table experiment for the extension kernels of bwamem_tpu_torch,
on a machine with one NVIDIA GPU:

    python3 chip_tune.py [--against DIR]...

The pass of bwamem_tpu_torch/csrc/band_pass.cuh gives each alignment a
group of G threads, each with a strip of C query columns; the table of
csrc/launch_table.cuh chooses (G, C) from the query window.  This script
builds the kernels as they are and under alternative tables (narrower
groups with longer strips, each a copy of the sources with its own
launch_table.cuh), checks every build against the plain version, and times
them in turns with CUDA events on five batches: bench.py's per-phase
shape, chip_smoke.py's fused gate batch, a fused batch shaped like
150 bp reads (near-identical target, 1% substitutions), and per-phase
batches in 160 and 64 column windows, each with 32-bit cells and with the
packed 16-bit cells (the _i16 entry points).  For the kernels as they are it
also prints, from `cuobjdump -sass`, the length in SASS lines of each
kernel's row loop (the span of its innermost backward branch).

With `--against DIR`, a directory holding another version of the kernel
sources (say csrc/ of an earlier commit) is built and timed as one more
table, "against", on the entry points it has; a second and later DIR is
listed as "against:" and its last path component.

With `--seed`, it times the seeding kernels instead (bwt_smem_all,
bwt_smem1, bwt_sa of csrc/fm_seed.cu on chip_smoke.py's phase-4 gate, and
the table-sharded bwt_smem_all_sh, bwt_smem1_sh over the same gate's
tables split over [cuda:0] * 4), as committed and in each `--against`
DIR, in turns (committed, against, ..., then the reverse order), every
output checked against the committed build's.  Say

    git archive e071fb8 bwamem_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_tune.py --seed --against _archive/parent/bwamem_tpu_torch/csrc

to time a parent commit's seeding kernels beside the committed ones.

It prints one line per batch: the band cells the inputs need, the bound
chip_smoke.py computes from them, and each table's times in ms.  Nothing
here is used by the port; the table that is committed is the one this
experiment favoured.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

# name -> [(largest query window, G, C), ...]; None = the table as committed.
# Windows above the last entry take the shared-memory row either way.
TABLES = {
    "committed": None,
    "g8": [(32, 8, 4), (64, 8, 8), (104, 8, 13), (128, 8, 16), (160, 8, 20),
           (192, 8, 24), (256, 16, 16)],
    "g16": [(32, 8, 4), (64, 8, 8), (104, 16, 7), (128, 16, 8),
            (160, 16, 10), (192, 16, 12), (256, 16, 16)],
}
B = 8192


def with_table(src, dst, table):
    """Copy the kernel sources, launch_table.cuh replaced by `table`."""
    shutil.copytree(src, dst)
    if table is None:
        return
    rows = " ".join(f"ROW({q}, {g}, {c})" for q, g, c in table)
    with open(os.path.join(dst, "launch_table.cuh"), "w") as f:
        f.write(f"#pragma once\n#define BWT_LAUNCH_TABLE(ROW) {rows}\n")


def row_loop_sizes(nvcc, lib_path):
    """{kernel<G,C,cell type (i = int32_t, s = int16_t)>: SASS lines from
    the target of the innermost backward branch to the branch} out of
    `cuobjdump -sass`."""
    exe = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    r = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300)
    sizes = {}
    for fn in r.stdout.split("Function :")[1:]:
        m = re.search(r"(extend_(?:t|fused)_kernel)ILi(\d+)ELi(\d+)E(\w)E",
                      fn)
        if not m:
            continue
        addrs, loops = [], []
        for line in fn.splitlines():
            a = re.search(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?(\S+)(.*)",
                          line)
            if not a:
                continue
            addr = int(a.group(1), 16)
            addrs.append(addr)
            tgt = re.search(r"0x([0-9a-f]+)", a.group(3))
            if a.group(2).startswith("BRA") and tgt \
                    and int(tgt.group(1), 16) < addr:
                loops.append((int(tgt.group(1), 16), addr))
        if loops:
            lo, hi = min(loops, key=lambda x: x[1] - x[0])
            key = f"{m.group(1)}<{m.group(2)},{m.group(3)},{m.group(4)}>"
            sizes[key] = sum(lo <= x <= hi for x in addrs)
    return sizes


def reads_like_batch(rng):
    """A fused batch shaped like 150 bp reads: per side a query of 10..130
    bases in a 160 window, the target the query with 1% substitutions and
    100 bases more, w 100, h0 30 on the left."""
    def side():
        qlen = rng.integers(10, 131, B).astype(np.int32)
        q = rng.integers(0, 4, (160, B)).astype(np.int8)
        t = rng.integers(0, 4, (320, B)).astype(np.int8)
        t[:160] = q
        mut = rng.random((320, B)) < 0.01
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        return q, t, qlen, np.minimum(qlen + 100, 320).astype(np.int32)

    ql, tl, qll, tll = side()
    qr, tr, qlr, tlr = side()
    scal = np.zeros((16, B), np.int32)
    scal[0], scal[1], scal[2], scal[3], scal[4] = qll, tll, 100, 30, 200
    scal[5], scal[6], scal[7], scal[8], scal[9] = qlr, tlr, 100, 200, 100
    return ql, tl, qr, tr, scal


def time_seed_kernels(libs, dev):
    """The seeding kernels of each library on chip_smoke.py's phase-4 gate
    (2,048 reads over the smoke genome and the overflow contig; bwt_smem1
    at random x / min_intv / mask; bwt_sa on the gate's seed rows; the
    _sh twins of the first two over the tables split in four), three
    rounds of turns, 20 launches a time."""
    import ctypes

    import torch

    import _torch_gate as gate
    import chip_smoke as cs
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.ops import smem_cuda, smem_sharded, smem_torch

    genome = np.random.default_rng(0).integers(0, 4, cs.GENOME_BP)
    rng = np.random.default_rng(5)
    hp, rep = gate.overflow_contig(rng)
    fm = build_index(np.concatenate([genome, hp, rep]).astype(np.uint8))
    po = pack_occ(fm)
    reads = gate.seed_gate_reads(rng, genome, hp, rep, cs.SEED_B,
                                 cs.READ_LEN)
    mat, qlen = gate.read_matrix(reads)
    B, L = mat.shape
    x = rng.integers(0, np.maximum(qlen, 1))
    x[:2] = 0
    mi = rng.choice([1, 2, 5], B)
    mask = (rng.random(B) < 0.9).astype(np.uint8)
    opt = MemOptions()
    d = smem_torch.DeviceOcc(po, dev)
    progs = smem_cuda.Programs(d, fm.ssa, fm.sa_intv)
    mems = smem_torch.collect_smems_device(
        progs, fm, reads, opt.min_seed_len, smem_torch.split_len_of(opt),
        opt.split_width)
    _, sa_rows = smem_torch.occurrences(mems, opt.max_occ)
    q, ql, xd, mid, maskd, rows = (torch.from_numpy(
        np.ascontiguousarray(a)).to(dev) for a in (mat, qlen, x, mi, mask,
                                                    sa_rows))
    tables = (d.occ.data_ptr(), d.pk.data_ptr(), d.va.data_ptr(),
              d.C.data_ptr(), d.primary, d.n_rows)
    stream = torch.cuda.current_stream().cuda_stream
    shards = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv,
                                            [dev] * 4)
    sh = ctypes.byref(shards.shard_table())

    def launch(lib, name):
        if name.startswith("bwt_smem_all"):
            out = torch.empty((B, smem_torch.ALL_COLS), dtype=torch.int64,
                              device=dev)
            args = (q.data_ptr(), L, ql.data_ptr(), B, opt.min_seed_len,
                    out.data_ptr(), stream)
            rc = (lib.bwt_smem_all_sh(sh, *args) if name.endswith("_sh")
                  else lib.bwt_smem_all(*tables, *args))
        elif name.startswith("bwt_smem1"):
            out = torch.empty((B, smem_torch.SMEM1_COLS), dtype=torch.int64,
                              device=dev)
            args = (q.data_ptr(), L, ql.data_ptr(), xd.data_ptr(),
                    mid.data_ptr(), maskd.data_ptr(), B, out.data_ptr(),
                    stream)
            rc = (lib.bwt_smem1_sh(sh, *args) if name.endswith("_sh")
                  else lib.bwt_smem1(*tables, *args))
        else:
            out = torch.empty(len(rows), dtype=torch.int64, device=dev)
            rc = lib.bwt_sa(*tables, progs.ssa.data_ptr(), len(progs.ssa),
                            fm.sa_intv, rows.data_ptr(), len(rows),
                            smem_torch.sa_max_it(d.n_rows), out.data_ptr(),
                            stream)
        if rc != 0:
            sys.exit(f"{name} launch failed: {rc}")
        return out

    names = list(libs)
    for name in ("bwt_smem_all", "bwt_smem1", "bwt_sa", "bwt_smem_all_sh",
                 "bwt_smem1_sh"):
        want = launch(libs["committed"], name)
        times = {n: [] for n in names}
        for k in range(3):
            for n in (names if k % 2 == 0 else names[::-1]):
                if not torch.equal(launch(libs[n], name), want):
                    sys.exit(f"{name}: {n} != committed")
                times[n].append(round(cs.cuda_ms(
                    lambda: launch(libs[n], name), 20), 4))
        print(f"{name} on the phase-4 gate ({B} reads, {len(rows)} SA "
              f"rows): ms by build {json.dumps(times)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_tune.py needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import _torch_gate as gate
    import chip_smoke as cs
    from bwamem_tpu_torch.ops import _build, extend_cuda, extend_torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp(prefix="bwamem_tune_")
    libs = {}
    def bind_present(lib):
        """_build._bind for a library that may lack the newer entries."""
        class Present:
            def __getattr__(self, fn):
                return getattr(lib, fn) if hasattr(lib, fn) else self
        _build._bind(Present())

    argv = sys.argv[1:]
    seed = "--seed" in argv
    sources = {name: _build.CSRC for name in TABLES
               if not seed or name == "committed"}
    tables = {name: TABLES[name] for name in sources}
    for k, arg in enumerate(argv):
        if arg == "--against":
            name = "against" if "against" not in sources else \
                "against:" + os.path.basename(argv[k + 1].rstrip("/"))
            sources[name] = argv[k + 1]
            tables[name] = None
    for name, table in tables.items():
        csrc = os.path.join(tmp, name)
        with_table(sources[name], csrc, table)
        kl = _build.build(csrc, os.path.join(csrc, "build"), bind_present)
        libs[name] = kl.lib
        print(f"{name}: built in {kl.build_seconds:.1f}s; "
              f"{cs.ptxas_summary(kl.log)}", flush=True)
        if name == "committed" and not seed:
            print(f"{name}: row loop SASS lines "
                  f"{json.dumps(row_loop_sizes(_build._nvcc(), kl.path))}",
                  flush=True)

    def call(lib, fn, windows, scal, rows, prm):
        out = torch.empty((rows, scal.shape[1]), dtype=torch.int32,
                          device=dev)
        dims = [x for w in windows for x in (w.data_ptr(), w.shape[0])]
        rc = getattr(lib, fn)(*dims, scal.data_ptr(), scal.shape[1],
                              *extend_cuda.kernel_prm(prm), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"{fn} launch failed: {rc}")
        return out

    def on_dev(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    if seed:
        time_seed_kernels(libs, dev)
        shutil.rmtree(tmp, ignore_errors=True)
        return 0

    prm0 = cs.PRM.copy()
    prm0[6] = 0
    q, t, scal, _ = cs.bench_t_batch()
    fused = gate.random_fused_batch(1, B, cs.GATE_DIMS, n_pad=100)
    reads = reads_like_batch(np.random.default_rng(5))
    t160 = gate.random_t_batch(3, B, 160, 320, n_pad=100)
    t64 = gate.random_t_batch(3, B, 64, 128, n_pad=100)
    batches = [
        ("extend_t bench.py shape", "bwt_extend_t", on_dev(q, t, scal), prm0),
        ("extend_fused gate (160,320,160,320)", "bwt_extend_fused",
         on_dev(*fused[:5]), cs.PRM),
        ("extend_fused 150 bp reads", "bwt_extend_fused", on_dev(*reads),
         cs.PRM),
        ("extend_t gate (160,320)", "bwt_extend_t", on_dev(*t160[:3]),
         cs.PRM),
        ("extend_t (64,128)", "bwt_extend_t", on_dev(*t64[:3]), cs.PRM),
    ]
    # (..., cells an operation): the packed 16-bit pairs halve the bound
    batches = [(f"{what}{tag}", fn + suffix, tensors, prm, per_op)
               for what, fn, tensors, prm in batches
               for tag, suffix, per_op in (("", "", 1),
                                           (", 16-bit cells", "_i16", 2))]
    for what, fn, tensors, prm, per_op in batches:
        *windows, scal_d = tensors
        rows = 8 if fn.startswith("bwt_extend_t") else 32
        plain = (extend_torch.extend_t if rows == 8
                 else extend_torch.extend_fused)
        cells = [0]
        want = plain(*tensors, None, prm, cells=cells)
        have = {name: lib for name, lib in libs.items() if hasattr(lib, fn)}
        times = {name: [] for name in have}
        for _ in range(2):
            for name, lib in have.items():
                got = call(lib, fn, windows, scal_d, rows, prm)
                if not torch.equal(got, want):
                    sys.exit(f"{what}: table {name} != plain")
                times[name].append(round(cs.cuda_ms(
                    lambda: call(lib, fn, windows, scal_d, rows, prm), 20),
                    4))
        bound = cs.ops_bound_ms(cells[0], per_op)
        print(f"{what}: {cells[0]} band cells, bound {bound:.4f} ms "
              f"({per_op} cell(s) an operation), "
              f"ms by table {json.dumps(times)}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
