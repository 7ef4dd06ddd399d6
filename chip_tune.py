#!/usr/bin/env python3
"""Launch-table experiment for the extension kernels of bwamem_tpu_torch,
on a machine with one NVIDIA GPU:

    python3 chip_tune.py [--tables NAME,...] [--against DIR]...

The pass of bwamem_tpu_torch/csrc/band_pass.cuh gives each alignment a
group of G threads, each with a strip of C query columns; the tables of
csrc/launch_table.cuh choose (G, C): BWT_LAUNCH_TABLE for 32-bit cells
from the query window, BWT_LAUNCH_TABLE16 for the packed 16-bit cells
(band_pass16.cuh) from the window and the number of alignments.  This
script builds the kernels as they are and under the alternative tables of
TABLES (each a copy of the sources with those macros of launch_table.cuh
replaced; `--tables` picks some by name), checks every build against the
plain version, and times them in turns (each table, then the reverse
order) with CUDA events on five batches: bench.py's per-phase shape,
chip_smoke.py's fused gate batch, a fused batch shaped like 150 bp reads
(near-identical target, 1% substitutions), and per-phase batches in 160
and 64 column windows, each with 32-bit cells and with the packed 16-bit
cells (the _i16 entry points); then on the batches that chip_smoke.py's
16-bit path hands its kernels (its 8,192 SE reads of the main set through
NativePipeline with the 16-bit resident fused backend and the 16-bit
four-pass backend, every launch's inputs kept, each backend's first
launch once more with its lanes twice over, and its launches joined side
by side to 16,384 and 32,768 lanes, as a larger -b hands them), with both
cell types.
Each line gives the batch's band cells against the qlen x tlen rectangles
of the passes run, and each build's time once more with the lanes binned
by length ("NAME+binned": a device-side permutation into order of target
length, the launch, and the results put back in lane order, all timed).  For the kernels as they are (and each `--against`
DIR) it also prints, from `cuobjdump -sass`, the length in SASS lines of
each kernel's row loop (the shortest loop that holds a group reduction).

With `--against DIR`, a directory holding another version of the kernel
sources (say csrc/ of an earlier commit) is built and timed as one more
table, "against", on the entry points it has; a second and later DIR is
listed as "against:DIR".  Say

    git archive e6ad50c bwamem_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_tune.py --against _archive/parent/bwamem_tpu_torch/csrc

to time a parent commit's kernels beside the committed ones.

With `--seed`, it times the seeding kernels instead (bwt_smem_all,
bwt_smem1, bwt_sa of csrc/fm_seed.cu on chip_smoke.py's phase-4 gate, and
the table-sharded bwt_smem_all_sh, bwt_smem1_sh, bwt_sa_sh over the same
gate's tables split over [cuda:0] * 4), as committed and in each `--against`
DIR, in turns (committed, against, ..., then the reverse order), every
output checked against the committed build's.  Say

    git archive e071fb8 bwamem_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_tune.py --seed --against _archive/parent/bwamem_tpu_torch/csrc

to time a parent commit's seeding kernels beside the committed ones.

`--seed` also times the bare bwt_rank4_sh launch (its output made
beforehand, a sleep kernel queued first so the host's time between
launches does not count) on 100,003 rows of the phase-4 gate's tables
split in four and on 1,000,000 rows of chip_smoke.py's synthetic 6.2 G-row
index (one shard and four), with its bytes bound.

With `--sw`, it times the CIGAR kernel (bwt_global_cigar of
csrc/global_sw.cu) instead, as committed and in each `--against` DIR, in
turns, on chip_smoke.py's dev-fn round (2,048 lanes, (160, 160), w 19),
its hard-case round, and the rounds that `mem --device-cigar` hands the
kernel (captured from NativePipeline on chip_smoke.py's device-protocol PE
sets, PE and SE, at -b 512, 2048 and 8192 (MEM_RUNS), the band-doubling
retry rounds included; then the -b 512 rounds joined to 1,024-4,096
lanes), every output checked against the committed build's and the
committed build's against the plain version; and under the variants of
SW_TABLES (`--tables` picks some).  Each build is timed once more with
its traceback stubbed out ("NAME:fill", a copy of its sources), so the
split between fill and traceback is known.  Each round's line gives the
band cells against the qlen x tlen rectangles, the widest band, the
longest traceback chain, the launch's row and the times; a line sums the
`mem` rounds, and a last one times the rescue kernel (bwt_local_align6,
whose sources are not the CIGAR kernel's) of each build on the dev-fn
wave.  Say

    git archive e38ca92 bwamem_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_tune.py --sw --against _archive/parent/bwamem_tpu_torch/csrc

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

# name -> (32-bit rows, 16-bit rows): each a list of the rows of
# launch_table.cuh's BWT_LAUNCH_TABLE or BWT_LAUNCH_TABLE16 ((largest
# query window, G, C), ...), or None for the macro of the sources as they
# are.  Windows above the last row take the shared-memory row either way.
# A source without BWT_LAUNCH_TABLE16 (as before the 16-bit cells had a
# table of their own) runs its 16-bit cells under BWT_LAUNCH_TABLE.
TABLES = {
    "committed": (None, None),
    "i16-g8": (None, [(32, 4, 8), (64, 8, 8), (112, 8, 14), (128, 8, 16),
                      (160, 8, 20), (192, 8, 24), (256, 8, 32)]),
    "i16-g16": (None, [(32, 8, 4), (64, 8, 8), (128, 16, 8), (160, 16, 10),
                       (192, 16, 12), (256, 16, 16)]),
}
B = 8192
MEM_SE = 8192   # chip_smoke.py's 16-bit path: its first 8,192 SE reads
MEM_LANES = (16384, 32768)  # its launches joined: as a larger -b makes


def with_table(src, dst, table):
    """Copy the kernel sources, the macros of launch_table.cuh that
    `table` = (32-bit rows, 16-bit rows) gives replaced."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "launch_table.cuh")
    with open(path) as f:
        text = f.read()
    for macro, rows in zip(("BWT_LAUNCH_TABLE", "BWT_LAUNCH_TABLE16"),
                           table):
        if rows is None:
            continue
        line = (f"#define {macro}(ROW) "
                + " ".join(f"ROW({', '.join(map(str, r))})" for r in rows)
                + "\n")
        pat = re.compile(rf"#define {macro}\(ROW\)(?:[^\n]*\\\n)*[^\n]*\n")
        text, n = pat.subn(lambda _: line, text)
        if not n:
            text += line
    with open(path, "w") as f:
        f.write(text)


def row_loop_sizes(nvcc, lib_path):
    """{kernel<G,C,cell type (i = int32_t, s = int16_t)>: SASS lines of
    its row loop} out of `cuobjdump -sass`: the span from the target of a
    backward branch to the branch, the shortest span that holds a REDUX
    (the group reductions happen once a row, so only the row loop and
    loops around it hold one)."""
    exe = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    r = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300)
    sizes = {}
    for fn in r.stdout.split("Function :")[1:]:
        m = re.search(r"(extend_(?:t|fused)_kernel)ILi(\d+)ELi(\d+)E(\w)E",
                      fn)
        if not m:
            continue
        addrs, redux, loops = [], [], []
        for line in fn.splitlines():
            a = re.search(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?(\S+)(.*)",
                          line)
            if not a:
                continue
            addr = int(a.group(1), 16)
            addrs.append(addr)
            if a.group(2).startswith("REDUX"):
                redux.append(addr)
            tgt = re.search(r"0x([0-9a-f]+)", a.group(3))
            if a.group(2).startswith("BRA") and tgt \
                    and int(tgt.group(1), 16) < addr:
                loops.append((int(tgt.group(1), 16), addr))
        rows = [x for x in loops if any(x[0] <= y <= x[1] for y in redux)]
        if rows:
            lo, hi = min(rows, key=lambda x: x[1] - x[0])
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
        elif name == "bwt_sa_sh":
            out = torch.empty(len(rows), dtype=torch.int64, device=dev)
            rc = lib.bwt_sa_sh(sh, rows.data_ptr(), len(rows),
                               smem_torch.sa_max_it(d.n_rows),
                               out.data_ptr(), stream)
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
                 "bwt_smem1_sh", "bwt_sa_sh"):
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

    rows4 = np.concatenate([rng.integers(0, po.n_rows + 1, 100_000),
                            [0, po.primary, po.n_rows]]).astype(np.int64)
    time_rank4(libs, dev, "the phase-4 gate's tables, n_dev 4", shards,
               torch.from_numpy(rows4).to(dev),
               smem_torch.rank4(d, torch.from_numpy(rows4).to(dev)))
    del d, progs, shards
    torch.cuda.empty_cache()
    hpo, hssa = cs.human_scale_tables(dev)
    hd = smem_torch.DeviceOcc(hpo, dev)
    edges = [np.arange(max(p - 64, 0), min(p + 65, cs.SH_N_ROWS + 1))
             for p in (1 << 31, 1 << 32, cs.SH_N_ROWS)]
    hrows = torch.from_numpy(np.concatenate(
        [*edges, rng.integers(0, cs.SH_N_ROWS + 1, 1_000_000)])[:1_000_000]
        .astype(np.int64)).to(dev)
    want = smem_torch.rank4(hd, hrows)
    for n_dev in (1, 4):
        tabs = smem_sharded.ShardedSeedTables(hpo, hssa, cs.SH_SA_INTV,
                                              [dev] * n_dev)
        time_rank4(libs, dev, f"the 6.2 G-row index, n_dev {n_dev}", tabs,
                   hrows, want)
        del tabs
        torch.cuda.empty_cache()


def time_rank4(libs, dev, what, tabs, rows, want):
    """The bare bwt_rank4_sh launch of each library over the shards of
    `tabs` at `rows` (int64 on dev): the output made once, a sleep kernel
    queued before the timed launches (so the host's ctypes call between
    them does not count), three rounds of turns, 20 launches a time; each
    output == `want` (the plain version's).  Prints the times beside the
    bytes bound (48 B a query, the row read, 32 B written)."""
    import ctypes

    import torch

    import chip_smoke as cs

    n = rows.shape[0]
    sh = ctypes.byref(tabs.shard_table())
    stream = torch.cuda.current_stream().cuda_stream
    outs = {name: torch.empty((n, 4), dtype=torch.int64, device=dev)
            for name in libs}

    def launch(name):
        rc = libs[name].bwt_rank4_sh(sh, rows.data_ptr(), n,
                                     outs[name].data_ptr(), stream)
        if rc != 0:
            sys.exit(f"bwt_rank4_sh launch failed: {rc}")

    names = list(libs)
    times = {name: [] for name in names}
    for k in range(3):
        for name in (names if k % 2 == 0 else names[::-1]):
            outs[name].fill_(-1)
            launch(name)
            if not torch.equal(outs[name], want):
                sys.exit(f"bwt_rank4_sh on {what}: {name} != plain")
            times[name].append(round(cs.cuda_ms(
                lambda: launch(name), 20, sleep_cycles=4_000_000), 5))
    n_bytes = n * (48 + 8 + 32)
    bound = 1e3 * n_bytes / cs.PEAK_BYTES
    shares = times.items()
    print(f"bwt_rank4_sh bare launch on {what}: {n} rows, {n_bytes} B -> "
          f"bytes bound {bound:.5f} ms; ms by build {json.dumps(times)}; "
          f"share of the bound by build "
          f"{json.dumps({k: round(bound / min(v), 4) for k, v in shares})}",
          flush=True)


# The traceback walk of each version of csrc/global_sw.cuh, stubbed out
# for the fill-only builds: (text, replacement), the first that is found.
TRACEBACK_STUBS = (
    # the walk from the band-compressed plane (the steps are still written
    # out, all 3)
    ("      n = global_walk<kNibbles<C>>(plane, wn, tn, qn, wl, ops, &tail,\n"
     "                                   &n_tail);\n", ""),
    # the one-thread walk from global memory (the body before the band
    # window)
    ("  if (tg == 0) {\n    int i = tn - 1, k = qn - 1, which = 0;",
     "  if (tg < 0) {\n    int i = tn - 1, k = qn - 1, which = 0;"),
)
# name -> (BWT_GLOBAL_TABLE's rows or None for the committed ones, and
# (text, replacement) pairs for global_sw.cu or .cuh), built beside the
# committed sources with --sw: "narrow" is the table of narrow groups
# (several tasks a warp below 128 columns) that was timed against whole
# warps on `mem`'s rounds and dropped
LB_DEFAULT = [("__launch_bounds__(sw::kThreads, 1)",
               "__launch_bounds__(sw::kThreads)")]
NARROW_ROWS = [(16, 4, 4), (32, 8, 4), (40, 8, 5), (64, 8, 8), (128, 16, 8),
               (160, 32, 5), (192, 32, 6), (256, 32, 8)]
SW_TABLES = {
    "narrow": (NARROW_ROWS, []),
    "lb-default": (None, LB_DEFAULT),
}


def with_global_table(src, dst, rows, subs=()):
    """Copy the kernel sources with BWT_GLOBAL_TABLE's rows replaced
    (unless rows is None) and the (text, replacement) pairs `subs` made in
    global_sw.cu or global_sw.cuh."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build"))
    path = os.path.join(dst, "global_sw.cuh")
    with open(path) as f:
        text = f.read()
    if rows is not None:
        line = ("#define BWT_GLOBAL_TABLE(ROW) "
                + " ".join(f"ROW({', '.join(map(str, r))})" for r in rows)
                + "\n")
        pat = re.compile(r"#define BWT_GLOBAL_TABLE\(ROW\)(?:[^\n]*\\\n)*"
                         r"[^\n]*\n")
        text, n = pat.subn(lambda _: line, text)
        if not n:
            sys.exit(f"no BWT_GLOBAL_TABLE in {path}")
    with open(path, "w") as f:
        f.write(text)
    for a, b in subs:
        for name in ("global_sw.cu", "global_sw.cuh"):
            path = os.path.join(dst, name)
            with open(path) as f:
                text = f.read()
            if a in text:
                with open(path, "w") as f:
                    f.write(text.replace(a, b))
                break
        else:
            sys.exit(f"no {a!r} in {dst}/global_sw.cu[h]")


def with_traceback_stubbed(src, dst):
    """Copy the kernel sources with the traceback walk of global_sw.cuh
    left out (its steps are then not the plain version's)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build"))
    path = os.path.join(dst, "global_sw.cuh")
    with open(path) as f:
        text = f.read()
    for pat, rep in TRACEBACK_STUBS:
        if pat in text:
            with open(path, "w") as f:
                f.write(text.replace(pat, rep, 1))
            return
    sys.exit(f"no traceback walk to stub out in {path}")


def takes_band(csrc):
    """Whether the kernel sources in csrc take a band and an error word
    (bwt_global_cigar as committed) or neither (an earlier version's)."""
    with open(os.path.join(csrc, "global_sw.cu")) as f:
        return "void* err" in f.read()


def bind_global(lib, new):
    """The argument types of an earlier version's bwt_global_cigar (`new`
    False: no band, no error word); a library as committed keeps
    ops/_build.py's."""
    import ctypes

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if not new:
        lib.bwt_global_cigar_scratch.restype = i64
        lib.bwt_global_cigar_scratch.argtypes = [i32, i32, i64]
        lib.bwt_global_cigar.restype = i32
        lib.bwt_global_cigar.argtypes = [vp, i32, vp, vp, i32, vp, vp, i64,
                                         vp, vp, vp, vp, vp, vp]
    return new


def launch_row(csrc, band):
    """(G, C) of the row of csrc/global_sw.cuh's launch table that a round
    whose widest band is `band` takes (C 0: the memory row)."""
    import _torch_gate as gate

    rows = gate.global_launch_table(os.path.join(csrc, "global_sw.cuh"))
    return next(([g, c] for b, g, c in rows if band <= b), [32, 0])


def band_of(args):
    """The widest band of a round's lanes, min(2 w' + 1, qlen) with w' =
    max(w, |tlen - qlen|): what the host passes the kernel."""
    qlen, tlen, w = (np.asarray(args[k].cpu() if hasattr(args[k], "cpu")
                                else args[k]).astype(np.int64)
                     for k in (1, 3, 4))
    qn = np.clip(qlen, 0, args[0].shape[1])
    wp = np.maximum(w, np.abs(tlen - qlen))
    return int(np.minimum(2 * wp + 1, qn).max(initial=0))


# `mem --device-cigar` runs whose CIGAR rounds are captured: (the set's
# pairs, -b, the calls kept from each of PE and SE (None: all)).  -b 512
# gives rounds of 256-512 lanes; 2048 and 8192 1,024-8,192 (the 2,048
# pairs at -b 2048: chip_smoke.py's pe-dev rounds).
MEM_RUNS = ((2048, 512, None), (2048, 2048, None), (8192, 2048, 2),
            (8192, 8192, 1))
MEM_JOINED = (1024, 2048, 4096)   # the -b 512 rounds joined side by side


def mem_cigar_rounds(dev, tmp, cs):
    """The rounds that `mem --device-cigar` hands the CIGAR kernel on
    chip_smoke.py's device-protocol PE sets (its genome; MEM_RUNS), PE
    and SE, resident reference: each call's inputs kept as they reach
    ops/global_cuda.global_batch; then the -b 512 rounds joined side by
    side to MEM_JOINED lanes.  Returns [(name, tensors, band)]."""
    from bwamem_tpu_torch.ops import global_cuda

    fa, _, _, _ = cs.simulate(tmp, 1, 1)
    cs.run_cli(["index", fa], os.path.join(tmp, "index.log"))
    sets = {}
    kept, out = [], []
    orig = global_cuda.global_batch

    def keep(*args, **kw):
        kept.append(([x.clone() for x in args], kw.get("band")))
        return orig(*args, **kw)

    global_cuda.global_batch = keep
    try:
        for n_pairs, b, n_keep in MEM_RUNS:
            if n_pairs not in sets:
                sub = os.path.join(tmp, f"pairs{n_pairs}")
                os.makedirs(sub, exist_ok=True)
                sets[n_pairs] = cs.simulate_device_pairs(sub, fa, n_pairs)
            pe = sets[n_pairs]
            for label, reads in (("PE", pe), ("SE", pe[:1])):
                kept.clear()
                cs.run_cli(["mem", "--backend", "cuda", "--device-cigar",
                            "-b", str(b), fa, *reads],
                           os.path.join(tmp, f"{label}.sam"))
                out += [(f"mem {label} -b {b} ({n_pairs} pairs) round {k}",
                         t, band_of(t) if band is None else band)
                        for k, (t, band) in enumerate(kept[:n_keep])]
    finally:
        global_cuda.global_batch = orig
    small = [r for r in out if " -b 512 " in r[0]]
    for lanes in MEM_JOINED:
        t = join_rounds([r[1] for r in small], lanes)
        out.append((f"mem -b 512 rounds joined to {t[0].shape[0]} lanes", t,
                    band_of(t)))
    return out


def join_rounds(rounds, lanes):
    """One CIGAR round of at least `lanes` lanes out of `rounds` (the
    arguments of ops/global_cuda.global_batch each, one scoring), taken in
    turn from the first: the windows padded with N (code 4) to the
    largest of each, so every lane keeps its own inputs."""
    import torch

    parts, n = [], 0
    while n < lanes:
        parts.append(rounds[len(parts) % len(rounds)])
        n += parts[-1][0].shape[0]
    out = []
    for k in range(5):
        if k in (0, 2):    # the (B, window) query and target
            cols = max(p[k].shape[1] for p in parts)
            out.append(torch.cat([torch.nn.functional.pad(
                p[k], (0, cols - p[k].shape[1]), value=4) for p in parts]))
        else:
            out.append(torch.cat([p[k] for p in parts]))
    return [x.contiguous() for x in out] + list(parts[0][5:])


def time_sw_kernels(libs, fill_libs, srcs, dev, tmp, cs):
    """bwt_global_cigar of each library (and of its fill-only copy) on the
    dev-fn round, the hard-case round and `mem`'s rounds, in turns (each
    build, then the reverse order), 20 launches a time with a sleep
    kernel queued first; every output == the committed build's, which ==
    the plain version's.  srcs: each library's kernel sources."""
    import torch

    import _torch_gate as gate
    from bwamem_tpu_torch.ops import global_torch

    new = {name: bind_global(lib, takes_band(srcs[name]))
           for name, lib in libs.items()}
    new.update({name + ":fill": bind_global(lib, new[name])
                for name, lib in fill_libs.items()})
    stream = torch.cuda.current_stream().cuda_stream
    glob = cs.dev_fn_batches()[1]
    hard = gate.global_sw_batch(32, *cs.SW_GLOBAL_SHAPE, n_pad=64)
    rounds = [(f"dev-fn round {cs.SW_GLOBAL_SHAPE}", glob, band_of(glob)),
              (f"hard-case round {cs.SW_GLOBAL_SHAPE}", hard,
               band_of(hard))]
    rounds = [(name, [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in args], band) for name, args, band in rounds]
    rounds += mem_cigar_rounds(dev, tmp, cs)

    def outputs(name, lib, t, band):
        q, _, tt = t[:3]
        B, qmax, tmax = q.shape[0], q.shape[1], tt.shape[1]
        n = (lib.bwt_global_cigar_scratch(qmax, tmax, band, B) if new[name]
             else lib.bwt_global_cigar_scratch(qmax, tmax, B))
        return (torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty((qmax + tmax, B), dtype=torch.int8, device=dev),
                torch.empty(max(int(n), 1), dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    def launch(name, lib, t, band, out):
        q, qlen, tt, tlen, w, mat, pens = t
        B, qmax, tmax = q.shape[0], q.shape[1], tt.shape[1]
        score, steps, scratch, err = out
        head = (q.data_ptr(), qmax, qlen.data_ptr(), tt.data_ptr(), tmax,
                tlen.data_ptr(), w.data_ptr(), B)
        outs = (mat.data_ptr(), pens.data_ptr(), score.data_ptr(),
                steps.data_ptr())
        tail = (scratch.data_ptr(), stream)
        rc = (lib.bwt_global_cigar(*head, band, *outs, err.data_ptr(), *tail)
              if new[name] else lib.bwt_global_cigar(*head, *outs, *tail))
        if rc != 0:
            sys.exit(f"bwt_global_cigar ({name}) launch failed: {rc}")

    builds = {**libs, **{n + ":fill": lib for n, lib in fill_libs.items()}}
    names = list(builds)
    mem_sum = {name: 0.0 for name in names}
    for what, t, band in rounds:
        want = global_torch.global_batch(*t)
        q, qlen, tt, tlen, w = (x.cpu().numpy() for x in t[:5])
        outs = {name: outputs(name, builds[name], t, band)
                for name in names}
        times = {name: [] for name in names}
        for k in range(2):
            for name in (names if k == 0 else names[::-1]):
                lib, out = builds[name], outs[name]
                out[1].fill_(-7)
                launch(name, lib, t, band, out)
                if out[3].item():
                    sys.exit(f"{what}: bwt_global_cigar ({name}) flagged "
                             f"band {band}")
                if not name.endswith(":fill") and not (
                        torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])):
                    sys.exit(f"{what}: bwt_global_cigar ({name}) != plain")
                times[name].append(round(cs.cuda_ms(
                    lambda: launch(name, lib, t, band, out), 20,
                    sleep_cycles=4_000_000), 4))
        cells = cs.global_cells((q, qlen, tt, tlen, w))
        qn = np.clip(qlen, 0, q.shape[1]).astype(np.int64)
        tn = np.clip(tlen, 0, tt.shape[1]).astype(np.int64)
        rect = int(qn @ tn)
        chain = int((want[1] != 3).sum(0).max())
        shapes = {name: launch_row(srcs[name], band)
                  + [int(outs[name][2].numel() == 1)]
                  for name in names
                  if new[name] and not name.endswith(":fill")}
        print(f"{what}: B={q.shape[0]}, (qmax, tmax)=({q.shape[1]}, "
              f"{tt.shape[1]}), {int((qlen > 0).sum())} live lanes, {cells} "
              f"band cells of {rect} in the qlen x tlen rectangles "
              f"({100 * cells / max(rect, 1):.1f}%), widest band {band}, "
              f"longest traceback chain {chain} steps, operations bound "
              f"{cs.ops_bound_ms(cells, 1):.4f} ms; launch (G, C, plane in "
              f"shared memory) {json.dumps(shapes)}; ms by build "
              f"{json.dumps(times)}", flush=True)
        if what.startswith("mem"):
            for name in names:
                mem_sum[name] += sum(times[name]) / len(times[name])
    print(f"the {sum(w.startswith('mem') for w, _, _ in rounds)} mem rounds "
          f"taken together (the mean of each round's times, summed): ms by "
          f"build {json.dumps({k: round(v, 4) for k, v in mem_sum.items()})}",
          flush=True)
    time_local(libs, dev, cs)


def time_local(libs, dev, cs):
    """bwt_local_align6 of each library on chip_smoke.py's dev-fn wave
    (8192, 160, 512), in turns, each output == the committed build's: the
    rescue kernel beside the CIGAR kernel's changes."""
    import torch

    wave = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in cs.dev_fn_batches()[0]]
    q, qlen, t, tlen, mat, pens = wave
    B, qmax, tmax = q.shape[0], q.shape[1], t.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}
    for name, lib in libs.items():
        n = lib.bwt_local_align6_scratch(qmax, tmax, B)
        outs[name] = (torch.empty((6, B), dtype=torch.int32, device=dev),
                      torch.empty(max(int(n), 1), dtype=torch.uint8,
                                  device=dev))

    def launch(name):
        out, scratch = outs[name]
        rc = libs[name].bwt_local_align6(
            q.data_ptr(), qmax, qlen.data_ptr(), t.data_ptr(), tmax,
            tlen.data_ptr(), B, mat.data_ptr(), pens.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), stream)
        if rc != 0:
            sys.exit(f"bwt_local_align6 ({name}) launch failed: {rc}")

    names = list(libs)
    launch(names[0])
    want = outs[names[0]][0].clone()
    times = {name: [] for name in names}
    for k in range(2):
        for name in (names if k == 0 else names[::-1]):
            launch(name)
            if not torch.equal(outs[name][0], want):
                sys.exit(f"bwt_local_align6 ({name}) != committed")
            times[name].append(round(cs.cuda_ms(
                lambda: launch(name), 20, sleep_cycles=4_000_000), 4))
    print(f"bwt_local_align6 on the dev-fn wave {cs.SW_LOCAL_SHAPE}: ms by "
          f"build {json.dumps(times)}", flush=True)


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
    sw = "--sw" in argv
    pick = next((argv[k + 1].split(",") for k, a in enumerate(argv)
                 if a == "--tables"), None)
    # (with --seed and --sw, the committed build and --tables' picks of
    # SW_TABLES)
    sources = {name: _build.CSRC for name in TABLES
               if (seed or sw) and name == "committed"
               or not (seed or sw) and (pick is None or name in pick)}
    tables = {name: TABLES[name] for name in sources}
    for k, arg in enumerate(argv):
        if arg == "--against":
            name = "against" if "against" not in sources else \
                "against:" + argv[k + 1].rstrip("/")
            sources[name] = argv[k + 1]
            tables[name] = (None, None)
    for name, table in tables.items():
        csrc = os.path.join(tmp, name)
        with_table(sources[name], csrc, table)
        kl = _build.build(csrc, os.path.join(csrc, "build"), bind_present)
        libs[name] = kl.lib
        print(f"{name}: built in {kl.build_seconds:.1f}s; "
              f"{cs.ptxas_summary(kl.log)}", flush=True)
        if (name == "committed" or name.startswith("against")) \
                and not (seed or sw):
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

    def binned(lib, fn, windows, scal, rows, prm):
        """`call` with the lanes binned by length: permuted on the device
        into order of their target length (both sides' for the fused
        kernel), run, and put back in lane order."""
        key = scal[1] + (scal[6] if rows == 32 else 0)
        order = torch.argsort(key, descending=True)
        out = call(lib, fn, [w[:, order] for w in windows], scal[:, order],
                   rows, prm)
        back = torch.empty_like(out)
        back[:, order] = out
        return back

    def on_dev(*arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]

    if seed:
        time_seed_kernels(libs, dev)
        shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if sw:
        srcs = {name: os.path.join(tmp, name) for name in libs}
        tables = {name: v for name, v in SW_TABLES.items()
                  if pick is None or name in pick}
        for name, (rows, subs) in tables.items():
            csrc = os.path.join(tmp, "sw_" + name)
            with_global_table(_build.CSRC, csrc, rows, subs)
            kl = _build.build(csrc, os.path.join(csrc, "build"),
                              bind_present)
            libs[name] = kl.lib
            srcs[name] = csrc
            print(f"{name} (BWT_GLOBAL_TABLE {rows or 'as committed'}, in "
                  f"global_sw.cu {subs or 'nothing'} changed): built in "
                  f"{kl.build_seconds:.1f}s; "
                  f"{cs.ptxas_summary(kl.log)}", flush=True)
        fill_libs = {}
        for name in [n for n in libs if n not in tables]:
            csrc = os.path.join(tmp, name.replace(":", "_") + "_fill")
            with_traceback_stubbed(os.path.join(tmp, name), csrc)
            kl = _build.build(csrc, os.path.join(csrc, "build"),
                              bind_present)
            fill_libs[name] = kl.lib
            print(f"{name}:fill (traceback stubbed out): built in "
                  f"{kl.build_seconds:.1f}s", flush=True)
        time_sw_kernels(libs, fill_libs, srcs, dev, tmp, cs)
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
    batches += mem_batches(dev, tmp, cs)
    names = list(libs)
    for what, fn, tensors, prm, per_op in batches:
        *windows, scal_d = tensors
        rows = 8 if fn.startswith("bwt_extend_t") else 32
        plain = (extend_torch.extend_t if rows == 8
                 else extend_torch.extend_fused)
        cells = [0]
        dt = torch.int16 if fn.endswith("_i16") else torch.int32
        want = plain(*tensors, None, prm, cells=cells, compute_dtype=dt)
        have = [name for name in names if hasattr(libs[name], fn)]
        # each build once more with the lanes binned by length
        runs = [(name, name, call) for name in have] + [
            (name + "+binned", name, binned) for name in have]
        times = {name: [] for name, _, _ in runs}
        for k in range(2):      # in turns, then in the reverse order
            for name, lib_name, run in (runs if k == 0 else runs[::-1]):
                lib = libs[lib_name]
                got = run(lib, fn, windows, scal_d, rows, prm)
                if not torch.equal(got, want):
                    sys.exit(f"{what}: table {name} != plain")
                times[name].append(round(cs.cuda_ms(
                    lambda: run(lib, fn, windows, scal_d, rows, prm), 20),
                    4))
        bound = cs.ops_bound_ms(cells[0], per_op)
        rect = rectangle_cells(scal_d.cpu().numpy(), want.cpu().numpy(),
                               windows)
        print(f"{what}: B={scal_d.shape[1]}, {cells[0]} band cells of "
              f"{rect} in the qlen x tlen rectangles of the passes run "
              f"({100 * cells[0] / max(rect, 1):.1f}%), bound {bound:.4f} ms "
              f"({per_op} cell(s) an operation), "
              f"ms by table {json.dumps(times)}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


def rectangle_cells(scal, out, windows):
    """Cells of the qlen x tlen rectangles of the passes that ran (qlen
    clipped to its window; a retry where its first pass did not
    converge), from the (8, B) or (16, B) scalars and the results."""
    def rect(qlen, tlen, h0, qmax, ran):
        ok = ran & (qlen > 0) & (tlen > 0) & (h0 > 0)
        return int((np.minimum(qlen, qmax).astype(np.int64)
                    * tlen)[ok].sum())

    if scal.shape[0] == 8:
        return rect(scal[0], scal[1], scal[3], windows[0].shape[0], True)
    thr = (scal[9] >> 1) + (scal[9] >> 2)
    QL, QR = windows[0].shape[0], windows[2].shape[0]
    conv_l = out[5] < thr
    h0_r = np.where(conv_l, out[0], out[8])
    return (rect(scal[0], scal[1], scal[3], QL, True)
            + rect(scal[0], scal[1], scal[3], QL, ~conv_l)
            + rect(scal[5], scal[6], h0_r, QR, True)
            + rect(scal[5], scal[6], h0_r, QR, out[21] >= thr))


def mem_batches(dev, tmp, cs):
    """The batches that chip_smoke.py's 16-bit path hands its kernels:
    its first MEM_SE SE reads (the main set's genome and reads) through
    NativePipeline with the 16-bit resident fused backend and the 16-bit
    four-pass backend, -b 2048 chunks, each launch's inputs kept.
    Returns them as (name, entry, tensors, prm, cells an operation)
    twice: 16-bit cells and 32-bit cells on the same inputs."""
    import torch

    from bwamem_tpu_torch.__main__ import load_index
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.io.fastq import iter_fastq_chunks
    from bwamem_tpu_torch.ops import extend_cuda
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.pipeline import native_driver, resident

    fa, se, _, _ = cs.simulate(tmp)
    with open(os.path.join(tmp, "index.log"), "w") as log:
        cs.run_cli(["index", fa], log.name)
    opt = MemOptions()
    params = params_from_options(opt)
    ref, fm = load_index(fa)
    pipe = native_driver.NativePipeline(opt, ref, fm, pack_occ(fm),
                                        nthreads=min(os.cpu_count() or 1, 8))
    chunks, n = [], 0
    for chunk in iter_fastq_chunks(se, 2048):
        chunks.append(chunk)
        n += len(chunk)
        if n >= MEM_SE:
            break
    kept = []
    out = []
    for entry, make in (
            ("bwt_extend_fused", lambda: resident.make_fused_idx_backend(
                params, ref.pac, dev, compute_dtype=torch.int16)),
            ("bwt_extend_t", lambda: native_driver.make_raw_t_backend(
                params, dev, compute_dtype=torch.int16))):
        attr = ("extend_batch_raw_fused" if entry == "bwt_extend_fused"
                else "extend_batch_raw_t")
        orig = getattr(extend_cuda, attr)

        def keep(*args, _orig=orig, **kw):
            n_win = 4 if _orig.__name__.endswith("fused") else 2
            kept.append([x.clone() for x in args[:n_win + 1]] + [args[-1]])
            return _orig(*args, **kw)

        kept.clear()
        setattr(extend_cuda, attr, keep)
        try:
            fn = make()
            for chunk in chunks:
                pipe.align_chunk_text(
                    [r.seq.astype(np.int64) for r in chunk], fn,
                    names=[r.name for r in chunk],
                    quals=[r.qual for r in chunk])
        finally:
            setattr(extend_cuda, attr, orig)
        # and the first launch with its lanes twice over: as many lanes as
        # the gate, the same rows; then the launches side by side (in turn,
        # from the first) up to MEM_LANES lanes each, the mem batch of a
        # larger -b, which the 16-bit table's lane-count rows take
        first = [torch.cat([x, x], 1) for x in kept[0][:-1]] + kept[0][-1:]
        joined = [join_launches(kept, n) for n in MEM_LANES]
        for k, args in enumerate(kept + [first] + joined):
            *tensors, prm = args
            what = (f"launch {k}" if k < len(kept) else "launch 0 x2 lanes"
                    if k == len(kept) else
                    f"launches joined to {tensors[-1].shape[1]} lanes")
            for tag, suffix, per_op in ((", 16-bit cells", "_i16", 2),
                                        ("", "", 1)):
                out.append((f"mem 16-bit path {entry[4:]} {what}{tag}",
                            entry + suffix, tensors, prm, per_op))
    return out


def join_launches(kept, lanes):
    """One launch of at least `lanes` lanes out of the kept launches'
    inputs ([windows..., scalars, prm] each), taken in turn from the
    first: the windows padded with N (code 4) to the largest of each, so
    every lane keeps its own inputs (no kernel reads a window past its
    lane's qlen or tlen)."""
    import torch

    parts, n = [], 0
    while n < lanes:
        parts.append(kept[len(parts) % len(kept)])
        n += parts[-1][-2].shape[1]
    cols = []
    for k in range(len(parts[0]) - 1):
        rows = max(p[k].shape[0] for p in parts)
        cols.append(torch.cat([
            p[k] if p[k].shape[0] == rows else
            torch.cat([p[k], p[k].new_full((rows - p[k].shape[0],
                                            p[k].shape[1]), 4)])
            for p in parts], 1))
    return cols + [parts[0][-1]]


if __name__ == "__main__":
    sys.exit(main())
