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
    pick = next((argv[k + 1].split(",") for k, a in enumerate(argv)
                 if a == "--tables"), None)
    sources = {name: _build.CSRC for name in TABLES
               if (name == "committed" or not seed)
               and (pick is None or name in pick)}
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
                and not seed:
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
