"""Command-line interface of the port — the `bwa` drop-in surface on an
NVIDIA GPU.

  python -m bwamem_tpu_torch index ref.fa
  python -m bwamem_tpu_torch mem [-t N] [-b BATCH] [--inflight N] \
         [--backend cuda|torch|scalar] [--host auto|native|python] \
         [--phased | --ship-ref] [--device-rescue] [--device-cigar] \
         [--device-seed] ref.fa reads.fq [mates.fq] > out.sam
  python -m bwamem_tpu_torch merge out.sam shard0.sam shard1.sam ...

`index` and `merge` run no device code; the index cache file keeps the
JAX package's format, so an index built by either package loads in the
other.  `mem --backend cuda` runs the hand-written kernels on the GPU,
`--backend torch` their plain PyTorch versions on the CPU, and
`--backend scalar` the pure host with no batched extension.  The
native C++ host (the default) drives the resident-reference fused
extension, or with `--ship-ref` the fused kernel fed from host-filled
windows, or with `--phased` the four-pass protocol of per-phase
launches.  `--host python` runs the Python host (plan, replay and
pairing in Python) with the port's batched extension.
`--device-rescue` runs the mate-rescue local alignments of the native PE
path on the device, `--device-cigar` the banded global realignments that
give the CIGARs (native host, SE and PE; Python host, SE): from the
device-resident reference, or with `--ship-ref` from windows the host
ships.  There is no fallback between hosts: the native host exits 1 when
its C++ library is unavailable.  `--device-seed` (native host) runs the
SMEM search and the SA walks of every chunk on the device: the CUDA
kernels with `--backend cuda`, their plain versions on the CPU with
`--backend torch`.  The JAX package's backend names (`jax`, `pallas`)
exit non-zero and name the port's counterparts.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# the JAX package's device backends -> the port's counterparts
_BACKEND_COUNTERPART = {"jax": "torch", "pallas": "cuda"}


def not_ported(args) -> str | None:
    """Why `args` asks for a path the port does not have, or None."""
    if args.backend in _BACKEND_COUNTERPART:
        return (f"--backend {args.backend} is the JAX package's; the "
                f"port's counterpart is --backend "
                f"{_BACKEND_COUNTERPART[args.backend]} (ROADMAP Queue 1 "
                f"item 4)")
    return None


def python_host(args) -> bool:
    """--host python, or --backend scalar (a pure host path, as in the
    JAX package)."""
    return args.host == "python" or args.backend == "scalar"


def bad_combination(args) -> str | None:
    """Why the options contradict each other, or None."""
    if args.phased and args.ship_ref:
        return "--phased and --ship-ref choose different native backends"
    if python_host(args) and (args.phased or args.ship_ref):
        return ("--phased and --ship-ref select native-host backends; "
                "the Python host (--host python, --backend scalar) has "
                "its own")
    if not (0 <= args.A <= 127 and 0 <= args.B <= 127):
        # the CUDA kernels keep a row's substitution scores as signed
        # bytes (extend_cuda.kernel_prm); every backend refuses alike
        return f"-A {args.A} or -B {args.B} outside 0..127"
    return None


def cmd_index(args) -> int:
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.io.fasta import read_fasta

    ref = read_fasta(args.fasta)
    sys.stderr.write(
        f"[index] {len(ref.contigs)} contig(s), {ref.l_pac} bp\n")
    fm = build_index(ref.pac, sa_intv=args.sa_intv)
    out = args.fasta + ".bwt.npz"
    # uncompressed: zlib over a GRCh38-scale index costs many minutes
    # and bwa's own index files are raw; np.load reads either format
    np.savez(
        out,
        l_pac=fm.l_pac, seq_len2=fm.seq_len2, primary=fm.primary,
        C=fm.C, bwt=fm.bwt, occ_cp=fm.occ_cp, sa_intv=fm.sa_intv,
        ssa=fm.ssa, pac=fm.pac,
        names=np.array([c.name for c in ref.contigs]),
        offsets=np.array([c.offset for c in ref.contigs]),
        lengths=np.array([c.length for c in ref.contigs]),
    )
    sys.stderr.write(f"[index] wrote {out}\n")
    return 0


def load_index(fasta: str):
    from bwamem_tpu_torch.index.build import FMIndex
    from bwamem_tpu_torch.io.fasta import Contig, Reference

    path = fasta + ".bwt.npz"
    if not os.path.exists(path):
        sys.stderr.write(f"[mem] no index at {path}; run `index` first\n")
        raise SystemExit(1)
    z = np.load(path, allow_pickle=False)
    fm = FMIndex(
        l_pac=int(z["l_pac"]), seq_len2=int(z["seq_len2"]),
        primary=int(z["primary"]), C=z["C"], bwt=z["bwt"],
        occ_cp=z["occ_cp"], sa_intv=int(z["sa_intv"]), ssa=z["ssa"],
        pac=z["pac"])
    contigs = [Contig(str(n), int(o), int(l)) for n, o, l in
               zip(z["names"], z["offsets"], z["lengths"])]
    return Reference(contigs=contigs, pac=z["pac"]), fm


def _parse_isize(spec):
    """-I FLOAT[,FLOAT[,INT[,INT]]]: mean, std (10% of mean if
    absent), max (mean+4*std if absent), min of the insert-size
    distribution (bwa mem -I)."""
    if not spec:
        return {}
    parts = spec.split(",")
    out = {"pe_mean": float(parts[0])}
    if len(parts) > 1:
        out["pe_std"] = float(parts[1])
    if len(parts) > 2:
        out["pe_max"] = int(parts[2])
    if len(parts) > 3:
        out["pe_min"] = int(parts[3])
    return out


def cmd_merge(args) -> int:
    import tempfile

    from bwamem_tpu_torch.parallel.multihost import merge_sam_files

    if args.out == "-":
        with tempfile.NamedTemporaryFile("r", suffix=".sam",
                                         delete=False) as tf:
            tmp = tf.name
        n = merge_sam_files(args.shards, tmp)
        with open(tmp) as f:
            for line in f:
                sys.stdout.write(line)
        os.unlink(tmp)
    else:
        n = merge_sam_files(args.shards, args.out)
    sys.stderr.write(f"[merge] {n} records from {len(args.shards)} "
                     f"shard(s)\n")
    return 0


def mem_device(args):
    """The torch.device of `mem`'s backends: the CPU for --backend torch
    or scalar; for --backend cuda the card that LOCAL_RANK names (one
    process a card under `torchrun`), else the current card.  Raises
    RuntimeError without a GPU, ValueError when LOCAL_RANK names no
    visible card."""
    from bwamem_tpu_torch.device import resolve

    if args.backend != "cuda":
        return resolve("cpu")
    import torch

    from bwamem_tpu_torch.parallel.multihost import local_cuda_device

    return resolve(local_cuda_device(os.environ.get("LOCAL_RANK"),
                                     torch.cuda.device_count()))


def make_backends(opt, args, pac, paired, device, tracer=None):
    """(extension, rescue, CIGAR) backends that `args` selects, on
    `device`: the GPU (`cuda`) or the CPU (`torch`).  Extension: for the
    Python host an extend_batch_fn (None for `scalar`); for the native
    host the callable NativePipeline drives (per-phase with --phased,
    host-shipped fused with --ship-ref, else resident-reference fused).
    Rescue (--device-rescue, native PE) and CIGAR (--device-cigar,
    native host) are None where the host does that work; with --ship-ref
    they take windows from the host, else they gather them from the one
    resident text that every idx backend shares; `tracer` gives the idx
    backends' calls their spans."""
    from bwamem_tpu_torch.ops.types import params_from_options

    if args.backend == "scalar":
        return None, None, None
    params = params_from_options(opt)
    if python_host(args):
        from bwamem_tpu_torch.ops import extend

        return extend.make_raw_backend(params, device), None, None
    from bwamem_tpu_torch.pipeline import native_driver, resident

    want_rescue = args.device_rescue and paired
    # one resident two-strand text shared by every idx backend
    text_dev = None
    if not args.ship_ref and (not args.phased or args.device_cigar
                              or want_rescue):
        text_dev = resident.make_resident_text(pac, device)
    if args.phased:
        ext_fn = native_driver.make_raw_t_backend(params, device)
    elif args.ship_ref:
        ext_fn = native_driver.make_fused_backend(params, device)
    else:
        ext_fn = resident.make_fused_idx_backend(params, pac, device,
                                                 text_dev=text_dev,
                                                 tracer=tracer)
    rescue_fn = cigar_fn = None
    if args.device_cigar:
        if args.ship_ref:
            from bwamem_tpu_torch.ops.global_torch import make_cigar_backend

            cigar_fn = make_cigar_backend(device)
        else:  # resident-reference rounds: meta-only H2D
            cigar_fn = resident.make_cigar_idx_backend(
                pac, device, text_dev=text_dev, tracer=tracer)
    if want_rescue:
        if args.ship_ref:
            from bwamem_tpu_torch.ops.local_torch import make_rescue_backend

            rescue_fn = make_rescue_backend(device)
        else:  # resident-reference batches: meta-only H2D
            rescue_fn = resident.make_rescue_idx_backend(
                pac, device, text_dev=text_dev, tracer=tracer)
    return ext_fn, rescue_fn, cigar_fn


def cmd_mem(args) -> int:
    import contextlib

    from bwamem_tpu_torch.parallel import multihost

    with contextlib.ExitStack() as cleanup:
        # the process group init_distributed joined; the trace, last in
        # first out, also when the run fails
        cleanup.callback(multihost.destroy)
        return _mem(args, cleanup)


def _mem(args, cleanup) -> int:
    import time

    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.occ_packed import pack_occ
    from bwamem_tpu_torch.io.fastq import iter_fastq_chunks
    from bwamem_tpu_torch.io.sam import sam_header
    from bwamem_tpu_torch.pipeline import native_driver
    from bwamem_tpu_torch.utils.metrics import Tracer, span

    why = not_ported(args) or bad_combination(args)
    if why:
        sys.stderr.write(f"[mem] {why}\n")
        return 2
    on_python = python_host(args)
    if not on_python and not native_driver.available():
        sys.stderr.write("[mem] the native host library is unavailable "
                         "(g++ build of csrc/ failed)\n")
        return 1
    opt = MemOptions(flag_M=args.M, flag_a=args.a, w=args.w,
                     min_seed_len=args.k, T=args.T,
                     a=args.A, b=args.B, o_del=args.O, o_ins=args.O,
                     e_del=args.E, e_ins=args.E, zdrop=args.d,
                     pen_clip5=args.L, pen_clip3=args.L,
                     pen_unpaired=args.U, split_factor=args.r,
                     max_occ=args.c,
                     max_matesw=0 if args.S else 100,
                     skip_pairing=args.P,
                     **_parse_isize(args.I))
    ref, fm = load_index(args.fasta)
    paired = bool(args.mates or args.p)
    # what the JAX package's CLI says where a flag has no effect
    if args.device_cigar and args.backend != "scalar" and paired \
            and on_python:
        sys.stderr.write("[mem] --device-cigar for PE needs the native "
                         "host; ignored here\n")
    if args.device_cigar and args.backend == "scalar":
        sys.stderr.write("[mem] --device-cigar needs a device backend; "
                         "ignored here\n")
    if args.device_rescue and (not paired or on_python):
        sys.stderr.write("[mem] --device-rescue applies to the native PE "
                         "path; ignored here\n")
    tracer = None
    if args.trace:
        tracer = Tracer(args.trace)
        cleanup.callback(tracer.close)
    try:
        device = mem_device(args)
        ext_fn, rescue_fn, cigar_fn = make_backends(opt, args, ref.pac,
                                                    paired, device, tracer)
    except (RuntimeError, ValueError) as e:
        # --backend cuda without a GPU, or LOCAL_RANK beyond the cards
        sys.stderr.write(f"[mem] {e}\n")
        return 1
    po = pack_occ(fm)
    seed_fn = None
    if args.device_seed:
        if on_python:
            sys.stderr.write("[mem] --device-seed needs the native host "
                             "and a device backend; ignored here\n")
        elif po.n_rows >= 1 << 31:
            sys.stderr.write("[mem] --device-seed: reference too large "
                             "for int32 device positions; using host "
                             "seeding\n")
        elif args.backend == "cuda":
            from bwamem_tpu_torch.ops import smem_cuda

            seed_fn = smem_cuda.make_device_seeder(po, fm, opt, device,
                                                   threads=args.t)
        else:
            from bwamem_tpu_torch.ops import smem_torch

            seed_fn = smem_torch.make_device_seeder(po, fm, opt, device,
                                                    threads=args.t)
    chunks = None
    pair_iter = None
    if args.p and not args.mates:
        # -p: one file of interleaved pairs — de-interleave per chunk
        def deinterleave(chunks):
            for c in chunks:
                with span(tracer, "input.parse"):
                    ends = c[0::2], c[1::2]
                yield ends

        pair_iter = deinterleave(iter_fastq_chunks(args.reads, 2 * args.b,
                                                   tracer=tracer))
    elif args.mates:
        pair_iter = zip(iter_fastq_chunks(args.reads, args.b, tracer=tracer),
                        iter_fastq_chunks(args.mates, args.b, tracer=tracer))
    else:
        chunks = iter_fastq_chunks(args.reads, args.b, tracer=tracer)
    # each process aligns the strided shard_reads assignment and writes
    # its own SAM; `merge` restores input order byte-identically.
    # --shard K/N is explicit; else the torch.distributed environment
    # (MASTER_ADDR and WORLD_SIZE set, e.g. by torchrun) gives the rank
    from bwamem_tpu_torch.parallel import multihost

    if args.shard:
        shard_id, n_shards = (int(x) for x in args.shard.split("/"))
        if not 0 <= shard_id < n_shards:
            sys.stderr.write(f"[mem] bad --shard {args.shard}\n")
            return 1
    else:
        shard_id, n_shards = multihost.init_distributed()
    if n_shards > 1:
        if pair_iter is not None:
            pair_iter = multihost.shard_pair_stream(pair_iter, shard_id,
                                                    n_shards, args.b)
        else:
            chunks = multihost.shard_chunk_stream(chunks, shard_id,
                                                  n_shards, args.b)
        sys.stderr.write(f"[mem] shard {shard_id}/{n_shards} "
                         f"(strided)\n")
    out = sys.stdout
    out.write(sam_header(ref.contigs, rg_line=args.R,
                         pg_cl=" ".join(sys.argv)))
    # bwa attaches RG:Z:<ID> to every record when -R carries an ID
    rg_id = None
    if args.R:
        for f in args.R.replace("\\t", "\t").split("\t"):
            if f.startswith("ID:"):
                rg_id = f[3:]
                break
    manifest = None
    if args.resume:
        from bwamem_tpu_torch.utils.checkpoint import Manifest, ReadRange

        manifest = Manifest(args.resume)

    def emit(rec, comments=None) -> None:
        """Write one record; -C appends the FASTQ comment of the end
        the record belongs to (native records already carry RG:Z)."""
        line = rec.line()
        if rg_id and on_python:
            line += "\tRG:Z:" + rg_id
        if comments is not None:
            cm = comments[1] if (rec.flag & 0x80) else comments[0]
            if cm:
                line += "\t" + cm
        out.write(line + "\n")

    # the Python host runs one chunk at a time
    depth = max(args.inflight, 1) if pair_iter is None and not on_python \
        else 1
    pipes = [] if on_python else [native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=args.t, tracer=tracer,
        bucket_split=args.bucket_split) for _ in range(depth)]
    for p_ in pipes:
        p_.seed_fn = seed_fn
        if rg_id:
            p_.set_rg(rg_id)
    n_rec = 0
    n_reads = 0
    t_align0 = time.time()  # align-loop wall: excludes index load and
    #                         backend/reference-residency setup
    # steady-state mark: the first completed chunk absorbs the kernel
    # build, so the steady rate is measured from its completion
    steady = [None, 0, 0]  # [t_first_done, reads_at_first_done, chunks]

    def mark_chunk_done(reads_done: int) -> None:
        steady[2] += 1
        if steady[0] is None:
            steady[0] = time.time()
            steady[1] = reads_done

    if tracer is not None:
        tracer.chunk = 0           # the first chunk's input
    if pair_iter is not None:
        # the native host runs the full PE chunk in C++ (pestat, mate
        # rescue, pairing, sam_pe); the Python host runs pair.align_pairs
        from bwamem_tpu_torch.pipeline.pair import align_pairs

        for ci, (chunk, mchunk) in enumerate(pair_iter):
            if tracer is not None:
                tracer.chunk = ci
            if len(chunk) != len(mchunk):
                raise ValueError("read/mate count mismatch")
            start = n_reads // 2
            n_reads += len(chunk) * 2
            if manifest is not None:
                rr = ReadRange(0, start, start + len(chunk))
                if manifest.is_done(rr):
                    continue
            with span(tracer, "chunk.prep"):
                if on_python:
                    kw = dict(names=[r.name for r in chunk],
                              quals1=[r.qual for r in chunk],
                              quals2=[m.qual for m in mchunk])
                    seqs1 = [r.seq.astype(np.int64) for r in chunk]
                    seqs2 = [m.seq.astype(np.int64) for m in mchunk]
                else:
                    # the native host takes the batches' columns
                    seqs1, seqs2, kw = chunk, mchunk, {}
            text = None
            if on_python:
                recs = align_pairs(opt, ref, fm, seqs1, seqs2, po=po,
                                   extend_batch_fn=ext_fn, **kw)
            elif not args.C:
                # zero-object fast path: one pre-terminated text blob
                text, nr_ = pipes[0].align_pairs_chunk_text(
                    seqs1, seqs2, ext_fn, rescue_fn=rescue_fn,
                    cigar_fn=cigar_fn, **kw)
                n_rec += nr_
                recs = []
            else:
                recs = pipes[0].align_pairs_chunk(
                    seqs1, seqs2, ext_fn, rescue_fn=rescue_fn,
                    cigar_fn=cigar_fn, **kw)
            with span(tracer, "sam.write"):
                if text is not None:
                    out.write(text)
                for gi, rr_ in enumerate(recs):
                    cms = ((chunk[gi].comment, mchunk[gi].comment)
                           if args.C else None)
                    for rec in rr_:
                        emit(rec, cms)
                        n_rec += 1
            if manifest is not None:
                manifest.mark_done(rr)
            mark_chunk_done(n_reads)
            if args.v >= 3:
                sys.stderr.write(f"[mem] processed {n_reads} reads\n")
            if tracer is not None:
                tracer.chunk = ci + 1   # the next chunk's input
    else:
        # --inflight pipeline handles: chunk n+1's host work (C++,
        # GIL-free) overlaps chunk n's device work
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from bwamem_tpu_torch.pipeline import align as A
        from bwamem_tpu_torch.pipeline.driver import align_batch

        def run_chunk(ci, chunk):
            """The chunk's SAM as (text, records) from the native fast
            path, else as per-read record lists."""
            if tracer is not None:
                tracer.chunk = ci          # this worker thread's chunk
            with span(tracer, "chunk.prep"):
                if on_python:
                    seqs = [r.seq.astype(np.int64) for r in chunk]
                    kw = dict(names=[r.name for r in chunk],
                              quals=[r.qual for r in chunk])
                else:
                    # the native host takes the batch's columns
                    seqs, kw = chunk, {}
            if on_python and ext_fn is None:
                return [A.align_read(opt, ref, fm, r.name, sq, r.qual)
                        for r, sq in zip(chunk, seqs)]
            if on_python:
                return align_batch(opt, ref, fm, seqs, ext_fn, po=po,
                                   device_cigar=args.device_cigar,
                                   device=device, **kw)
            pipe_ = pipes[ci % len(pipes)]
            if not args.C:
                return pipe_.align_chunk_text(seqs, ext_fn,
                                              cigar_fn=cigar_fn, **kw)
            return pipe_.align_chunk(seqs, ext_fn, cigar_fn=cigar_fn, **kw)

        reads_done = 0

        def flush_one(futs):
            nonlocal n_rec, reads_done
            rng_, cms, n_chunk, fut = futs.popleft()
            with span(tracer, "chunk.join"):
                got = fut.result()
            with span(tracer, "sam.write"):
                if isinstance(got, tuple):
                    text, nr_ = got
                    out.write(text)
                    n_rec += nr_
                else:
                    for gi, rr in enumerate(got):
                        for rec in rr:
                            emit(rec, (cms[gi], None) if args.C else None)
                            n_rec += 1
            if manifest is not None:
                manifest.mark_done(rng_)
            reads_done += n_chunk
            mark_chunk_done(reads_done)
            if args.v >= 3:
                sys.stderr.write(f"[mem] processed {reads_done} reads\n")

        with ThreadPoolExecutor(max_workers=depth) as ex:
            futs: deque = deque()
            submitted = 0
            for chunk in chunks:
                start = n_reads
                n_reads += len(chunk)
                rng_ = None
                if manifest is not None:
                    rng_ = ReadRange(0, start, start + len(chunk))
                    if manifest.is_done(rng_):
                        continue
                futs.append((rng_,
                             [r.comment for r in chunk] if args.C
                             else None, len(chunk),
                             ex.submit(run_chunk, submitted, chunk)))
                submitted += 1
                if tracer is not None:
                    tracer.chunk = submitted   # the next chunk's input
                while len(futs) >= depth:
                    flush_one(futs)
            while futs:
                flush_one(futs)
    t_end = time.time()
    t_align = t_end - t_align0
    if args.v >= 1:
        sys.stderr.write(
            f"[mem] wrote {n_rec} records for {n_reads} reads\n")
        # align-loop rates (startup excluded); the steady rate starts at
        # the first chunk's completion and needs >= 4 chunks and >= 1 s
        rate = n_reads / t_align if t_align > 0 else 0.0
        sr, sn = rate, n_reads
        if steady[0] is not None and n_reads > steady[1] \
                and steady[2] >= 4 and t_end - steady[0] >= 1.0:
            sn = n_reads - steady[1]
            sr = sn / (t_end - steady[0])
        sys.stderr.write(
            f"[mem] align: {n_reads} reads in {t_align:.3f}s = "
            f"{rate:.1f} reads/s (steady {sr:.1f} reads/s over last "
            f"{sn} reads)\n")
    if seed_fn is not None and args.v >= 1:
        c = seed_fn.stats.counts
        sys.stderr.write(
            f"[mem] device seeding: {c['chunks']} chunks, {c['reads']} "
            f"reads, {c['split_rounds']} re-seed rounds ({c['split_jobs']} "
            f"jobs); slot overflow in {c['ovf_reads']} first rounds and "
            f"{c['ovf_jobs']} re-seed jobs: {c['exact_reads']} reads seeded "
            f"whole by the C++ engine\n")
    if tracer is not None:
        import json

        sys.stderr.write("[mem] counters: "
                         + json.dumps(tracer.counters.as_dict()) + "\n")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bwamem_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("index", help="build the FM-index")
    ix.add_argument("fasta")
    ix.add_argument("--sa-intv", type=int, default=8)
    ix.set_defaults(fn=cmd_index)

    mem = sub.add_parser("mem", help="align reads")
    mem.add_argument("fasta")
    mem.add_argument("reads")
    mem.add_argument("mates", nargs="?", default=None)
    mem.add_argument("-t", type=int, default=1,
                     help="host threads (native pipeline stages)")
    mem.add_argument("--host", default="auto",
                     choices=["auto", "native", "python"],
                     help="host pipeline: the native C++ host (auto = "
                          "native; no fallback to python), or the Python "
                          "host with batched extension")
    mem.add_argument("-b", type=int, default=512, help="batch size")
    mem.add_argument("-k", type=int, default=19, help="min seed length")
    mem.add_argument("-w", type=int, default=100, help="band width")
    mem.add_argument("-d", type=int, default=100,
                     help="off-diagonal X-dropoff (Z-dropoff)")
    mem.add_argument("-r", type=float, default=1.5,
                     help="re-seed trigger: internal seeds inside a "
                          "seed longer than k*FLOAT")
    mem.add_argument("-c", type=int, default=500,
                     help="skip seeds with more than INT occurrences")
    mem.add_argument("-S", action="store_true", help="skip mate rescue")
    mem.add_argument("-P", action="store_true",
                     help="skip pairing; mate rescue performed unless "
                          "-S also in use")
    mem.add_argument("-A", type=int, default=1,
                     help="score for a sequence match")
    mem.add_argument("-B", type=int, default=4,
                     help="penalty for a mismatch")
    mem.add_argument("-O", type=int, default=6, help="gap open penalty")
    mem.add_argument("-E", type=int, default=1,
                     help="gap extension penalty; a gap of size k costs "
                          "O + k*E")
    mem.add_argument("-L", type=int, default=5,
                     help="penalty for 5'- and 3'-end clipping")
    mem.add_argument("-U", type=int, default=17,
                     help="penalty for an unpaired read pair")
    mem.add_argument("-I", default=None, metavar="FLOAT[,...]",
                     help="specify the mean, standard deviation (10%%"
                          " of the mean if absent), max (4 sigma from "
                          "the mean if absent) and min of the insert "
                          "size distribution; skips pestat inference")
    mem.add_argument("-p", action="store_true",
                     help="first query file consists of interleaved "
                          "paired-end sequences")
    mem.add_argument("-T", type=int, default=30, help="min output score")
    mem.add_argument("-M", action="store_true",
                     help="mark shorter split hits as secondary")
    mem.add_argument("-a", action="store_true",
                     help="output all alignments")
    mem.add_argument("-C", action="store_true",
                     help="append FASTA/FASTQ comment to SAM output")
    mem.add_argument("-v", type=int, default=3, help="verbose level")
    mem.add_argument("-R", default=None, help="read group header line")
    mem.add_argument("--backend", default="cuda",
                     choices=["cuda", "torch", "scalar", "jax", "pallas"],
                     help="extension backend: cuda = the hand-written "
                          "kernels on the GPU, torch = their plain PyTorch "
                          "versions on the CPU, scalar = the pure Python "
                          "host (jax/pallas are the JAX package's; their "
                          "counterparts here are torch/cuda)")
    mem.add_argument("--trace", default=None, metavar="OUT.jsonl",
                     help="per-batch device trace + counters summary")
    mem.add_argument("--resume", default=None, metavar="MANIFEST.jsonl",
                     help="checkpoint manifest: completed chunks are "
                          "skipped, finished chunks appended")
    mem.add_argument("--inflight", type=int, default=3,
                     help="SE chunks in flight (pipeline depth)")
    mem.add_argument("--ship-ref", action="store_true",
                     help="native host: the fused kernel fed from "
                          "windows filled and shipped by the host instead "
                          "of the device-resident reference")
    mem.add_argument("--phased", action="store_true",
                     help="native host: the four-pass protocol (L0, L "
                          "retry, R0, R retry as separate per-phase kernel "
                          "launches) instead of the fused kernel; the "
                          "port's counterpart of the JAX package's "
                          "`bench/throughput.py --phased`")
    mem.add_argument("--bucket-split", action="store_true",
                     help="dispatch each fused chunk as two shape "
                          "buckets (a second device call)")
    mem.add_argument("--device-cigar", action="store_true",
                     help="run the banded global realignments that give "
                          "the CIGARs on the device (native host: SE and "
                          "PE; Python host: SE)")
    mem.add_argument("--device-rescue", action="store_true",
                     help="run the mate-rescue local alignments of the "
                          "native PE path on the device")
    mem.add_argument("--device-seed", action="store_true",
                     help="native host: the SMEM search and the SA "
                          "walks of every chunk on the device (references "
                          "below 2^31 index rows; host seeding above)")
    mem.add_argument("--shard", default=None, metavar="K/N",
                     help="multi-host scale-out: align only the strided "
                          "shard K of N (reads K, K+N, K+2N, ...); one "
                          "process per shard, then `merge` the SAMs. "
                          "Derived from the torch.distributed environment "
                          "(RANK of WORLD_SIZE, rendezvous at MASTER_ADDR:"
                          "MASTER_PORT) when MASTER_ADDR and WORLD_SIZE "
                          "are set and --shard is not; under --backend "
                          "cuda, LOCAL_RANK picks the process's card")
    mem.set_defaults(fn=cmd_mem)

    mg = sub.add_parser(
        "merge", help="merge per-shard SAM files back into input order")
    mg.add_argument("out", help="output SAM path ('-' = stdout)")
    mg.add_argument("shards", nargs="+",
                    help="per-shard SAM files, in shard-id order")
    mg.set_defaults(fn=cmd_merge)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
