"""A dry run of the multi-device layer (parallel/dist.py) on a list of
devices: the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`.

`dryrun_multi_device(devices)` drives every sharded backend once on a
small simulated world and raises RuntimeError on any difference:
- the per-phase kernel step: the sharded raw_t backend against the
  single-device one on a random batch, every row and lane;
- one SE chunk through NativePipeline with the sharded raw_t, fused and
  fused_idx backends: SAM identical to the single-device resident run;
- one PE chunk with the sharded extension, mate rescue and CIGAR
  backends, host-shipped and resident: SAM identical to the
  single-device resident run, with rescue batches and CIGAR rounds run;
- the SE chunk seeded by the sharded device seeder: SAM identical to the
  host-seeded run;
- the table-sharded regime (ops/smem_sharded.py) forced at this scale:
  rank4 through make_sharded_rank4 on the tables placed at a block
  origin of 2^26 (a 2^32-row offset) equal to the host rank4 on the same
  rows, and the SE chunk seeded by the table-sharded seeder: SAM
  identical to the host-seeded run.

On CUDA devices the kernels run (`[torch.device("cuda:0")] * 4` splits
over one card); on `[torch.device("cpu")] * n` their plain versions."""

from __future__ import annotations

import numpy as np

GENOME_BP = 20000


def make_world(seed: int = 0, n_se: int = 16, n_pe: int = 24):
    """(pac, reads, (reads1, reads2)): a random genome of GENOME_BP bases,
    n_se exact 100 bp reads, and n_pe FR pairs (insert ~300) of which
    every sixth mate is substituted every 9 bases (mate rescue) and every
    sixth first read carries a 2 bp deletion or insertion (a CIGAR with D
    or I)."""
    from bwamem_tpu_torch.pipeline.align import revcomp_read

    rng = np.random.default_rng(seed)
    pac = rng.integers(0, 4, GENOME_BP).astype(np.uint8)
    reads = [pac[p:p + 100].astype(np.int64)
             for p in rng.integers(0, GENOME_BP - 200, n_se)]
    r1s, r2s = [], []
    for i in range(n_pe):
        p = int(rng.integers(0, GENOME_BP - 400))
        isize = 300 + int(rng.integers(-20, 20))
        r1 = pac[p:p + 100].astype(np.int64)
        m = pac[p + isize - 100:p + isize].astype(np.int64)
        if i % 6 == 2:
            m[4::9] = (m[4::9] + 1) % 4
        elif i % 6 == 4:
            r1 = np.concatenate([r1[:50], r1[52:]])
        elif i % 6 == 5:
            r1 = np.concatenate([r1[:50], [0, 1], r1[50:]])
        r1s.append(r1)
        r2s.append(revcomp_read(m))
    return pac, reads, (r1s, r2s)


def _lines(recs):
    return [[r.line() for r in rr] for rr in recs]


def _same(want, got, what):
    if want != got:
        i = next((k for k, (a, b) in enumerate(zip(want, got)) if a != b),
                 min(len(want), len(got)))
        raise RuntimeError(f"{what}: SAM differs from the single-device "
                           f"run at read {i}")


def _counting(fn):
    """fn noting its calls in .calls; keeps the protocol attributes."""
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)

    wrapped.__dict__.update(fn.__dict__)
    wrapped.calls = 0
    return wrapped


def dryrun_multi_device(devices, *, blk_l: int = 128, seed: int = 0):
    """Drive every sharded backend of parallel/dist.py over `devices` (see
    the module docstring); RuntimeError on any difference.  Returns
    {"se": per-read SAM lines, "pe": per-pair SAM lines, "world":
    make_world(seed)}: the single-device SAM that every sharded run
    reproduced."""
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.index.occ_packed import pack_occ, rank4
    from bwamem_tpu_torch.io.fasta import Contig, Reference
    from bwamem_tpu_torch.ops import smem_sharded
    from bwamem_tpu_torch.ops.types import params_from_options
    from bwamem_tpu_torch.parallel import dist
    from bwamem_tpu_torch.pipeline import native_driver, resident

    devices = dist.device_list(devices)
    n_dev = len(devices)
    dev0 = devices[0]
    opt = MemOptions()
    params = params_from_options(opt)

    # the per-phase kernel step on a random batch
    rng = np.random.default_rng(seed)
    Bp, qmax, tmax = blk_l * n_dev * 2, 32, 64
    query_t = rng.integers(0, 4, (qmax, Bp)).astype(np.int8)
    target_t = rng.integers(0, 4, (tmax, Bp)).astype(np.int8)
    scal_t = np.zeros((8, Bp), np.int32)
    scal_t[0] = rng.integers(5, qmax, Bp)
    scal_t[1] = rng.integers(5, tmax, Bp)
    scal_t[2] = 10
    scal_t[3] = rng.integers(1, 40, Bp)
    tmaxb = np.full(Bp // blk_l, tmax, np.int32)
    want = native_driver.make_raw_t_backend(params, dev0, blk_l)(
        query_t, target_t, scal_t, tmaxb)
    raw_t = dist.make_sharded_raw_t_backend(devices, params, blk_l=blk_l)
    got = raw_t(query_t, target_t, scal_t, tmaxb)
    if not np.array_equal(want, got) or int(got[0].sum()) <= 0:
        raise RuntimeError("sharded raw_t != single-device raw_t")

    world = make_world(seed)
    pac, reads, (r1s, r2s) = world
    ref = Reference(contigs=[Contig("c1", 0, len(pac))], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, blk_l=blk_l)

    # one SE chunk: every sharded extension backend
    text = dist.replicate_text(devices, pac)
    single = resident.make_fused_idx_backend(params, pac, dev0, blk_l,
                                             text_dev=text[dev0])
    want_se = _lines(pipe.align_chunk(reads, single))
    n_mapped = sum(1 for rr in want_se for r in rr
                   if not int(r.split("\t")[1]) & 4)
    if n_mapped < len(reads) - 1:
        raise RuntimeError(f"{n_mapped}/{len(reads)} SE reads mapped")
    fused_idx = dist.make_sharded_fused_idx_backend(
        devices, params, pac, blk_l=blk_l, text_dev=text)
    for name, fn in (
            ("raw_t", raw_t),
            ("fused", dist.make_sharded_fused_backend(devices, params,
                                                      blk_l=blk_l)),
            ("fused_idx", fused_idx)):
        _same(want_se, _lines(pipe.align_chunk(reads, fn)),
              f"SE chunk, sharded {name}")

    # one PE chunk: extension, mate rescue and CIGAR, shipped and resident
    want_pe = _lines(pipe.align_pairs_chunk(
        r1s, r2s, single,
        rescue_fn=resident.make_rescue_idx_backend(pac, dev0,
                                                   text_dev=text[dev0]),
        cigar_fn=resident.make_cigar_idx_backend(pac, dev0,
                                                 text_dev=text[dev0])))
    for name, ext, rescue, cigar in (
            ("shipped", raw_t, dist.make_sharded_rescue_backend(devices),
             dist.make_sharded_cigar_backend(devices)),
            ("resident", fused_idx,
             dist.make_sharded_rescue_idx_backend(devices, text_dev=text),
             dist.make_sharded_cigar_idx_backend(devices, text_dev=text))):
        rescue, cigar = _counting(rescue), _counting(cigar)
        _same(want_pe, _lines(pipe.align_pairs_chunk(
            r1s, r2s, ext, rescue_fn=rescue, cigar_fn=cigar)),
            f"PE chunk, sharded {name} extension, rescue and CIGAR")
        if not rescue.calls or not cigar.calls:
            raise RuntimeError(f"PE chunk, {name}: {rescue.calls} rescue "
                               f"batches, {cigar.calls} CIGAR rounds")

    # the SE chunk seeded by the sharded device seeder
    pipe.seed_fn = dist.make_sharded_device_seeder(devices, po, fm, opt)
    try:
        _same(want_se, _lines(pipe.align_chunk(reads, fused_idx)),
              "SE chunk, sharded device seeding")
    finally:
        pipe.seed_fn = None

    # the table-sharded regime: the rank routing at a 2^32-row origin,
    # then the SE chunk seeded through it
    origin = 1 << 26
    tabs = smem_sharded.ShardedSeedTables(po, fm.ssa, fm.sa_intv, devices,
                                          blk_origin=origin)
    rows = rng.integers(0, po.n_rows + 1, 257).astype(np.int64)
    got = smem_sharded.make_sharded_rank4(devices, tabs)(rows + (origin << 6))
    if not np.array_equal(got, rank4(po, rows)):
        raise RuntimeError("table-sharded rank4 at a 2^32-row origin != "
                           "host rank4")
    pipe.seed_fn = dist.make_sharded_device_seeder(devices, po, fm, opt,
                                                   table_sharded=True)
    try:
        _same(want_se, _lines(pipe.align_chunk(reads, fused_idx)),
              "SE chunk, table-sharded device seeding")
    finally:
        pipe.seed_fn = None
    return {"se": want_se, "pe": want_pe, "world": world}
