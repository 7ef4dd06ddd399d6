"""The port's batched Python host (bwamem_tpu_torch/pipeline/driver.py
align_batch, pipeline/pair.py align_pairs with a batched extension)
against its scalar path and the JAX package's: tests/test_driver.py's
batch == scalar SAM and tests/test_identity_fuzz.py's SE and PE sweeps
over hard reads (SNP-heavy, indels, a planted duplication, contig
junctions and an N gap), each held byte for byte to the reference's
scalar pipeline on its own index of the same text.  The port's extension
pass on the CPU takes the place of the extend_jax twin and is held to
it on the same inputs."""

import numpy as np
import pytest
import torch

from bwamem_tpu.config import MemOptions as RefOptions
from bwamem_tpu.index.build import build_index as ref_build_index
from bwamem_tpu.io import fasta as ref_fasta
from bwamem_tpu.pipeline import align as ref_align
from bwamem_tpu.pipeline import pair as ref_pair
from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.occ_packed import pack_occ
from bwamem_tpu_torch.io.fasta import Contig, Reference
from bwamem_tpu_torch.pipeline.align import align_read, revcomp_read
from bwamem_tpu_torch.pipeline.driver import align_batch
from bwamem_tpu_torch.pipeline.pair import align_pairs

from _torch_gate import same_sam
from _torch_ref import check_against_jax, port_extend_fn

torch.set_num_threads(1)

OPT = MemOptions()


def _worlds(pac, contigs):
    """(the port's Reference and index, the reference package's)."""
    return ((Reference(contigs=[Contig(*c) for c in contigs], pac=pac),
             build_index(pac)),
            (ref_fasta.Reference(contigs=[ref_fasta.Contig(*c)
                                          for c in contigs], pac=pac),
             ref_build_index(pac)))


def test_batch_matches_scalar_sam():
    rng = np.random.default_rng(99)
    pac = rng.integers(0, 4, 40000).astype(np.uint8)
    (ref, fm), (rref, rfm) = _worlds(pac, [("chr1", 0, 40000)])

    reads, names = [], []
    for i in range(12):
        pos = int(rng.integers(0, 39800))
        read = pac[pos:pos + 100].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, 4))):
            read[rng.integers(0, 100)] = rng.integers(0, 4)
        if i % 3 == 1:  # indel
            p = int(rng.integers(20, 80))
            if i % 2:
                read = np.concatenate([read[:p], rng.integers(0, 4, 3),
                                       read[p:]])[:100]
            else:
                read = np.concatenate([read[:p], read[p + 2:]])
        if i % 4 == 2:
            read = revcomp_read(read)
        reads.append(read)
        names.append(f"r{i}")

    scalar = [align_read(OPT, ref, fm, n, r) for n, r in zip(names, reads)]
    same_sam(scalar, [ref_align.align_read(RefOptions(), rref, rfm, n, r)
                      for n, r in zip(names, reads)])
    fn = port_extend_fn(OPT)
    same_sam(align_batch(OPT, ref, fm, reads, fn, names=names), scalar)
    check_against_jax(fn, OPT, n_calls=2)


@pytest.fixture(scope="module")
def sweep_world():
    rng = np.random.default_rng(4242)
    pac = rng.integers(0, 4, 120000).astype(np.uint8)
    pac[100000:101000] = pac[50000:51000]     # planted duplication
    pac[70000:70100] = 4                      # N gap
    (ref, fm), (rref, rfm) = _worlds(pac, [("c1", 0, 80000),
                                           ("c2", 80000, 40000)])
    return ref, fm, pack_occ(fm), rref, rfm


def hard_reads(rng, pac, n, L=120):
    reads = []
    for i in range(n):
        kind = i % 6
        pos = int(rng.integers(0, len(pac) - 2 * L))
        r = pac[pos:pos + L].astype(np.int64).copy()
        if kind == 1:   # heavy SNPs
            for _ in range(6):
                r[rng.integers(0, L)] = rng.integers(0, 5)
        elif kind == 2:  # indel
            p = int(rng.integers(20, L - 20))
            if i % 2:
                r = np.concatenate([r[:p], rng.integers(0, 4, 4), r[p:]])[:L]
            else:
                r = np.concatenate([r[:p], r[p + 3:]])
        elif kind == 3:  # duplication region (MAPQ 0 / XA territory)
            off = int(rng.integers(0, 900 - L))
            r = pac[50000 + off:50000 + off + L].astype(np.int64).copy()
        elif kind == 4:  # junction / N-gap straddlers
            base = [79950, 69950][i % 2]
            r = pac[base:base + L].astype(np.int64).copy()
        if i % 3 == 1:
            r = revcomp_read(r)
        reads.append(r)
    return reads


def test_se_batch_identity_sweep(sweep_world):
    ref, fm, po, rref, rfm = sweep_world
    reads = hard_reads(np.random.default_rng(77), ref.pac, 60)
    names = [f"s{i}" for i in range(len(reads))]
    scalar = [ref_align.align_read(RefOptions(), rref, rfm, n, rd)
              for n, rd in zip(names, reads)]
    fn = port_extend_fn(OPT)
    same_sam(align_batch(OPT, ref, fm, reads, fn, names=names, po=po),
             scalar)
    same_sam([align_read(OPT, ref, fm, n, rd)
              for n, rd in zip(names[::5], reads[::5])], scalar[::5])
    check_against_jax(fn, OPT)


def test_pe_batch_identity_sweep(sweep_world):
    ref, fm, po, rref, rfm = sweep_world
    rng = np.random.default_rng(88)
    r1s = hard_reads(rng, ref.pac, 30)
    # mates at plausible inserts from fresh positions (not tied to r1 —
    # exercises the no-pairing and rescue branches too)
    r2s = []
    for i in range(30):
        pos = int(rng.integers(0, ref.l_pac - 500))
        r2s.append(revcomp_read(
            ref.pac[pos + 200:pos + 320].astype(np.int64)))
    want = ref_pair.align_pairs(RefOptions(), rref, rfm, r1s, r2s)
    fn = port_extend_fn(OPT)
    same_sam(align_pairs(OPT, ref, fm, r1s, r2s, po=po, extend_batch_fn=fn),
             want)
    same_sam(align_pairs(OPT, ref, fm, r1s, r2s), want)
    check_against_jax(fn, OPT)
