"""Paired-end alignment on the Python host, with no JAX: the
`extend_batch_fn` branch of bwamem_tpu/pipeline/pair.align_pairs
(pair.py:283-332), with the two ends' extensions batched through the
port's `driver.extension_tables`.  Insert-size inference, mate rescue
and pairing are the reference's (`explicit_pes`, `infer_isize`,
`rescue_pairs`, `sam_pe`), reused unchanged; without an
`extend_batch_fn` (the scalar host) the reference `align_pairs` runs
as it is, since that branch never reaches JAX."""

from __future__ import annotations

from bwamem_tpu.config import MemOptions
from bwamem_tpu.io.fasta import Reference
from bwamem_tpu.pipeline import align as A
from bwamem_tpu.pipeline import pair as ref_pair
from bwamem_tpu.pipeline.driver import table_extend_fn
from bwamem_tpu_torch.pipeline import driver


def align_pairs(opt: MemOptions, ref: Reference, fm, reads1, reads2,
                names=None, quals1=None, quals2=None, po=None,
                extend_batch_fn=None):
    """Full paired-end batch alignment (mem_process_seqs PE path): the
    regions of all ends, the insert-size distribution of the batch,
    then rescue, pairing and SAM.  Records equal the reference
    `align_pairs` with the same arguments."""
    if extend_batch_fn is None:
        return ref_pair.align_pairs(opt, ref, fm, reads1, reads2,
                                    names=names, quals1=quals1,
                                    quals2=quals2, po=po)
    n = len(reads1)
    if n == 0:
        return []
    names = names or [f"pair{i}" for i in range(n)]
    quals1 = quals1 or [None] * n
    quals2 = quals2 or [None] * n
    all_reads = list(reads1) + list(reads2)
    all_chains = driver.chains_of(opt, fm, all_reads, po)
    tables = driver.extension_tables(opt, ref, all_reads, all_chains,
                                     extend_batch_fn)
    regs = [tuple(A.compute_regions(opt, ref, fm, all_reads[k],
                                    table_extend_fn(tables[k]),
                                    chains=all_chains[k])
                  for k in (i, n + i))
            for i in range(n)]
    pes = ref_pair.explicit_pes(opt) or ref_pair.infer_isize(
        opt, ref.l_pac, regs)
    out = []
    for i in range(n):
        if opt.max_matesw > 0:
            ref_pair.rescue_pairs(opt, ref, pes, (reads1[i], reads2[i]),
                                  regs[i])
        out.append(ref_pair.sam_pe(opt, ref, pes, names[i],
                                   (reads1[i], reads2[i]),
                                   (quals1[i], quals2[i]), regs[i]))
    return out
