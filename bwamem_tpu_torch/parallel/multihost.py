"""Scale-out across processes: read sharding, the shard from the
torch.distributed environment, and ordered output (the counterpart of
bwamem_tpu/parallel/multihost.py).

The index is replicated per process and read batches stream
data-parallel: a read's whole lifecycle (seeds, chains, extension, mate)
stays in one process, so the only traffic between processes is the
rendezvous at the start and the final SAM merge.  `mem --shard K/N`
names a process's shard; without it, `init_distributed` derives the
shard from the environment that `torchrun` (or a launcher that sets
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT) gives each process, and
`local_cuda_device` the card of the process from LOCAL_RANK.

SAM ordering: each process writes its shard to its own file;
`merge_sams` interleaves them back into input order (read index =
shard_id + n_shards * local_index), so the merged output is
byte-identical to a single-process run.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

# how long the rendezvous waits for the other processes before it fails
RENDEZVOUS_TIMEOUT_S = 120


def init_distributed() -> tuple[int, int]:
    """(rank, world size) of this process.  When MASTER_ADDR and
    WORLD_SIZE are set, joins the torch.distributed process group of the
    environment (`init_method="env://"`: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) over gloo, with a finite timeout so that a lost peer
    fails the run instead of hanging it: nothing crosses the processes but
    the rendezvous, so no GPU backend is needed.  Otherwise (0, 1)."""
    if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")):
        return 0, 1
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def destroy() -> None:
    """Leave the process group init_distributed joined, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_cuda_device(local_rank: str | None, n_cuda: int) -> str:
    """The CUDA device of a process: "cuda" when LOCAL_RANK is unset,
    else "cuda:{LOCAL_RANK}" (one process a card, as `torchrun
    --nproc-per-node N` starts them).  ValueError when LOCAL_RANK is not
    one of the n_cuda visible cards: processes never share a card by
    wrapping around."""
    if local_rank is None or local_rank == "":
        return "cuda"
    k = int(local_rank)
    if not 0 <= k < n_cuda:
        raise ValueError(f"LOCAL_RANK {k} names no card: {n_cuda} visible")
    return f"cuda:{k}"


def shard_reads(n_reads: int, shard: int, n_shards: int) -> range:
    """Strided read assignment: shard k gets reads k, k+n, k+2n, ...
    Striding (vs contiguous blocks) keeps per-shard work balanced when
    read difficulty drifts along the file."""
    return range(shard, n_reads, n_shards)


def _shard_ends(tuples, shard: int, n_shards: int, b: int):
    """Tuples of io/fastq.ReadBatches (the ends of one run of reads, or
    of pairs) filtered to this shard's strided share and re-cut to b."""
    from bwamem_tpu_torch.io.fastq import ReadBatch

    buf = None
    gi = 0
    for ends in tuples:
        mine = [e[(shard - gi) % n_shards::n_shards] for e in ends]
        gi += len(ends[0])
        buf = mine if buf is None else [ReadBatch.concat([x, y])
                                        for x, y in zip(buf, mine)]
        while len(buf[0]) >= b:
            yield [x[:b] for x in buf]
            buf = [x[b:] for x in buf]
    if buf is not None and len(buf[0]):
        yield buf


def shard_chunk_stream(chunks, shard: int, n_shards: int, b: int):
    """Filter a chunked read stream (io/fastq.ReadBatches) down to this
    shard's strided assignment (shard_reads order: global read index =
    shard + n_shards * local index) and re-chunk to batches of `b`,
    gathered column by column.  Every shard streams the same file; the
    skipped reads cost parse time only."""
    for (c,) in _shard_ends(((c,) for c in chunks), shard, n_shards, b):
        yield c


def shard_pair_stream(pair_iter, shard: int, n_shards: int, b: int):
    """PE version of shard_chunk_stream: the unit of assignment is the
    PAIR (a pair's whole lifecycle — pestat, rescue, pairing — stays on
    one shard)."""
    for c1, c2 in _shard_ends(pair_iter, shard, n_shards, b):
        yield c1, c2


def merge_sams(shard_iters: Sequence[Iterator[list[str]]],
               ) -> Iterator[list[str]]:
    """Interleave per-shard record-group streams back into input order.

    shard_iters[k] yields the SAM record groups (one list per read) of
    shard k in its local order; the merge emits read 0, 1, 2, ... .
    """
    iters = [iter(s) for s in shard_iters]
    n = len(iters)
    done = [False] * n
    i = 0
    while not all(done):
        k = i % n
        if not done[k]:
            try:
                yield next(iters[k])
            except StopIteration:
                done[k] = True
        i += 1
        # safety: once every iterator is exhausted in a full cycle, stop
        if i % n == 0 and all(done):
            break


def _unit_start(flag: int) -> bool:
    """True when a record opens a new read unit (SE read or PE pair):
    a PRIMARY record (neither secondary 0x100 nor supplementary 0x800)
    that is either unpaired or the first-in-pair end (0x40).  The
    aligner always emits a unit as [read1 primary, its secondaries/
    supplementaries..., read2 primary, ...], so this boundary is
    correct even when adjacent units share a QNAME (the case that
    grouping by QNAME runs merges wrongly)."""
    return (flag & 0x900) == 0 and ((flag & 0x1) == 0 or bool(flag & 0x40))


def sam_units(lines) -> Iterator[list[str]]:
    """Group an iterable of SAM lines (headers skipped) into read/pair
    units by flag structure, with a QNAME change as a fallback
    boundary."""
    cur: list[str] = []
    cur_name = None
    for line in lines:
        if line.startswith("@"):
            continue
        name, flag_s, _ = line.split("\t", 2)
        if cur and (name != cur_name or _unit_start(int(flag_s))):
            yield cur
            cur = []
        cur.append(line)
        cur_name = name
    if cur:
        yield cur


def merge_sam_files(paths: Sequence[str], out_path: str,
                    header_lines: int | None = None) -> int:
    """Merge per-shard SAM files (written in shard_reads order) into
    one input-ordered file; the result is byte-identical to the
    single-process run's record stream.  Units are delimited by flag
    structure (sam_units), not QNAME runs, so duplicate or repeated
    read names cannot glue two units together.  Returns records
    written."""
    def groups(path):
        with open(path) as f:
            yield from sam_units(f)

    header: list[str] = []
    with open(paths[0]) as f:
        for line in f:
            if line.startswith("@"):
                header.append(line)
            else:
                break
    n = 0
    with open(out_path, "w") as out:
        out.writelines(header)
        for grp in merge_sams([groups(p) for p in paths]):
            out.writelines(grp)
            n += len(grp)
    return n
