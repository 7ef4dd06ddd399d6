"""Table-sharded device seeding: the FM-index rank and sampled-SA tables
split by block range over a list of devices, each holding 1/N of the
index, for an index of 2^31 rows or more (a GRCh38 two-strand text is
6.2 G rows).  The counterpart of bwamem_tpu/ops/smem_sharded.py.

Layout (ShardedSeedTables, as the JAX module's): the occ / pk / va rows
split by contiguous 64-symbol block ranges, shard k holding the global
blocks [blk_origin + k*nb_loc, blk_origin + (k+1)*nb_loc); the sampled SA
splits the same way by index range (ns_loc entries a shard); each shard
is copied to its device once, its three tables interleaved into one
tensor of 64-byte block records (smem_torch.block_records), the kernels'
layout, of which occ / pk / va are column views.  C, the primary row and
the read batch are the same everywhere.  blk_origin is 0 in production;
the tests place a small table at a block origin of 2^26 (a 2^32-row
offset) to prove the routing past 2^31 rows without gigabytes of data.

Routing.  The JAX module answers each rank or SA gather with a masked
gather on every shard and a `psum` over the mesh, then runs the search
replicated on every shard.  A psum per dependent gather has no sensible
GPU counterpart: here a thread computes the owning shard of a block,
`(blk - blk_origin) / nb_loc`, and the local row, and reads that shard's
tables through its device pointer (csrc/fm_seed.cuh, `ShardedOcc`).  A
shard on another card is read over NVLink, so every pair of cards needs
peer access: the factories check `torch.cuda.can_device_access_peer` and
enable it (RuntimeError where a pair lacks it; there is no copy-based
fallback).  On `[cuda:0] * n` every pointer is local.

Positions are int64 in the kernels and in the plain version.  The JAX
module carries them as (hi, lo) int32 pairs (`split64`, `wadd`, `wlt`,
...) only because a TPU has no int64; that algebra has no counterpart
here.  Its guards stay: n_rows >> 6 and n_rows // sa_intv below 2^31, a
power-of-two sa_intv, and at most 8 shards (the kernels' table holds 8).

Reads, re-seed jobs and SA rows split over the devices as in the
reads-sharded regime (parallel/dist.ShardedPrograms), so each card holds
1/N of the index and seeds 1/N of the reads; the rows equal the
single-device seeder's in value and order.  With one device this is the
whole index on one card, the replicated single-card mode.

Wrappers (`rank4`, `smem_all`, `smem1`, `sa`) take a ShardedOcc (the
tables as seen from the launching device, ops/smem_torch.py) and dispatch
on the tensors' device: on the CPU the plain PyTorch version
(ops/smem_torch.py over the shards), on a CUDA device the kernel
(bwt_rank4_sh, bwt_smem_all_sh, bwt_smem1_sh, bwt_sa_sh of
csrc/fm_seed.cu) or an exception: no fallback.  `launches` counts the
kernel launches."""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from bwamem_tpu_torch.ops import smem_torch
from bwamem_tpu_torch.ops.smem_cuda import check_arg, device_of
from bwamem_tpu_torch.ops.smem_torch import ALL_COLS, SMEM1_COLS, ShardedOcc
from bwamem_tpu_torch.parallel import dist

MAX_SHARDS = 8      # fmseed::kMaxShards

launches = {"bwt_rank4_sh": 0, "bwt_smem_all_sh": 0, "bwt_smem1_sh": 0,
            "bwt_sa_sh": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _shard(a, k: int, n_loc: int, device) -> torch.Tensor:
    """Rows [k * n_loc, (k+1) * n_loc) of the table `a` (numpy or a
    tensor) as a tensor of its own on `device`, n_loc rows, zero past the
    end of `a`."""
    src = smem_torch.table_tensor(a[k * n_loc:(k + 1) * n_loc], device)
    out = torch.zeros((n_loc, *src.shape[1:]), dtype=src.dtype,
                      device=device)
    out[:src.shape[0]].copy_(src)
    return out


class ShardedSeedTables:
    """The packed occ tables of `po` (a PackedOcc; its occ / pk / va may
    be tensors made on a card) and the sampled SA `ssa` split over
    `devices` (shard k on devices[k]; a device may repeat), each shard a
    tensor of its own: `rec[k]`, nb_loc block records (zero past the
    tables' end), and `occ[k]` / `pk[k]` / `va[k]` its column views.
    ValueError where the JAX module raises: n_rows >> 6 >= 2^31, a
    non-power-of-two sa_intv, n_rows // sa_intv >= 2^31; and for more than
    MAX_SHARDS devices."""

    def __init__(self, po, ssa, sa_intv: int, devices, blk_origin: int = 0):
        n_rows = int(po.n_rows)
        if n_rows >> 6 >= 1 << 31:
            raise ValueError("text too large: block indices exceed int32"
                             " (n_rows >= 2^37)")
        if sa_intv & (sa_intv - 1):
            raise ValueError(f"sharded SA needs power-of-two sa_intv, "
                             f"got {sa_intv}")
        if n_rows // sa_intv >= 1 << 31:
            raise ValueError("sampled-SA index exceeds int32")
        self.devices = dist.device_list(devices)
        n_dev = len(self.devices)
        if n_dev > MAX_SHARDS:
            raise ValueError(f"{n_dev} shards: the kernels take at most "
                             f"{MAX_SHARDS}")
        self.nb_loc = -(-int(po.occ_rows.shape[0]) // n_dev)
        self.n_ssa = len(ssa)
        self.ns_loc = -(-self.n_ssa // n_dev)
        self.rec = [smem_torch.block_records(
            [a[k * self.nb_loc:(k + 1) * self.nb_loc]
             for a in (po.occ_rows, po.pk_rows, po.va_rows)], d,
            self.nb_loc)[0] for k, d in enumerate(self.devices)]
        self.occ, self.pk, self.va = (
            [rec[:, cols] for rec in self.rec]
            for cols in smem_torch.REC_COLS)
        self.ssa = [_shard(ssa, k, self.ns_loc, d)
                    for k, d in enumerate(self.devices)]
        self.C = np.asarray(po.C, np.int64)
        self.primary = int(po.primary)
        self.n_rows = n_rows
        self.sa_intv = int(sa_intv)
        self.blk_origin = int(blk_origin)
        self._views = {}
        self._table = None

    def view(self, device) -> ShardedOcc:
        """The tables as the kernels and the plain version on `device` see
        them (one view a device)."""
        device = torch.device(device)
        if device not in self._views:
            self._views[device] = ShardedOcc(self, device)
        return self._views[device]

    def shard_table(self):
        """The kernels' fmseed::ShardedOcc of these (CUDA) shards."""
        from bwamem_tpu_torch.ops import _build

        if self._table is None:
            t = _build.ShardTable()
            for k in range(len(self.devices)):
                t.rec[k] = self.rec[k].data_ptr()
                t.ssa[k] = self.ssa[k].data_ptr()
            t.C[:] = [int(c) for c in self.C]
            t.primary, t.n_rows = self.primary, self.n_rows
            t.nb_loc, t.ns_loc = self.nb_loc, self.ns_loc
            t.blk_origin, t.n_ssa = self.blk_origin, self.n_ssa
            t.sa_intv, t.n_shards = self.sa_intv, len(self.devices)
            self._table = t
        return self._table


def enable_peer_access(devices) -> None:
    """Let every distinct CUDA device of `devices` read every other's
    memory; RuntimeError where a pair cannot (there is no copy-based
    fallback).  Nothing to do on one card or on the CPU."""
    cards = [d for d in dist.distinct(dist.device_list(devices))
             if d.type == "cuda"]
    if len(cards) < 2:
        return
    from bwamem_tpu_torch.ops import _build

    lib = _build.load().lib
    for a in cards:
        for b in cards:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a.index, b.index):
                raise RuntimeError(
                    f"{a} cannot read the memory of {b} (no peer access): "
                    "table-sharded seeding needs peer access between every "
                    "pair of cards")
            rc = lib.bwt_enable_peer_access(a.index, b.index)
            if rc != 0:
                raise RuntimeError(
                    f"enabling peer access {a} -> {b} failed: "
                    f"{lib.bwt_error_string(rc)}")


def _launch(name, dev, d: ShardedOcc, *args) -> None:
    """Launch `name` of the kernel library on dev's current stream over
    d's shards; raise if the launch failed, count it if not."""
    from bwamem_tpu_torch.ops import _build

    _build.launch(dev, name, ctypes.byref(d.tabs.shard_table()), *args)
    with _count_lock:
        launches[name] += 1


def rank4(d: ShardedOcc, rows):
    """Counts of each base 0..3 in bwt[0:i) at the int64 rows (n,)
    (smem_torch.rank4 over the shards); returns (n, 4) int64."""
    dev = device_of(d, rows)
    if dev is None:
        return smem_torch.rank4(d, rows)
    n = rows.shape[0]
    check_arg("rows", rows, torch.int64, (n,))
    out = torch.empty((n, 4), dtype=torch.int64, device=dev)
    if n:
        _launch("bwt_rank4_sh", dev, d, rows.data_ptr(), n, out.data_ptr())
    return out


def smem_all(d: ShardedOcc, q, qlen, min_seed_len: int):
    """smem_cuda.smem_all over the shards: q (B, L) uint8 codes, qlen
    (B,) int64; returns (B, ALL_COLS) int64."""
    dev = device_of(d, q, qlen)
    if dev is None:
        return smem_torch.smem_all(d, q, qlen, min_seed_len)
    B, L = q.shape
    check_arg("q", q, torch.uint8, (B, L))
    check_arg("qlen", qlen, torch.int64, (B,))
    out = torch.empty((B, ALL_COLS), dtype=torch.int64, device=dev)
    if B:
        _launch("bwt_smem_all_sh", dev, d, q.data_ptr(), L, qlen.data_ptr(),
                B, int(min_seed_len), out.data_ptr())
    return out


def smem1(d: ShardedOcc, q, qlen, x, min_intv, mask):
    """smem_cuda.smem1 over the shards: one bwt_smem1 call a read at x
    where mask is set; returns (B, SMEM1_COLS) int64."""
    dev = device_of(d, q, qlen, x, min_intv, mask)
    if dev is None:
        return smem_torch.pack_smem1(smem_torch.smem1(
            d, q, qlen, torch.where(mask.bool(), x, qlen), min_intv))
    B, L = q.shape
    check_arg("q", q, torch.uint8, (B, L))
    for name, t in (("qlen", qlen), ("x", x), ("min_intv", min_intv)):
        check_arg(name, t, torch.int64, (B,))
    check_arg("mask", mask, torch.uint8, (B,))
    out = torch.empty((B, SMEM1_COLS), dtype=torch.int64, device=dev)
    if B:
        _launch("bwt_smem1_sh", dev, d, q.data_ptr(), L, qlen.data_ptr(),
                x.data_ptr(), min_intv.data_ptr(), mask.data_ptr(), B,
                out.data_ptr())
    return out


def sa(d: ShardedOcc, ssa, sa_intv: int, rows, max_it=None):
    """smem_cuda.sa over the shards: text positions of the SA rows (n,)
    int64.  ssa and sa_intv are the tables' own (d.ssa, the tables'
    sa_intv; smem_cuda.sa's signature, for parallel/dist.py)."""
    if ssa is not d.ssa or sa_intv != d.tabs.sa_intv:
        raise ValueError("the sampled SA of a table-sharded index is its "
                         "own: pass d.ssa and its sa_intv")
    dev = device_of(d, rows)
    if max_it is None:
        max_it = smem_torch.sa_max_it(d.n_rows)
    if dev is None:
        return smem_torch.sa_batch(d, ssa, sa_intv, rows, max_it=max_it)
    n = rows.shape[0]
    check_arg("rows", rows, torch.int64, (n,))
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _launch("bwt_sa_sh", dev, d, rows.data_ptr(), n, int(max_it),
                out.data_ptr())
    return out


def make_sharded_rank4(devices, tabs: ShardedSeedTables):
    """A host-callable rank4 over the sharded tables: fn(rows) -> (N, 4)
    int64 counts for int64 rows (global, blk_origin included), the rows
    split over `devices` (each launching bwt_rank4_sh, or the plain
    version on the CPU).  Enables peer access (RuntimeError where a pair
    of cards lacks it)."""
    devices = dist.device_list(devices)
    enable_peer_access(devices + tabs.devices)
    views = {d: tabs.view(d) for d in dist.distinct(devices)}

    def rank4_wide(rows):
        rows = np.ascontiguousarray(rows, np.int64)
        ins = [(d, torch.from_numpy(rows[a:b]).to(d))
               for d, (a, b) in zip(devices, dist.split_rows(
                   len(rows), len(devices)))]
        outs = [rank4(views[d], r) for d, r in ins]
        if not outs:
            return np.zeros((0, 4), np.int64)
        return dist.collect(outs, 0)

    return rank4_wide


class TableShardedPrograms(dist.ShardedPrograms):
    """parallel/dist.ShardedPrograms (reads, re-seed jobs and SA rows
    split over the devices) over one ShardedSeedTables instead of a copy
    of the index a device: each shard of rows runs this module's
    wrappers on its device's view of the tables."""

    smem_all = staticmethod(smem_all)
    smem1 = staticmethod(smem1)
    sa = staticmethod(sa)

    def __init__(self, tabs: ShardedSeedTables):
        self.devices = tabs.devices
        self.tables = {d: tabs.view(d) for d in dist.distinct(self.devices)}
        self.ssas = {d: t.ssa for d, t in self.tables.items()}
        self.d = self.tables[self.devices[0]]
        self.sa_intv = tabs.sa_intv
        self._pinned = threading.local()


def make_table_sharded_seeder(devices, po, fm, opt):
    """Device seeding with the tables split by block range over
    `devices` (every pair of cards with peer access, which this enables;
    RuntimeError otherwise) and each chunk's rows split over them: the
    `seed_fn(q, qlen) -> (n, 4) int64 rows` of smem_cuda.make_device_seeder,
    equal to it in value and order, with no 2^31-row cap."""
    devices = dist.device_list(devices)
    enable_peer_access(devices)
    tabs = ShardedSeedTables(po, fm.ssa, fm.sa_intv, devices)
    return smem_torch.seeder(TableShardedPrograms(tabs),
                             smem_torch.exact_seeder(po, fm, opt), opt)
