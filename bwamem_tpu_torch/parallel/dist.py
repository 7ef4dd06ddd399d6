"""Data parallelism over several devices: every device backend of the
port as a lane split over an explicit list of torch.devices (the
counterpart of bwamem_tpu/parallel/dist.py, whose backends shard_map the
same functions over a `jax.sharding.Mesh`).

A backend splits the lane (task) axis of each call into contiguous
shards, one a device, runs the single-device function of the port on
each shard (the CUDA kernels through ops/extend_cuda, ops/smem_cuda,
ops/local_cuda and ops/global_cuda, the plain PyTorch versions on a CPU
device) and concatenates the results
in shard order, so a call returns what the single-device backend returns
for the whole batch.  What every lane reads is replicated: the scoring
block, the two-strand reference text (one copy a distinct device), the
chunk's read matrix, the seeding tables.  A read's tasks never need
another shard's data, so nothing but the inputs and the results crosses
between the host and the devices.

The order inside a call matters on several cards: every shard's inputs
are copied to its device first, then every shard is launched, and only
then is any result copied back.  A copy back waits for its device, so
collecting shard k before launching shard k+1 would run the cards one
after another.  On one card listed several times (`[cuda:0] * 4`, how
one card exercises the split) the shards queue on one stream and run in
turn.

`device_list` is the counterpart of `make_mesh`; a device may repeat.
The factories keep the contract NativePipeline reads: `bp_quantum =
blk_l * n_dev` for the extension backends, `.fused` / `.idx`,
`dispatches`; the rescue and CIGAR backends need B to be a multiple of
n_dev (`b_quantum`), which the wave builder's 256-lane buckets are for
n_dev up to 256.  The factories keep no state but their counters, which
a lock guards, so `--inflight` threads may share one.  The seeder splits
the reads, the re-seed jobs and the SA rows of a chunk over the devices,
each of which holds its own copy of the tables (the reads-sharded
regime, below 2^31 index rows), or the tables split by block range over
the devices (the table-sharded regime of ops/smem_sharded.py, at 2^31
index rows or more)."""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.device import resolve, to_device
from bwamem_tpu_torch.ops import extend_cuda, smem_cuda, smem_torch
from bwamem_tpu_torch.ops.types import params_vector


def device_list(devices=None) -> list[torch.device]:
    """The devices of a split: every visible CUDA device by default
    (RuntimeError when there is none: there is no CPU fallback), else
    `devices` resolved, in order, repeats kept (`[torch.device("cpu")] *
    n` runs the plain versions in n shards).  A CUDA device without an
    index gets the current one, so equal devices compare equal."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible (torch.cuda.is_available() is "
                "False); pass the devices, e.g. [torch.device('cpu')] * n")
        return [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("an empty device list")
    return out


def distinct(devices) -> list[torch.device]:
    """The devices of `devices` without repeats, in first-seen order."""
    return list(dict.fromkeys(devices))


def replicate_text(devices, pac) -> dict:
    """The resident two-strand text of `pac` on each distinct device of
    `devices`: {torch.device: tensor}, one host pack, one copy a device."""
    from bwamem_tpu_torch.pipeline import resident

    devs = distinct(device_list(devices))
    first = resident.make_resident_text(pac, devs[0])
    return {d: first.to(d) for d in devs}


def _texts(devices, pac, text_dev) -> dict:
    """text_dev (one text a distinct device), checked, or the text of
    `pac` replicated."""
    if text_dev is None:
        if pac is None:
            raise ValueError("pass pac or text_dev")
        return replicate_text(devices, pac)
    missing = [d for d in distinct(devices) if d not in text_dev]
    if missing:
        raise ValueError(f"text_dev holds no text on {missing}")
    return text_dev


def _lanes(n: int, n_dev: int, quantum: int, what: str):
    """The n_dev contiguous equal lane ranges of n lanes; ValueError
    unless n is a multiple of `quantum` (itself a multiple of n_dev)."""
    if n % quantum:
        raise ValueError(f"{what}: {n} lanes, not a multiple of {quantum} "
                         f"({n_dev} devices)")
    step = n // n_dev
    return [(k * step, (k + 1) * step) for k in range(n_dev)]


def split_rows(n: int, n_dev: int):
    """The non-empty ranges of n rows split over n_dev devices as
    torch.tensor_split does (the first n % n_dev ranges one row longer)."""
    q, r = divmod(n, n_dev)
    out, a = [], 0
    for k in range(n_dev):
        b = a + q + (k < r)
        if b > a:
            out.append((a, b))
        a = b
    return out


def collect(outs, axis: int) -> np.ndarray:
    """The shards' device results copied back in order and joined."""
    return np.concatenate([o.cpu().numpy() for o in outs], axis)


def _on_each(devices, x, dtype) -> dict:
    """The host array `x` as a tensor of numpy type `dtype` on each
    distinct device: {torch.device: tensor}."""
    return {d: to_device(x, dtype, d) for d in distinct(devices)}


def _counted(fn):
    """fn counting its calls in fn.dispatches, under a lock (threads may
    share a backend)."""
    lock = threading.Lock()

    def wrapped(*args):
        with lock:
            wrapped.dispatches += 1
        return fn(*args)

    wrapped.dispatches = 0
    return wrapped


def make_sharded_raw_t_backend(devices, params, *, blk_l: int = 512):
    """The per-phase backend (native_driver.make_raw_t_backend's
    contract: raw_t(query_t, target_t, scal_t, tmaxb) -> (8, Bp) int32
    numpy) with the lanes split over `devices`; Bp must be a multiple of
    `raw_t.bp_quantum` = blk_l * n_dev, which NativePipeline pads to."""
    devices = device_list(devices)
    n_dev = len(devices)
    prm = params_vector(params)

    def raw_t(query_t, target_t, scal_t, tmaxb):
        lanes = _lanes(query_t.shape[1], n_dev, blk_l * n_dev, "raw_t")
        nb = len(tmaxb) // n_dev        # row bounds a shard (not read)
        ins = [(to_device(query_t[:, a:b], np.int8, d),
                to_device(target_t[:, a:b], np.int8, d),
                to_device(scal_t[:, a:b], np.int32, d))
               for d, (a, b) in zip(devices, lanes)]
        outs = [extend_cuda.extend_batch_raw_t(
                    *x, tmaxb[k * nb:(k + 1) * nb], prm)
                for k, x in enumerate(ins)]
        return collect(outs, 1)

    fn = _counted(raw_t)
    fn.bp_quantum = blk_l * n_dev
    return fn


def make_sharded_fused_backend(devices, params, *, blk_l: int = 512):
    """The host-shipped-window fused backend
    (native_driver.make_fused_backend's contract: fused(ql, tl, qr, tr,
    scal, tmax2) -> (32, Bp) int32 numpy) with the lanes split over
    `devices`; `.fused`, `bp_quantum` = blk_l * n_dev."""
    devices = device_list(devices)
    n_dev = len(devices)
    prm = params_vector(params)

    def fused(ql, tl, qr, tr, scal, tmax2):
        lanes = _lanes(ql.shape[1], n_dev, blk_l * n_dev, "fused")
        nb = len(tmax2) // n_dev
        ins = [([to_device(x[:, a:b], np.int8, d) for x in (ql, tl, qr, tr)],
                to_device(scal[:, a:b], np.int32, d))
               for d, (a, b) in zip(devices, lanes)]
        outs = [extend_cuda.extend_batch_raw_fused(
                    *win, s, tmax2[k * nb:(k + 1) * nb], prm)
                for k, (win, s) in enumerate(ins)]
        return collect(outs, 1)

    fn = _counted(fused)
    fn.fused = True
    fn.bp_quantum = blk_l * n_dev
    return fn


def make_sharded_fused_idx_backend(devices, params, pac, *,
                                   blk_l: int = 512, text_dev=None):
    """The resident-reference fused backend, the production protocol
    (resident.make_fused_idx_backend's contract: fused_idx(reads_nib,
    scal, tmax2, dims) -> (32, Bp) numpy) with the (16, Bp) lane scalars
    split over `devices`, and the text and the read matrix replicated:
    each shard gathers its windows on its own device.  `text_dev`
    (replicate_text's dict) shares the text with the rescue and CIGAR
    backends; `.fused`, `.idx`, `bp_quantum` = blk_l * n_dev."""
    from bwamem_tpu_torch.pipeline.resident import fused_idx_local

    devices = device_list(devices)
    n_dev = len(devices)
    prm = params_vector(params)
    a_max = int(np.max(np.asarray(params.mat_flat)))
    texts = _texts(devices, pac, text_dev)

    def fused_idx(reads_nib, scal, tmax2, dims):
        qmax_l, tmax_l, qmax_r, tmax_r = dims
        lanes = _lanes(scal.shape[1], n_dev, blk_l * n_dev, "fused_idx")
        nb = len(tmax2) // n_dev
        reads = _on_each(devices, reads_nib, np.int8)
        ins = [to_device(scal[:, a:b], np.int32, d)
               for d, (a, b) in zip(devices, lanes)]
        outs = [fused_idx_local(
                    reads[d], s, tmax2[k * nb:(k + 1) * nb], prm, texts[d],
                    qmax_l=qmax_l, tmax_l=tmax_l, qmax_r=qmax_r,
                    tmax_r=tmax_r, a_max=a_max)
                for k, (d, s) in enumerate(zip(devices, ins))]
        return collect(outs, 1)

    fn = _counted(fused_idx)
    fn.fused = True
    fn.idx = True
    fn.bp_quantum = blk_l * n_dev
    return fn


def _global_shards(devices, query, qlen, target, tlen, w, mat, pens):
    """global_cuda.global_batch (the kernel on a card, the plain version on
    the CPU) of host arrays with the tasks split over `devices`: (score
    (B,), steps (qmax + tmax, B)) CPU tensors."""
    from bwamem_tpu_torch.ops.global_cuda import global_batch
    from bwamem_tpu_torch.ops.global_torch import band_width

    band = band_width(qlen, tlen, w, query.shape[1])
    lanes = _lanes(query.shape[0], len(devices), len(devices), "global")
    mats, pens = _on_each(devices, mat, np.int32), _on_each(devices, pens,
                                                             np.int32)
    ins = [[to_device(x[a:b], np.int32, d)
            for x in (query, qlen, target, tlen, w)]
           for d, (a, b) in zip(devices, lanes)]
    outs = [global_batch(*x, mats[d], pens[d], band=band)
            for d, x in zip(devices, ins)]
    return (torch.cat([s.cpu() for s, _ in outs]),
            torch.cat([st.cpu() for _, st in outs], 1))


def make_sharded_global_batch(devices, *, qmax: int, tmax: int):
    """The batched banded global alignment with traceback
    (global_cuda.global_batch) with the tasks split over `devices`:
    fn(query (B, qmax), qlen, target (B, tmax), tlen, w, mat, pens) ->
    (score (B,), steps (qmax + tmax, B)) numpy, B a multiple of n_dev
    (`b_quantum`)."""
    devices = device_list(devices)

    def sharded(query, qlen, target, tlen, w, mat, pens):
        if query.shape[1] != qmax or target.shape[1] != tmax:
            raise ValueError(f"windows {query.shape[1]}, {target.shape[1]}; "
                             f"this program is for {qmax}, {tmax}")
        s, st = _global_shards(devices, query, qlen, target, tlen, w, mat,
                               pens)
        return s.numpy(), st.numpy()

    sharded.b_quantum = len(devices)
    return sharded


def make_sharded_cigar_backend(devices):
    """The host-shipped-segment CIGAR backend of NativePipeline's
    mp_cigar_* rounds (global_torch.make_cigar_backend's contract) with
    the fill and traceback split over `devices`; the run-length encoding
    stays on the host (pack_cigar_round).  B a multiple of n_dev."""
    from bwamem_tpu_torch.ops.global_torch import pack_cigar_round

    devices = device_list(devices)

    def fn(q_i8, t_i8, meta, mat, o_del, e_del, o_ins, e_ins):
        # the JAX backend caches one program a (qmax, tmax) bucket; in
        # PyTorch nothing is compiled for a shape
        return pack_cigar_round(*_global_shards(
            devices, q_i8, meta[0], t_i8, meta[1], meta[2], mat,
            [o_del, e_del, o_ins, e_ins]))

    fn.b_quantum = len(devices)
    return fn


def make_sharded_rescue_backend(devices):
    """The host-shipped-window mate-rescue backend of NativePipeline's
    mp_rescue_* waves (local_torch.make_rescue_backend's contract:
    fn(seq_i8, rseq_i8, lens, mat, o_del, e_del, o_ins, e_ins) -> (6, Bp)
    int32 numpy) with the batched local SW (local_cuda.align6: the kernel
    on a card) split over `devices`.  Bp a multiple of n_dev."""
    from bwamem_tpu_torch.ops.local_cuda import align6

    devices = device_list(devices)
    n_dev = len(devices)

    def fn(seq_i8, rseq_i8, lens, mat, o_del, e_del, o_ins, e_ins):
        lanes = _lanes(seq_i8.shape[0], n_dev, n_dev, "rescue")
        mats = _on_each(devices, mat, np.int32)
        pens = _on_each(devices, [o_del, e_del, o_ins, e_ins], np.int32)
        ins = [[to_device(x, np.int32, d) for x in (
                    seq_i8[a:b], lens[0][a:b], rseq_i8[a:b], lens[1][a:b])]
               for d, (a, b) in zip(devices, lanes)]
        return collect([align6(*x, mats[d], pens[d])
                        for d, x in zip(devices, ins)], 1)

    fn.b_quantum = n_dev
    return fn


def make_sharded_rescue_idx_backend(devices, pac=None, text_dev=None):
    """The resident-reference mate-rescue backend
    (resident.make_rescue_idx_backend's contract) with the (6, Bp) meta
    block split over `devices` and the text and read matrix replicated;
    each shard runs resident.rescue_idx_local.  `text_dev`: one text a
    distinct device (replicate_text).  Bp a multiple of n_dev."""
    from bwamem_tpu_torch.pipeline.resident import rescue_idx_local

    devices = device_list(devices)
    n_dev = len(devices)
    texts = _texts(devices, pac, text_dev)

    def rescue_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins, qmax,
                   tmax):
        lanes = _lanes(meta.shape[1], n_dev, n_dev, "rescue_idx")
        reads = _on_each(devices, reads_nib, np.int8)
        mats = _on_each(devices, mat, np.int32)
        pens = _on_each(devices, [o_del, e_del, o_ins, e_ins], np.int32)
        ins = [to_device(meta[:, a:b], np.int32, d)
               for d, (a, b) in zip(devices, lanes)]
        return collect([rescue_idx_local(reads[d], m, mats[d], pens[d],
                                         texts[d], qmax=qmax, tmax=tmax)
                        for d, m in zip(devices, ins)], 1)

    rescue_idx.idx = True
    rescue_idx.b_quantum = n_dev
    return rescue_idx


def make_sharded_cigar_idx_backend(devices, pac=None, text_dev=None):
    """The resident-reference CIGAR backend
    (resident.make_cigar_idx_backend's contract) with the (8, Bp) meta
    block split over `devices` and the text and read matrix replicated;
    each shard runs resident.cigar_idx_local, the run-length encoding
    stays on the host.  `text_dev` as in make_sharded_rescue_idx_backend;
    Bp a multiple of n_dev."""
    from bwamem_tpu_torch.ops.global_torch import band_width, pack_cigar_round
    from bwamem_tpu_torch.pipeline.resident import cigar_idx_local

    devices = device_list(devices)
    n_dev = len(devices)
    texts = _texts(devices, pac, text_dev)

    def cigar_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins, qmax,
                  tmax):
        lanes = _lanes(meta.shape[1], n_dev, n_dev, "cigar_idx")
        reads = _on_each(devices, reads_nib, np.int8)
        mats = _on_each(devices, mat, np.int32)
        pens = _on_each(devices, [o_del, e_del, o_ins, e_ins], np.int32)
        ins = [to_device(meta[:, a:b], np.int32, d)
               for d, (a, b) in zip(devices, lanes)]
        band = band_width(meta[0], meta[1], meta[2], qmax)
        outs = [cigar_idx_local(reads[d], m, mats[d], pens[d], texts[d],
                                qmax=qmax, tmax=tmax, band=band)
                for d, m in zip(devices, ins)]
        return pack_cigar_round(torch.cat([s.cpu() for s, _ in outs]),
                                torch.cat([st.cpu() for _, st in outs], 1))

    cigar_idx.idx = True
    cigar_idx.b_quantum = n_dev
    return cigar_idx


class ShardedPrograms(smem_torch.Programs):
    """The three seeding programs with their rows split over `devices`
    (smem_torch.Programs' interface, numpy out): each distinct device
    holds its own DeviceOcc and sampled SA; each shard runs
    ops/smem_cuda's wrapper (the kernel on a CUDA device, the plain
    version on the CPU) and the shards' rows are joined in order.  Row
    counts need not be multiples of n_dev: the split is uneven where they
    are not.  The chunk's reads arrive on the first device and each shard
    is copied from there."""

    # the wrappers each shard runs (ops/smem_sharded.TableShardedPrograms
    # runs its own over the tables it shares)
    smem_all = staticmethod(smem_cuda.smem_all)
    smem1 = staticmethod(smem_cuda.smem1)
    sa = staticmethod(smem_cuda.sa)

    def __init__(self, devices, po, ssa, sa_intv: int):
        self.devices = device_list(devices)
        self.tables = {d: smem_torch.DeviceOcc(po, d)
                       for d in distinct(self.devices)}
        super().__init__(self.tables[self.devices[0]], ssa, sa_intv)
        self.ssas = {d: self.ssa.to(d) for d in self.tables}

    def _shards(self, n):
        return list(zip(self.devices, split_rows(n, len(self.devices))))

    def all_fn(self, q, qlen, msl):
        ins = [(d, q[a:b].to(d), qlen[a:b].to(d))
               for d, (a, b) in self._shards(q.shape[0])]
        return collect([self.smem_all(self.tables[d], qs, ls, msl)
                        for d, qs, ls in ins], 0)

    def smem1_fn(self, q, qlen, x, min_intv, mask):
        mask = mask.astype(np.uint8)
        ins = [(d, q[a:b].to(d), qlen[a:b].to(d),
                *(torch.from_numpy(np.ascontiguousarray(v[a:b])).to(d)
                  for v in (x, min_intv, mask)))
               for d, (a, b) in self._shards(q.shape[0])]
        return collect([self.smem1(self.tables[d], *xs)
                        for d, *xs in ins], 0)

    def sa_fn(self, rows):
        ins = [(d, torch.from_numpy(np.ascontiguousarray(rows[a:b])).to(d))
               for d, (a, b) in self._shards(rows.shape[0])]
        return collect([self.sa(self.tables[d], self.ssas[d],
                                self.sa_intv, r)
                        for d, r in ins], 0)


def make_sharded_device_seeder(devices, po, fm, opt,
                               table_sharded: bool | None = None):
    """Device seeding with each chunk's reads, re-seed jobs and SA rows
    split over `devices`: the `seed_fn(reads) -> (n, 4) int64 rows` of
    smem_cuda.make_device_seeder, rows equal to the single-device
    seeder's in value and order.  Two regimes, as the JAX package's:

    - reads-sharded (below 2^31 index rows by default): each device holds
      its own copy of the tables;
    - table-sharded (at 2^31 index rows or more, or table_sharded=True):
      the tables split by block range over the devices, each read from
      its owner (ops/smem_sharded.make_table_sharded_seeder; every pair of
      cards needs peer access).

    A reads-sharded regime forced (table_sharded=False) on an index of
    2^31 rows or more: ValueError."""
    if table_sharded is None:
        table_sharded = int(po.n_rows) >= 1 << 31
    if table_sharded:
        from bwamem_tpu_torch.ops.smem_sharded import (
            make_table_sharded_seeder,
        )

        return make_table_sharded_seeder(devices, po, fm, opt)
    if int(po.n_rows) >= 1 << 31:
        raise ValueError(
            "reads-sharded device seeding requires n_rows < 2^31; "
            "use table_sharded=True (the default at this scale)")
    return smem_torch.seeder(ShardedPrograms(devices, po, fm.ssa,
                                             fm.sa_intv), fm, opt)


def shard_batch(devices, arrays):
    """A tuple or dict of (B, ...) host arrays as one tuple or dict of
    tensors a device, each holding its contiguous slice of the first
    dimension; B must be a multiple of len(devices)."""
    devices = device_list(devices)
    n_dev = len(devices)

    def split(a):
        a = np.asarray(a)
        return [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(d)
                for d, (lo, hi) in zip(devices, _lanes(
                    a.shape[0], n_dev, n_dev, "shard_batch"))]

    if isinstance(arrays, dict):
        parts = {k: split(v) for k, v in arrays.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n_dev)]
    parts = [split(a) for a in arrays]
    return [tuple(p[i] for p in parts) for i in range(n_dev)]
