"""Device seeding, plain PyTorch: the batched SMEM search and SA walks.

The JAX package runs seeding on the device as three jitted lockstep
programs over the packed occ tables (bwamem_tpu/ops/smem_jax.py:
`_smem1_kernel`, `_smem_all_kernel`, `_sa_kernel`).  This module is their
plain PyTorch version, on any device: `smem1`, `smem_all` and `sa_batch`
give the JAX programs' outputs (positions int64 here, int32 there),
including their slot caps and overflow flags (P_CAP = 24 live intervals,
M_CAP = 64 emissions a call, ALL_CAP = 128 seeds a read in the first
round).  It serves the CPU tests, `mem --backend torch --device-seed`, and
the card's gate, which holds the CUDA kernels of csrc/fm_seed.cu
(ops/smem_cuda.py) to it.

The three functions read the tables only through `d.occ[blk]`,
`d.pk[blk]`, `d.va[blk]` (rows gathered by block) and `ssa[k]`, so they run
unchanged over a DeviceOcc (the whole index on one device) or a
ShardedOcc (the index split by block range over several devices, the
plain version of ops/smem_sharded.py's kernels), where each gather goes to
the owning shard.  On the device the three tables are column views of
one (blocks, REC_WORDS) int32 tensor of block records (`block_records`,
the kernels' layout): a block's checkpoints and words lie in one 64-byte
row, so a kernel's rank4 query or LF step reads one line.

`device_smems` / `collect_seeds_device` are the host flow around the
three programs, shared with the kernel seeder: one first-round call,
split re-seed rounds (at most one job a read a round), bwa's max_occ
subsampling, one SA call over all rows; a read any of whose slots
overflowed is seeded whole by the C++ engine the host path runs
(`exact_seeder`, csrc/smem.cpp bwamem_collect_seeds), or, at 2^31
index rows or more, by the Python scalar search.  The seed rows
{read_idx, rbeg, qbeg, len} come out in the exact order of that engine,
so NativePipeline.mp_chunk_start_seeded takes either seeder's rows.

Torch has no `>>` for uint32 on the CPU: the packed words are held as
int32 on the device (the kernel's layout) and widened to int64 and masked
to 32 bits after the gather.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.index.smem_batch import M_CAP, P_CAP
from bwamem_tpu_torch.utils.metrics import span

ALL_CAP = 128   # first-round seeds a read (smem_jax.ALL_CAP)
EXACT_MAX_ROWS = 1 << 31   # the C++ engine's int32 checkpoints hold less
PIECES = 4      # runs of overflowed reads a seeding thread (exact_seeder)
SMEM1_COLS = 3 + 5 * M_CAP     # [ret, ovf, n, qb.., qe.., x0.., x1.., s..]
ALL_COLS = 2 + 5 * ALL_CAP     # [cnt, ovf, qb.., qe.., x0.., x1.., s..]

_M32 = 0xFFFFFFFF
_M55 = 0x55555555


def table_tensor(a, device):
    """A table of a PackedOcc as a tensor on `device`: a numpy array is
    copied (uint32 words held as int32), a tensor (int32 words made on
    the device) moved only if it lies elsewhere."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


REC_WORDS = 16                  # fmseed::kRecWords (csrc/fm_seed.cuh)
REC_COLS = (slice(0, 4), slice(4, 8), slice(8, 12))   # occ, pk, va


def block_records(tables, device, n=None):
    """The kernels' layout of a PackedOcc's tables: `tables` = (occ, pk,
    va), each (rows, 4) (numpy or tensors, the words' uint32 held as
    int32), interleaved into one (n, REC_WORDS) int32 tensor on `device`
    whose row b is block b's record [occ[b], pk[b], va[b], 0 x 4]; n is
    the longest table's rows unless given (rows past n are left out, rows
    a table lacks are 0).  Returns the records and the three tables as
    column views of them, each with its table's rows (at most n)."""
    if n is None:
        n = max(len(a) for a in tables)
    rec = torch.zeros((n, REC_WORDS), dtype=torch.int32, device=device)
    views = []
    for a, cols in zip(tables, REC_COLS):     # one table on the device at once
        m = min(len(a), n)
        rec[:m, cols].copy_(table_tensor(a[:m], rec.device))
        views.append(rec[:m, cols])
    return rec, views


class DeviceOcc:
    """The packed occ tables of a PackedOcc (index/occ_packed.py) on
    `device` as one tensor of block records, `rec` ((NB+1, REC_WORDS)
    int32, block_records), and its column views occ (NB+1, 4) int32
    checkpoints, pk / va (NB, 4) uint32 words held as int32, each equal
    to the PackedOcc's table; C (6,) int64.  The PackedOcc's occ / pk /
    va may also be tensors already (a table made on the card); its C is a
    numpy array."""

    def __init__(self, po, device):
        self.rec, (self.occ, self.pk, self.va) = block_records(
            (po.occ_rows, po.pk_rows, po.va_rows), device)
        self.device = self.rec.device     # with its index: "cuda" -> cuda:0
        self.C = table_tensor(np.asarray(po.C, np.int64), device)
        self.primary = int(po.primary)
        self.n_rows = int(po.n_rows)


class BlockShards:
    """The rows of one table split in contiguous ranges over shards:
    shard k (a tensor on any device) holds the global rows [origin +
    k * n_loc, origin + (k+1) * n_loc).  Indexing with a tensor of global
    rows gathers each from its owning shard onto the index's device (the
    plain version of the kernels' block_of / sample_at, csrc/
    fm_seed.cuh): every shard gathers at the clamped local row and the
    owner's answer is kept (a row no shard owns gives 0, as the JAX
    module's masked psum).  len() is the number of rows the shards hold
    for real (`n`)."""

    def __init__(self, parts, n_loc: int, origin: int = 0, n: int = 0):
        self.parts = list(parts)
        self.n_loc = int(n_loc)
        self.origin = int(origin)
        self.n = int(n)

    def __len__(self):
        return self.n

    def __getitem__(self, rows):
        g = rows - self.origin
        s = torch.div(g, self.n_loc, rounding_mode="floor")
        loc = (g - s * self.n_loc).clamp(0, self.n_loc - 1)
        out = None
        for k, part in enumerate(self.parts):
            got = part[loc.to(part.device)].to(rows.device)
            mine = (s == k).reshape(s.shape + (1,) * (got.dim() - s.dim()))
            out = torch.where(mine, got, 0 if out is None else out)
        return out


class ShardedOcc:
    """A table-sharded index (ops/smem_sharded.ShardedSeedTables) as the
    plain version on `device` sees it: occ / pk / va and the sampled SA
    `ssa` as BlockShards, C (6,) int64 on `device`; the DeviceOcc
    interface otherwise."""

    def __init__(self, tabs, device):
        self.tabs = tabs
        self.device = torch.device(device)
        self.occ, self.pk, self.va = (
            BlockShards(parts, tabs.nb_loc, tabs.blk_origin)
            for parts in (tabs.occ, tabs.pk, tabs.va))
        self.ssa = BlockShards(tabs.ssa, tabs.ns_loc, 0, tabs.n_ssa)
        self.C = torch.as_tensor(tabs.C, dtype=torch.int64,
                                 device=self.device)
        self.primary = tabs.primary
        self.n_rows = tabs.n_rows


def _count(stats, key, mask) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(mask.sum())


def _count_rows(stats, key, mask) -> None:
    """stats[key], an int64 tensor of mask's shape, += mask, row by row
    (a read, or an SA row)."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + mask.long()


def _popcount32(x):
    """Bits set in each int64 element < 2^32."""
    x = x - ((x >> 1) & _M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def rank4(d: DeviceOcc, i):
    """Counts of each base 0..3 in bwt[0:i) for int64 positions i of any
    shape (values in [0, n_rows]); returns (..., 4) int64."""
    blk = i >> 6
    r = i & 63
    base = d.occ[blk].long()
    w = d.pk[blk].long() & _M32
    v = d.va[blk].long() & _M32
    k = torch.arange(4, device=i.device)
    nsym = (r[..., None] - 16 * k).clamp(0, 16)
    pmask = torch.where(nsym >= 16, _M32, (1 << (2 * nsym)) - 1)
    pat = (k * _M55)[:, None]                       # (4 bases, 1)
    t = w[..., None, :] ^ pat                       # (..., 4 bases, 4 words)
    nt = ~t & _M32
    q = nt & (nt >> 1) & _M55 & (v & pmask)[..., None, :]
    return _popcount32(q).sum(-1) + base


def extend_backward4(d: DeviceOcc, x0, x1, s):
    """All four backward extensions of the bi-intervals (x0, x1, s):
    (nx0, nx1, ns), each (..., 4) int64 (index/occ_packed.py)."""
    tk = rank4(d, x0)
    tl = rank4(d, x0 + s)
    ns = tl - tk
    nx0 = d.C[:4] + tk
    has = ((x0 <= d.primary) & (d.primary < x0 + s)).long()
    n3 = x1 + has
    n2 = n3 + ns[..., 3]
    n1 = n2 + ns[..., 2]
    n0 = n1 + ns[..., 1]
    return nx0, torch.stack([n0, n1, n2, n3], -1), ns


def extend_forward4(d: DeviceOcc, x0, x1, s):
    """All four forward extensions P.c: the backward extension of the
    reverse complement by 3-c, x0 and x1 swapped back."""
    bx0, bx1, bs = extend_backward4(d, x1, x0, s)
    rev = [3, 2, 1, 0]
    return bx1[..., rev], bx0[..., rev], bs[..., rev]


def _take(a, idx):
    """a[b, idx[b]] for a (B, K) and idx (B,)."""
    return a.gather(1, idx[:, None])[:, 0]


def smem1(d: DeviceOcc, q, qlen, x, min_intv, stats=None):
    """bwt_smem1 at per-read positions x, the twin of smem_jax.
    _smem1_kernel.  q (B, L) base codes (4 = N or pad), qlen / x /
    min_intv (B,); any integer dtype, all on d.device.  Returns the eight
    (B,) / (B, M_CAP) int64 tensors (ret, overflow, m_qb, m_qe, m_x0,
    m_x1, m_s, m_n); emission slots past m_n are 0.  `stats["rank4"]`
    (when given) counts the rank4 queries the live lanes need,
    `stats["records"]` the 64-byte block records they read (one a
    query), and `stats["rounds"]` ((B,) int64) each read's rounds of
    dependent gathers: one a forward step, one a backward step with a
    live slot (a backward step extends all its slots at once)."""
    q = q.long()
    qlen, x, min_intv = qlen.long(), x.long(), min_intv.long()
    B, L = q.shape
    dev = q.device
    iotaP = torch.arange(P_CAP, device=dev)
    iotaM = torch.arange(M_CAP, device=dev)

    at_x = _take(q, x.clamp(max=L - 1))
    startable = (x < qlen) & (at_x < 4)
    c0 = torch.where(startable, at_x.clamp(0, 3), 0)
    zero = torch.zeros_like(x)
    cx0 = torch.where(startable, d.C[c0], zero)
    cs = torch.where(startable, d.C[c0 + 1] - d.C[c0], zero)
    cx1 = torch.where(startable, d.C[3 - c0], zero)
    cqe = x + 1

    f = torch.zeros((4, B, P_CAP), dtype=torch.long, device=dev)
    f_n = torch.zeros_like(x)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)

    def fpush(mask):
        nonlocal f, f_n, overflow
        ok = mask & (f_n < P_CAP)
        oh = (iotaP == f_n[:, None]) & ok[:, None]
        f = torch.where(oh, torch.stack([cx0, cx1, cs, cqe])[:, :, None], f)
        overflow = overflow | (mask & (f_n >= P_CAP))
        f_n = f_n + ok.long()

    active = startable
    for t in range(1, L + 1):
        if not bool(active.any()):
            break
        i = x + t
        at_end = active & (i >= qlen)
        ch = _take(q, i.clamp(0, L - 1))
        amb = active & ~at_end & (ch > 3)
        fpush(at_end | amb)
        active = active & ~(at_end | amb)
        _count(stats, "rank4", 2 * active)
        _count(stats, "records", 2 * active)
        _count_rows(stats, "rounds", active)
        nx0, nx1, ns = extend_backward4(d, cx1, cx0, cs)
        cc = (3 - ch).clamp(0, 3)
        ex1, ex0, es = _take(nx0, cc), _take(nx1, cc), _take(ns, cc)
        changed = active & (es != cs)
        fpush(changed)
        active = active & ~(changed & (es < min_intv))
        cx0 = torch.where(active, ex0, cx0)
        cx1 = torch.where(active, ex1, cx1)
        cs = torch.where(active, es, cs)
        cqe = torch.where(active, i + 1, cqe)
    fpush(active)
    has = startable & (f_n > 0)
    ret = torch.where(has, _take(f[3], (f_n - 1).clamp(min=0)), x + 1)

    # prev = the forward list reversed (longest first)
    ridx = (f_n[:, None] - 1 - iotaP).clamp(0, P_CAP - 1)
    inb = iotaP < f_n[:, None]
    p = torch.where(inb, f.gather(2, ridx.expand(4, B, P_CAP)), 0)
    p_n = f_n
    m = torch.zeros((5, B, M_CAP), dtype=torch.long, device=dev)
    m_n = torch.zeros_like(x)
    back_active = startable & (p_n > 0)
    for t in range(1, L + 2):
        if not bool(back_active.any()):
            break
        i = x - t
        live = back_active & (i >= -1)
        ch = torch.where(i >= 0, _take(q, i.clamp(min=0)), 4)
        cvalid = live & (i >= 0) & (ch < 4)
        p_x0, p_x1, p_s, p_qe = p
        has = live[:, None] & (iotaP < p_n[:, None])
        _count(stats, "rank4", 2 * (has & cvalid[:, None]))
        _count(stats, "records", 2 * (has & cvalid[:, None]))
        _count_rows(stats, "rounds", live & cvalid & (p_n > 0))
        nx0, nx1, ns = extend_backward4(d, p_x0, p_x1, p_s)
        chc = ch.clamp(0, 3)[:, None, None].expand(B, P_CAP, 1)
        sel_x0 = nx0.gather(2, chc)[..., 0]
        sel_x1 = nx1.gather(2, chc)[..., 0]
        sel_s = ns.gather(2, chc)[..., 0]
        # the slot compaction of smem_jax.py:236-286: a kept slot is
        # pushed unless its s equals the last kept slot's; at most one
        # slot emits a step, the first stop slot before any keep
        stop = has & (~cvalid[:, None] | (sel_s < min_intv[:, None]))
        keep = has & ~stop
        keep_i = keep.long()
        ncum = keep_i.cumsum(1)
        kidx = torch.where(keep, iotaP, -1)
        prev_kidx = torch.cat([torch.full((B, 1), -1, dtype=torch.long,
                                          device=dev),
                               kidx.cummax(1).values[:, :-1]], 1)
        prev_s = sel_s.gather(1, prev_kidx.clamp(min=0))
        push = keep & ((prev_kidx < 0) | (sel_s != prev_s))
        key = torch.where(push, iotaP, P_CAP)
        order = key.argsort(dim=1, stable=True)
        n_cnt = push.long().sum(1)
        inb_n = iotaP < n_cnt[:, None]
        new = torch.stack([sel_x0, sel_x1, sel_s, p_qe])
        new = torch.where(inb_n, new.gather(2, order.expand(4, B, P_CAP)), 0)
        cand = stop & (ncum - keep_i == 0)
        any_cand = cand.any(1)
        first_j = torch.where(cand, iotaP, P_CAP).min(1).values.clamp(
            max=P_CAP - 1)
        lastm = (m_n - 1).clamp(min=0)
        emit = any_cand & ((m_n == 0) | (i + 1 < _take(m[0], lastm))) \
            & (m_n < M_CAP)
        ohm = (iotaM == m_n[:, None]) & emit[:, None]
        vals = torch.stack([i + 1, _take(p_qe, first_j), _take(p_x0, first_j),
                            _take(p_x1, first_j), _take(p_s, first_j)])
        m = torch.where(ohm, vals[:, :, None], m)
        m_n = m_n + emit.long()
        p, p_n = new, n_cnt
        back_active = back_active & (n_cnt > 0)
    overflow = overflow | (m_n >= M_CAP)
    return (ret, overflow.long(), m[0], m[1], m[2], m[3], m[4], m_n)


def pack_smem1(outs):
    """smem1's eight outputs as one (B, SMEM1_COLS) int64 matrix:
    [ret, ovf, n, qb.., qe.., x0.., x1.., s..] (the kernel's layout)."""
    ret, ovf, qb, qe, x0, x1, s, n = outs
    return torch.cat([ret[:, None], ovf[:, None], n[:, None],
                      qb, qe, x0, x1, s], 1)


def smem_all(d: DeviceOcc, q, qlen, min_seed_len, stats=None):
    """The whole first SMEM round of every read, the twin of smem_jax.
    _smem_all_kernel: start pointers advance in lockstep (an N run is
    skipped in one round), one smem1 round at each frontier, and the
    emissions of length >= min_seed_len append per read in the host
    path's order (rounds ascending, each call's emissions reversed).
    Returns (B, ALL_COLS) int64 [cnt, ovf, qb.., qe.., x0.., x1.., s..]
    with ALL_CAP slots; slots past cnt are 0.  `stats` as smem1's, summed
    over the rounds."""
    q = q.long()
    qlen = qlen.long()
    B, L = q.shape
    dev = q.device
    kI = torch.arange(M_CAP, device=dev)
    idxL = torch.arange(L, device=dev)
    nn = torch.where(q <= 3, idxL, L)
    next_nn = nn.flip(1).cummin(1).values.flip(1)
    ones = torch.ones_like(qlen)
    x = torch.zeros_like(qlen)
    sl = torch.zeros((5, B, ALL_CAP + 1), dtype=torch.long, device=dev)
    cnt = torch.zeros_like(qlen)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    while bool((x < qlen).any()):
        at = _take(q, x.clamp(max=L - 1))
        todo = x < qlen
        skip = todo & (at > 3)
        x_adv = torch.where(skip, _take(next_nn, x.clamp(max=L - 1)), x)
        active = todo & ~skip
        ret, o, m_qb, m_qe, m_x0, m_x1, m_s, m_n = smem1(
            d, q, qlen, torch.where(active, x_adv, qlen), ones, stats)
        keep = (kI < m_n[:, None]) & ((m_qe - m_qb) >= min_seed_len) \
            & active[:, None]
        csum = keep.long().cumsum(1)
        total = csum[:, -1]
        tgt = torch.where(keep, cnt[:, None] + total[:, None] - csum,
                          ALL_CAP).clamp(max=ALL_CAP)
        sl.scatter_(2, tgt.expand(5, B, M_CAP),
                    torch.stack([m_qb, m_qe, m_x0, m_x1, m_s]))
        new_cnt = cnt + torch.where(active, total, 0)
        ovf = ovf | (active & o.bool()) | (new_cnt > ALL_CAP)
        x = torch.where(active, ret, x_adv)
        cnt = new_cnt.clamp(max=ALL_CAP)
    # the spill column ALL_CAP took duplicate writes: drop it
    return torch.cat([cnt[:, None], ovf.long()[:, None],
                      sl[:, :, :ALL_CAP].permute(1, 0, 2).reshape(B, -1)], 1)


def sa_max_it(n_rows: int) -> int:
    """The steps after which an SA walk gives up (smem_jax._sa_kernel's
    bound): n_rows + 1, at most 2^31 - 1."""
    return min(int(n_rows) + 1, (1 << 31) - 1)


def sa_batch(d: DeviceOcc, ssa, sa_intv: int, rows, stats=None,
             max_it=None):
    """Text positions of SA rows (bwt_sa), the twin of smem_jax.
    _sa_kernel: LF walks in lockstep until each row reaches the primary
    row or a sampled row, or until max_it steps (sa_max_it by default;
    such a row gives 0).  ssa: the sampled SA as int64 on d.device (or a
    ShardedOcc's BlockShards); rows (N,) int64.  Returns (N,) int64.
    `stats["rank4"]` / `stats["lf"]` count the rank4 queries and the LF
    steps taken, `stats["records"]` the block records read (one a step),
    `stats["rounds"]` ((N,) int64) each row's LF steps."""
    return sa_walk(d, ssa, sa_intv, rows, stats, max_it)[0]


def sa_walk(d: DeviceOcc, ssa, sa_intv: int, rows, stats=None,
            max_it=None):
    """sa_batch's walks: (N,) int64 positions and the (N,) bool mask of
    the rows whose walk ended within max_it steps."""
    r = rows.long().clone()
    dpt = torch.zeros_like(r)
    val = torch.zeros_like(r)
    done = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    n_ssa = len(ssa)
    for _ in range(sa_max_it(d.n_rows) if max_it is None else max_it):
        hitp = ~done & (r == d.primary)
        val = torch.where(hitp, dpt, val)
        done = done | hitp
        sampled = ~done & (r % sa_intv == 0)
        val = torch.where(sampled, ssa[(r // sa_intv) % n_ssa] + dpt, val)
        done = done | sampled
        if bool(done.all()):
            break
        _count(stats, "rank4", ~done)
        _count(stats, "lf", ~done)
        _count(stats, "records", ~done)
        _count_rows(stats, "rounds", ~done)
        blk = r >> 6
        off = r & 63
        lane = 2 * (off & 15)
        word = (off >> 4)[..., None]
        w = d.pk[blk].gather(-1, word)[..., 0].long() & _M32
        vw = d.va[blk].gather(-1, word)[..., 0].long() & _M32
        sym = (w >> lane) & 3
        vbit = (vw >> lane) & 1
        rk4 = rank4(d, r)
        rankc = rk4.gather(-1, sym[..., None])[..., 0]
        n_before = r - rk4.sum(-1) - (r > d.primary).long()
        c_idx = torch.where(vbit == 1, sym, 4)
        rankc = torch.where(vbit == 1, rankc, n_before)
        newr = d.C[c_idx] + rankc
        r = torch.where(done, r, newr)
        dpt = torch.where(done, dpt, dpt + 1)
    return val, done


# ---------------------------------------------------------------------
# the host flow around the three programs (shared with ops/smem_cuda.py)
# ---------------------------------------------------------------------

class Stats:
    """What a seeder did, summed over its calls (threads share one):
    `ovf_reads` the reads whose first round overflowed its slots,
    `ovf_jobs` the re-seed jobs that did, `exact_reads` the reads the C++
    engine seeded whole for either."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {"chunks": 0, "reads": 0, "split_rounds": 0,
                       "split_jobs": 0, "ovf_reads": 0, "ovf_jobs": 0,
                       "exact_reads": 0}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self.counts[k] += int(v)


class Programs:
    """The three seeding programs behind one interface, as numpy in,
    numpy out: `all_fn(q, qlen, msl)` -> (B, ALL_COLS), `smem1_fn(q, qlen,
    x, min_intv, mask)` -> (B, SMEM1_COLS), `sa_fn(rows)` -> (N,), each
    int64.  q is the chunk's (B, L) uint8 codes and qlen (B,) int64,
    already on the device.  Each also takes `rec`, None or a `counter()`
    that the call adds the block records it read to (64-byte rows: one a
    rank4 query or an LF step); `records(rec)` reads it.  `counter()` is
    None where the programs do not count them.  This class runs the plain
    versions.

    The host flow also takes the narrowed forms a program may return
    instead (ops/smem_cuda.Programs): all_fn's slots cut to W <= ALL_CAP
    a field, (B, 2 + 5W); smem1_fn's rows cut to the masked-in reads, in
    read order, and its slots to W <= M_CAP a field, (R, 3 + 5W).  W
    covers every row's count."""

    def __init__(self, d: DeviceOcc, ssa, sa_intv: int):
        self.d = d
        self.ssa = torch.from_numpy(np.ascontiguousarray(ssa, np.int64)).to(
            d.device)
        self.sa_intv = int(sa_intv)

    def counter(self):
        return [0]

    def records(self, rec) -> int:
        return rec[0]

    def all_fn(self, q, qlen, msl, rec=None):
        st = None if rec is None else {}
        out = smem_all(self.d, q, qlen, msl, st).cpu().numpy()
        _tally(rec, st)
        return out

    def smem1_fn(self, q, qlen, x, min_intv, mask, rec=None):
        dev = self.d.device
        x = torch.where(torch.from_numpy(mask).to(dev),
                        torch.from_numpy(x).to(dev), qlen)
        st = None if rec is None else {}
        out = pack_smem1(smem1(self.d, q, qlen, x, torch.from_numpy(
            min_intv).to(dev), st)).cpu().numpy()
        _tally(rec, st)
        return out

    def sa_fn(self, rows, rec=None):
        st = None if rec is None else {}
        out = sa_batch(self.d, self.ssa, self.sa_intv, torch.from_numpy(
            rows).to(self.d.device), st).cpu().numpy()
        _tally(rec, st)
        return out


def _tally(rec, stats) -> None:
    """A plain call's stats["records"] added to the chunk's counter."""
    if rec is not None:
        rec[0] += stats.get("records", 0)


def scalar_seeds(fm, q, qlen, opt):
    """The exact seed rows {read_idx, rbeg, qbeg, len} of the reads of q
    by the Python scalar search (pipeline/chain.collect_seeds over
    index/fmindex.smem1), values and order those of the C++ engine."""
    from bwamem_tpu_torch.pipeline.chain import collect_seeds

    rows = [(b, s.rbeg, s.qbeg, s.len) for b in range(len(q))
            for s in collect_seeds(fm, q[b, :qlen[b]].astype(np.int64), opt)]
    return np.array(rows, np.int64).reshape(-1, 4)


def exact_seeder(po, fm, opt, threads: int = 1):
    """The seeding of reads whose slots overflowed: the C++ engine the
    host path runs (csrc/smem.cpp bwamem_collect_seeds through
    native.collect_seeds_native), which gives the exact seed rows in the
    order the device flow gives its own.  Returns `exact(q, qlen)` ->
    (n, 4) int64 rows {read_idx, rbeg, qbeg, len} of the reads of q ((R,
    L) uint8 codes, qlen (R,) int64), read_idx into q, the reads split in
    contiguous runs, PIECES a thread, over `threads` threads (the binding
    drops the GIL).
    An index of EXACT_MAX_ROWS rows or more, which the engine's int32
    checkpoints cannot hold (the table-sharded seeder's regime), is
    searched by the Python scalar search instead (scalar_seeds)."""
    from concurrent.futures import ThreadPoolExecutor

    from bwamem_tpu_torch import native

    split_len = split_len_of(opt)

    def one(q, qlen):
        got = native.collect_seeds_native(
            po, fm.ssa, fm.sa_intv, q, qlen, opt.min_seed_len, split_len,
            opt.split_width, opt.max_occ)
        if got is not None:
            return got[1]
        if native.get_lib() is None:
            raise RuntimeError("the native host library is unavailable")
        if len(q) == 1:
            raise RuntimeError("a read has more seed rows than the C++ "
                               "engine's buffer holds")
        # more rows than the binding's buffer (4 a base, at least
        # 65,536): seed the halves apart
        h = len(q) // 2
        lo, hi = one(q[:h], qlen[:h]), one(q[h:], qlen[h:])
        hi[:, 0] += h
        return np.concatenate([lo, hi])

    def exact(q, qlen):
        if po.n_rows >= EXACT_MAX_ROWS:
            return scalar_seeds(fm, q, qlen, opt)
        n = len(q)
        k = max(1, min(int(threads), n))
        if k == 1:
            return one(q, qlen)
        # PIECES runs a thread, taken as threads come free: the reads
        # that overflow are the repeat-rich ones, and one slow run (or one
        # core taken by another process) would otherwise hold the chunk
        cut = np.linspace(0, n, min(n, PIECES * k) + 1).astype(np.int64)
        with ThreadPoolExecutor(k) as ex:
            parts = list(ex.map(lambda a, b: one(q[a:b], qlen[a:b]),
                                cut[:-1], cut[1:]))
        for a, part in zip(cut[:-1], parts):
            part[:, 0] += a
        return np.concatenate(parts)

    return exact


def device_smems(progs, q, qlen, min_seed_len: int, split_len: int,
                 split_width: int, tracer=None, rec=None):
    """Batched mem_collect_intv on the programs (smem_jax.
    collect_smems_device's flow): one first-round call, split re-seed
    rounds (a read's k-th job in round k).  q (B, L) uint8 codes and qlen
    (B,) int64 on the host.  Returns (mems, bad, counts): the (read, qb,
    qe, x0, x1, s) int64 rows of the reads none of whose slots overflowed,
    sorted by (read, qb, qe) with ties in the host path's order; the (B,)
    mask of the reads whose first round or a re-seed job overflowed, which
    have no rows; and the counts (split_rounds, split_jobs, ovf_reads,
    ovf_jobs).  `rec`: the programs' counter() the calls count into."""
    B = len(q)
    dev = progs.d.device
    with span(tracer, "seed.smem_all"):
        q_d = torch.from_numpy(q).to(dev)
        qlen_d = torch.from_numpy(qlen).to(dev)
        packed = progs.all_fn(q_d, qlen_d, int(min_seed_len), rec)
    cnt, ovf = packed[:, 0], packed[:, 1].astype(bool)
    bad = ovf.copy()
    W = (packed.shape[1] - 2) // 5           # ALL_CAP, or narrowed
    slots = packed[:, 2:].reshape(B, 5, W)
    take = (np.arange(W) < cnt[:, None]) & ~ovf[:, None]
    rd, k = np.nonzero(take)                 # by read, then slot
    first = np.stack([rd, *(slots[rd, f, k] for f in range(5))], 1)

    # second round: re-seed long low-occurrence SMEMs from their middle;
    # a read's k-th job runs in round k
    sel = ((first[:, 2] - first[:, 1]) >= split_len) \
        & (first[:, 5] <= split_width)
    jobs = first[sel]
    rank = np.zeros(len(jobs), np.int64)
    if len(jobs):
        start = np.r_[0, np.nonzero(np.diff(jobs[:, 0]))[0] + 1]
        rank = np.arange(len(jobs)) - np.repeat(
            start, np.diff(np.r_[start, len(jobs)]))
    out = [first]
    n_rounds = n_ovf_jobs = 0
    for k in range(int(rank.max()) + 1 if len(jobs) else 0):
        jk = jobs[rank == k]
        jk = jk[~bad[jk[:, 0]]]   # a read that overflowed goes to C++ whole
        if not len(jk):
            continue
        n_rounds += 1
        rb = jk[:, 0]
        xs = np.zeros(B, np.int64)
        mis = np.ones(B, np.int64)
        mask = np.zeros(B, bool)
        xs[rb] = (jk[:, 1] + jk[:, 2]) // 2
        mis[rb] = jk[:, 5] + 1
        mask[rb] = True
        with span(tracer, "seed.reseed"):
            res = progs.smem1_fn(q_d, qlen_d, xs, mis, mask, rec)
        if len(res) == B:       # every read's row: keep the round's jobs
            res = res[mask]
        rd_of = np.nonzero(mask)[0]     # res row k is read rd_of[k]
        r_ovf = res[:, 1].astype(bool)
        m_n = res[:, 2]
        W = (res.shape[1] - 3) // 5     # M_CAP, or narrowed
        f = res[:, 3:].reshape(len(res), 5, W)
        # each call's emissions reversed: slot m_n-1 first
        slot = m_n[:, None] - 1 - np.arange(W)
        ok = ~r_ovf[:, None] & (slot >= 0)
        k, j = np.nonzero(ok)
        sl = slot[k, j]
        got = np.stack([rd_of[k], *(f[k, c, sl] for c in range(5))], 1)
        out.append(got[(got[:, 2] - got[:, 1]) >= min_seed_len])
        n_ovf_jobs += int(r_ovf.sum())
        bad[rd_of[r_ovf]] = True
    allm = np.concatenate(out)
    allm = allm[~bad[allm[:, 0]]]
    seq = np.arange(len(allm))
    order = np.lexsort((seq, allm[:, 2], allm[:, 1], allm[:, 0]))
    return allm[order], bad, dict(split_rounds=n_rounds,
                                  split_jobs=len(jobs),
                                  ovf_reads=int(ovf.sum()),
                                  ovf_jobs=n_ovf_jobs)


def occurrences(mems, max_occ: int):
    """The SA rows of each SMEM's occurrences under bwa's subsampling
    rule: step = s // max_occ when s > max_occ, rows x0, x0 + step, ...,
    at most max_occ of them.  Returns (index into mems, row) int64."""
    s = mems[:, 5]
    step = np.where(s > max_occ, s // max(max_occ, 1), 1)
    n_occ = np.minimum(max_occ, (s + step - 1) // step)
    idx = np.repeat(np.arange(len(mems)), n_occ)
    first = np.cumsum(n_occ) - n_occ
    rows = mems[idx, 3] + (np.arange(len(idx)) - first[idx]) * step[idx]
    return idx, np.ascontiguousarray(rows, np.int64)


def collect_seeds_device(progs, exact, q, qlen, min_seed_len: int,
                         split_len: int, split_width: int, max_occ: int,
                         stats=None, tracer=None):
    """Device seeding of a chunk: the (n, 4) int64 seed rows {read_idx,
    rbeg, qbeg, len} of csrc/smem.cpp bwamem_collect_seeds, values and
    order.  The programs seed every read (device_smems, then one SA call
    over all rows); a read whose slots overflowed, in its first round or
    in a re-seed job, is seeded whole by `exact` (exact_seeder), and its
    rows take its place in read order.  Under `tracer`, the calls are the
    spans seed.smem_all, seed.reseed (a round), seed.sa and seed.exact,
    and the counts go to the span open around the call (Tracer.note).
    `q`, `qlen`: the chunk's (B, L) uint8 code matrix (4 past each read's
    end) and (B,) int64 read lengths, as NativePipeline holds them."""
    B = len(q)
    # the kernels count the block records they read only under a tracer
    rec = None if tracer is None else progs.counter()
    mems, bad, counts = device_smems(progs, q, qlen, min_seed_len,
                                     split_len, split_width, tracer, rec)
    idx, rows = occurrences(mems, max_occ)
    out = np.empty((len(idx), 4), np.int64)
    if len(idx):
        with span(tracer, "seed.sa"):
            out[:, 1] = progs.sa_fn(rows, rec)
        out[:, 0] = mems[idx, 0]
        out[:, 2] = mems[idx, 1]
        out[:, 3] = mems[idx, 2] - mems[idx, 1]
    redo = np.nonzero(bad)[0]
    if len(redo):
        with span(tracer, "seed.exact", n_reads=len(redo)):
            ex = exact(q[redo], qlen[redo])
        ex[:, 0] = redo[ex[:, 0]]
        out = np.concatenate([out, ex])
        out = out[np.argsort(out[:, 0], kind="stable")]
    counts["exact_reads"] = len(redo)
    if stats is not None:
        stats.add(chunks=1, reads=B, **counts)
    if tracer is not None:
        tracer.note(**counts, **({} if rec is None
                                 else {"records": progs.records(rec)}))
    return out


def split_len_of(opt) -> int:
    """The re-seed length threshold bwa derives from -k and -r."""
    return int(opt.min_seed_len * opt.split_factor + 0.499)


def seeder(progs, exact, opt):
    """A `seed_fn(q, qlen, tracer=None) -> (n, 4) int64 rows` for
    NativePipeline.seed_fn over `progs` (q and qlen as
    collect_seeds_device takes them), the overflowed reads seeded by
    `exact` (exact_seeder); its Stats are `seed_fn.stats`."""
    stats = Stats()
    split_len = split_len_of(opt)

    def seed_fn(q, qlen, tracer=None):
        return collect_seeds_device(progs, exact, q, qlen, opt.min_seed_len,
                                    split_len, opt.split_width, opt.max_occ,
                                    stats, tracer)

    seed_fn.stats = stats
    return seed_fn


def make_device_seeder(po, fm, opt, device, threads: int = 1):
    """The plain seeder on `device`: tables copied there once, each call
    seeds one chunk, the overflowed reads on `threads` host threads.
    ValueError for an index of 2^31 rows or more, as the JAX package's
    seeder raises."""
    if po.n_rows >= 1 << 31:
        raise ValueError("device SA lookup requires n_rows < 2^31")
    return seeder(Programs(DeviceOcc(po, device), fm.ssa, fm.sa_intv),
                  exact_seeder(po, fm, opt, threads), opt)
