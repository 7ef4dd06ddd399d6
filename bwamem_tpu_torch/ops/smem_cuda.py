"""The seeding kernels on the card: wrappers of csrc/fm_seed.cu, and the
kernel seeder of `mem --backend cuda --device-seed`.

`smem_all`, `smem1` and `sa` dispatch on the tensors' device.  On the CPU
they run the plain PyTorch versions (ops/smem_torch.py); on a CUDA device
they launch the hand-written kernel (bwt_smem_all, bwt_smem1, bwt_sa) or
raise: there is no fallback.  `launches` counts kernel launches per
kernel (the CPU path does not count).

The seeder runs smem_torch's host flow over the kernels: per chunk one
H2D copy of the (B, L) uint8 reads, one bwt_smem_all launch, one
bwt_smem1 launch a split re-seed round, one bwt_sa launch over all seed
rows.  Each copies back only what the host flow reads (`Programs`): the
head columns, then the slots up to the largest count, and for bwt_smem1
only the round's jobs, into pinned memory.  Reads and re-seed jobs whose
slots overflowed take the exact scalar search on the host
(index/fmindex.smem1), the algorithm's own overflow path as in the JAX
package; `seed_fn.stats` counts them."""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.ops import smem_torch
from bwamem_tpu_torch.ops.smem_torch import ALL_COLS, SMEM1_COLS, DeviceOcc

launches = {"bwt_smem_all": 0, "bwt_smem1": 0, "bwt_sa": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def device_of(d: DeviceOcc, *xs):
    """The tensors' device when it is a CUDA device, None for the CPU;
    raises unless d's tables and every tensor lie on one device."""
    dev = xs[0].device
    for x in xs:
        if x.device != dev or d.device != dev:
            raise ValueError(f"tables on {d.device}, tensors on "
                             f"{[str(y.device) for y in xs]}")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_arg(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, want {dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(x.shape)}, want a "
                         f"contiguous {tuple(shape)}")


def _launch(name, dev, d: DeviceOcc, *args) -> None:
    """Launch `name` of the kernel library on dev's current stream over
    d's tables; raise if the launch failed, count it if not."""
    from bwamem_tpu_torch.ops import _build

    _build.launch(dev, name, d.rec.data_ptr(), d.C.data_ptr(), d.primary,
                  d.n_rows, *args)
    with _count_lock:
        launches[name] += 1


def smem_all(d: DeviceOcc, q, qlen, min_seed_len: int):
    """The first SMEM round of every read (smem_torch.smem_all): q (B, L)
    uint8 codes, qlen (B,) int64; returns (B, ALL_COLS) int64."""
    dev = device_of(d, q, qlen)
    if dev is None:
        return smem_torch.smem_all(d, q, qlen, min_seed_len)
    B, L = q.shape
    check_arg("q", q, torch.uint8, (B, L))
    check_arg("qlen", qlen, torch.int64, (B,))
    out = torch.empty((B, ALL_COLS), dtype=torch.int64, device=dev)
    if B:
        _launch("bwt_smem_all", dev, d, q.data_ptr(), L, qlen.data_ptr(), B,
                int(min_seed_len), out.data_ptr())
    return out


def smem1(d: DeviceOcc, q, qlen, x, min_intv, mask):
    """One bwt_smem1 call a read (smem_torch.smem1) at x where mask is
    set, at x = qlen (nothing) where not: q (B, L) uint8, qlen / x /
    min_intv (B,) int64, mask (B,) uint8.  Returns smem_torch.pack_smem1's
    (B, SMEM1_COLS) int64 layout."""
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
        _launch("bwt_smem1", dev, d, q.data_ptr(), L, qlen.data_ptr(),
                x.data_ptr(), min_intv.data_ptr(), mask.data_ptr(), B,
                out.data_ptr())
    return out


def sa(d: DeviceOcc, ssa, sa_intv: int, rows, max_it=None):
    """Text positions of SA rows (smem_torch.sa_batch): ssa (n_ssa,) and
    rows (n,) int64; returns (n,) int64 (0 for a walk that takes more
    than max_it steps, smem_torch.sa_max_it by default)."""
    dev = device_of(d, ssa, rows)
    if max_it is None:
        max_it = smem_torch.sa_max_it(d.n_rows)
    if dev is None:
        return smem_torch.sa_batch(d, ssa, sa_intv, rows, max_it=max_it)
    check_arg("ssa", ssa, torch.int64, (ssa.shape[0],))
    check_arg("rows", rows, torch.int64, (rows.shape[0],))
    n = rows.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _launch("bwt_sa", dev, d, ssa.data_ptr(), ssa.shape[0], int(sa_intv),
                rows.data_ptr(), n, int(max_it), out.data_ptr())
    return out


class Programs(smem_torch.Programs):
    """smem_torch's host flow over the wrappers above, each returning the
    narrowed form smem_torch.Programs describes: the head columns ([cnt,
    ovf] or [ret, ovf, n]) are copied back first, then one gather on the
    device makes the head and the first C slots of each field, C the
    largest count, one contiguous tensor, copied back in one piece;
    bwt_smem1's rows are the round's jobs only.  On a CUDA device every
    copy goes through a pinned buffer of this thread's own, one a
    program, grown as needed (one seeder serves every --inflight thread);
    what is returned is a copy, not a view of it.  `_narrow` takes a list
    of outputs (parallel/dist.ShardedPrograms passes one a shard) and
    cuts them all to one C."""

    def __init__(self, d, ssa, sa_intv: int):
        super().__init__(d, ssa, sa_intv)
        self._pinned = threading.local()

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.d.device)

    def _host(self, name, t):
        """The tensor t as a numpy array of its own."""
        if t.device.type != "cuda" or t.numel() == 0:
            return t.cpu().numpy().copy()
        n = t.numel()
        buf = getattr(self._pinned, name, None)
        if buf is None or buf.numel() < n:
            size = max(n, 0 if buf is None else 2 * buf.numel())
            buf = torch.empty(size, dtype=t.dtype, pin_memory=True)
            setattr(self._pinned, name, buf)
        view = buf[:n].view(t.shape)
        view.copy_(t)
        return view.numpy().copy()

    def _narrow(self, name, outs, head, n_col, cap):
        """The outputs `outs` (one a shard, in row order) joined: each
        one's head columns and the first C of each field's `cap` slots,
        C = the largest count (head column n_col) of any row of any of
        them, so every part has the same width.  Every head is copied
        back before any body."""
        C = max(int(self._host(name + "_head", o[:, :head])[:, n_col].max(
            initial=0)) for o in outs)
        return np.concatenate([self._host(name, torch.cat(
            [o[:, :head], o[:, head:].view(len(o), 5, cap)[:, :, :C]
             .reshape(len(o), 5 * C)], 1)) for o in outs])

    def all_fn(self, q, qlen, msl):
        return self._narrow("all", [smem_all(self.d, q, qlen, msl)], 2, 0,
                            smem_torch.ALL_CAP)

    def smem1_fn(self, q, qlen, x, min_intv, mask):
        out = smem1(self.d, q, qlen, self._put(x), self._put(min_intv),
                    self._put(mask.astype(np.uint8)))
        jobs = out.index_select(0, self._put(np.nonzero(mask)[0]))
        return self._narrow("smem1", [jobs], 3, 2, smem_torch.M_CAP)

    def sa_fn(self, rows):
        return self._host("sa", sa(self.d, self.ssa, self.sa_intv,
                                   self._put(rows)))


def make_device_seeder(po, fm, opt, device):
    """The kernel seeder on `device` (a CUDA device; the CPU runs the plain
    versions): tables copied there once, each call seeds one chunk.
    ValueError for an index of 2^31 rows or more, as the JAX package's
    seeder raises."""
    if po.n_rows >= 1 << 31:
        raise ValueError("device SA lookup requires n_rows < 2^31")
    return smem_torch.seeder(
        Programs(DeviceOcc(po, device), fm.ssa, fm.sa_intv), fm, opt)
