"""The CIGAR global alignment on the card: the wrapper of
csrc/global_sw.cu.

`global_batch` dispatches on the tensors' device.  On the CPU it runs the
plain PyTorch version (ops/global_torch.global_batch); on a CUDA device it
launches the hand-written kernel bwt_global_cigar (fill and traceback of
a round in one launch) or raises: there is no fallback.  Every device
caller of the port (the shipped and the resident CIGAR backends, their
sharded twins, global_torch.ksw_global_batch) reaches the kernel through
it.  `launches` counts kernel launches, keyed "global_cigar" (the CPU path
does not count)."""

from __future__ import annotations

import threading

import torch

from bwamem_tpu_torch.ops import global_torch
from bwamem_tpu_torch.ops.local_cuda import check_task_args, cuda_device_of

launches = {"global_cigar": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def global_batch(query, qlen, target, tlen, w, mat, pens, *, band=None):
    """Fill and traceback of every task (global_torch.global_batch:
    arguments and result as there).  On CUDA every argument must be a
    contiguous int32 tensor on one device, pens a (4,) tensor.  `band`, a
    host integer, is the round's widest band (global_torch.band_width of
    the lanes, which the callers have on the host): the kernel's window is
    sized from it; None sizes it for the whole query window (qmax), which
    every lane fits.  Raises if a lane's band is wider than the window (the
    kernel flags it).  Returns (score (B,) int32, steps (qmax + tmax, B)
    int8) on the inputs' device."""
    dev = cuda_device_of(query, qlen, target, tlen, w, mat, pens)
    if dev is None:
        return global_torch.global_batch(query, qlen, target, tlen, w, mat,
                                         pens)
    from bwamem_tpu_torch.ops import _build

    B, qmax, tmax = check_task_args(query, qlen, target, tlen, mat, pens, w)
    band = qmax if band is None else int(band)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty((qmax + tmax, B), dtype=torch.int8, device=dev)
    if B:
        lib = _build.load().lib
        with torch.cuda.device(dev):   # the launch's card's shared memory
            n = int(lib.bwt_global_cigar_scratch(qmax, tmax, band, B))
        scratch = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        _build.launch(dev, "bwt_global_cigar", query.data_ptr(), qmax,
                      qlen.data_ptr(), target.data_ptr(), tmax,
                      tlen.data_ptr(), w.data_ptr(), B, band,
                      mat.data_ptr(), pens.data_ptr(), score.data_ptr(),
                      steps.data_ptr(), err.data_ptr(), scratch.data_ptr())
        with _count_lock:
            launches["global_cigar"] += 1
        if err.item():
            raise ValueError(f"bwt_global_cigar: band {band} is narrower "
                             f"than a lane's band (global_torch.band_width)")
    return score, steps
