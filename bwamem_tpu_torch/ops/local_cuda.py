"""The mate-rescue local alignment on the card: the wrapper of
csrc/local_sw.cu.

`align6` dispatches on the tensors' device.  On the CPU it runs the plain
PyTorch version (ops/local_torch.align6); on a CUDA device it launches the
hand-written kernel bwt_local_align6 (the whole ksw_align of a wave in one
launch) or raises: there is no fallback.  Every device caller of the port
(the shipped and the resident rescue backends, their sharded twins,
local_torch.ksw_align_batch) reaches the kernel through it.  `launches`
counts kernel launches, keyed "local_align6" (the CPU path does not
count)."""

from __future__ import annotations

import threading

import torch

from bwamem_tpu_torch.ops import local_torch
from bwamem_tpu_torch.ops.smem_cuda import check_arg

launches = {"local_align6": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def cuda_device_of(*xs):
    """The tensors' device when it is a CUDA device, None for the CPU;
    raises unless every tensor lies on one device."""
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"tensors on {[str(y.device) for y in xs]}, "
                             f"want one device")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_task_args(query, qlen, target, tlen, mat, pens, *extra):
    """The shapes of a batch of B tasks: query (B, qmax) and target (B,
    tmax) with qmax, tmax >= 1, qlen, tlen and each of `extra` (B,), mat
    (5, 5), pens (4,); all contiguous int32.  Returns (B, qmax, tmax)."""
    if query.dim() != 2 or target.dim() != 2:
        raise ValueError("query and target must be 2-D (B, window)")
    B, qmax = query.shape
    tmax = target.shape[1]
    if qmax < 1 or tmax < 1:
        raise ValueError(f"empty window ({qmax}, {tmax})")
    i32 = torch.int32
    check_arg("query", query, i32, (B, qmax))
    check_arg("target", target, i32, (B, tmax))
    for name, x in (("qlen", qlen), ("tlen", tlen),
                    *((f"lane scalar {k}", x) for k, x in enumerate(extra))):
        check_arg(name, x, i32, (B,))
    check_arg("mat", mat, i32, (5, 5))
    check_arg("pens", pens, i32, (4,))
    return B, qmax, tmax


def align6(query, qlen, target, tlen, mat, pens):
    """The whole ksw_align of every task (local_torch.align6: arguments,
    result and the all-zero padding lanes as there).  On CUDA every
    argument must be a contiguous int32 tensor on one device.  Returns (6, B) int32 [score, qb, qe, tb, te, score2] on the
    inputs' device."""
    dev = cuda_device_of(query, qlen, target, tlen, mat, pens)
    if dev is None:
        return local_torch.align6(query, qlen, target, tlen, mat, pens)
    from bwamem_tpu_torch.ops import _build

    B, qmax, tmax = check_task_args(query, qlen, target, tlen, mat, pens)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    if B:
        lib = _build.load().lib
        scratch = torch.empty(
            max(int(lib.bwt_local_align6_scratch(qmax, tmax, B)), 1),
            dtype=torch.uint8, device=dev)
        _build.launch(dev, "bwt_local_align6", query.data_ptr(), qmax,
                      qlen.data_ptr(), target.data_ptr(), tmax,
                      tlen.data_ptr(), B, mat.data_ptr(), pens.data_ptr(),
                      out.data_ptr(), scratch.data_ptr())
        with _count_lock:
            launches["local_align6"] += 1
    return out
