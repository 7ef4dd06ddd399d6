"""The extension kernels on the card: wrappers of csrc/extend_fused.cu
and csrc/extend_t.cu.

`extend_batch_raw_fused` and `extend_batch_raw_t` dispatch on the
tensors' device.  On the CPU they run the plain PyTorch versions
(ops/extend_torch.extend_fused, extend_t); on a CUDA device they launch
the hand-written kernel or raise — there is no fallback.  `launches`
counts kernel launches per kernel, keyed "extend_fused" and "extend_t"
(the CPU path does not count)."""

from __future__ import annotations

import threading

import torch

from bwamem_tpu_torch.ops import extend_torch

launches = {"extend_fused": 0, "extend_t": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _check(name, x, dtype, dev, rows=None, cols=None):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, want {dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 2-D tensor")
    if x.device != dev:
        raise ValueError(f"{name} on {x.device}, want {dev}")
    if rows is not None and x.shape[0] != rows:
        raise ValueError(f"{name}: {x.shape[0]} rows, want {rows}")
    if cols is not None and x.shape[1] != cols:
        raise ValueError(f"{name}: {x.shape[1]} lanes, want {cols}")
    if x.shape[0] < 1:
        raise ValueError(f"{name}: empty window")


def _cuda_device(x):
    """x's device when it is a CUDA device; None for the CPU."""
    dev = x.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_prm(prm) -> list[int]:
    """[a, b, o_del, e_del, o_ins, e_ins, zdrop] for the kernels, which
    look a cell's substitution score up in a word of signed bytes: a and
    b must lie in 0..127."""
    ints = extend_torch.prm_ints(prm)
    if not (0 <= ints[0] <= 127 and 0 <= ints[1] <= 127):
        raise ValueError(f"match score {ints[0]} or mismatch penalty "
                         f"{ints[1]} outside 0..127")
    return ints


def _launch(name, dev, fn, *args) -> None:
    """Call the C launcher `fn` on dev's current stream; raise if the
    launch failed, count it if not."""
    from bwamem_tpu_torch.ops import _build

    kl = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(kl.lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {kl.lib.bwt_error_string(rc)}")
    with _count_lock:
        launches[name] += 1


def extend_batch_raw_fused(ql, tl, qr, tr, scal, tmax2, prm):
    """Fused L0/L1/R0/R1 extension of every lane (see
    extend_torch.extend_fused for the layout).  On CUDA the windows
    must be int8 and scal int32, all contiguous on one device.  tmax2
    (the Pallas call's per-block row bounds) is not read: each lane
    stops at its own tlen.  Returns (32, B) int32 on the inputs'
    device."""
    dev = _cuda_device(ql)
    if dev is None:
        return extend_torch.extend_fused(ql, tl, qr, tr, scal, tmax2, prm)
    B = ql.shape[1]
    for name, x in (("ql", ql), ("tl", tl), ("qr", qr), ("tr", tr)):
        _check(name, x, torch.int8, dev, cols=B)
    _check("scal", scal, torch.int32, dev, rows=16, cols=B)
    QL, QR = ql.shape[0], qr.shape[0]
    if max(QL, QR) > 1024:
        raise ValueError(f"query window {max(QL, QR)} > 1024")
    out = torch.empty((32, B), dtype=torch.int32, device=dev)
    _launch("extend_fused", dev, "bwt_extend_fused",
            ql.data_ptr(), QL, tl.data_ptr(), tl.shape[0], qr.data_ptr(),
            QR, tr.data_ptr(), tr.shape[0], scal.data_ptr(), B,
            *kernel_prm(prm), out.data_ptr())
    return out


def extend_batch_raw_t(query_t, target_t, scal_t, tmax, prm):
    """One banded pass per lane (see extend_torch.extend_t for the
    layout).  On CUDA the windows must be int8 and scal_t (8, B) int32,
    all contiguous on one device, and qmax <= 1024 (the packed argmax
    key of the plain version and the Pallas kernel).  tmax (the Pallas
    call's per-block row bounds) is not read: each lane stops at its
    own tlen.  Returns (8, B) int32 on the inputs' device."""
    dev = _cuda_device(query_t)
    if dev is None:
        return extend_torch.extend_t(query_t, target_t, scal_t, tmax, prm)
    qmax, B = query_t.shape
    _check("query_t", query_t, torch.int8, dev, cols=B)
    _check("target_t", target_t, torch.int8, dev, cols=B)
    _check("scal_t", scal_t, torch.int32, dev, rows=8, cols=B)
    if qmax > 1024:
        raise ValueError(f"query window {qmax} > 1024")
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    _launch("extend_t", dev, "bwt_extend_t",
            query_t.data_ptr(), qmax, target_t.data_ptr(),
            target_t.shape[0], scal_t.data_ptr(), B,
            *kernel_prm(prm), out.data_ptr())
    return out
