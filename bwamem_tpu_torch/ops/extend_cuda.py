"""The extension kernels on the card: wrappers of csrc/extend_fused.cu
and csrc/extend_t.cu.

`extend_batch_raw_fused` and `extend_batch_raw_t` dispatch on the
tensors' device.  On the CPU they run the plain PyTorch versions
(ops/extend_torch.extend_fused, extend_t); on a CUDA device they launch
the hand-written kernel or raise — there is no fallback.  Both take
`compute_dtype` as the Pallas entry points do: torch.int32 (the default)
or torch.int16, the kernels with 16-bit cells (two query columns a
register under Hopper's packed DPX instructions), which
`check_i16_range` admits only where they equal the 32-bit ones; nothing
falls back from them to the 32-bit kernels or to the plain version.
`launches` counts kernel launches per kernel, keyed "extend_fused",
"extend_t", "extend_fused_i16" and "extend_t_i16" (the CPU path does not
count)."""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.ops import extend_torch

launches = {"extend_fused": 0, "extend_t": 0, "extend_fused_i16": 0,
            "extend_t_i16": 0}
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


def check_i16_range(prm, qmax: int, tmax: int) -> None:
    """Raise ValueError unless 16-bit cells give the 32-bit result for
    every lane of a (qmax, B) query window and a (tmax, B) target window
    under the scoring block `prm`.  Decided from host data alone: no
    device tensor is read.

    The cells are signed 16-bit with -2^14 / +2^14 as minus and plus
    infinity (extend_pallas._band_pass at dt == int16).  With R = 2*tmax
    the most rows a lane may run (tlen may pass the window, whose last
    row is then re-read, by no more than the window), the intermediates
    and what bounds each:

    - H, E, F <= h0 + a*min(qlen, rows): a cell gains at most `a` a
      diagonal step.  Data: every lane needs h0 + a*qmax < 2^14; the
      static part is a*qmax < 2^14.
    - the F scan's ramp P = M + e_ins*j - oe_ins and the sentinel less
      the ramp, -2^14 - e_ins*(j-1): 2^14 + e_ins*(qmax-1) <= 2^15, which
      with the line above keeps P below 2^15.
    - M - oe_ins, M - oe_del at the sentinel M = -2^14: o_ins + e_ins
      and o_del + e_del <= 2^14.
    - the first column, h0 - (o_del + e_del*(i+1)), i < R:
      o_del + e_del*R < 2^15.
    - the Z-drop penalty |(i - max_i) - (mj - max_j)| * e, at most
      (qmax + R) * max(e_del, e_ins) < 2^15, and 0 <= zdrop < 2^15.
    - the band clamp i + aw + 1 and i - aw: R <= 2^14 and, data,
      0 <= aw < 2^14.
    - the column numbers: qmax <= 1024 (the int32 key H*1024 + j); a and
      b in 0..127 and every penalty >= 0, as for the 32-bit kernels.
    """
    a, b, o_del, e_del, o_ins, e_ins, zdrop = kernel_prm(prm)
    R = 2 * tmax
    lim, half = 1 << 15, 1 << 14
    checks = (
        (min(o_del, e_del, o_ins, e_ins) >= 0, "a negative gap penalty"),
        (qmax <= 1024, f"query window {qmax} > 1024"),
        (a * qmax < half, f"a*qmax = {a * qmax} >= 2^14"),
        (half + e_ins * (qmax - 1) <= lim,
         f"2^14 + e_ins*(qmax-1) = {half + e_ins * (qmax - 1)} > 2^15"),
        (o_ins + e_ins <= half and o_del + e_del <= half,
         "a gap open + extend > 2^14"),
        (o_del + e_del * R < lim,
         f"o_del + e_del*2*tmax = {o_del + e_del * R} >= 2^15"),
        ((qmax + R) * max(e_del, e_ins) < lim,
         f"(qmax + 2*tmax)*max(e_del, e_ins) = "
         f"{(qmax + R) * max(e_del, e_ins)} >= 2^15"),
        (0 <= zdrop < lim, f"zdrop {zdrop} outside 0..2^15-1"),
        (R <= half, f"target window {tmax} > 2^13"),
    )
    for ok, why in checks:
        if not ok:
            raise ValueError(f"outside the 16-bit cells' exact range: {why}")


def check_i16_lanes(prm, scal, qsum: int) -> None:
    """The per-lane half of check_i16_range, from the HOST copy of the
    scalar block (numpy, before its H2D copy: no device tensor is read).
    scal is (8, B) [qlen, tlen, aw, h0, ...] with qsum = qmax, or the
    fused (16, B) block (h0_seed in row 3, the four bands in rows 2, 4,
    7, 8) with qsum = QL + QR: the right passes start from the left
    score, which may reach h0_seed + a*QL.  Raises ValueError unless
    every lane has 0 <= h0, h0 + a*qsum < 2^14 and 0 <= aw < 2^14."""
    scal = np.asarray(scal)
    a = kernel_prm(prm)[0]
    half = 1 << 14
    h0 = scal[3]
    aw = scal[[2, 4, 7, 8]] if scal.shape[0] == 16 else scal[2]
    if h0.size and (int(h0.min()) < 0 or int(h0.max()) + a * qsum >= half):
        raise ValueError(
            f"outside the 16-bit cells' exact range: a lane's h0 + "
            f"a*{qsum} = {int(h0.max()) + a * qsum} >= 2^14, or h0 < 0")
    if aw.size and (int(aw.min()) < 0 or int(aw.max()) >= half):
        raise ValueError(
            f"outside the 16-bit cells' exact range: a lane's band "
            f"{int(aw.min())}..{int(aw.max())} outside 0..2^14-1")


def _kernel_name(name, compute_dtype, prm, qmax, tmax) -> str:
    """The kernel `compute_dtype` selects, after its range check."""
    if compute_dtype == torch.int32:
        return name
    if compute_dtype != torch.int16:
        raise ValueError(f"compute_dtype {compute_dtype}: want torch.int32 "
                         f"or torch.int16")
    check_i16_range(prm, qmax, tmax)
    return name + "_i16"


def _launch(name, dev, fn, *args) -> None:
    """Call the C launcher `fn` on dev's current stream; raise if the
    launch failed, count it if not."""
    from bwamem_tpu_torch.ops import _build

    _build.launch(dev, fn, *args)
    with _count_lock:
        launches[name] += 1


def extend_batch_raw_fused(ql, tl, qr, tr, scal, tmax2, prm,
                           compute_dtype=torch.int32):
    """Fused L0/L1/R0/R1 extension of every lane (see
    extend_torch.extend_fused for the layout).  On CUDA the windows
    must be int8 and scal int32, all contiguous on one device.  tmax2
    (the Pallas call's per-block row bounds) is not read: each lane
    stops at its own tlen.  compute_dtype=torch.int16 runs the 16-bit
    cells (kernel or plain version) and raises ValueError outside
    check_i16_range; beyond that check every lane needs
    h0 + a*(QL + QR) < 2^14 and aw < 2^14, which the backend factories
    check on the host copy of scal (check_i16_lanes).  Returns (32, B) int32 on
    the inputs' device."""
    dev = _cuda_device(ql)
    name = _kernel_name("extend_fused", compute_dtype, prm,
                        max(ql.shape[0], qr.shape[0]),
                        max(tl.shape[0], tr.shape[0]))
    if dev is None:
        return extend_torch.extend_fused(ql, tl, qr, tr, scal, tmax2, prm,
                                         compute_dtype=compute_dtype)
    B = ql.shape[1]
    for what, x in (("ql", ql), ("tl", tl), ("qr", qr), ("tr", tr)):
        _check(what, x, torch.int8, dev, cols=B)
    _check("scal", scal, torch.int32, dev, rows=16, cols=B)
    QL, QR = ql.shape[0], qr.shape[0]
    if max(QL, QR) > 1024:
        raise ValueError(f"query window {max(QL, QR)} > 1024")
    out = torch.empty((32, B), dtype=torch.int32, device=dev)
    _launch(name, dev, "bwt_" + name,
            ql.data_ptr(), QL, tl.data_ptr(), tl.shape[0], qr.data_ptr(),
            QR, tr.data_ptr(), tr.shape[0], scal.data_ptr(), B,
            *kernel_prm(prm), out.data_ptr())
    return out


def extend_batch_raw_t(query_t, target_t, scal_t, tmax, prm,
                       compute_dtype=torch.int32):
    """One banded pass per lane (see extend_torch.extend_t for the
    layout).  On CUDA the windows must be int8 and scal_t (8, B) int32,
    all contiguous on one device, and qmax <= 1024 (the packed argmax
    key of the plain version and the Pallas kernel).  tmax (the Pallas
    call's per-block row bounds) is not read: each lane stops at its
    own tlen.  compute_dtype=torch.int16 as in extend_batch_raw_fused
    (every lane needs h0 + a*qmax < 2^14 and aw < 2^14).  Returns (8, B)
    int32 on the inputs' device."""
    dev = _cuda_device(query_t)
    name = _kernel_name("extend_t", compute_dtype, prm, query_t.shape[0],
                        target_t.shape[0])
    if dev is None:
        return extend_torch.extend_t(query_t, target_t, scal_t, tmax, prm,
                                     compute_dtype=compute_dtype)
    qmax, B = query_t.shape
    _check("query_t", query_t, torch.int8, dev, cols=B)
    _check("target_t", target_t, torch.int8, dev, cols=B)
    _check("scal_t", scal_t, torch.int32, dev, rows=8, cols=B)
    if qmax > 1024:
        raise ValueError(f"query window {qmax} > 1024")
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    _launch(name, dev, "bwt_" + name,
            query_t.data_ptr(), qmax, target_t.data_ptr(),
            target_t.shape[0], scal_t.data_ptr(), B,
            *kernel_prm(prm), out.data_ptr())
    return out
