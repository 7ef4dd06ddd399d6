"""Host half of the per-phase extension: the counterpart of
bwamem_tpu/ops/extend_pallas.py:480-582 (`pack_scal`,
`extend_batch_core`, `extend_batch`, `make_raw_backend`).

Everything takes numpy and returns `types.ExtendOut` of numpy arrays.
The packing, transposing and narrowing to int8 happen here on the host;
the device sees the (qmax, B) / (tmax, B) int8 windows and the (8, B)
int32 scalars of `extend_cuda.extend_batch_raw_t` — the kernel on a
CUDA device, the plain version on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from bwamem_tpu_torch.device import resolve
from bwamem_tpu_torch.ops import extend_cuda
from bwamem_tpu_torch.ops.types import ExtendOut, params_vector


def pack_scal(qlen, tlen, aw, h0, blk_b: int = 128):
    """Host-side packing of the (B, 8) scalar block [qlen, tlen, aw, h0,
    0...] and the per-block row bound tmax (B/blk_b,): the longest tlen
    among the block's lanes with qlen > 0.  B must be a multiple of
    blk_b."""
    B = len(qlen)
    scal = np.zeros((B, 8), np.int32)
    scal[:, 0] = qlen
    scal[:, 1] = tlen
    scal[:, 2] = aw
    scal[:, 3] = h0
    grid = B // blk_b
    tl = np.asarray(tlen, np.int32).reshape(grid, blk_b)
    vq = np.asarray(qlen, np.int32).reshape(grid, blk_b)
    tmax = np.max(np.where(vq > 0, tl, 0), axis=1).astype(np.int32)
    return scal, tmax


def _run(query, qlen, target, tlen, aw, h0, prm, blk_b, device,
         compute_dtype=torch.int32) -> ExtendOut:
    """Pack row-major (B, qmax) / (B, tmax) tasks, run one pass on
    `device` and unpack the (8, B) result."""
    scal, tmax = pack_scal(np.asarray(qlen), np.asarray(tlen),
                           np.asarray(aw), np.asarray(h0), blk_b=blk_b)
    if compute_dtype == torch.int16:
        extend_cuda.check_i16_lanes(prm, scal.T, np.asarray(query).shape[1])

    def dev_t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).T, dt)).to(device)

    out = extend_cuda.extend_batch_raw_t(
        dev_t(query, np.int8), dev_t(target, np.int8), dev_t(scal, np.int32),
        tmax, prm, compute_dtype=compute_dtype).cpu().numpy()
    return ExtendOut(score=out[0], qle=out[1], tle=out[2], gtle=out[3],
                     gscore=out[4], max_off=out[5], w_used=out[6])


def extend_batch_core(query, qlen, target, tlen, aw, h0, params, *,
                      blk_b: int = 128, device="cuda") -> ExtendOut:
    """One banded extension pass (no doubling) of B row-major tasks:
    query (B, qmax) and target (B, tmax) base codes 0-4, the rest (B,).
    B must be a multiple of blk_b (pad with qlen == 0 tasks).  Runs on
    the card unless `device` says otherwise (device.resolve: a card asked
    for and absent raises)."""
    return _run(query, qlen, target, tlen, aw, h0, params_vector(params),
                blk_b, resolve(device))


def extend_batch(query, qlen, target, tlen, w, h0, max_ins, max_del,
                 params, prev_score=None, max_band_try: int = 2, *,
                 blk_b: int = 128, device="cuda") -> ExtendOut:
    """Full extension with band doubling: pass k at aw = min(w << k,
    max_ins, max_del); a lane keeps the first pass that converged
    (score == the previous score, or max_off < (aw>>1) + (aw>>2))."""
    h0 = np.asarray(h0, np.int32)
    prev = (np.full_like(h0, -1) if prev_score is None
            else np.asarray(prev_score, np.int32))
    out = converged = None
    for k in range(max_band_try):
        awk = np.minimum(np.minimum(np.asarray(w, np.int32) << k,
                                    max_ins), max_del).astype(np.int32)
        o = extend_batch_core(query, qlen, target, tlen, awk, h0, params,
                              blk_b=blk_b, device=device)
        o = o._replace(w_used=awk)
        conv_k = (o.score == prev) | (o.max_off < ((awk >> 1) + (awk >> 2)))
        if out is None:
            out, converged = o, conv_k
        else:
            out = ExtendOut(*[np.where(converged, x, y)
                              for x, y in zip(out, o)])
            converged = converged | conv_k
        prev = out.score
    return out


def make_raw_backend(params, device, blk_l: int = 512, *,
                     compute_dtype=torch.int32):
    """The Python host's extend_batch_fn on `device` (a torch.device):
    backend(query, qlen, target, tlen, aw, h0) -> ExtendOut of numpy,
    one `extend_t` launch per call on a CUDA device.  The host packs the
    scalars, transposes the row-major int32 tasks and narrows them to
    int8 (codes 0-4) before the H2D copy; the result comes back to the
    host.  Calls need len(qlen) % blk_l == 0.  compute_dtype=torch.int16
    runs the 16-bit cells (extend_cuda.check_i16_range; every lane
    needs h0 + a*qmax < 2^14 and aw < 2^14, checked on the host block:
    ValueError outside them)."""
    prm = params_vector(params)
    device = torch.device(device)

    def backend(query, qlen, target, tlen, aw, h0):
        return _run(query, qlen, target, tlen, aw, h0, prm, blk_l, device,
                    compute_dtype)

    return backend
