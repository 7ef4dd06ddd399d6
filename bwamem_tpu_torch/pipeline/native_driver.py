"""Host-shipped-window backends for the reused C++ host pipeline (the
counterparts of bwamem_tpu/pipeline/native_driver.py:682-738).

`NativePipeline` (bwamem_tpu.pipeline.native_driver, JAX-free) fills the
windows on the host and drives either backend unchanged:

- `make_raw_t_backend`: the four-pass protocol (`_run_phase`): L0, the
  compacted L retry, R0, the compacted R retry, each one `extend_t`
  launch;
- `make_fused_backend` (`--ship-ref`): one fused launch per chunk over
  the four int8 windows the host filled (`_run_fused`'s non-idx
  branch), where the resident path gathers them on the device.

Calls take host numpy arrays and return host numpy arrays (the pipeline
calls `np.asarray` on the result): the H2D and D2H copies happen inside.
The row bounds (`tmaxb`, `tmax2`) stay on the host, since the kernels do
not read them.  Both backends are safe to call from several threads at
once (--inflight) and count their calls in `dispatches`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.ops import extend_cuda
from bwamem_tpu_torch.ops.types import params_vector


def _to(x, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def make_raw_t_backend(params, device, blk_l: int = 512):
    """The per-phase backend on `device` (a torch.device):
    raw_t(query_t (qmax, Bp) int8, target_t (tmax, Bp) int8, scal_t
    (8, Bp) int32, tmaxb) -> (8, Bp) int32 numpy.  Lane counts are
    padded to a multiple of blk_l (`.bp_quantum`)."""
    prm = params_vector(params)
    lock = threading.Lock()

    def raw_t(query_t, target_t, scal_t, tmaxb):
        with lock:
            raw_t.dispatches += 1
        out = extend_cuda.extend_batch_raw_t(
            _to(query_t, np.int8, device), _to(target_t, np.int8, device),
            _to(scal_t, np.int32, device), tmaxb, prm)
        return out.cpu().numpy()

    raw_t.bp_quantum = blk_l
    raw_t.dispatches = 0
    return raw_t


def make_fused_backend(params, device, blk_l: int = 512):
    """The host-shipped-window fused backend on `device` (--ship-ref):
    fused(ql, tl, qr, tr (len, Bp) int8, scal (16, Bp) int32, tmax2) ->
    (32, Bp) int32 numpy.  `.fused` routes NativePipeline to
    `_run_fused`; without `.idx` it fills and ships the windows."""
    prm = params_vector(params)
    lock = threading.Lock()

    def fused(ql, tl, qr, tr, scal, tmax2):
        with lock:
            fused.dispatches += 1
        win = [_to(x, np.int8, device) for x in (ql, tl, qr, tr)]
        out = extend_cuda.extend_batch_raw_fused(
            *win, _to(scal, np.int32, device), tmax2, prm)
        return out.cpu().numpy()

    fused.fused = True
    fused.bp_quantum = blk_l
    fused.dispatches = 0
    return fused
