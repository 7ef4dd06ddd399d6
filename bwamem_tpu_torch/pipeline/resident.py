"""Device half of the resident-reference fused path (the counterpart of
bwamem_tpu/pipeline/native_driver.py:741-967).

The two-strand reference text lives on the device once, nibble-packed
into 32-bit words (8 base codes per word, built on the host by
`native_driver.two_strand_text_packed`).  Per chunk the host ships only
the (16, Bp) lane scalars and the nibble-packed read matrix; the query and
target windows are gathered on the device and fed to the fused
extension kernel.  `make_fused_idx_backend` returns the callable that
`NativePipeline._run_fused` drives unchanged (.fused = .idx = True,
.bp_quantum).

The gathers are plain PyTorch (they are XLA ops outside Pallas in the
JAX package).  Torch has no `>>` for uint32 on the CPU, so the text is
held as an int32 view of the words and gathered words are widened to
int64 and masked to 32 bits before they are shifted.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.ops import extend_cuda
from bwamem_tpu_torch.ops.types import params_vector

_MASK32 = 0xFFFFFFFF


def make_resident_text(pac, device) -> torch.Tensor:
    """The packed two-strand text of `pac` on `device`: a flat int32
    tensor holding the uint32 words bit for bit."""
    from bwamem_tpu_torch.pipeline.native_driver import resident_text_host

    words = resident_text_host(np.asarray(pac))
    return torch.from_numpy(words.view(np.int32)).to(device)


def nib_gather(reads_nib, row, col):
    """Base codes at (row, col) of the logical (n, 2*L2) read matrix
    held nibble-packed in `reads_nib` (n, L2) int8 (low nibble first).
    The column is clamped to [0, 2*L2-1]; returns int32."""
    L2 = reads_nib.shape[1]
    col = col.clamp(0, 2 * L2 - 1)
    idx = row.long() * L2 + (col >> 1).long()
    b = reads_nib.reshape(-1)[idx].to(torch.int32) & 0xFF
    return torch.where((col & 1) == 1, b >> 4, b & 0xF)


def _words(text, w):
    """Words at int64 indices `w` (clamped to the text), as int64 in
    [0, 2^32)."""
    w = w.clamp(0, text.shape[0] - 1)
    return text[w].long() & _MASK32


def text_gather(text, lo, hi):
    """Per-symbol gather at position hi*2^20 + lo (lo may carry an
    offset of either sign): the semantic oracle of text_gather_window.
    Returns int32 codes."""
    lo = lo.to(torch.int32)
    w = hi.long() * (1 << 17) + (lo >> 3).long()
    word = _words(text, w)
    return ((word >> ((lo & 7).long() * 4)) & 0xF).to(torch.int32)


def text_gather_window(text, lo, hi, length, sign):
    """`length` consecutive base codes per lane from position
    hi*2^20 + lo, ascending (sign=+1) or descending (sign=-1).
    Returns (length, B) int32.  Gathers length//8 + 1 words per lane and
    realigns each lane's nibble stream by its start offset."""
    lo = lo.to(torch.int32)
    if sign < 0:
        # descending window = ascending window from lo-(length-1), flipped
        lo = lo - (length - 1)
    dev = text.device
    nw = length // 8 + 1
    k = torch.arange(nw, device=dev, dtype=torch.int64)[:, None]
    base = hi.long() * (1 << 17) + (lo >> 3).long()
    W = _words(text, base[None, :] + k)                     # (nw, B)
    off = ((lo & 7).long() * 4)[None, :]
    Wn = torch.cat([W[1:], W[-1:]], 0)
    # off == 0 guard: a shift by 32 would pull in the next word
    v = torch.where(off == 0, W, ((W >> off) | (Wn << (32 - off))) & _MASK32)
    j = torch.arange(length, device=dev, dtype=torch.int64)
    rows = v[j >> 3]
    out = ((rows >> ((j & 7)[:, None] * 4)) & 0xF).to(torch.int32)
    return out.flip(0) if sign < 0 else out


def fused_idx_local(reads_nib, scal, tmax2, prm, text, *, qmax_l, tmax_l,
                    qmax_r, tmax_r, a_max):
    """Gather the query windows from the read matrix and the target
    windows from the resident text, then run the fused extension.  All
    tensors on one device; tmax2, which is not read, may be anywhere.
    Target starts arrive as (lo20, hi) pairs in scal rows 12-15.
    Returns (32, B), narrowed to int16 when the score bound
    a_max*2*L2 < 32000 (every field then fits)."""
    L2 = reads_nib.shape[1]
    dev = scal.device
    ri = scal[10][None, :]

    def q_gather(qmax, col_of):
        j = torch.arange(qmax, device=dev, dtype=torch.int32)[:, None]
        return nib_gather(reads_nib, ri, col_of(j)).to(torch.int8)

    # left query = reversed read prefix; right = read suffix
    ql = q_gather(qmax_l, lambda j: scal[0][None, :] - 1 - j)
    qr = q_gather(qmax_r, lambda j: scal[11][None, :] + j)
    # left target descends from rows 12/14; right ascends from 13/15
    tl = text_gather_window(text, scal[12], scal[14], tmax_l, -1)
    tr = text_gather_window(text, scal[13], scal[15], tmax_r, +1)
    out = extend_cuda.extend_batch_raw_fused(
        ql, tl.to(torch.int8), qr, tr.to(torch.int8), scal, tmax2, prm)
    if a_max * 2 * L2 < 32000:
        out = out.to(torch.int16)
    return out


def make_fused_idx_backend(params, pac, device, blk_l: int = 512):
    """The resident-reference fused backend for NativePipeline on
    `device` (a torch.device).  Calls take host numpy arrays and return a
    host numpy array: the H2D and D2H copies happen inside.  tmax2 stays
    on the host (the extension reads no row bound).  Safe to call from
    several threads at once (--inflight); `dispatches` counts the
    calls."""
    prm = params_vector(params)
    a_max = int(np.max(np.asarray(params.mat_flat)))
    text = make_resident_text(pac, device)
    lock = threading.Lock()

    def fused_idx(reads_nib, scal, tmax2, dims):
        qmax_l, tmax_l, qmax_r, tmax_r = dims
        with lock:
            fused_idx.dispatches += 1
        r = torch.from_numpy(np.ascontiguousarray(reads_nib)).to(device)
        s = torch.from_numpy(np.ascontiguousarray(scal, np.int32)).to(device)
        out = fused_idx_local(
            r, s, tmax2, prm, text, qmax_l=qmax_l, tmax_l=tmax_l,
            qmax_r=qmax_r, tmax_r=tmax_r, a_max=a_max)
        return out.cpu().numpy()

    fused_idx.fused = True
    fused_idx.idx = True
    fused_idx.bp_quantum = blk_l
    fused_idx.dispatches = 0
    return fused_idx
