"""Device half of the resident-reference paths (the counterpart of
bwamem_tpu/pipeline/native_driver.py:741-1076): the fused extension, the
mate-rescue waves and the CIGAR rounds.

The two-strand reference text lives on the device once, nibble-packed
into 32-bit words (8 base codes per word, built on the host by
`native_driver.two_strand_text_packed`).  Per chunk the host ships only
the (16, Bp) lane scalars and the nibble-packed read matrix; the query and
target windows are gathered on the device and fed to the fused
extension kernel.  `make_fused_idx_backend` returns the callable that
`NativePipeline._run_fused` drives unchanged (.fused = .idx = True,
.bp_quantum).  `make_rescue_idx_backend` (mp_rescue_* waves) and
`make_cigar_idx_backend` (mp_cigar_* rounds) work the same way: the host
ships a (6, Bp) or (8, Bp) meta block, the mate or query segments come
out of the read matrix and the reference windows out of the text, both
on the device, and the kernels of ops/local_cuda or ops/global_cuda run
on them.
`make_resident_text` is called once and its tensor handed to every idx
backend (`text_dev=`), so the reference is on the card once.

The gathers are plain PyTorch (they are XLA ops outside Pallas in the
JAX package).  Torch has no `>>` for uint32 on the CPU, so the text is
held as an int32 view of the words and gathered words are widened to
int64 and masked to 32 bits before they are shifted.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bwamem_tpu_torch.device import to_device

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
                    qmax_r, tmax_r, a_max, compute_dtype=torch.int32):
    """Gather the query windows from the read matrix and the target
    windows from the resident text, then run the fused extension.  All
    tensors on one device; tmax2, which is not read, may be anywhere.
    Target starts arrive as (lo20, hi) pairs in scal rows 12-15.
    Returns (32, B), narrowed to int16 when the score bound
    a_max*2*L2 < 32000 (every field then fits).  With
    compute_dtype=torch.int16 the extension runs with 16-bit cells;
    the same bound then has to stay below 2^14 (it is the most a seed
    score h0 plus a*qmax can reach on reads of 2*L2 bases), else
    ValueError."""
    L2 = reads_nib.shape[1]
    if compute_dtype == torch.int16 and a_max * 2 * L2 >= 1 << 14:
        raise ValueError(f"16-bit cells need a_max*read length < 2^14, got "
                         f"{a_max} * {2 * L2}")
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
        ql, tl.to(torch.int8), qr, tr.to(torch.int8), scal, tmax2, prm,
        compute_dtype=compute_dtype)
    if a_max * 2 * L2 < 32000:
        out = out.to(torch.int16)
    return out


def make_fused_idx_backend(params, pac, device, blk_l: int = 512, *,
                           text_dev=None, compute_dtype=torch.int32):
    """The resident-reference fused backend for NativePipeline on
    `device` (a torch.device).  Calls take host numpy arrays and return a
    host numpy array: the H2D and D2H copies happen inside.  tmax2 stays
    on the host (the extension reads no row bound).  Safe to call from
    several threads at once (--inflight); `dispatches` counts the
    calls.  Pass `text_dev` (make_resident_text's tensor on `device`) to
    share the reference with the other idx backends instead of packing
    `pac` again; compute_dtype=torch.int16 runs the 16-bit cell kernel
    (see fused_idx_local for its bound)."""
    prm = params_vector(params)
    a_max = int(np.max(np.asarray(params.mat_flat)))
    text = text_dev if text_dev is not None else make_resident_text(
        pac, device)
    lock = threading.Lock()

    def fused_idx(reads_nib, scal, tmax2, dims):
        qmax_l, tmax_l, qmax_r, tmax_r = dims
        with lock:
            fused_idx.dispatches += 1
        r = to_device(reads_nib, np.int8, device)
        s = to_device(scal, np.int32, device)
        out = fused_idx_local(
            r, s, tmax2, prm, text, qmax_l=qmax_l, tmax_l=tmax_l,
            qmax_r=qmax_r, tmax_r=tmax_r, a_max=a_max,
            compute_dtype=compute_dtype)
        return out.cpu().numpy()

    fused_idx.fused = True
    fused_idx.idx = True
    fused_idx.bp_quantum = blk_l
    fused_idx.dispatches = 0
    return fused_idx


def rescue_idx_local(reads_nib, meta, mat, pens, text, *, qmax, tmax):
    """One resident-reference mate-rescue wave: gather the mate sequence
    from the read matrix (reverse-complemented in-lane when meta row 3 is
    set: 3 - q for codes < 4) and the reference window from the text,
    then run the batched local SW (ops/local_cuda.align6: the kernel on a
    card, the plain version on the CPU).  meta (6, B)
    int32 rows: [l_ms, l_ts, read index, is_rev, win_lo20, win_hi]; all
    tensors on one device.  Returns (6, B) int32."""
    from bwamem_tpu_torch.ops.local_cuda import align6

    j = torch.arange(qmax, device=meta.device, dtype=torch.int32)[None, :]
    rev = meta[3][:, None] == 1
    col = torch.where(rev, meta[0][:, None] - 1 - j, j)
    q = nib_gather(reads_nib, meta[2][:, None], col)
    q = torch.where(rev & (q < 4), 3 - q, q)
    t = text_gather_window(text, meta[4], meta[5], tmax, 1).t()
    return align6(q, meta[0], t.contiguous(), meta[1], mat, pens)


def make_rescue_idx_backend(pac, device, *, text_dev=None):
    """Resident-reference device mate rescue on `device`: NativePipeline's
    mp_rescue_* wave protocol ships only the (6, Bp) meta block; the
    mate sequences and reference windows are gathered on the device.
    Calls take host numpy arrays and return a (6, Bp) int32 numpy array.
    Pass `text_dev` to share the text tensor with the other idx
    backends.  `.idx = True` is what the host loop looks for; the
    backend keeps no state beyond the text."""
    device = torch.device(device)
    text = text_dev if text_dev is not None else make_resident_text(
        pac, device)

    def rescue_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins,
                   qmax, tmax):
        out = rescue_idx_local(
            to_device(reads_nib, np.int8, device),
            *(to_device(x, np.int32, device)
              for x in (meta, mat, [o_del, e_del, o_ins, e_ins])),
            text, qmax=qmax, tmax=tmax)
        return out.cpu().numpy()

    rescue_idx.idx = True
    return rescue_idx


def cigar_idx_local(reads_nib, meta, mat, pens, text, *, qmax, tmax,
                    band=None):
    """One resident-reference CIGAR round: gather the query segment from
    the read matrix and the reference segment from the text (both walked
    backwards for reverse-strand regions, as the host's gen_cigar_setup
    does), then run the batched banded global alignment with traceback
    (ops/global_cuda.global_batch: the kernel on a card, the plain version
    on the CPU).  meta (8, B) int32 rows: [qlen,
    tlen, w, read index, qcol0, is_rev, t_lo20, t_hi]; all tensors on one
    device; `band` the round's widest band (global_cuda.global_batch).
    Returns (score (B,), steps (qmax + tmax, B))."""
    from bwamem_tpu_torch.ops.global_cuda import global_batch

    rev = meta[5] == 1
    sign = torch.where(rev, -1, 1).to(torch.int32)[:, None]
    j = torch.arange(qmax, device=meta.device, dtype=torch.int32)[None, :]
    q = nib_gather(reads_nib, meta[3][:, None], meta[4][:, None] + sign * j)
    # per-lane walk direction: one ascending window gather (reverse lanes
    # start at t_lo - (tmax-1)), then a flip selected per lane
    lo = torch.where(rev, meta[6] - (tmax - 1), meta[6])
    A = text_gather_window(text, lo, meta[7], tmax, 1)    # (tmax, B)
    t = torch.where(rev[None, :], A.flip(0), A).t()
    return global_batch(q, meta[0], t.contiguous(), meta[1], meta[2], mat,
                        pens, band=band)


def make_cigar_idx_backend(pac, device, *, text_dev=None):
    """Resident-reference device CIGAR on `device`: NativePipeline's
    mp_cigar_* round protocol ships only the (8, Bp) meta block; query
    and reference segments are gathered on the device.  Calls take host
    numpy arrays and return the round triple of
    global_torch.pack_cigar_round.  `text_dev` and `.idx` as in
    make_rescue_idx_backend."""
    from bwamem_tpu_torch.ops.global_torch import band_width, pack_cigar_round

    device = torch.device(device)
    text = text_dev if text_dev is not None else make_resident_text(
        pac, device)

    def cigar_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins,
                  qmax, tmax):
        return pack_cigar_round(*cigar_idx_local(
            to_device(reads_nib, np.int8, device),
            *(to_device(x, np.int32, device)
              for x in (meta, mat, [o_del, e_del, o_ins, e_ins])),
            text, qmax=qmax, tmax=tmax,
            band=band_width(meta[0], meta[1], meta[2], qmax)))

    cigar_idx.idx = True
    return cigar_idx
